"""Every family's tiny config exported with ``vit_tpu_torch.utils.aot`` on
the CPU: the program exported, saved and loaded against the eager forward
(bitwise), and its graph's port operators against eager's calls of them.
Apart from ``tests/test_torch_aot.py`` so that the two run on two workers."""

import pytest
import torch

from test_torch_aot import QUANT_MODES, _family, _graph_ops, _RoutedPortOps
from vit_tpu_torch.__main__ import init_parameters
from vit_tpu_torch.models import MODEL_REGISTRY
from vit_tpu_torch.utils import export_forward, load_forward

torch.set_num_threads(2)

FAMILIES = sorted(MODEL_REGISTRY) + ["vit_moe"] + [f"quant_{m}" for m in QUANT_MODES]


@pytest.mark.parametrize("name", FAMILIES)
def test_exported_program_equals_eager(name):
    """Each family's tiny config in bf16 at batch 2: the program exported,
    saved and loaded gives eager's logits bit for bit; its graph holds
    ``aten`` operators and the port's, one node of each port operator for
    each launch an eager forward makes (``_RoutedPortOps``)."""
    model, size = _family(name)
    if not name.startswith("quant_"):
        init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    x = torch.randn(2, size, size, 3, generator=torch.Generator().manual_seed(1)).bfloat16()
    program = load_forward(export_forward(model, x))
    counter = _RoutedPortOps()
    with torch.inference_mode():
        with counter:
            eager = model(x)
        out = program(x)
    eager, out = (t[0] if isinstance(t, tuple) else t for t in (eager, out))
    assert torch.equal(out, eager)
    assert _graph_ops(program) == counter.counts
    if name == "vit":
        assert counter.counts == {"attention_block": 2, "fused_mlp": 2}
    if name == "vit_small_datasets":  # LSA keeps every layer off the attention kernels
        assert not set(counter.counts) & {"attention_block", "qkv_attention", "flash_attention",
                                          "flash_attention_kv_blocked"}
