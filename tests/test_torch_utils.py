"""The port's parity, health and profiling utilities on the CPU:
``fp64_vit_forward`` and ``max_logit_err`` against vit_tpu's, ``cost_analysis``
of a tiny ViT against its analytic FLOPs, ``benchmark``, ``log_event``,
``trace``, ``probe_devices``, ``with_retry`` and ``memory_stats``."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from vit_tpu_torch import ops
from vit_tpu_torch.models import ViT
from vit_tpu_torch.utils import (
    fp64_vit_forward,
    init_params,
    max_logit_err,
    memory_stats,
    probe_devices,
    with_retry,
)
from vit_tpu_torch.utils import profiling

torch.set_num_threads(2)

CFG = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4,
           mlp_dim=128, dim_head=16)


def _reference_tree(depth=2, dim=32, heads=2, dim_head=16, mlp=64, classes=5, patch=8, seed=0):
    """A reference ``vit.py`` parameter tree (its flax call-order names) of
    random numpy values."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (0.2 * rng.standard_normal(s)).astype(np.float32)
    inner, n = heads * dim_head, (32 // patch) ** 2 + 1
    tr = {}
    for i in range(depth):
        tr[f"PreNorm_{2 * i}"] = {"LayerNorm_0": {"scale": 1 + r(dim), "bias": r(dim)}}
        tr[f"PreNorm_{2 * i + 1}"] = {"LayerNorm_0": {"scale": 1 + r(dim), "bias": r(dim)}}
        tr[f"Attention_{i}"] = {"Dense_0": {"kernel": r(dim, 3 * inner)},
                                "Dense_1": {"kernel": r(inner, dim), "bias": r(dim)}}
        tr[f"FeedForward_{i}"] = {"Dense_0": {"kernel": r(dim, mlp), "bias": r(mlp)},
                                  "Dense_1": {"kernel": r(mlp, dim), "bias": r(dim)}}
    return {"params": {"Dense_0": {"kernel": r(patch * patch * 3, dim), "bias": r(dim)},
                       "cls": r(1, 1, dim), "pos_embedding": r(1, n, dim), "Transformer_0": tr,
                       "LayerNorm_0": {"scale": 1 + r(dim), "bias": r(dim)},
                       "Dense_1": {"kernel": r(dim, classes), "bias": r(classes)}}}


def test_fp64_vit_forward_and_max_logit_err_equal_vit_tpus():
    from vit_tpu.utils import parity as jparity

    tree = _reference_tree()
    img = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    kw = dict(patch_size=8, depth=2, heads=2, dim_head=16)
    ours = fp64_vit_forward(tree, img, **kw)
    ref = jparity.fp64_vit_forward(tree, img, **kw)
    assert ours.dtype == np.float64 and ours.shape == (2, 5)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(fp64_vit_forward(tree["params"], torch.from_numpy(img), **kw),
                                  ref)
    b = ref + np.float32(1e-3) * np.arange(10).reshape(2, 5)
    assert max_logit_err(ref, b) == jparity.max_logit_err(ref, b)
    assert max_logit_err(torch.from_numpy(ref), torch.from_numpy(b)) == max_logit_err(ref, b)


def _vit_flops(b, c):
    """Multiply-adds x 2 of ViT's products: the patch embedding, each layer's
    qkv, scores, P V, out, and both MLP products, and the head."""
    n_p = (c["image_size"] // c["patch_size"]) ** 2
    n, d, inner = n_p + 1, c["dim"], c["heads"] * c["dim_head"]
    layer = (2 * b * n * d * 3 * inner + 2 * 2 * b * c["heads"] * n * n * c["dim_head"]
             + 2 * b * n * inner * d + 2 * 2 * b * n * d * c["mlp_dim"])
    return (2 * b * n_p * c["patch_size"] ** 2 * 3 * d + c["depth"] * layer
            + 2 * b * d * c["num_classes"])


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cost_analysis_counts_a_tiny_vits_analytic_flops(qkv_bias):
    """The fused branch (kernel 1's twin) and the qkv-bias branch (kernel 4's
    twin, flax Dense products) count the same FLOPs: every product, 2 per
    multiply-add."""
    cfg = dict(CFG, qkv_bias=qkv_bias)
    model = ViT(**cfg, dtype=torch.bfloat16, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, 32, 3).bfloat16()
    cost = profiling.cost_analysis(model, x)
    assert cost["flops"] == _vit_flops(2, CFG), (cost["flops"], _vit_flops(2, CFG))
    assert sum(cost["flops_by_op"].values()) == cost["flops"]


def test_cost_analysis_sees_through_a_kernel_wrapper(monkeypatch):
    """A layer counts the same FLOPs whatever implements it: cost_analysis
    runs the twins, where a kernel's launch would be invisible."""
    seen = []
    real = ops.mlp

    def spy(*a, **kw):
        seen.append(ops._use_kernel(a[0]))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "mlp", spy)
    model = ViT(**CFG, device="cpu")
    profiling.cost_analysis(model, torch.randn(1, 32, 32, 3))
    assert seen and not any(seen)


def test_benchmark_log_event_and_trace(tmp_path, capsys):
    calls = []
    stats = profiling.benchmark(lambda x: calls.append(x) or x * 2, torch.ones(4), iters=5,
                                warmup=2, items_per_call=8)
    assert len(calls) == 7
    assert stats["min_s"] <= stats["p50_s"] and stats["mean_s"] > 0
    assert stats["items_per_sec"] == pytest.approx(8 / stats["p50_s"])
    assert "items_per_sec" not in profiling.benchmark(lambda: None, iters=1, warmup=0)
    profiling.log_event("compile", seconds=1.5, batch=8)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["event"] == "compile" and line["batch"] == 8 and line["seconds"] == 1.5
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    files = list((tmp_path / "t").iterdir())
    assert len(files) == 1 and json.loads(files[0].read_text())["traceEvents"]


def test_probe_devices_with_retry_and_memory_stats():
    report = probe_devices(["cpu"])
    assert report["ok"] and report["devices"] == 1 and report["details"][0]["device"] == "cpu"
    assert memory_stats("cpu") == {"bytes_in_use": None, "peak_bytes_in_use": None,
                                   "bytes_limit": None}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe_devices()
    tries = []

    def flaky(x):
        tries.append(x)
        if len(tries) < 2:
            raise RuntimeError("transient")
        return x + 1

    assert with_retry(flaky, attempts=3, backoff_s=0.0)(1) == 2 and len(tries) == 2
    with pytest.raises(ValueError):
        with_retry(lambda: (_ for _ in ()).throw(ValueError("always")), attempts=2,
                   backoff_s=0.0)()


def test_the_utilities_import_nothing_of_jax():
    code = ("import sys, vit_tpu_torch.utils.parity, vit_tpu_torch.utils.health, "
            "vit_tpu_torch.utils.profiling, vit_tpu_torch.utils.quantize; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'vit_tpu')]; "
            "sys.exit(bool(bad))")
    assert subprocess.run([sys.executable, "-c", code], timeout=120).returncode == 0


@pytest.mark.cuda
def test_probe_and_memory_stats_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    report = probe_devices()
    assert report["ok"] and report["devices"] == torch.cuda.device_count()
    x = torch.empty(1 << 20, device="cuda")
    stats = memory_stats()
    assert stats["bytes_in_use"] >= x.numel() * 4 and stats["bytes_limit"] > stats["bytes_in_use"]
