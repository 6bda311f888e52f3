"""The port's ahead-of-time export (``vit_tpu_torch.utils.aot``) and the
kernels as ``torch.library`` operators, on the CPU: the serving artifact
against the live pipeline and against ``vit_tpu``'s artifact, every family's
exported program against its eager forward, the operators' fake
implementations against their CPU implementations, and planted faults. The
card tests hold each operator's fake against the kernel's output."""

import collections
import io
import operator
import zipfile
from unittest import mock

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from vit_tpu_torch import ops
from vit_tpu_torch.__main__ import init_parameters
from vit_tpu_torch.models import MODEL_REGISTRY, ViT, ViTMoE
from vit_tpu_torch.nn import Dense
from vit_tpu_torch.pipeline import InferencePipeline, preprocess
from vit_tpu_torch.utils import (
    ExportedServing,
    export_forward,
    export_serving,
    from_jax_params,
    load_forward,
    quantize_vit,
)

torch.set_num_threads(2)

# vit_tpu's tests/test_pipeline_and_utils.py MODEL and tests/test_quant.py _small_vit
MODEL = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=1, heads=4, mlp_dim=128,
             dim_head=16)
SMALL_VIT = dict(MODEL, depth=3)
MOE = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2, heads=4, mlp_dim=64,
           dim_head=8, num_experts=4, num_selected=2)
QUANT_MODES = ("w8", "w8a8", "w8a8_kernel")
# The port's artifact against vit_tpu's on the same uint8 images: preprocess
# agrees to 2e-4 (tests/test_torch_serving.py, the live pipelines' bound),
# and the logits of the fp32 tiny ViT measured 4.8e-6 apart here.
ARTIFACT_TOL = 2e-4

KERNEL_OPS = ("attention_block", "fused_mlp", "qkv_attention", "quant_attention_block",
              "quant_mlp", "talking_heads_block", "reattention_block", "flash_attention",
              "window_attention_block", "flash_attention_kv_blocked")
PORT_OPS = KERNEL_OPS + ("gemm_sm90", "mm_rounded")


def _jax_vit(cfg):
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import ViT as JaxViT

    model = JaxViT(**cfg)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, jnp.ones((1, 32, 32, 3)))
    return model, variables


def _port_vit(cfg, variables):
    import jax

    model = ViT(**cfg, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables),
                                          model.jax_stages))
    return model.eval()


def _images(n, seed, size=40):
    return (np.random.default_rng(seed).random((n, size, size, 3)) * 255).astype(np.uint8)


# -- (a) vit_tpu's two round-trip tests, mirrored ------------------------------------


def _served_matches_pipeline(blob, model):
    served = ExportedServing(blob)
    pipe = InferencePipeline(model, image_size=32, batch_size=4, dtype=torch.float32)
    raw = _images(3, 0)
    np.testing.assert_allclose(served(raw), pipe(raw), atol=1e-5)  # ragged: pads 3 -> 4
    raw9 = _images(9, 1)
    np.testing.assert_allclose(served(raw9), pipe(raw9), atol=1e-5)  # chunked 4 + 4 + 1


@pytest.fixture(scope="module")
def float_artifact():
    model = _port_vit(MODEL, _jax_vit(MODEL)[1])
    return model, export_serving(model, image_size=32, batch_buckets=(2, 4), decode_size=40,
                                 dtype=torch.float32)


def test_aot_export_roundtrip(float_artifact):
    """The serving artifact (preprocess + model, weights baked in), loaded
    from bytes, serves the rows of the live InferencePipeline: a ragged
    batch padded to bucket 4, a batch of 9 in chunks of the largest."""
    model, blob = float_artifact
    assert ExportedServing(blob).buckets == [2, 4]
    _served_matches_pipeline(blob, model)


def test_the_buckets_share_one_copy_of_the_weights(float_artifact):
    """The artifact holds the weights once, whatever the number of buckets,
    and the loaded programs read the same tensors."""
    model, blob = float_artifact
    one = export_serving(model, image_size=32, batch_buckets=(2,), decode_size=40,
                         dtype=torch.float32)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert len(blob) - len(one) < 0.25 * nbytes, (len(blob), len(one), nbytes)
    programs = ExportedServing(blob)._programs
    for name, p in programs[2].state_dict().items():
        assert p.data_ptr() == programs[4].state_dict()[name].data_ptr(), name


def _swapped(blob, a, b):
    src, out = zipfile.ZipFile(io.BytesIO(blob)), io.BytesIO()
    with zipfile.ZipFile(out, "w") as z:
        for name in src.namelist():
            swap = {f"program_{a}": f"program_{b}", f"program_{b}": f"program_{a}"}
            z.writestr(name, src.read(swap.get(name, name)))
    return out.getvalue()


def test_a_swapped_bucket_program_fails_the_roundtrip(float_artifact):
    """Planted fault: each bucket's program stands under the other's name."""
    model, blob = float_artifact
    with pytest.raises((RuntimeError, AssertionError)):
        _served_matches_pipeline(_swapped(blob, 2, 4), model)


def test_w8a8_aot_export_roundtrip():
    """The int8 QuantViT (auto: w8a8 at batch 2) exports with its int8 codes
    baked in, below 0.6x the float artifact's bytes (the program keeps only
    the code layout it reads), and the loaded program reproduces the live
    logits."""
    model = _port_vit(SMALL_VIT, _jax_vit(SMALL_VIT)[1])
    qmodel = quantize_vit(model)
    blob = export_serving(qmodel, image_size=32, batch_buckets=(2,), decode_size=40,
                          dtype=torch.float32)
    float_blob = export_serving(model, image_size=32, batch_buckets=(2,), decode_size=40,
                                dtype=torch.float32)
    assert len(blob) < 0.6 * len(float_blob), (len(blob), len(float_blob))
    raw = _images(2, 9)
    with torch.inference_mode():
        live = qmodel(preprocess(torch.from_numpy(raw), image_size=32, dtype=torch.float32))
    np.testing.assert_allclose(ExportedServing(blob)(raw), live.numpy(), atol=1e-5)


# -- (b) against vit_tpu's artifact --------------------------------------------------


def test_artifact_matches_vit_tpus_artifact():
    """One set of weights (``from_jax_params``), one set of uint8 images: the
    port's artifact and vit_tpu's give the same rows within ARTIFACT_TOL, at
    a ragged batch and a chunked one."""
    import jax.numpy as jnp
    from vit_tpu.utils.aot import ExportedServing as JaxServing
    from vit_tpu.utils.aot import export_serving as jax_export_serving

    jmodel, variables = _jax_vit(MODEL)
    theirs = JaxServing(jax_export_serving(jmodel, variables, image_size=32,
                                           batch_buckets=(2, 4), decode_size=40,
                                           dtype=jnp.float32))
    ours = ExportedServing(export_serving(_port_vit(MODEL, variables), image_size=32,
                                          batch_buckets=(2, 4), decode_size=40,
                                          dtype=torch.float32))
    for raw in (_images(3, 2), _images(9, 3)):
        ref = np.asarray(theirs(raw))
        err = np.abs(ours(raw) - ref).max()
        assert err <= ARTIFACT_TOL, err


# -- the operators in an eager forward and in a graph --------------------------------


class _DispatchedPortOps(TorchDispatchMode):
    """Counts the calls of each ``vit_tpu_torch::`` operator that reach the
    dispatcher."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "vit_tpu_torch":
            self.counts[func._schema.name.split("::")[1]] += 1
        return func(*args, **(kwargs or {}))


class _RoutedPortOps:
    """Counts, by port operator, the entry calls of a forward made outside
    ``force_backend("torch")`` with no operand that needs grad: each is one
    launch on the card, and must be one node of an exported graph."""

    def __init__(self):
        self.counts = collections.Counter()
        self._patch = mock.patch.object(ops, "_route", self._route)

    def _route(self, op, *rest):
        if not ops._forced() and not ops.needs_grad(*rest[2:]):
            self.counts[op._schema.name.split("::")[1]] += 1
        return self._real(op, *rest)

    def __enter__(self):
        self._real = ops._route
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def _graph_ops(program_module):
    """``{port op: nodes}`` of a loaded program's graph; asserts that every
    other node calls an ``aten`` operator (or takes an item of a tuple)."""
    counts = collections.Counter()
    for node in program_module.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        namespace = getattr(node.target, "namespace", None)
        assert namespace in ("aten", "vit_tpu_torch"), node.format_node()
        if namespace == "vit_tpu_torch":
            counts[node.target._schema.name.split("::")[1]] += 1
    return counts


def _family(name):
    if name == "vit_moe":
        return ViTMoE(**MOE, dtype=torch.bfloat16, device="cpu"), 32
    if name.startswith("quant_"):
        cls, cfg, size = MODEL_REGISTRY["vit"]
        model = cls(**cfg, dtype=torch.bfloat16, device="cpu")
        init_parameters(model, torch.Generator().manual_seed(0))
        qmodel = quantize_vit(model)
        qmodel.mode = name[len("quant_"):]
        return qmodel, size
    cls, cfg, size = MODEL_REGISTRY[name]
    return cls(**cfg, dtype=torch.bfloat16, device="cpu"), size


# -- (d), (e): the bf16 Dense and force_backend ---------------------------------------


def test_bf16_dense_exports_as_the_mm_rounded_operator():
    """The bf16 product carries its fp32 split-K sums (``fp32_bf16_sums``)
    inside the operator, so the exported graph holds the operator and no
    bare product."""
    dense = Dense(64, 32, dtype=torch.bfloat16, device="cpu")
    init_parameters(dense, torch.Generator().manual_seed(0))
    program = load_forward(export_forward(dense, torch.randn(3, 5, 64)))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert _graph_ops(program) == {"mm_rounded": 1}
    assert not [t for t in targets if "matmul" in t or "aten.mm" in t or "bmm" in t], targets


def test_force_backend_exports_no_port_operator():
    model, size = _family("vit")
    x = torch.randn(2, size, size, 3).bfloat16()
    with ops.force_backend("torch"):
        program = load_forward(export_forward(model.eval(), x))
    assert _graph_ops(program) == {}
    with torch.inference_mode():
        assert torch.equal(program(x), model(x))


def test_export_forward_takes_a_function():
    """A plain function is exported wrapped in a module, as vit_tpu's
    ``export_forward`` takes one."""
    x = torch.randn(3, 4)
    program = load_forward(export_forward(lambda t: torch.tanh(t) * 2.0 + 1.0, x))
    assert torch.equal(program(x), torch.tanh(x) * 2.0 + 1.0)


# -- (f) -----------------------------------------------------------------------------


@pytest.mark.parametrize("blob", [b"not a zip", b"PK\x05\x06" + bytes(18)])
def test_exported_serving_rejects_garbage_with_value_error(blob):
    with pytest.raises(ValueError, match="not a vit_tpu_torch AOT"):
        ExportedServing(blob)


def test_exported_serving_rejects_another_zip():
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as z:
        z.writestr("MAGIC", "vit_tpu_aot_v1")  # vit_tpu's artifact
    with pytest.raises(ValueError, match="not a vit_tpu_torch AOT"):
        ExportedServing(out.getvalue())


# -- (g) grad: the entries keep the twins under autograd ------------------------------


def test_entries_call_the_operators_only_while_traced():
    """An eager forward reaches no operator: the twins run outside the
    dispatcher. Traced without grad, the tiny ViT routes one operator per
    launch; under grad none (autograd runs through the twins) and every
    parameter gets a gradient; under force_backend none."""
    model, size = _family("vit")
    init_parameters(model, torch.Generator().manual_seed(0))
    x = torch.randn(2, size, size, 3).bfloat16()
    dispatched, routed = _DispatchedPortOps(), _RoutedPortOps()
    with dispatched, routed, torch.no_grad():
        model(x)
    assert dispatched.counts == {}
    assert routed.counts == {"attention_block": 2, "fused_mlp": 2}
    routed = _RoutedPortOps()
    with routed:
        model(x).float().sum().backward()
        with ops.force_backend("torch"), torch.no_grad():
            model(x)
    assert routed.counts == {}
    assert all(p.grad is not None for p in model.parameters())


# -- the fakes -----------------------------------------------------------------------


def _op_cases(dev):
    """``{operator: (overload, args)}`` at small shapes each kernel takes,
    kernel 4 also on the strided per-head views of fused qkv rows."""
    gen = torch.Generator().manual_seed(0)
    r = lambda *s, dtype=torch.bfloat16: (torch.randn(*s, generator=gen) * 0.5).to(dev, dtype)
    f32 = lambda *s: r(*s, dtype=torch.float32)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=gen, dtype=torch.int8).to(dev)
    b, n, dim, heads, d = 2, 17, 128, 2, 64
    hd = heads * d
    block = (r(b, n, dim), f32(dim), f32(dim), r(dim, 3 * hd), r(hd, dim), f32(dim))
    qkv = r(b, n, 3 * hd)
    q, k, v = qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    t = torch.ops.vit_tpu_torch
    return {
        "attention_block": (t.attention_block.default, (*block, heads, d**-0.5, 1e-6, None,
                                                         None)),
        "fused_mlp": (t.fused_mlp.default, (r(b, n, dim), r(dim, 256), f32(256), r(256, dim),
                                            f32(dim), f32(dim), f32(dim), "gelu", True, 1e-6)),
        "qkv_attention": (t.qkv_attention.default, (qkv, heads, None, d**-0.5)),
        "quant_attention_block": (t.quant_attention_block.default, (
            r(b, n, dim), f32(dim), f32(dim), i8(3 * hd, dim), f32(3 * hd).abs() * 1e-3,
            i8(dim, hd), f32(dim).abs() * 1e-3, f32(dim), heads, d**-0.5, 1e-6, None)),
        "quant_mlp": (t.quant_mlp.default, (
            r(b, n, dim), f32(dim), f32(dim), i8(256, dim), f32(256).abs() * 1e-3, f32(256),
            i8(dim, 256), f32(dim).abs() * 1e-3, f32(dim), "gelu", 1e-6)),
        "talking_heads_block": (t.talking_heads_block.default, (
            *block, f32(heads, heads), f32(heads, heads), heads, d**-0.5, 1e-5, False)),
        "reattention_block": (t.reattention_block.default, (
            *block, f32(heads, heads), f32(heads), f32(heads), heads, d**-0.5, 1e-6, 1e-6)),
        "flash_attention": (t.flash_attention.default, (
            r(b, heads, n, d), r(b, heads, 33, d), r(b, heads, 33, d), f32(1, heads, n, 33),
            d**-0.5, False)),
        "flash_attention strided views": (t.flash_attention.default, (q, k, v, None, d**-0.5,
                                                                      True)),
        "flash_attention_kv_blocked": (t.flash_attention_kv_blocked.default, (
            r(b, 1, n, 40), r(b, 1, n, 40), r(b, 1, n, 40), None, 40**-0.5, False)),
        "window_attention_block": (t.window_attention_block.default, (
            r(8, 16, 64), f32(64), f32(64), r(64, 192), r(64, 64), f32(64), 2, f32(2, 16, 16),
            32**-0.5, 1e-5)),
        "gemm_sm90": (t.gemm_sm90.default, (r(34, 64), r(64, 128), f32(128), None,
                                            torch.bfloat16, None)),
        "mm_rounded": (t.mm_rounded.default, (r(3, 5, 64), r(64, 32), torch.bfloat16)),
    }


def _fake_matches_real(op, args):
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert (fake.shape, fake.dtype, fake.stride(), fake.device) == (
        real.shape, real.dtype, real.stride(), real.device)


@pytest.mark.parametrize("case", list(_op_cases("cpu")))
def test_each_operators_fake_matches_its_cpu_implementation(case):
    op, args = _op_cases("cpu")[case]
    _fake_matches_real(op, args)


def test_every_launch_site_is_an_operator():
    assert {c.split()[0] for c in _op_cases("cpu")} == set(PORT_OPS)
    assert set(KERNEL_OPS) == set(ops.launch_counts())


def test_a_wrong_fake_fails_the_export():
    """Planted fault: a fake of kernel 2 one column too wide; the exported
    graph's shapes then contradict the next LayerNorm's, and the export
    raises."""
    model, size = _family("vit")
    x = torch.randn(2, size, size, 3).bfloat16()
    lib = torch.library.Library("vit_tpu_torch", "FRAGMENT")
    try:
        torch.library.register_fake(
            "vit_tpu_torch::fused_mlp",
            lambda x, *a: x.new_empty(*x.shape[:-1], x.shape[-1] + 1), lib=lib)
        with pytest.raises(Exception, match="size|shape"):
            export_forward(model.eval(), x)
    finally:
        lib._destroy()
    export_forward(model, x)  # the port's fake again


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_op_cases("cpu")))
def test_each_operators_fake_matches_the_kernel(cuda, case):
    """On the card: each operator's fake gives the kernel's output shape,
    dtype and strides (kernels 4 and 5 write ``[B, Nq, H, Dv]`` and return
    its ``[B, H, Nq, Dv]`` view)."""
    op, args = _op_cases(cuda)[case]
    with torch.inference_mode():
        _fake_matches_real(op, args)
