"""The fp32 routes of kernels 1, 3, 4, 5 and 6 (``vit_tpu``'s default precision):
their twins against vit_tpu's interpret-mode kernels at ``Precision.HIGHEST``,
the route choice and the fp32 core's fit rule, the fp32 presets' dispatch on
the CPU, and the routes against their twins on the card.

With fp32 operands (kernels 3, 4) or fp32 weights on an fp32 stream (the
blocks 1, 6) each kernel runs on the fp32 core ``csrc/attention_f32.cuh``
(the blocks' products on ``csrc/gemm_f32.cuh``). JAX is imported inside the
tests that use it: the machine with the card has no JAX, and runs this
file's ``cuda`` tests with
``python -m pytest --noconftest -m cuda tests/test_torch_fp32_routes.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import (
    DOMAIN_F32_TOL, FAMILY_LAUNCHES, f32_batch_slice, f32_route_change, f32_route_fault,
    f32_route_inputs, f32_route_kernel, function_twin,
)
from vit_tpu_torch import ops
from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops import block_attention as tba

tfa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
tqa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
twa = importlib.import_module("vit_tpu_torch.ops.window_attention")

torch.set_num_threads(2)

# fp32 twin against vit_tpu's interpret-mode kernel: fp32 products on both
# sides, summed in other orders (~1e-7 relative an op); measured up to 6.5e-7
# of max |out| for these twins (tests/test_torch_flash_window.py): 2e-5 of
# max |out|. A bf16 rounding of the qkv operands moves the output by ~1e-3
# of it, a dropped bias or mask_self diagonal by ~1e-1.
TOL = 2e-5

# (kernel, shape, the faults planted in the twin): kernel 3 with a bias over
# every batch and head; kernel 4 with Nq != Nk, Dv != D, a head bias and
# mask_self; kernel 6 with the shared [1, S, S] bias (its per-head bias in
# fp32 is tests/test_torch_flash_window.py's WINDOW_CASES).
TWIN_CASES = {
    "qkv_attention": (dict(b=2, n=19, heads=4, d=16, bias=(2, 4)),
                      ("qkv rounded to bf16", "bias dropped")),
    "flash_attention": (dict(b=2, h=3, nq=33, nk=49, d=32, dv=16, bias=(1, 3), mask_self=True),
                        ("q, k and v rounded to bf16", "bias dropped", "mask_self dropped")),
    "window_attention_block": (dict(nw=3, s=49, c=32, heads=2, d=16, bias=(1,)),
                               ("qkv weights rounded to bf16", "bias dropped")),
}


def _inputs(kind, shape, seed, device="cpu"):
    """chip_smoke's fp32 inputs of ``kind`` at ``shape`` (f32_route_inputs),
    drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return f32_route_inputs(
        lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device),
        kind, shape)


def _interpret(kind, args, kw):
    """vit_tpu's Pallas kernel of ``kind`` in interpret mode on ``args``."""
    import jax.numpy as jnp

    j = [None if t is None else jnp.asarray(t.numpy()) for t in args]
    if kind == "qkv_attention":
        jqa = importlib.import_module("vit_tpu.ops.qkv_attention")
        out = jqa.fused_qkv_attention(j[0], kw["heads"], j[1], scale=kw["scale"], interpret=True)
    elif kind == "flash_attention":
        jfa = importlib.import_module("vit_tpu.ops.flash_attention")
        out = jfa.flash_attention(*j, scale=kw["scale"], mask_self=kw["mask_self"],
                                  interpret=True)
    else:
        jwa = importlib.import_module("vit_tpu.ops.window_attention")
        out = jwa.fused_window_attention_block(*j[:6], kw["heads"], j[6], scale=kw["scale"],
                                               ln_eps=kw["ln_eps"], interpret=True)
    return np.asarray(out, np.float32)


# -- the twins against vit_tpu ---------------------------------------------------


@pytest.mark.parametrize("kind", list(TWIN_CASES))
def test_fp32_twins_match_interpret_mode(kind):
    """Each twin in fp32 against vit_tpu's kernel in interpret mode (which
    runs fp32 at Precision.HIGHEST) within TOL of max |out|; each planted
    fault (chip_smoke.f32_route_fault, the faults phase 28 plants on the
    card) is far past it."""
    shape, faults = TWIN_CASES[kind]
    args, kw = _inputs(kind, shape, seed=len(kind))
    with torch.inference_mode():
        out = function_twin(kind, kw)(*args)
    ref = _interpret(kind, args, kw)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    tol = TOL * float(np.abs(ref).max())
    err = float(np.abs(out.numpy() - ref).max())
    assert err <= tol, (err, tol)
    for fault in faults:
        with torch.inference_mode():
            bad = f32_route_fault(fault, kind, args, kw).numpy()
        assert float(np.abs(bad - ref).max()) > 10 * tol, fault


# -- the route choice --------------------------------------------------------------


def test_fp32_routes_are_counted():
    assert _build.FP32_ROUTES == ("attention_block", "fused_mlp", "qkv_attention",
                                  "talking_heads_block", "reattention_block", "flash_attention",
                                  "window_attention_block", "flash_attention_kv_blocked",
                                  "quant_attention_block", "quant_mlp")
    assert set(ops.fp32_launch_counts()) == set(_build.FP32_ROUTES)
    assert set(_build.FP32_ROUTES) <= set(_build.KERNELS)


def test_weights_route_picks_the_blocks_route():
    """Kernels 1 and 6 route as kernels 2, 7 and 8: bf16 weights the bf16
    route, fp32 weights on an fp32 stream the fp32 route, fp32 weights on a
    bf16 stream and mixed weights a TypeError."""
    x32, x16 = torch.zeros(1, 2, 8), torch.zeros(1, 2, 8, dtype=torch.bfloat16)
    w32, w16 = torch.zeros(8, 24), torch.zeros(8, 24, dtype=torch.bfloat16)
    assert tba.weights_route(x32, w32, w32) == "fp32"
    assert tba.weights_route(x32, w16, w16) == tba.weights_route(x16, w16, w16) == "bf16"
    for x, a, b in ((x16, w32, w32), (x32, w32, w16)):
        with pytest.raises(TypeError):
            tba.weights_route(x, a, b)


@pytest.mark.parametrize("shape,plan", [
    ((49, 64, 8, 64), twa.WindowPlan("fp32", 0, 34816)),     # Twins' LSA stage 1
    ((49, 64, 2, 32), twa.WindowPlan("fp32", 0, 22528)),     # CrossFormer's stage-0 SDA
    ((1, 512, 16, 32), twa.WindowPlan("fp32", 0, 22528)),    # CrossFormer's 1-token LDA
    ((100, 96, 3, 32), twa.WindowPlan("fp32", 0, 30720)),    # past the fused kernel's 64
])
def test_window_plan_has_the_fp32_route(shape, plan):
    assert twa.plan_for(*shape, fp32=True) == plan
    assert twa.plan_for(*shape).route != "fp32"


@pytest.mark.parametrize("nk,d,dv,nbytes", [
    (197, 64, 64, 59392), (1088, 64, 64, 165888), (962, 64, 64, 157696),
    (1024, 128, 128, 182272), (1, 32, 32, 22528), (784, 64, 64, 133120), (196, 32, 64, 55296),
])
def test_f32_core_bytes_is_pinned(nk, d, dv, nbytes):
    assert tfa.f32_core_bytes(nk, d, dv) == nbytes


def test_f32_core_fits_every_kernels_domain():
    """Wherever kernel 4 takes a shape (core_fits: D, Dv multiples of 16 up
    to 128, its longest key rows), kernel 3 (qkv_kernel_fits) or the fused
    blocks (1,024 tokens), a block of the fp32 core fits 227 KB: the fp32
    routes take every shape their bf16 routes take."""
    for d in range(16, 129, 16):
        for dv in range(16, 129, 16):
            lo, hi = 1, 8192  # the longest key row kernel 4 takes, by bisection
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lo, hi = (mid, hi) if tfa.core_fits(mid, d, dv) else (lo, mid)
            assert tfa.f32_core_bytes(lo, d, dv) <= tfa.MAX_SMEM
        assert tqa.qkv_kernel_fits(tba.MAX_TOKENS, d)
        assert tfa.f32_core_bytes(tba.MAX_TOKENS, d, d) <= tfa.MAX_SMEM
    assert tfa.f32_core_bytes(2048, 128, 128) > tfa.MAX_SMEM  # the rule can refuse


# -- the fp32 presets dispatch as the card would -----------------------------------

TWINS = {"xla_attention_block": "attention_block", "reference_mlp": "fused_mlp",
         "xla_qkv_attention": "qkv_attention", "reference_attention": "flash_attention",
         "reference_attention_kv_blocked": "flash_attention_kv_blocked",
         "xla_window_attention_block": "window_attention_block",
         "xla_talking_heads_block": "talking_heads_block",
         "xla_reattention_block": "reattention_block"}
VIT_L_DEPTH = 2  # ViT-L/16's widths at depth 2: its 24 layers launch alike


def _fp32_model(fam):
    import chip_smoke as cs
    from vit_tpu_torch.models import CvT, NesT, ScalableViT, T2TViT, TwinsSVT, ViT

    ctor, cfg = {"vit_l": (ViT, dict(cs.VIT_L, depth=VIT_L_DEPTH)), "nest": (NesT, cs.NEST),
                 "twins": (TwinsSVT, cs.TWINS), "cvt": (CvT, cs.CVT), "t2t": (T2TViT, cs.T2T),
                 "scalable_vit": (ScalableViT, cs.SCALABLE_VIT)}[fam]
    return ctor(**cfg, device="cpu").eval(), cs.IMAGE_SIZE[fam]


@pytest.mark.parametrize("fam", ["vit_l", "nest", "twins", "cvt", "t2t", "scalable_vit"])
def test_fp32_presets_route_as_the_card_would(fam, monkeypatch):
    """An fp32 model (``dtype=None``: vit_tpu's default) at batch 1 on the
    CPU calls each kernel's twin as often as chip_smoke's FAMILY_LAUNCHES
    wants the kernel launched a forward on the card (ViT-L's at depth 2:
    its per-layer share), every operand fp32: no layer rounds to bf16 on
    the way to a kernel, so on the card every launch takes an fp32 route."""
    calls, dtypes = {}, set()

    def counted(kernel, fn):
        def call(*a, **k):
            calls[kernel] = calls.get(kernel, 0) + 1
            dtypes.update(t.dtype for t in (*a, *k.values()) if isinstance(t, torch.Tensor))
            return fn(*a, **k)
        return call

    for name, kernel in TWINS.items():
        monkeypatch.setattr(ops, name, counted(kernel, getattr(ops, name)))
    model, size = _fp32_model(fam)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, size, size, 3),
                                                                  dtype=np.float32))
    with torch.inference_mode():
        out = model(x)
    assert out.dtype == torch.float32 and out.shape == (1, 1000)
    scale = VIT_L_DEPTH / 24 if fam == "vit_l" else 1
    assert calls == {k: int(n * scale) for k, n in FAMILY_LAUNCHES[fam].items() if n}
    assert dtypes == {torch.float32}


def test_fp32_quant_vit_routes_as_the_card_would(monkeypatch):
    """QuantViT of an fp32 ViT (``dtype`` None) at batch 8 on the CPU calls
    the twins of kernels 9 and 10 once a layer each, every operand fp32 or
    int8 codes: on the card both take their fp32 streams."""
    import chip_smoke as cs
    from vit_tpu_torch.models import ViT
    from vit_tpu_torch.utils import quantize_vit

    calls, dtypes = {}, set()
    for name in ("xla_quant_attention_block", "reference_quant_mlp"):
        real = getattr(ops, name)

        def call(*a, _n=name, _f=real, **k):
            calls[_n] = calls.get(_n, 0) + 1
            dtypes.update(t.dtype for t in (*a, *k.values()) if isinstance(t, torch.Tensor))
            return _f(*a, **k)

        monkeypatch.setattr(ops, name, call)
    qm = quantize_vit(ViT(**dict(cs.VIT_L, depth=VIT_L_DEPTH, image_size=32), device="cpu").eval())
    assert qm.dtype is None
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 32, 32, 3),
                                                                  dtype=np.float32))
    with torch.inference_mode():
        out = qm(x)
    assert out.dtype == torch.float32 and out.shape == (8, 1000)
    assert calls == {"xla_quant_attention_block": VIT_L_DEPTH, "reference_quant_mlp": VIT_L_DEPTH}
    assert dtypes == {torch.float32, torch.int8}


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (kernel, shape): small shapes of each route, with its options.
CARD_CASES = [
    ("attention_block", dict(b=3, n=197, dim=256, heads=4, d=64)),
    ("attention_block", dict(b=2, n=208, dim=128, heads=2, d=64, true_n=197)),
    ("attention_block", dict(b=2, n=962, dim=64, heads=2, d=32)),
    ("qkv_attention", dict(b=6, n=196, heads=3, d=32)),
    ("qkv_attention", dict(b=6, n=50, heads=4, d=32, bias=(1, 4))),
    ("qkv_attention", dict(b=6, n=64, heads=2, d=64, bias=(6, 2))),
    ("flash_attention", dict(b=6, h=1, nq=300, nk=784, d=64, dv=64)),
    ("flash_attention", dict(b=6, h=4, nq=196, nk=196, d=32, dv=64, bias=(1, 4))),
    ("flash_attention", dict(b=6, h=2, nq=197, nk=197, d=64, dv=64, mask_self=True)),
    ("flash_attention", dict(b=6, h=2, nq=33, nk=1088, d=64, dv=64, bias=(6, 1))),
    ("window_attention_block", dict(nw=20, s=49, c=64, heads=8, d=64)),
    ("window_attention_block", dict(nw=20, s=49, c=64, heads=2, d=32, bias=(2,))),
    ("window_attention_block", dict(nw=20, s=1, c=128, heads=4, d=32, bias=(1,))),
    ("window_attention_block", dict(nw=20, s=100, c=96, heads=3, d=32)),
]


def _card_id(case):
    kind, shape = case
    return kind + "-" + "-".join(f"{k}{v}" for k, v in shape.items())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=_card_id)
def test_fp32_route_matches_its_twin(cuda, case):
    """The fp32 route: one launch counted on it, fp32 out, within
    DOMAIN_F32_TOL (1e-4) of the largest change the op makes against the
    fp32 twin on the card (cuBLAS fp32 products, TF32 off)."""
    kind, shape = case
    args, kw = _inputs(kind, shape, seed=11, device=cuda)
    before, before32 = ops.launch_counts()[kind], ops.fp32_launch_counts()[kind]
    with torch.inference_mode():
        out = f32_route_kernel(kind, kw)(*args)
        torch.cuda.synchronize()
        ref = function_twin(kind, kw)(*args)
    assert ops.launch_counts()[kind] == before + 1
    assert ops.fp32_launch_counts()[kind] == before32 + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    rows, delta = f32_route_change(kind, args, ref, kw)
    assert (out[rows] - ref[rows]).abs().max().item() <= DOMAIN_F32_TOL * delta


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES[::3], ids=_card_id)
def test_fp32_route_is_batch_invariant(cuda, case):
    kind, shape = case
    args, kw = _inputs(kind, shape, seed=12, device=cuda)
    part = slice(1, 3)
    with torch.inference_mode():
        full = f32_route_kernel(kind, kw)(*args)
        alone = f32_route_kernel(kind, kw)(*f32_batch_slice(kind, args, part))
    torch.testing.assert_close(alone, full[part], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nk,d,dv", [(1, 32, 32), (49, 64, 64), (197, 64, 64), (784, 64, 64),
                                     (196, 32, 64), (1088, 64, 64), (1024, 128, 128)])
def test_f32_core_plan_mirrors_the_kernel(cuda, nk, d, dv):
    import ctypes

    got = (ctypes.c_int * 3)()
    _build.load_library().vt_attention_f32_plan(nk, d, dv, got)
    assert list(got) == [32, 256, tfa.f32_core_bytes(nk, d, dv)]
    if d == dv:
        assert twa.plan_for(nk, 64, 2, d, fp32=True).smem_bytes == got[2]


@pytest.mark.cuda
def test_kv_blocked_kernel_takes_fp32(cuda):
    """ops.attention at a shape kernel 4 does not take (SSA's D 40 / Dv 32)
    runs kernel 5's fp32 route: one launch counted there, fp32 out, within
    DOMAIN_F32_TOL of its twin's largest output at the kernel's chunk."""
    args, kw = _inputs("flash_attention", dict(b=1, h=2, nq=64, nk=64, d=40, dv=32), 13, cuda)
    before = ops.fp32_launch_counts()["flash_attention_kv_blocked"]
    out = ops.attention(*args[:3])
    assert ops.fp32_launch_counts()["flash_attention_kv_blocked"] == before + 1
    ref = tfa.reference_attention_kv_blocked(*args[:3], block_k=tfa.KV_CHUNK)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= DOMAIN_F32_TOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["attention_block", "qkv_attention", "flash_attention",
                                  "window_attention_block", "flash_attention_kv_blocked"])
def test_fp32_functions_forward_on_the_route(cuda, kind):
    """Each Function under grad: its forward on the fp32 route (one fp32
    launch), its gradients those of autograd through the twin within the
    recompute's bound (chip_smoke.check_function: 2% of each gradient's
    largest value; the backward recomputes the twin, so the forward's
    last bits are all that differ)."""
    from chip_smoke import check_function

    shape = {"attention_block": dict(b=2, n=65, dim=128, heads=2, d=64),
             "qkv_attention": dict(b=2, n=50, heads=4, d=32, bias=(1, 4)),
             "flash_attention": dict(b=2, h=4, nq=49, nk=196, d=32, dv=64, bias=(1, 4)),
             "window_attention_block": dict(nw=8, s=49, c=64, heads=2, d=32, bias=(2,)),
             "flash_attention_kv_blocked": dict(b=2, h=2, nq=100, nk=200, d=40, dv=32,
                                                bias=(1, 2))}[kind]
    args, kw = _inputs(kind, shape, seed=14, device=cuda)
    with torch.no_grad():
        out = f32_route_kernel(kind, kw)(*args)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(15),
                    device=cuda)
    ops.reset_launch_counts()
    check_function(f"fp32 {shape}", kind, args, kw, g)
    assert ops.fp32_launch_counts()[kind] >= 1
