"""Kernels 7 and 8 over vit_tpu's whole fused domain (n <= 1,024, heads <=
16, dim_head a multiple of 16 up to 128), with bf16 or fp32 weights, and
kernel 2's fp32 route.

On the CPU: the head-mix core's plans (bf16 route and fp32 route) pinned at
the new shapes and within shared memory over the domain; the plain twins
past 256 tokens and at fp32 weights against vit_tpu's Pallas kernels in
interpret mode (kernel 2's twin at fp32 weights too); chip_smoke's three
configurations (CaiT-S24/384, CaiT-M48/448, DeepViT at 384 px) against
``jax.eval_shape`` of vit_tpu's ``init``; what still raises. On the card
(``cuda``): kernels 7 and 8 at 577 and 784 tokens, the fp32 routes of
kernels 7, 8 and 2 and the fp32 GEMM against their twins, the C plans, the
Functions' gradients at 576 tokens and in fp32. JAX is imported inside the
CPU tests only: the machine with the card runs this file's ``cuda`` tests
with ``python -m pytest --noconftest -m cuda tests/test_torch_head_mix_domain.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from vit_tpu_torch import ops

trb = importlib.import_module("vit_tpu_torch.ops.reattention_block")
tfm = importlib.import_module("vit_tpu_torch.ops.fused_mlp")

torch.set_num_threads(2)

TH_ARGS = ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout", "mix_pre", "mix_post")
RA_ARGS = ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout", "mix", "rln_scale", "rln_bias")

# (n, heads, dim_head) -> the head-mix core's plan: the bf16 route's
# (hmix::plan_for) and the fp32 route's (hmix::plan_f32), at CaiT-S24/384
# (576 tokens, 8 heads of 48: 36 key tiles), CaiT-M48/448 (784, 16 of 48:
# 49 tiles), DeepViT at 384 px (577, 16 of 64: 37 tiles) and the domain's
# corner (1,024 tokens, 16 heads of 128).
NEW_PLANS = [
    ((576, 8, 48), ("streamed", 22, 3, 225408), ("streamed", 4, 0, 34944)),
    ((784, 16, 48), ("streamed", 8, 3, 219264), ("streamed", 4, 0, 67712)),
    ((577, 16, 64), ("streamed", 7, 3, 227456), ("streamed", 4, 0, 67712)),
    ((1024, 16, 128), ("streamed", 5, 2, 223360), ("streamed", 4, 0, 67712)),
]


@pytest.mark.parametrize("shape,plan,plan_f32", NEW_PLANS)
def test_head_mix_plan_is_pinned_past_256_tokens(shape, plan, plan_f32):
    assert tuple(trb.head_mix_plan(*shape)) == plan
    assert tuple(trb.head_mix_plan(*shape, fp32=True)) == plan_f32


def test_head_mix_plans_cover_the_whole_domain():
    """Every shape of the domain has a plan on both routes within 227 KB:
    the streamed variant at least a one-tile slab and a 2-stage ring, the
    fp32 core a slab of up to four tiles and no ring."""
    for n in (1, 16, 17, 255, 256, 257, 272, 400, 576, 577, 784, 1000, 1024):
        for heads in (1, 3, 8, 16):
            for d in (16, 48, 64, 128):
                p = trb.head_mix_plan(n, heads, d)
                assert p.slab_tiles >= 1 and 2 <= p.stages <= 4, (n, heads, d, p)
                assert p.smem_bytes <= 232448, (n, heads, d, p)
                f = trb.head_mix_plan(n, heads, d, fp32=True)
                assert f.variant == "streamed" and f.stages == 0, (n, heads, d, f)
                assert f.slab_tiles == min(-(-n // 16), 4) and f.smem_bytes <= 232448


def test_what_stays_out_raises():
    """H > 16 and dim_head > 128 need another mapping (one warp a head);
    vit_tpu fuses nothing past 1,024 tokens: NotImplementedError naming
    ROADMAP.md. fp32 weights on a bf16 stream, or weights of two dtypes,
    are no vit_tpu configuration: TypeError."""
    trb.check_domain("talking_heads_block", 1024, 16, 128)
    for n, heads, d in ((64, 17, 16), (64, 4, 144), (1025, 4, 16), (64, 4, 40)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            trb.check_domain("talking_heads_block", n, heads, d)
    x16, w32, w16 = torch.zeros(1, 2), torch.zeros(2, 2), torch.zeros(2, 2, dtype=torch.bfloat16)
    assert trb.weights_route(x16.float(), w32, w32) == "fp32"
    assert trb.weights_route(x16.bfloat16(), w16, w16) == "bf16"
    assert trb.weights_route(x16.float(), w16, w16) == "bf16"
    with pytest.raises(TypeError, match="fp32 stream"):
        trb.weights_route(x16.bfloat16(), w32, w32)
    with pytest.raises(TypeError, match="all be bf16 or all fp32"):
        trb.weights_route(x16.float(), w32, w16)


def _inputs(seed, b, n, dim, heads, d, kind):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s)
    hd = heads * d
    inp = dict(x=r(b, n, dim), ln_scale=1.0 + 0.1 * r(dim), ln_bias=0.1 * r(dim),
               wqkv=r(dim, 3 * hd) / np.sqrt(dim), wout=r(hd, dim) / np.sqrt(hd),
               bout=0.1 * r(dim))
    if kind == "th":
        inp.update(mix_pre=0.3 * r(heads, heads), mix_post=0.3 * r(heads, heads))
    else:
        inp.update(mix=0.3 * r(heads, heads), rln_scale=1.0 + 0.1 * r(heads),
                   rln_bias=0.1 * r(heads))
    return inp


def _cast(inp, dtype, conv):
    return {k: conv(np.asarray(v, np.float32), dtype if k in ("x", "wqkv", "wout") else "float32")
            for k, v in inp.items()}


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jnp(a, dtype):
    import jax.numpy as jnp

    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# Max |out - ref| over max |ref| against the interpret-mode kernels, as
# tests/test_torch_reattention.py states them: fp32 2e-5 (every side sums fp32
# products in its own order), bf16 2^-7 (the twin rounds where the kernel
# does; a sum order may put one rounding on the neighbouring value). Measured
# here at most 3.2e-7 (fp32) and 1.8e-3 (bf16).
TOL = {"float32": 2e-5, "bfloat16": 2.0**-7}


# (kind, n, weights' dtype): past 256 tokens and not multiples of 16 (272 =
# 17 key tiles, 400 = 25), on the bf16 route and on the fp32 route (fp32 x
# and weights: vit_tpu's kernels at Precision.HIGHEST)
TWIN_CASES = [("th", 272, "bfloat16"), ("ra", 400, "bfloat16"), ("th", 400, "float32"),
              ("ra", 272, "float32")]


@pytest.mark.parametrize("kind,n,dtype", TWIN_CASES)
def test_twins_past_256_tokens_match_the_interpret_mode_kernels(kind, n, dtype):
    jrb = importlib.import_module("vit_tpu.ops.reattention_block")

    names = TH_ARGS if kind == "th" else RA_ARGS
    inp = _inputs(n, 1, n, 64, 4, 16, kind)
    t = [_cast(inp, dtype, _torch)[k] for k in names]
    j = [_cast(inp, dtype, _jnp)[k] for k in names]
    if kind == "th":
        out = trb.xla_talking_heads_block(*t, 4, 0.25, residual=True)
        ref = jrb.fused_talking_heads_block(*j, 4, residual=True, interpret=True)
    else:
        out = trb.xla_reattention_block(*t, 4, 0.25)
        ref = jrb.fused_reattention_block(*j, 4, interpret=True)
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    assert _rel(out.float(), ref.astype("float32")) <= TOL[dtype], _rel(out.float(), ref)


@pytest.mark.parametrize("activation", ["gelu", "hard_swish"])
def test_mlp_twin_at_fp32_weights_matches_the_interpret_mode_kernel(activation):
    """Kernel 2's twin with fp32 x and weights (its fp32 route's
    arithmetic) against vit_tpu's fused_mlp in interpret mode (fp32 weights
    at Precision.HIGHEST): within 2e-5 of the largest change it makes
    (measured at most 5.5e-7); with the residual and the LayerNorm, and at
    T2T's width 147 without a LN."""
    jfm = importlib.import_module("vit_tpu.ops.fused_mlp")

    rng = np.random.default_rng(5)
    for t_, dim, f, ln in ((272, 64, 256, True), (50, 147, 147, False)):
        r = lambda *s: rng.standard_normal(s).astype(np.float32)
        inp = dict(x=r(2, t_, dim), w1=r(dim, f) / np.sqrt(dim), b1=0.1 * r(f),
                   w2=r(f, dim) / np.sqrt(f), b2=0.1 * r(dim))
        if ln:
            inp.update(ln_scale=1.0 + 0.1 * r(dim), ln_bias=0.1 * r(dim))
        out = tfm.reference_mlp(**{k: torch.from_numpy(v) for k, v in inp.items()},
                                activation=activation)
        ref = jfm.fused_mlp(**{k: _jnp(v, "float32") for k, v in inp.items()},
                            activation=activation, interpret=True)
        assert out.dtype == torch.float32
        assert _rel(out.numpy() - inp["x"], np.asarray(ref) - inp["x"]) <= 2e-5


class _ShapesOnly(cs._Init):
    """chip_smoke's initializers drawing zero-stride arrays: a tree in shapes."""

    def _zeros(self, *shape):
        return np.broadcast_to(np.float32(0), shape)

    lecun = tokens = normal = _zeros


@pytest.mark.parametrize("name", ["CAIT_S24_384", "CAIT_M48_448", "DEEPVIT_384"])
def test_config_trees_have_the_shapes_of_init(name, monkeypatch):
    import jax
    import jax.numpy as jnp
    from vit_tpu import models as jm

    cfg = getattr(cs, name)
    monkeypatch.setattr(cs, "_Init", _ShapesOnly)
    if name.startswith("CAIT"):
        tree, model = cs.cait_tree(cfg, 0), jm.CaiT(**cfg)
    else:
        tree, model = cs.vit_tree(cfg, 0, reattention=True), jm.DeepViT(**cfg)
    size = cfg["image_size"]
    want = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    shapes = lambda t: {jax.tree_util.keystr(k): tuple(np.shape(v))
                        for k, v in jax.tree_util.tree_leaves_with_path(t)}
    assert shapes(tree) == shapes(want)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card(kind, b, n, dim, heads, d, dtype, dev, seed=0, x_dtype=None):
    inp = _inputs(seed, b, n, dim, heads, d, kind)
    names = TH_ARGS if kind == "th" else RA_ARGS
    t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        dev, (getattr(torch, x_dtype or dtype) if k == "x" else getattr(torch, dtype)
              if k in ("wqkv", "wout") else torch.float32)) for k, v in inp.items()}
    return [t[k] for k in names]


def _run(kind, args, heads, **kw):
    if kind == "th":
        return ops.talking_heads_block(*args, heads, **kw)
    return ops.reattention_block(*args, heads, **kw)


# (kind, n, dim, heads, dim_head, weights' dtype): the three configurations'
# shapes on the bf16 route and on the fp32 route, the domain's corner
CARD_CASES = [
    ("th", 576, 384, 8, 48, "bfloat16"), ("th", 784, 768, 16, 48, "bfloat16"),
    ("ra", 577, 1024, 16, 64, "bfloat16"), ("ra", 1024, 256, 16, 128, "bfloat16"),
    ("th", 576, 384, 8, 48, "float32"), ("ra", 577, 1024, 16, 64, "float32"),
    ("th", 1024, 256, 16, 128, "float32"), ("ra", 50, 64, 3, 16, "float32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,dim,heads,d,dtype", CARD_CASES)
def test_kernel_matches_twin_over_the_domain(cuda, kind, n, dim, heads, d, dtype):
    """bf16 route within chip_smoke's kernel_tol of the twin; the fp32 route
    within 1e-4 of the largest change the block makes (the twin's fp32
    products on cuBLAS with TF32 off; measured about 2e-6)."""
    name = "talking_heads_block" if kind == "th" else "reattention_block"
    args = _card(kind, 2, n, dim, heads, d, dtype, cuda)
    before, before32 = ops.launch_counts()[name], ops.fp32_launch_counts()[name]
    out = _run(kind, args, heads)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    assert ops.fp32_launch_counts()[name] == before32 + (dtype == "float32")
    with ops.force_backend("torch"):
        ref = _run(kind, args, heads)
    base = args[0].float() if kind == "ra" else 0.0
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == "float32":
        assert err <= 1e-4 * (ref.float() - base).abs().max().item(), err
    else:
        assert err <= cs.kernel_tol(ref, args[0] if kind == "ra" else None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape,plan,plan_f32", NEW_PLANS)
def test_head_mix_plans_mirror_the_kernel(cuda, shape, plan, plan_f32):
    import ctypes

    from vit_tpu_torch.ops import _build

    lib = _build.load_library()
    got = (ctypes.c_int * 4)()
    assert lib.vt_head_mix_plan(*shape, ctypes.cast(got, ctypes.c_void_p)) == 0
    assert (trb.HEAD_MIX_VARIANTS[got[0]], got[1], got[2], got[3]) == plan
    assert lib.vt_head_mix_plan_f32(*shape[:2], ctypes.cast(got, ctypes.c_void_p)) == 0
    assert (trb.HEAD_MIX_VARIANTS[got[0]], got[1], got[2], got[3]) == plan_f32


@pytest.mark.cuda
def test_kernels_raise_outside_the_domain(cuda):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run("ra", _card("ra", 1, 17, 17 * 16, 17, 16, "bfloat16", cuda), 17)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run("th", _card("th", 1, 8, 288, 2, 144, "float32", cuda), 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run("th", _card("th", 1, 1025, 64, 4, 16, "bfloat16", cuda), 4)
    with pytest.raises(TypeError, match="fp32 stream"):
        _run("th", _card("th", 1, 8, 64, 4, 16, "float32", cuda, x_dtype="bfloat16"), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,f,ln,activation", [(384, 1536, True, "gelu"), (147, 147, False, "gelu"),
                                                 (1323, 1323, True, "gelu_exact"),
                                                 (256, 512, False, "hard_swish")])
def test_mlp_fp32_route_matches_twin(cuda, dim, f, ln, activation):
    """Kernel 2 with fp32 x and weights (CaiT-S24/384's MLP, T2T's widths,
    LeViT's activation) against its twin: within 1e-4 of the largest change."""
    g = torch.Generator(device=cuda).manual_seed(dim)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    x = r(2, 197, dim)
    args = (x, r(dim, f) / dim**0.5, 0.1 * r(f), r(f, dim) / f**0.5, 0.1 * r(dim),
            1.0 + 0.1 * r(dim) if ln else None, 0.1 * r(dim) if ln else None)
    before = ops.fp32_launch_counts()["fused_mlp"]
    out = tfm.fused_mlp(*args, activation, True, 1e-6)
    ref = tfm.reference_mlp(*args, activation, True, 1e-6)
    torch.cuda.synchronize()
    assert ops.fp32_launch_counts()["fused_mlp"] == before + 1
    assert (out - ref).abs().max().item() <= 1e-4 * (ref - x).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,activation", [(197, 3072, 1024, None), (300, 1323, 147, "gelu"),
                                               (1, 8, 5, "hard_swish")])
def test_gemm_f32_matches_an_fp32_product(cuda, m, n, k, activation):
    from vit_tpu_torch.ops import block_attention as ba

    g = torch.Generator(device=cuda).manual_seed(m)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    a, b, bias, res = r(m, k), r(k, n) / k**0.5, r(n), r(m, n)
    out = ba.gemm_f32(a, b, bias, res, activation)
    ref = ba.reference_gemm(a, b, bias, res, torch.float32, activation)
    slack = 2 * k * 2.0**-24 * (a.abs() @ b.abs()).max().item()
    assert (out - ref).abs().max().item() <= slack + 1e-6 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,heads,d,dtype", [("th", 576, 8, 48, "bfloat16"),
                                                  ("ra", 577, 4, 64, "bfloat16"),
                                                  ("th", 65, 4, 16, "float32"),
                                                  ("ra", 65, 4, 16, "float32")])
def test_functions_fill_every_gradient(cuda, kind, n, heads, d, dtype):
    """TalkingHeadsBlockFn / ReattentionBlockFn at 576-577 tokens and on the
    fp32 route: gradients against autograd through the twin, within 1% of
    the largest (the forward runs the kernel; the backward the same
    recompute)."""
    dim = heads * d
    args = _card(kind, 2, n, dim, heads, d, dtype, cuda, seed=3)
    args = [a.detach().requires_grad_(True) for a in args]
    g = torch.randn_like(args[0])
    ops.reset_launch_counts()
    out = _run(kind, args, heads)
    grads = torch.autograd.grad(out, args, g)
    name = "talking_heads_block" if kind == "th" else "reattention_block"
    assert ops.launch_counts()[name] == 1 and ops.recompute_counts()[name] == 1
    with ops.force_backend("torch"):
        ref = torch.autograd.grad(_run(kind, args, heads), args, g)
    for got, want in zip(grads, ref):
        assert got is not None and torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max() + 1e-6


@pytest.mark.cuda
def test_mlp_function_fills_every_gradient_in_fp32(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    args = [r(2, 576, 384), r(384, 1536) / 20, 0.1 * r(1536), r(1536, 384) / 40, 0.1 * r(384),
            1.0 + 0.1 * r(384), 0.1 * r(384)]
    args = [a.requires_grad_(True) for a in args]
    cot = torch.randn_like(args[0])
    ops.reset_launch_counts()
    grads = torch.autograd.grad(ops.mlp(*args, ln_eps=1e-5), args, cot)
    assert ops.fp32_launch_counts()["fused_mlp"] == 1 and ops.recompute_counts()["fused_mlp"] == 1
    with ops.force_backend("torch"):
        ref = torch.autograd.grad(ops.mlp(*args, ln_eps=1e-5), args, cot)
    for got, want in zip(grads, ref):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
