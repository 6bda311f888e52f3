"""The head-mixing block kernels: the plain PyTorch twins against vit_tpu on
the CPU, and the Hopper kernels against their twins on the card.

CaiT's talking-heads block (``vit_tpu/ops/reattention_block.py:_th_kernel``)
and DeepViT's re-attention block (``:_kernel``). The same numpy inputs go
through the port's twin, JAX's Pallas kernel in interpret mode and JAX's XLA
twin. JAX is imported inside the tests that use it: the machine with the
card has no JAX, and runs this file's ``cuda`` tests with
``python -m pytest --noconftest -m cuda tests/test_torch_reattention.py``.
"""

import contextlib
import importlib
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import kernel_tol
from vit_tpu_torch import ops

# ops/__init__ exports functions of the modules' own names
trb = importlib.import_module("vit_tpu_torch.ops.reattention_block")

torch.set_num_threads(2)

DIM, D = 48, 16

# Tolerances on max |out - ref|, as a share of max |ref| (|out| ~ 1-3).
# fp32: every side sums fp32 products in its own order (~1e-7 relative per
#   op; the head LayerNorm of re-attention divides by the deviation across
#   heads, a few times smaller than the values). Measured up to 4.6e-7 on
#   these cases against both JAX functions: 2e-5.
# bf16 against the interpret-mode kernel: the twin rounds where the kernel
#   does (qkv, P, each head's P V, the output); the sums' order can put a
#   rounding on the neighbouring bf16 value, which moves the output by about
#   one bf16 ulp of its magnitude: 2^-7 allows two such steps. Measured 0 to
#   2.5e-3.
# bf16 against JAX's XLA twin: that twin rounds the same sites but takes the
#   head LayerNorm's mean with jnp.mean, not as sum * (1/H), and sums its
#   head mixes as XLA dots: measured 0 to 2.5e-3, within the same 2^-7.
TOL = {"float32": 2e-5, "bfloat16": 2.0**-7}

# (dtype, n, heads, residual): n = 65 is padded inside the JAX kernel (to 72
# in fp32, 80 in bf16) and masked; heads 3 makes 1/H inexact.
TH_CASES = [
    ("float32", 50, 3, False), ("float32", 64, 4, True), ("float32", 65, 3, False),
    ("float32", 65, 4, True), ("bfloat16", 50, 4, True), ("bfloat16", 64, 3, False),
    ("bfloat16", 65, 4, False), ("bfloat16", 65, 3, True),
]
RA_CASES = [
    ("float32", 50, 3), ("float32", 64, 4), ("float32", 65, 3), ("float32", 65, 4),
    ("bfloat16", 50, 4), ("bfloat16", 64, 3), ("bfloat16", 65, 3), ("bfloat16", 65, 4),
]


def _inputs(seed, b, n, dim, heads, d, kind):
    """The TestTalkingHeadsBlock / TestReattentionBlock scales of
    tests/test_ops.py, drawn with numpy; the re-attention LN bias nonzero."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s)
    hd = heads * d
    inp = dict(x=r(b, n, dim), ln_scale=1.0 + 0.1 * r(dim), ln_bias=0.1 * r(dim),
               wqkv=0.1 * r(dim, 3 * hd), wout=0.1 * r(hd, dim), bout=0.1 * r(dim))
    if kind == "th":
        inp.update(mix_pre=0.3 * r(heads, heads), mix_post=0.3 * r(heads, heads))
    else:
        inp.update(mix=0.3 * r(heads, heads), rln_scale=1.0 + 0.1 * r(heads),
                   rln_bias=0.1 * r(heads))
    return inp


def _cast(inp, dtype, conv):
    """x and the two GEMM weights in ``dtype``, everything else fp32."""
    return {k: conv(v, dtype if k in ("x", "wqkv", "wout") else "float32") for k, v in inp.items()}


def _torch(a, dtype="float32", device="cpu"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=getattr(torch, dtype))


def _jnp(a, dtype="float32"):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dtype))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


TH_ARGS = ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout", "mix_pre", "mix_post")
RA_ARGS = ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout", "mix", "rln_scale", "rln_bias")


def _check(out, ref, dtype, what):
    err = float(np.abs(_np(out) - _np(ref)).max())
    tol = TOL[dtype] * float(np.abs(_np(ref)).max())
    assert err <= tol, f"{what}: {err} > {tol}"
    return err, tol


@pytest.mark.parametrize("dtype,n,heads,residual", TH_CASES)
def test_talking_heads_twin_matches_jax(dtype, n, heads, residual):
    jrb = importlib.import_module("vit_tpu.ops.reattention_block")

    inp = _inputs(n + heads, 2, n, DIM, heads, D, "th")
    t = [_cast(inp, dtype, _torch)[k] for k in TH_ARGS]
    j = [_cast(inp, dtype, _jnp)[k] for k in TH_ARGS]
    out = trb.xla_talking_heads_block(*t, heads, D**-0.5, residual=residual)
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    _check(out, jrb.xla_talking_heads_block(*j, heads, D**-0.5, residual=residual), dtype, "xla")
    pallas = jrb.fused_talking_heads_block(*j, heads, residual=residual, interpret=True)
    _check(out, pallas, dtype, "interpret")


@pytest.mark.parametrize("dtype,n,heads", RA_CASES)
def test_reattention_twin_matches_jax(dtype, n, heads):
    jrb = importlib.import_module("vit_tpu.ops.reattention_block")

    inp = _inputs(n + heads, 2, n, DIM, heads, D, "ra")
    t = [_cast(inp, dtype, _torch)[k] for k in RA_ARGS]
    j = [_cast(inp, dtype, _jnp)[k] for k in RA_ARGS]
    out = trb.xla_reattention_block(*t, heads, D**-0.5)
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    _check(out, jrb.xla_reattention_block(*j, heads, D**-0.5), dtype, "xla")
    _check(out, jrb.fused_reattention_block(*j, heads, interpret=True), dtype, "interpret")


@pytest.mark.parametrize("kind", ["th", "ra"])
def test_a_transposed_mix_is_seen(kind):
    """The tolerance above sees a head mix read as ``mix[g, h]``."""
    jrb = importlib.import_module("vit_tpu.ops.reattention_block")

    names = TH_ARGS if kind == "th" else RA_ARGS
    inp = _inputs(7, 2, 65, DIM, 4, D, kind)
    t = {k: _torch(v) for k, v in inp.items()}
    j = [_jnp(inp[k]) for k in names]
    if kind == "th":
        ref = jrb.fused_talking_heads_block(*j, 4, interpret=True)
        bad = trb.xla_talking_heads_block(*(t[k] for k in names[:6]), t["mix_pre"].T,
                                          t["mix_post"].T, 4, D**-0.5)
    else:
        ref = jrb.fused_reattention_block(*j, 4, interpret=True)
        bad = trb.xla_reattention_block(*(t[k] for k in names[:6]), t["mix"].T,
                                        t["rln_scale"], t["rln_bias"], 4, D**-0.5)
    err = float(np.abs(_np(bad) - _np(ref)).max())
    assert err > 10 * TOL["float32"] * float(np.abs(_np(ref)).max()), err


@pytest.mark.parametrize("kind", ["th", "ra"])
def test_padded_keys_are_masked_and_zeroed(kind):
    """A stream padded from 65 to 80 rows (random padding rows, so their K
    and V are not zero), ``true_n=65``: the real rows equal the unpadded
    block's. Without the mask (talking heads) or the zeroing of padded key
    columns after the head LayerNorm (re-attention, nonzero LN bias) they
    do not."""
    names = TH_ARGS if kind == "th" else RA_ARGS
    fn = trb.xla_talking_heads_block if kind == "th" else trb.xla_reattention_block
    hole = "_mask_keys" if kind == "th" else "_zero_padded_keys"
    inp = _inputs(11, 2, 80, DIM, 4, D, kind)
    t = [_torch(inp[k]) for k in names]
    real = fn(t[0][:, :65].contiguous(), *t[1:], 4, D**-0.5)
    padded = fn(*t, 4, D**-0.5, true_n=65)[:, :65]
    np.testing.assert_allclose(_np(padded), _np(real), rtol=0,
                               atol=TOL["float32"] * float(np.abs(_np(real)).max()))
    with mock.patch.object(trb, hole, lambda s, true_n: s):
        bad = fn(*t, 4, D**-0.5, true_n=65)[:, :65]
    assert float(np.abs(_np(bad) - _np(real)).max()) > 0.01 * float(np.abs(_np(real)).max())


def test_dispatch_cpu_runs_twins_and_counts_nothing():
    ops.reset_launch_counts()
    th = {k: _torch(v) for k, v in _inputs(3, 2, 17, DIM, 3, D, "th").items()}
    ra = {k: _torch(v) for k, v in _inputs(4, 2, 17, DIM, 3, D, "ra").items()}
    out = ops.talking_heads_block(*(th[k] for k in TH_ARGS), 3, residual=True)
    ref = trb.xla_talking_heads_block(*(th[k] for k in TH_ARGS), 3, D**-0.5, 1e-5, True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    out = ops.reattention_block(*(ra[k] for k in RA_ARGS), 3)
    ref = trb.xla_reattention_block(*(ra[k] for k in RA_ARGS), 3, D**-0.5)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert sum(ops.launch_counts().values()) == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    th = {k: _torch(v) for k, v in _inputs(5, 1, 8, 32, 2, D, "th").items()}
    with pytest.raises(ValueError, match="CUDA"):
        trb.fused_talking_heads_block(*(th[k] for k in TH_ARGS), 2)
    ra = {k: _torch(v) for k, v in _inputs(5, 1, 8, 32, 2, D, "ra").items()}
    with pytest.raises(ValueError, match="CUDA"):
        trb.fused_reattention_block(*(ra[k] for k in RA_ARGS), 2)


# (n, heads, dim_head) -> (variant, slab tiles, ring stages, shared-memory
# bytes) of the head-mix core of kernels 7 and 8 (csrc/head_mix_core.cuh
# hmix::plan_for, mirrored by head_mix_plan; the card test below holds the
# mirror to the C code): the CaiT and DeepViT presets, CARD_CASES' other
# shapes, the widest rows at Dh 16, 64 and 128, and one head.
HEAD_MIX_PLANS = [
    ((64, 16, 64), ("resident", 4, 4, 215168)),   # CaiT preset
    ((65, 16, 64), ("resident", 5, 4, 231552)),   # DeepViT preset
    ((197, 16, 64), ("streamed", 7, 3, 227456)),
    ((200, 16, 48), ("streamed", 8, 3, 219264)),
    ((256, 16, 128), ("streamed", 5, 2, 223360)),
    ((65, 16, 128), ("resident", 5, 2, 223360)),
    ((128, 16, 128), ("streamed", 5, 2, 223360)),
    ((256, 16, 16), ("streamed", 11, 3, 219264)),
    ((112, 16, 64), ("resident", 7, 3, 227456)),  # the 8-tile register row, 16 heads
    ((50, 3, 16), ("resident", 4, 4, 23680)),
    ((5, 2, 16), ("resident", 1, 4, 10368)),
    ((256, 1, 128), ("streamed", 16, 3, 31616)),
]


@pytest.mark.parametrize("shape,plan", HEAD_MIX_PLANS)
def test_head_mix_plan_is_pinned(shape, plan):
    assert tuple(trb.head_mix_plan(*shape)) == plan


def test_head_mix_plan_covers_the_kernels_domain():
    """Every shape the wrappers take (n <= 1,024, heads <= 16, dim_head % 16
    == 0 up to 128) has a plan that fits 227 KB (the fp32 route's plans:
    tests/test_torch_head_mix_domain.py)."""
    for n in (1, 16, 17, 65, 128, 129, 197, 256, 257, 576, 577, 784, 1024):
        for heads in (1, 3, 16):
            for d in (16, 48, 64, 128):
                p = trb.head_mix_plan(n, heads, d)
                assert p.slab_tiles >= 1 and 2 <= p.stages <= 4, (n, heads, d, p)
                assert p.smem_bytes <= 232448, (n, heads, d, p)
                if p.variant == "resident":  # the whole row in one slab, in registers
                    assert p.slab_tiles == -(-n // 16) <= 8, (n, heads, d, p)


# -- on the card: each kernel against its twin --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card(kind, b, n, dim, heads, d, x_dtype, dev, seed=0):
    inp = _inputs(seed, b, n, dim, heads, d, kind)
    inp["wqkv"] *= 10 / np.sqrt(dim)  # unit-scale products at any width
    inp["wout"] *= 10 / np.sqrt(heads * d)
    names = TH_ARGS if kind == "th" else RA_ARGS
    t = {k: _torch(v, x_dtype if k == "x" else "bfloat16" if k in ("wqkv", "wout") else
                   "float32", dev) for k, v in inp.items()}
    return [t[k] for k in names]


def _run(kind, args, heads, **kw):
    if kind == "th":
        return ops.talking_heads_block(*args, heads, **kw)
    return ops.reattention_block(*args, heads, **kw)


# (kind, n, heads, dim_head, x dtype): the CaiT and DeepViT preset geometry,
# n = 197 (the 224/16 geometry; an 8-row query tile), n = 256 at Dh = 128,
# Dh = 48 on the 8-row tile (V columns padded to 64), tiny shapes.
CARD_CASES = [
    ("th", 64, 16, 64, "bfloat16"), ("th", 64, 16, 64, "float32"), ("th", 197, 16, 64, "bfloat16"),
    ("th", 256, 16, 128, "bfloat16"), ("th", 200, 16, 48, "bfloat16"), ("th", 5, 2, 16, "float32"),
    ("ra", 65, 16, 64, "bfloat16"), ("ra", 65, 16, 64, "float32"), ("ra", 197, 16, 64, "bfloat16"),
    ("ra", 256, 16, 128, "bfloat16"), ("ra", 200, 16, 48, "bfloat16"), ("ra", 50, 3, 16, "float32"),
    # the head-mix core's plans: a resident row at Dh 128, a streamed one at Dh 16 (11-tile slab)
    ("th", 65, 16, 128, "bfloat16"), ("ra", 65, 16, 128, "bfloat16"),
    ("th", 256, 16, 16, "bfloat16"), ("ra", 256, 16, 16, "bfloat16"),
    ("th", 129, 1, 128, "float32"), ("ra", 1, 2, 16, "bfloat16"),
    # the resident variant's 8-tile score row (6-8 key tiles)
    ("th", 112, 16, 64, "bfloat16"), ("ra", 112, 16, 64, "bfloat16"), ("ra", 128, 4, 32, "float32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,heads,d,x_dtype", CARD_CASES)
def test_kernel_matches_twin(cuda, kind, n, heads, d, x_dtype):
    name = "talking_heads_block" if kind == "th" else "reattention_block"
    args = _card(kind, 3, n, 256, heads, d, x_dtype, cuda)
    kw = dict(residual=True) if kind == "th" and x_dtype == "float32" else {}
    before = ops.launch_counts()[name]
    out = _run(kind, args, heads, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    with ops.force_backend("torch"):
        ref = _run(kind, args, heads, **kw)
    assert ops.launch_counts()[name] == before + 1
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    residual = kind == "ra" or kw.get("residual", False)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, args[0] if residual else None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["th", "ra"])
def test_kernel_masks_padded_keys(cuda, kind):
    args = _card(kind, 2, 80, 256, 4, 64, "bfloat16", cuda, seed=1)
    fused = trb.fused_talking_heads_block if kind == "th" else trb.fused_reattention_block
    twin = trb.xla_talking_heads_block if kind == "th" else trb.xla_reattention_block
    out = fused(*args, 4, true_n=65)
    ref = twin(*args, 4, 64**-0.5, true_n=65)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, args[0] if kind == "ra" else None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["th", "ra"])
def test_kernel_intermediates(cuda, kind):
    """The kernel's fp32 mixed and normalised rows against the twin's stages
    run on the kernel's own qkv."""
    args = _card(kind, 2, 65, 256, 16, 64, "bfloat16", cuda, seed=2)
    st = {}
    fused = trb.fused_talking_heads_block if kind == "th" else trb.fused_reattention_block
    fused(*args, 16, intermediates=st)
    torch.cuda.synchronize()
    s, _ = trb._scores(st["qkv"].view(2, 65, -1), 16, 64**-0.5)
    if kind == "th":
        mixed, _ = trb._talking_heads_probs(s, args[6], args[7])
        p = trb._mix_heads(trb._softmax(st["mixed"]), args[7])
    else:
        mixed, _ = trb._reattention_probs(s, args[6], args[7], args[8], 1e-6)
        p = trb._zero_padded_keys(trb._head_layer_norm(st["mixed"], args[7], args[8], 1e-6), None)
    for key, ref in (("mixed", mixed), ("p", p)):
        err = (st[key] - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), (key, err)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["pre-mix transposed", "post-mix transposed",
                                   "re-attention mix transposed", "padded keys left unzeroed"])
def test_planted_faults_fail_the_kernel_bound(cuda, fault):
    """The bound the kernels are held to sees each fault: the twin with it
    planted, against the kernel on the same inputs."""
    kind = "th" if "-mix" in fault else "ra"
    padded = "padded" in fault
    n, true_n = (80, 65) if padded else (65, None)
    args = _card(kind, 2, n, 256, 16, 64, "bfloat16", cuda, seed=4)
    bad, hole = list(args), contextlib.nullcontext()
    if padded:  # an LN bias that the padded key columns would carry into P V
        args[8] = 0.5 * args[8] / args[8].abs().max()
        bad[8] = args[8]
        hole = mock.patch.object(trb, "_zero_padded_keys", lambda r, true_n: r)
    else:
        i = 7 if fault.startswith("post") else 6
        bad[i] = args[i].t().contiguous()
    fused = trb.fused_talking_heads_block if kind == "th" else trb.fused_reattention_block
    twin = trb.xla_talking_heads_block if kind == "th" else trb.xla_reattention_block
    out = fused(*args, 16, true_n=true_n)
    with hole:
        ref = twin(*bad, 16, 64**-0.5, true_n=true_n)
    err = (out.float() - ref.float()).abs().max().item()
    assert err > kernel_tol(ref, args[0] if kind == "ra" else None, out.dtype), err


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_cover(cuda):
    """fp32 weights and 257 tokens, refused before the fp32 route and the
    longer rows were ported, now run (tests/test_torch_head_mix_domain.py
    holds them to the twins); fp32 weights on a bf16 stream, 1,025 tokens
    and 17 heads are still refused."""
    th = _card("th", 1, 17, 64, 4, 16, "float32", cuda)
    assert ops.talking_heads_block(*th[:3], th[3].float(), th[4].float(), *th[5:], 4).shape == (
        1, 17, 64)
    with pytest.raises(TypeError, match="fp32 stream"):
        ops.talking_heads_block(th[0].bfloat16(), *th[1:3], th[3].float(), th[4].float(), *th[5:],
                                4)
    th = _card("th", 1, 257, 64, 4, 16, "bfloat16", cuda)
    assert torch.isfinite(ops.talking_heads_block(*th, 4).float()).all()
    th = _card("th", 1, 1025, 64, 4, 16, "bfloat16", cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.talking_heads_block(*th, 4)
    ra = _card("ra", 1, 17, 17 * 16, 17, 16, "bfloat16", cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.reattention_block(*ra, 17)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["th", "ra"])
@pytest.mark.parametrize("n", [65, 197])  # the core's resident and streamed variants
def test_kernel_is_batch_invariant(cuda, kind, n):
    args = _card(kind, 5, n, 256, 16, 64, "bfloat16", cuda, seed=3)
    full = _run(kind, args, 16)
    alone = _run(kind, [args[0][3:4].contiguous(), *args[1:]], 16)
    torch.testing.assert_close(alone, full[3:4], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,plan", HEAD_MIX_PLANS)
def test_head_mix_plan_mirrors_the_kernel(cuda, shape, plan):
    import ctypes

    from vit_tpu_torch.ops import _build

    got = (ctypes.c_int * 4)()
    assert _build.load_library().vt_head_mix_plan(*shape, ctypes.cast(got, ctypes.c_void_p)) == 0
    assert (trb.HEAD_MIX_VARIANTS[got[0]], got[1], got[2], got[3]) == plan


@pytest.mark.cuda
def test_reattention_refuses_a_misaligned_operand(cuda):
    """Kernel 8's products run on the wgmma GEMM, whose TMA loads need
    16-byte starts: x one element into its storage is refused before any
    launch."""
    args = _card("ra", 2, 65, 256, 4, 64, "bfloat16", cuda, seed=9)
    x = torch.empty(args[0].numel() + 1, device=cuda, dtype=args[0].dtype)[1:]
    x = x.view_as(args[0]).copy_(args[0])
    before = ops.launch_counts()["reattention_block"]
    with pytest.raises(ValueError, match="16-byte"):
        trb.fused_reattention_block(x, *args[1:], 4)
    assert ops.launch_counts()["reattention_block"] == before


# -- kernel 7's products on the wgmma GEMM (csrc/gemm_sm90.cuh) -------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,x_dtype,residual", [
    (8, "bfloat16", False), (8, "bfloat16", True), (128, "bfloat16", False),
    (128, "bfloat16", True), (8, "float32", False), (128, "float32", True),
])
def test_talking_heads_at_the_cait_preset(cuda, b, x_dtype, residual):
    """The CaiT preset's patch-stage shape (64 tokens, dim 1024, 16 heads of
    64), both products on the wgmma GEMM, with and without the residual, in
    both streams."""
    args = _card("th", b, 64, 1024, 16, 64, x_dtype, cuda, seed=6)
    out = trb.fused_talking_heads_block(*args, 16, residual=residual)
    ref = trb.xla_talking_heads_block(*args, 16, 64**-0.5, residual=residual)
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, args[0] if residual else None, out.dtype), err


@pytest.mark.cuda
def test_talking_heads_is_batch_invariant_at_the_cait_preset(cuda):
    """Sample 77 alone and inside batch 128 (other GEMM tiles): bitwise equal."""
    args = _card("th", 128, 64, 1024, 16, 64, "bfloat16", cuda, seed=7)
    full = trb.fused_talking_heads_block(*args, 16, residual=True)
    alone = trb.fused_talking_heads_block(args[0][77:78].contiguous(), *args[1:], 16,
                                          residual=True)
    torch.testing.assert_close(alone, full[77:78], rtol=0, atol=0)


@pytest.mark.cuda
def test_talking_heads_refuses_a_misaligned_operand(cuda):
    """The wgmma GEMM's TMA loads need 16-byte starts: x one element into its
    storage is refused before any launch."""
    args = _card("th", 2, 64, 256, 4, 64, "bfloat16", cuda, seed=8)
    x = torch.empty(args[0].numel() + 1, device=cuda, dtype=args[0].dtype)[1:]
    x = x.view_as(args[0]).copy_(args[0])
    before = ops.launch_counts()["talking_heads_block"]
    with pytest.raises(ValueError, match="16-byte"):
        trb.fused_talking_heads_block(x, *args[1:], 4)
    assert ops.launch_counts()["talking_heads_block"] == before
