"""The flash-attention and window-attention kernels: the window partitions and
the plain PyTorch twins against vit_tpu on the CPU, and the Hopper kernels
against their twins on the card.

``reference_attention`` twins ``vit_tpu/ops/flash_attention.py:_attn_kernel``
and ``xla_window_attention_block`` twins ``vit_tpu/ops/window_attention.py:
_kernel``. The same numpy inputs go through the port's twin, JAX's Pallas
kernel in interpret mode and JAX's XLA twin. JAX is imported inside the tests
that use it: the machine with the card has no JAX, and runs this file's
``cuda`` tests with
``python -m pytest --noconftest -m cuda tests/test_torch_flash_window.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import flash_fault_twin, kernel_tol, window_fault_twin
from vit_tpu_torch import ops

# ops/__init__ exports functions of the modules' own names
tfa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
twa = importlib.import_module("vit_tpu_torch.ops.window_attention")

torch.set_num_threads(2)

# Tolerances on max |out - ref|, as a share of max |ref| (|out| ~ 1).
# fp32: fp32 products summed in another order on each side (~1e-7 relative
#   per op); measured up to 6.5e-7 against both JAX functions: 2e-5.
# bf16: every side rounds at the same sites (qkv, P, each head's P V, the
#   output); the sums' order can put a rounding on the neighbouring bf16
#   value, about one bf16 ulp of the output's magnitude: 2^-7 allows two such
#   steps. Measured 0 to 2.4e-3.
TOL = {"float32": 2e-5, "bfloat16": 2.0**-7}

# (dtype, B, H, Nq, Nk, D, Dv, bias shape or None, mask_self): the four bias
# patterns, Nq != Nk, Nk = 1 (Twins' stage 4: P = 1, out = v), Nk not a
# multiple of the kernel's 64-key chunk, Dv != D.
FLASH_CASES = [
    ("float32", 2, 3, 40, 40, 16, 16, None, False),
    ("float32", 2, 3, 40, 40, 16, 16, (1, 1), True),
    ("float32", 2, 3, 33, 49, 32, 16, (2, 3), False),
    ("float32", 1, 2, 20, 1, 16, 16, None, False),
    ("bfloat16", 2, 3, 50, 16, 32, 32, (1, 3), False),
    ("bfloat16", 2, 3, 40, 40, 16, 32, (2, 1), True),
    ("bfloat16", 2, 2, 70, 4, 64, 64, None, False),
    ("bfloat16", 1, 2, 20, 1, 16, 16, None, False),
]

# (dtype, windows, S, C, heads, D, bias shape or None): Twins' S = 49 (not a
# multiple of 16: the JAX kernel pads it to 64 and masks), a per-head and a
# shared bias, and a [1, H, S, S] bias that reshapes to [H, S, S].
WINDOW_CASES = [
    ("float32", 3, 49, 32, 2, 16, None),
    ("float32", 3, 16, 32, 2, 16, (2,)),
    ("float32", 2, 49, 32, 2, 16, (1, 2)),
    ("bfloat16", 3, 49, 32, 2, 16, None),
    ("bfloat16", 3, 49, 32, 2, 16, (1,)),
    ("bfloat16", 4, 16, 64, 4, 16, (4,)),
]

W_ARGS = ("xw", "ln_scale", "ln_bias", "wqkv", "wout", "bout")


def _torch(a, dtype="float32", device="cpu"):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(device=device, dtype=getattr(torch, dtype))


def _jnp(a, dtype="float32"):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dtype))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _check(out, ref, dtype, what):
    err = float(np.abs(_np(out) - _np(ref)).max())
    tol = TOL[dtype] * float(np.abs(_np(ref)).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _flash_inputs(seed, b, h, nq, nk, d, dv, bias):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(q=r(b, h, nq, d), k=r(b, h, nk, d), v=r(b, h, nk, dv),
                bias=None if bias is None else r(*bias, nq, nk))


def _window_inputs(seed, nw, s, c, heads, d, bias):
    """vit_tpu's TestWindowAttentionBlock scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    hd = heads * d
    return dict(xw=r(nw, s, c), ln_scale=1.0 + 0.1 * r(c), ln_bias=0.1 * r(c),
                wqkv=0.1 * r(c, 3 * hd), wout=0.1 * r(hd, c), bout=0.1 * r(c),
                bias=None if bias is None else r(*bias, s, s))


# -- the partitions --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["window", "dilated"])
def test_partitions_match_jax_and_invert(kind):
    jw = importlib.import_module("vit_tpu.ops.windows")
    x = np.random.default_rng(0).standard_normal((2, 12, 8, 5)).astype(np.float32)
    part, unpart = getattr(ops, f"{kind}_partition"), getattr(ops, f"{kind}_unpartition")
    out = part(_torch(x), 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(getattr(jw, f"{kind}_partition")(x, 4)))
    assert out.shape == (2 * 3 * 2, 16, 5)
    np.testing.assert_array_equal(unpart(out, 4, 12, 8).numpy(), x)


# -- the twins against vit_tpu ---------------------------------------------------


@pytest.mark.parametrize("dtype,b,h,nq,nk,d,dv,bias,mask_self", FLASH_CASES)
def test_reference_attention_matches_jax(dtype, b, h, nq, nk, d, dv, bias, mask_self):
    jfa = importlib.import_module("vit_tpu.ops.flash_attention")

    inp = _flash_inputs(nq + nk, b, h, nq, nk, d, dv, bias)
    t = [None if a is None else _torch(a, dtype if n != "bias" else "float32")
         for n, a in inp.items()]
    j = [None if a is None else _jnp(a, dtype if n != "bias" else "float32")
         for n, a in inp.items()]
    out = tfa.reference_attention(*t, scale=0.3, mask_self=mask_self)
    assert out.dtype == t[2].dtype and out.shape == (b, h, nq, dv)
    _check(out, jfa.reference_attention(*j, scale=0.3, mask_self=mask_self), dtype, "xla")
    pallas = jfa.flash_attention(*j, scale=0.3, mask_self=mask_self, interpret=True)
    _check(out, pallas, dtype, "interpret")


@pytest.mark.parametrize("dtype,nw,s,c,heads,d,bias", WINDOW_CASES)
def test_window_twin_matches_jax(dtype, nw, s, c, heads, d, bias):
    jwa = importlib.import_module("vit_tpu.ops.window_attention")

    inp = _window_inputs(s + nw, nw, s, c, heads, d, bias)
    cast = lambda conv: [conv(inp[k], dtype if k in ("xw", "wqkv", "wout") else "float32")
                         for k in W_ARGS]
    t, j = cast(_torch), cast(_jnp)
    tb = None if bias is None else _torch(inp["bias"])
    jb = None if bias is None else _jnp(inp["bias"])
    out = twa.xla_window_attention_block(*t, heads, tb)
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    _check(out, jwa.xla_window_attention_block(*j, heads, jb), dtype, "xla")
    _check(out, jwa.fused_window_attention_block(*j, heads, jb, interpret=True), dtype, "interpret")


def test_planted_faults_fail_the_tolerance():
    """The faults chip_smoke plants in the twins (padded keys left unmasked,
    the bias added transposed, windows attending across each other) move the
    output far past the tolerance above."""
    inp = _flash_inputs(3, 2, 2, 40, 40, 16, 16, (2, 2))
    q, k, v, bias = (_torch(a) for a in inp.values())
    ref = tfa.reference_attention(q, k, v, bias)
    for fault in ("padded keys unmasked", "bias transposed"):
        bad = flash_fault_twin(fault, q, k, v, bias)
        assert (bad - ref).abs().max() > 10 * TOL["float32"] * ref.abs().max(), fault
    w = _window_inputs(4, 4, 49, 32, 2, 16, (2,))
    args = [_torch(w[k]) for k in W_ARGS]
    ref = twa.xla_window_attention_block(*args, 2, _torch(w["bias"]))
    bad = window_fault_twin(args, 2, _torch(w["bias"]))
    assert (bad - ref).abs().max() > 10 * TOL["float32"] * ref.abs().max()


# -- dispatch and the wrappers' contracts on the CPU ----------------------------


def test_dispatch_cpu_runs_twins_and_counts_nothing():
    ops.reset_launch_counts()
    inp = _flash_inputs(5, 2, 2, 9, 7, 16, 16, (1, 2))
    t = [_torch(a) for a in inp.values()]
    torch.testing.assert_close(ops.attention(*t, mask_self=True),
                               tfa.reference_attention(*t, mask_self=True), rtol=0, atol=0)
    w = _window_inputs(6, 2, 16, 32, 2, 16, (2,))
    args = [_torch(w[k]) for k in W_ARGS]
    torch.testing.assert_close(ops.window_attention_block(*args, 2, _torch(w["bias"])),
                               twa.xla_window_attention_block(*args, 2, _torch(w["bias"])),
                               rtol=0, atol=0)
    assert sum(ops.launch_counts().values()) == 0


def test_kernel_wrappers_refuse_cpu_tensors_and_name_the_kv_blocked_item():
    t = [_torch(a) for a in _flash_inputs(5, 1, 2, 9, 7, 16, 16, None).values() if a is not None]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(*t)
    w = _window_inputs(6, 2, 16, 32, 2, 16, None)
    with pytest.raises(ValueError, match="CUDA"):
        twa.fused_window_attention_block(*(_torch(w[k]) for k in W_ARGS), 2)
    for nk, d, dv in ((64, 24, 24), (64, 64, 256), (4096, 64, 64)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 2 item 5"):
            tfa.check_core_shape(nk, d, dv)
    tfa.check_core_shape(1088, 64, 64)  # the most keys whose score rows fit 227 KB


# (S, C, heads, dim_head) -> (route, windows a block, shared-memory bytes) of
# kernel 6 (csrc/window_attention_block.cu win::plan_for, mirrored by
# plan_for; the card test below holds the mirror to the C code): Twins' three
# LSA stages, S on both sides of 64, C 64 and 512, dim_head 32 and 128.
WINDOW_PLANS = [
    ((49, 64, 8, 64), ("registers", 2, 82944)),   # Twins LSA stage 1
    ((49, 128, 8, 64), ("registers", 2, 126976)),  # stage 2
    ((49, 256, 8, 64), ("registers", 2, 159744)),  # stage 3
    ((16, 64, 8, 64), ("registers", 8, 82944)),
    ((64, 64, 8, 64), ("registers", 2, 82944)),
    ((65, 64, 8, 64), ("four-launch", 0, 0)),
    ((49, 512, 8, 64), ("o-tile", 1, 206848)),
    ((49, 64, 8, 32), ("o-tile", 2, 150528)),
    ((49, 64, 4, 128), ("o-tile", 1, 162816)),
    ((49, 512, 4, 128), ("o-tile", 1, 220160)),
    ((49, 512, 8, 128), ("four-launch", 0, 0)),   # the o tile alone is 130 KB
]


@pytest.mark.parametrize("shape,plan", WINDOW_PLANS)
def test_window_plan_is_pinned(shape, plan):
    assert tuple(twa.plan_for(*shape)) == plan
    assert twa.route(*shape) == plan[0]


# -- on the card: each kernel against its twin ---------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,nq,nk,d,dv,bias,mask_self", [
    (2, 8, 3136, 64, 64, 64, None, False), (2, 8, 49, 1, 64, 64, None, False),
    (2, 3, 40, 40, 64, 64, (1, 1), True), (2, 3, 33, 49, 32, 16, (2, 3), False),
    (2, 3, 50, 130, 64, 128, (1, 3), True), (3, 2, 70, 1088, 64, 64, (3, 1), False),
])
def test_flash_kernel_matches_twin(cuda, b, h, nq, nk, d, dv, bias, mask_self):
    inp = _flash_inputs(7, b, h, nq, nk, d, dv, bias)
    q, k, v = (_torch(inp[n], "bfloat16", cuda) for n in "qkv")
    tb = None if bias is None else _torch(inp["bias"], "float32", cuda)
    before = ops.launch_counts()["flash_attention"]
    out = ops.attention(q, k, v, tb, mask_self=mask_self)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    with ops.force_backend("torch"):
        ref = ops.attention(q, k, v, tb, mask_self=mask_self)
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, nq, dv)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err
    if nk == 1:
        assert torch.equal(out, v.expand(b, h, nq, dv))


@pytest.mark.cuda
def test_flash_kernel_reads_split_heads_views(cuda):
    """q, k, v as the split_heads views of [B, N, H*D] rows (GSA's layout),
    not copied: the result equals the kernel's on contiguous copies, on the
    bf16 route and on the fp32 routes of kernels 4 and 5 (fp32 operands,
    which both refused before their fp32 routes)."""
    from vit_tpu_torch.nn.attention import mha_tokens, split_heads

    rng = np.random.default_rng(8)
    q = _torch(rng.standard_normal((2, 100, 8 * 64)), "bfloat16", cuda)
    kv = _torch(rng.standard_normal((2, 16, 2 * 8 * 64)), "bfloat16", cuda)
    k, v = kv.chunk(2, dim=-1)
    out = mha_tokens(q, k, v, 8)
    parts = [split_heads(t, 8).contiguous() for t in (q, k, v)]
    torch.testing.assert_close(out, tfa.flash_attention(*parts).transpose(1, 2).reshape(2, 100, -1),
                               rtol=0, atol=0)
    views = [split_heads(t.float(), 8) for t in (q, k, v)]
    before = ops.fp32_launch_counts()["flash_attention"]
    out32 = tfa.flash_attention(*views)
    assert ops.fp32_launch_counts()["flash_attention"] == before + 1
    torch.testing.assert_close(out32, tfa.flash_attention(*(t.contiguous() for t in views)),
                               rtol=0, atol=0)
    before = ops.fp32_launch_counts()["flash_attention_kv_blocked"]
    out32 = tfa.flash_attention_kv_blocked(*views)
    assert ops.fp32_launch_counts()["flash_attention_kv_blocked"] == before + 1
    torch.testing.assert_close(
        out32, tfa.flash_attention_kv_blocked(*(t.contiguous() for t in views)), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("nw,s,c,heads,bias", [
    (64, 49, 64, 8, None), (64, 49, 128, 8, (8,)), (16, 49, 256, 8, (1,)), (6, 40, 64, 2, (1, 2)),
])
def test_window_kernel_matches_twin(cuda, x_dtype, nw, s, c, heads, bias):
    w = _window_inputs(9, nw, s, c, heads, 64, bias)
    args = [_torch(w[k], x_dtype if k == "xw" else "bfloat16" if k[0] == "w" else "float32", cuda)
            for k in W_ARGS]
    tb = None if bias is None else _torch(w["bias"], "float32", cuda)
    before = ops.launch_counts()["window_attention_block"]
    out = ops.window_attention_block(*args, heads, tb)
    torch.cuda.synchronize()
    assert ops.launch_counts()["window_attention_block"] == before + 1
    with ops.force_backend("torch"):
        ref = ops.window_attention_block(*args, heads, tb)
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
def test_window_kernel_takes_65536_window_head_pairs(cuda):
    """Twins' stage 1 at batch 128: 8192 windows x 8 heads, one pair past
    what a grid's y dimension holds (4,096 blocks of the fused route)."""
    w = _window_inputs(10, 8192, 49, 64, 8, 64, (8,))
    args = [_torch(w[k], "bfloat16" if k in ("xw", "wqkv", "wout") else "float32", cuda)
            for k in W_ARGS]
    tb = _torch(w["bias"], "float32", cuda)
    out = twa.fused_window_attention_block(*args, 8, tb)
    ref = twa.xla_window_attention_block(*args, 8, tb)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= kernel_tol(ref, None, out.dtype)


# -- kernel 6 as one fused launch ----------------------------------------------


def _window_card(seed, nw, s, c, heads, d, bias, x_dtype, dev):
    w = _window_inputs(seed, nw, s, c, heads, d, bias)
    args = [_torch(w[k], x_dtype if k == "xw" else "bfloat16" if k[0] == "w" else "float32", dev)
            for k in W_ARGS]
    return args, None if bias is None else _torch(w["bias"], "float32", dev)


def _window_check(args, heads, tb):
    out = twa.fused_window_attention_block(*args, heads, tb)
    ref = twa.xla_window_attention_block(*args, heads, tb)
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [None, (8,), (1,)])
@pytest.mark.parametrize("windows,c", [(64, 64), (16, 128), (4, 256)])
def test_window_kernel_at_the_twins_lsa_stages(cuda, windows, c, bias):
    """Twins' three LSA stages at batch 8 (7x7 windows, 8 heads of 64), with
    no bias, a per-head [8, 49, 49] and a shared [1, 49, 49] one."""
    args, tb = _window_card(30 + c, 8 * windows, 49, c, 8, 64, bias, "bfloat16", cuda)
    assert twa.route(49, c, 8, 64) == "registers"
    _window_check(args, 8, tb)


@pytest.mark.cuda
@pytest.mark.parametrize("nw,s,c,heads,d,bias,x_dtype,route", [
    (40, 16, 64, 8, 64, (8,), "bfloat16", "registers"),
    (33, 64, 64, 4, 64, (1,), "bfloat16", "registers"),
    (12, 65, 64, 4, 64, (4,), "bfloat16", "four-launch"),
    (10, 100, 128, 2, 64, None, "float32", "four-launch"),
    (64, 49, 64, 8, 64, (8,), "float32", "registers"),
    (16, 49, 256, 8, 64, None, "float32", "registers"),
    (9, 49, 512, 8, 64, (8,), "bfloat16", "o-tile"),
    (9, 49, 512, 8, 64, None, "float32", "o-tile"),
    (21, 49, 64, 8, 32, (8,), "bfloat16", "o-tile"),
    (11, 49, 64, 4, 128, (1,), "bfloat16", "o-tile"),
    (7, 33, 72, 3, 32, (3,), "float32", "o-tile"),
])
def test_window_kernel_edge_shapes(cuda, nw, s, c, heads, d, bias, x_dtype, route):
    """S 16 and 64 (one and four warps a window), windows past 64 tokens on
    the four-launch route, the fp32 stream, C 512, dim_head 32 and 128, C
    and S not multiples of 16 or 64, an odd NW (a block's last window
    missing)."""
    assert twa.route(s, c, heads, d) == route
    args, tb = _window_card(40 + s + c, nw, s, c, heads, d, bias, x_dtype, cuda)
    _window_check(args, heads, tb)


@pytest.mark.cuda
def test_window_kernel_is_batch_invariant(cuda):
    """Window 0 of Twins' stage 1 alone (one block, its second window
    missing) and among batch 128's 8,192 windows: bitwise equal."""
    args, tb = _window_card(50, 8192, 49, 64, 8, 64, (8,), "bfloat16", cuda)
    full = twa.fused_window_attention_block(*args, 8, tb)
    alone = [args[0][:1].contiguous(), *args[1:]]
    torch.testing.assert_close(twa.fused_window_attention_block(*alone, 8, tb), full[:1],
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,plan", WINDOW_PLANS)
def test_window_plan_mirrors_the_kernel(cuda, shape, plan):
    import ctypes

    from vit_tpu_torch.ops import _build

    got = (ctypes.c_int * 3)()
    assert _build.load_library().vt_window_attention_plan(
        *shape, ctypes.cast(got, ctypes.c_void_p)) == 0
    assert (twa.VARIANTS[got[0]], got[1], got[2]) == plan


@pytest.mark.cuda
def test_window_kernel_fused_route_stores_no_intermediates(cuda):
    """On the fused route the wrapper allocates only the output: the peak
    memory of a stage-1 call at batch 128 stays near the output's bytes.
    Weights one element off a 16-byte boundary take the four-launch route,
    which also holds xn, qkv and the attention output, and agree with the
    twin."""
    args, tb = _window_card(51, 8192, 49, 64, 8, 64, None, "bfloat16", cuda)
    shifted = torch.empty(args[3].numel() + 1, device=cuda, dtype=args[3].dtype)[1:]
    misaligned = [*args[:3], shifted.view_as(args[3]).copy_(args[3]), *args[4:]]
    out_bytes = args[0].numel() * 2
    peaks = []
    for a in (args, misaligned):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        twa.fused_window_attention_block(*a, 8, tb)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    assert peaks[0] <= out_bytes + (1 << 20), peaks
    assert peaks[1] >= out_bytes + 8192 * 49 * (64 + 3 * 512 + 512) * 2, peaks
    _window_check(misaligned, 8, tb)


# -- kernel 4 on the register-resident core (csrc/attention_core_sm90.cuh) -------


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,nq,nk,d,dv,bias,mask_self", [
    (2, 3, 40, 1, 64, 64, (2, 3), True), (2, 3, 40, 4, 64, 64, (1, 3), False),
    (2, 3, 33, 16, 16, 16, (2, 1), True), (2, 3, 100, 64, 64, 16, (1, 1), False),
    (2, 3, 50, 197, 64, 64, (2, 3), True), (2, 2, 30, 257, 64, 64, (1, 2), False),
    (1, 2, 20, 1088, 64, 64, None, True), (2, 2, 45, 197, 16, 128, (2, 1), False),
    (2, 2, 45, 130, 128, 16, None, True), (2, 2, 45, 64, 128, 128, (1, 1), True),
    (2, 2, 45, 1024, 128, 128, (2, 2), False),
])
def test_flash_kernel_edge_shapes(cuda, b, h, nq, nk, d, dv, bias, mask_self):
    """Nk 1 to 1,088 on either side of the core's resident and streamed
    variants, Nq != Nk, Dv != D with D, Dv in {16, 64, 128}, every bias
    pattern, mask_self."""
    inp = _flash_inputs(21, b, h, nq, nk, d, dv, bias)
    q, k, v = (_torch(inp[n], "bfloat16", cuda) for n in "qkv")
    tb = None if bias is None else _torch(inp["bias"], "float32", cuda)
    out = tfa.flash_attention(q, k, v, tb, mask_self=mask_self)
    ref = tfa.reference_attention(q, k, v, tb, mask_self=mask_self)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [16, 197])
def test_flash_kernel_reads_split_heads_views_at_the_resident_variants(cuda, nk):
    """The split_heads views of [B, N, H*D] rows at 16 and 197 keys (one
    chunk; four chunks of the 208-key variant) equal the kernel's result on
    contiguous copies."""
    from vit_tpu_torch.nn.attention import split_heads

    rng = np.random.default_rng(22)
    q = split_heads(_torch(rng.standard_normal((2, 150, 8 * 64)), "bfloat16", cuda), 8)
    kv = _torch(rng.standard_normal((2, nk, 2 * 8 * 64)), "bfloat16", cuda)
    k, v = (split_heads(t, 8) for t in kv.chunk(2, dim=-1))
    out = tfa.flash_attention(q, k, v)
    torch.testing.assert_close(out, tfa.flash_attention(*(t.contiguous() for t in (q, k, v))),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk", [(49, 1), (196, 197)])
def test_flash_kernel_is_batch_invariant_across_tile_choices(cuda, nq, nk):
    """A sample alone and inside a batch of 16 take other tile choices
    (Twins' GSA stage 4; ViT's 197 keys) and come out bitwise equal."""
    from vit_tpu_torch.ops import _build

    warps = _build.load_library().vt_attention_sm90_warps
    assert warps(1, 8, nq, nk, 64, 64) != warps(16, 8, nq, nk, 64, 64)
    inp = _flash_inputs(23, 16, 8, nq, nk, 64, 64, None)
    q, k, v = (_torch(inp[n], "bfloat16", cuda) for n in "qkv")
    full = tfa.flash_attention(q, k, v)
    for i in (0, 9):
        alone = tfa.flash_attention(*(t[i:i + 1] for t in (q, k, v)))
        torch.testing.assert_close(alone, full[i:i + 1], rtol=0, atol=0)
