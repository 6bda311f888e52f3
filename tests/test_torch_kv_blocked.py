"""The kv-blocked (online-softmax) flash kernel: its plain PyTorch twin against
vit_tpu's Pallas kernel on the CPU, the dispatch between the attention
kernels, the planted faults chip_smoke holds it to, and, on the card, the
Hopper kernel against its twin and the MLP kernel at T2T's widths.

``reference_attention_kv_blocked`` twins ``vit_tpu/ops/flash_attention.py:
_kv_blocked_kernel``. The same numpy inputs go through the twin and through
JAX's ``_flash_attention_kv_blocked_impl`` in interpret mode, with the same
``block_k``. JAX is imported inside the tests that use it: the machine with
the card has no JAX, and runs this file's ``cuda`` tests with
``python -m pytest --noconftest -m cuda tests/test_torch_kv_blocked.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import (DOMAIN_F32_TOL, KV_F32_FAULTS, KV_FAULTS, kernel_tol, kv_f32_fault_twin,
                        kv_fault_twin)
from vit_tpu_torch import ops

# ops/__init__ exports functions of the modules' own names
tfa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
tqa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
tfm = importlib.import_module("vit_tpu_torch.ops.fused_mlp")

torch.set_num_threads(2)

# Tolerances on max |out - ref|, as a share of max |ref| (|out| ~ 0.1-1).
# fp32: fp32 products summed in another order on each side (~1e-7 relative
#   per op): 2e-5.
# bf16: both sides round p to bf16 at the same places (the same block_k, so
#   the same running max) and the output once; a sum in another order can
#   move p or the output to the neighbouring bf16 value: 2^-8, half an ulp
#   of the largest output.
TOL = {"float32": 2e-5, "bfloat16": 2.0**-8}

# (dtype, B, H, Nq, Nk, D, Dv, bias shape or None, mask_self, block_k):
# several kv blocks, Nk not a multiple of the block, the four bias patterns,
# mask_self, Dv != D, T2T's D = 147; in fp32 also ScalableViT's SSA (D 40 /
# Dv 32 against 64 keys) and widths past 160 (the fp32 route's two-phase
# plan, Dv 300, and its sliced Q K^T, D 200).
KV_CASES = [
    ("float32", 2, 2, 65, 300, 32, 32, None, False, 128),
    ("float32", 1, 2, 40, 200, 16, 16, (1, 1), True, 64),
    ("float32", 2, 2, 33, 130, 32, 48, (2, 2), False, 64),
    ("float32", 2, 1, 70, 150, 147, 147, (2, 1), True, 64),
    ("float32", 2, 2, 100, 64, 40, 32, None, False, 64),
    ("float32", 1, 1, 20, 100, 200, 300, (1, 1), True, 64),
    ("bfloat16", 2, 2, 65, 300, 32, 32, (1, 2), False, 128),
    ("bfloat16", 1, 2, 40, 200, 16, 16, (1, 1), True, 64),
    ("bfloat16", 2, 2, 33, 130, 32, 48, (2, 2), False, 64),
    ("bfloat16", 2, 1, 70, 150, 147, 147, (2, 1), True, 64),
    ("bfloat16", 1, 1, 20, 100, 147, 147, None, False, 64),
]


def _torch(a, dtype="float32", device="cpu"):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(device=device, dtype=getattr(torch, dtype))


def _inputs(seed, b, h, nq, nk, d, dv, bias):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(q=r(b, h, nq, d), k=r(b, h, nk, d), v=r(b, h, nk, dv),
                bias=None if bias is None else r(*bias, nq, nk))


@pytest.mark.parametrize("dtype,b,h,nq,nk,d,dv,bias,mask_self,block_k", KV_CASES)
def test_kv_twin_matches_jax_kernel(dtype, b, h, nq, nk, d, dv, bias, mask_self, block_k):
    import jax.numpy as jnp
    from vit_tpu.ops.flash_attention import _flash_attention_kv_blocked_impl

    inp = _inputs(1, b, h, nq, nk, d, dv, bias)
    jx = {k: None if a is None else jnp.asarray(a).astype(getattr(jnp, dtype) if k != "bias"
                                                          else jnp.float32)
          for k, a in inp.items()}
    ref = _flash_attention_kv_blocked_impl(
        jx["q"], jx["k"], jx["v"], jx["bias"], scale=d**-0.5, mask_self=mask_self,
        block_q=64, block_k=block_k, interpret=True)
    t = {k: None if a is None else _torch(a, dtype if k != "bias" else "float32")
         for k, a in inp.items()}
    out = tfa.reference_attention_kv_blocked(t["q"], t["k"], t["v"], t["bias"],
                                             mask_self=mask_self, block_k=block_k)
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.dtype == getattr(torch, dtype) and out.shape == (b, h, nq, dv)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= TOL[dtype] * np.abs(ref).max(), err


@pytest.mark.parametrize("nk", [100, 700])
def test_kv_twin_default_block_is_jax_and_agrees_with_exact_softmax(nk):
    """The default ``block_k`` is JAX's ``min(512, round_up(Nk, 128))``; in
    fp32 the online softmax equals the exact one (``reference_attention``)
    to fp32 rounding."""
    import jax.numpy as jnp
    from vit_tpu.ops import flash_attention_kv_blocked

    inp = _inputs(2, 1, 2, 30, nk, 32, 32, (1, 2))
    ref = flash_attention_kv_blocked(*(jnp.asarray(inp[k]) for k in ("q", "k", "v", "bias")),
                                     interpret=True)
    t = [_torch(inp[k]) for k in ("q", "k", "v", "bias")]
    out = tfa.reference_attention_kv_blocked(*t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=0)
    np.testing.assert_allclose(out.numpy(), tfa.reference_attention(*t).numpy(), atol=2e-6, rtol=0)


# (what, q/k/v shapes) -> which twin ops.attention runs on the CPU: the twin
# of the kernel the card would run.
ATTENTION_ROUTES = [
    ("resident core", (1, 2, 40, 40, 64, 64), "reference_attention"),
    ("D not a multiple of 16", (1, 1, 40, 40, 147, 147), "reference_attention_kv_blocked"),
    ("D above 128", (1, 1, 20, 30, 256, 256), "reference_attention_kv_blocked"),
    ("score rows past 227 KB", (1, 1, 8, 1200, 64, 64), "reference_attention_kv_blocked"),
]


@pytest.mark.parametrize("what,shape,twin", ATTENTION_ROUTES)
def test_attention_dispatch_on_the_cpu_runs_the_card_kernels_twin(what, shape, twin):
    b, h, nq, nk, d, dv = shape
    t = [_torch(a) for a in _inputs(3, b, h, nq, nk, d, dv, None).values() if a is not None]
    ops.reset_launch_counts()
    out = ops.attention(*t)
    torch.testing.assert_close(out, getattr(tfa, twin)(*t), rtol=0, atol=0)
    assert sum(ops.launch_counts().values()) == 0


# (what, B, N, heads, D) of a fused qkv tensor -> which twin ops.qkv_attention
# runs: kernel 3's limits (D % 16, D <= 128, N <= 1024), else ops.attention
# on per-head views of the fused rows (kernel 4 where its core fits, else 5).
# T2T's tokenizer stages take kernel 5.
QKV_ROUTES = [
    ("kernel 3", 2, 17, 2, 16, "xla_qkv_attention"),
    ("T2T stage 0 width", 1, 40, 1, 147, "reference_attention_kv_blocked"),
    ("T2T stage 1 width", 1, 12, 1, 1323, "reference_attention_kv_blocked"),
    ("1030 tokens: kernel 4", 1, 1030, 2, 16, "reference_attention"),
    ("1200 tokens: kernel 5", 1, 1200, 2, 16, "reference_attention_kv_blocked"),
]


@pytest.mark.parametrize("what,b,n,heads,d,twin", QKV_ROUTES)
def test_qkv_dispatch_on_the_cpu_runs_the_card_kernels_twin(what, b, n, heads, d, twin):
    qkv = _torch(np.random.default_rng(4).standard_normal((b, n, 3 * heads * d)), "bfloat16")
    ops.reset_launch_counts()
    out = ops.qkv_attention(qkv, heads)
    if twin == "xla_qkv_attention":
        ref = tqa.xla_qkv_attention(qkv, heads)
    else:
        q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        ref = getattr(tfa, twin)(q, k, v).transpose(1, 2).reshape(b, n, heads * d)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert sum(ops.launch_counts().values()) == 0


def test_t2t_stage_shapes_route_to_the_kv_blocked_kernel_and_fit():
    """At the t2t preset both tokenizer stages fail kernels 3 and 4 and fit
    kernel 5: stage 0 on the register variant (128 query rows a block, one
    block an SM), stage 1 on the two-phase variant (three ring stages, one
    block an SM); the encoder's 197 tokens of 8 x 64 take kernel 3's limits.
    At image_size 384 stage 1 has 2,304 keys: p goes to device memory."""
    assert not tqa.qkv_kernel_fits(3136, 147) and not tfa.core_fits(3136, 147, 147)
    assert not tqa.qkv_kernel_fits(784, 1323) and not tfa.core_fits(784, 1323, 1323)
    assert tqa.qkv_kernel_fits(197, 64) and tfa.core_fits(197, 64, 64)
    p0 = tfa.kv_blocked_layout(3136, 147, 147)
    p1 = tfa.kv_blocked_layout(784, 1323, 1323)
    assert p0.variant == "registers" and p0.rows == 128 and p0.bytes <= tfa.MAX_SMEM
    assert p1.variant == "two-phase" and p1.stages == 3
    assert tfa.MAX_SMEM // 2 < p1.bytes <= tfa.MAX_SMEM
    p384 = tfa.kv_blocked_layout(2304, 1323, 1323)
    assert p384.variant == "two-phase-global" and p384.bytes <= tfa.MAX_SMEM


# (Nk, D, Dv) -> (variant, warps, query rows, ring stages) of the kernel's
# plan (kv_blocked_layout, the mirror of csrc kvb::plan_for), pinned: both
# padded widths <= 160 take the register variant at any Nk; wider heads the
# two-phase variant, three stages up to 896 keys, two up to 1,216, and past
# that the two-phase variant with p in device memory.
KV_PLANS = [
    (3136, 147, 147, ("registers", 8, 128, 2)),
    (100_000, 160, 160, ("registers", 8, 128, 2)),
    (200, 16, 16, ("registers", 8, 128, 2)),
    (130, 32, 48, ("registers", 8, 128, 2)),
    (130, 161, 64, ("two-phase", 8, 64, 3)),
    (130, 64, 161, ("two-phase", 8, 64, 3)),
    (784, 1323, 1323, ("two-phase", 8, 64, 3)),
    (896, 1323, 1323, ("two-phase", 8, 64, 3)),
    (897, 1323, 1323, ("two-phase", 8, 64, 2)),
    (1216, 4096, 4096, ("two-phase", 8, 64, 2)),
    (1217, 200, 200, ("two-phase-global", 8, 64, 3)),
    (1296, 1323, 1323, ("two-phase-global", 8, 64, 3)),
    (2304, 1323, 1323, ("two-phase-global", 8, 64, 3)),
    (100_000, 64, 4096, ("two-phase-global", 8, 64, 3)),
]


@pytest.mark.parametrize("nk,d,dv,plan", KV_PLANS)
def test_kv_blocked_plan_is_pinned(nk, d, dv, plan):
    got = tfa.kv_blocked_layout(nk, d, dv)
    assert tuple(got)[:4] == plan
    assert got.bytes <= tfa.MAX_SMEM


# (Nk, D, Dv) -> the fp32 route's plan (kv_blocked_layout(fp32=True), the
# mirror of csrc kvf::plan_for), pinned at the served shapes (T2T's two
# tokenizer stages, ScalableViT's IWSA and SSA at stage 0) and around the
# one-pass limit: Dv up to 160 (padded to 4) in one pass at any Nk, wider
# in two phases; D past 160 slices Q K^T, in either.
KV_F32_PLANS = [
    (3136, 147, 147, ("f32-one-pass", 8, 32, 1, 68864)),
    (784, 1323, 1323, ("f32-two-phase", 8, 32, 1, 71936)),
    (4096, 32, 32, ("f32-one-pass", 8, 32, 1, 22784)),
    (64, 40, 32, ("f32-one-pass", 8, 32, 1, 25856)),
    (100_000, 160, 160, ("f32-one-pass", 8, 32, 1, 71936)),
    (100, 161, 64, ("f32-one-pass", 8, 32, 1, 71936)),
    (100, 64, 157, ("f32-one-pass", 8, 32, 1, 59648)),
    (100, 64, 161, ("f32-two-phase", 8, 32, 1, 59648)),
    (1, 3, 5, ("f32-one-pass", 8, 32, 1, 13568)),
]


@pytest.mark.parametrize("nk,d,dv,plan", KV_F32_PLANS)
def test_kv_blocked_f32_plan_is_pinned(nk, d, dv, plan):
    got = tfa.kv_blocked_layout(nk, d, dv, fp32=True)
    assert tuple(got) == plan
    assert got.bytes <= tfa.MAX_SMEM


def test_kv_blocked_f32_scratch_holds_p_and_alpha_of_two_phases():
    # one pass reads q, k and v in place: no scratch
    assert tfa.kv_blocked_scratch(128, 1, 3136, 3136, 147, 147, fp32=True) == 0
    assert tfa.kv_blocked_scratch(128, 2, 4096, 64, 40, 32, fp32=True) == 0
    # T2T stage 1 at batch 2: 2 x 25 blocks of 32 rows, 13 chunks of 64 keys
    assert tfa.kv_blocked_scratch(2, 1, 784, 784, 1323, 1323, fp32=True) == \
        50 * 32 * 13 * 64 + 50 * 13 * 32


@pytest.mark.parametrize("fault", (None,) + KV_F32_FAULTS)
def test_kv_f32_bound_sees_planted_faults(fault):
    """chip_smoke's fp32 faults (kv_f32_fault_twin) each move the fp32 twin
    past the bound phase 29 holds the fp32 route to, DOMAIN_F32_TOL of max
    |out|, at a shape where all apply: 1,100 keys in 18 chunks (chunk 16
    whole, the last partial with 52 padded keys), a per-sample bias and
    mask_self. Without a fault, its loop is the twin."""
    inp = _inputs(16, 2, 2, 40, 1100, 40, 32, (2, 1))
    q, k, v, bias = (None if a is None else _torch(a) for a in inp.values())
    scale = 40**-0.5
    ref = tfa.reference_attention_kv_blocked(q, k, v, bias, scale, True, block_k=tfa.KV_CHUNK)
    got = kv_f32_fault_twin(fault, q, k, v, bias, scale, True)
    err = (got - ref).abs().max().item()
    tol = DOMAIN_F32_TOL * ref.abs().max().item()
    assert err <= tol / 10 if fault is None else err > tol, (fault, err, tol)


def test_kv_blocked_scratch_holds_rows_padded_to_16_columns():
    # T2T stage 0 at batch 2: q, k, v of 3136 rows of 147 -> 160 columns
    assert tfa.kv_blocked_scratch(2, 1, 3136, 3136, 147, 147) == 2 * 3 * 3136 * 160
    assert tfa.kv_blocked_scratch(2, 3, 40, 200, 32, 48) == 6 * (40 * 32 + 200 * 32 + 200 * 48)
    # T2T stage 1 at image_size 384, batch 2: then each of the 2 x 36 blocks'
    # bf16 p (64 rows x 2304 keys) and fp32 alpha (36 chunks x 64 rows)
    qkv = 2 * 3 * 2304 * 1328
    assert tfa.kv_blocked_scratch(2, 1, 2304, 2304, 1323, 1323) == \
        qkv + 72 * 64 * 2304 + 2 * 72 * 36 * 64


def test_kv_blocked_wrapper_refuses_cpu_tensors_and_fp32():
    t = [_torch(a) for a in _inputs(5, 1, 1, 9, 7, 147, 147, None).values() if a is not None]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_kv_blocked(*t)
    for nk, d, dv in ((64, 147, 147), (4096, 64, 64)):
        with pytest.raises(NotImplementedError, match="flash_attention_kv_blocked"):
            tfa.check_core_shape(nk, d, dv)


@pytest.mark.parametrize("fault", KV_FAULTS)
def test_kv_bound_sees_planted_faults(fault):
    """Each planted fault moves the output past chip_smoke's bound
    (``kernel_tol``) at a T2T-like shape: 150 keys in three 64-key chunks,
    the last one partial, D = 147, bf16."""
    t = [_torch(a, "bfloat16") for a in _inputs(6, 2, 1, 64, 150, 147, 147, None).values()
         if a is not None]
    ref = tfa.reference_attention_kv_blocked(*t, block_k=64)
    good = kv_fault_twin(None, *t)
    bad = kv_fault_twin(fault, *t)
    tol = kernel_tol(ref, None, ref.dtype)
    assert (good.float() - ref.float()).abs().max().item() <= tol
    assert (bad.float() - ref.float()).abs().max().item() > tol


# -- on the card: kernel 5 against its twin, kernel 2 at T2T's widths ----------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,nq,nk,d,dv,bias,mask_self", [
    (2, 1, 300, 300, 147, 147, None, False), (1, 1, 100, 150, 1323, 1323, None, False),
    (2, 3, 40, 200, 16, 16, (1, 1), True), (2, 2, 33, 130, 32, 48, (2, 2), False),
    (2, 1, 70, 150, 147, 147, (2, 1), True), (1, 2, 65, 64, 64, 64, (1, 2), False),
    # D 48; the two-phase variant with each bias pattern, mask_self, Dv != D
    # (one width at most 160, the other above), partial slices and passes,
    # and at its two key limits (896 keys: three stages; 1,216: two)
    (2, 2, 90, 190, 48, 48, (2, 1), True),
    (2, 1, 130, 150, 1323, 1323, (2, 1), True), (1, 2, 70, 100, 1323, 1323, (1, 2), False),
    (2, 2, 65, 130, 200, 300, (2, 2), True), (1, 1, 64, 129, 1323, 1323, (1, 1), False),
    (2, 1, 80, 70, 96, 400, None, True), (1, 1, 50, 90, 400, 64, None, False),
    (1, 1, 70, 896, 1323, 1323, None, False), (1, 1, 40, 1216, 176, 176, None, True),
    # p in device memory: T2T's stage 1 at image_size 384 (2,304 keys), and
    # with a bias, mask_self, Dv != D and a partial last chunk
    (1, 1, 100, 2304, 1323, 1323, None, False), (2, 1, 70, 1300, 200, 300, (2, 1), True),
])
def test_kv_blocked_kernel_matches_twin(cuda, b, h, nq, nk, d, dv, bias, mask_self):
    inp = _inputs(7, b, h, nq, nk, d, dv, bias)
    q, k, v = (_torch(inp[n], "bfloat16", cuda) for n in "qkv")
    tb = None if bias is None else _torch(inp["bias"], "float32", cuda)
    before = ops.launch_counts()["flash_attention_kv_blocked"]
    out = tfa.flash_attention_kv_blocked(q, k, v, tb, mask_self=mask_self)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_kv_blocked"] == before + 1
    ref = tfa.reference_attention_kv_blocked(q, k, v, tb, mask_self=mask_self,
                                             block_k=tfa.KV_CHUNK)
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, nq, dv)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(300, 147), (100, 1323), (3136, 147), (784, 1323)])
def test_qkv_attention_runs_kernel_5_on_fused_rows(cuda, n, d):
    """T2T's tokenizer layout: one head as wide as the token, the fused qkv
    rows 2-byte aligned; the kernel reads per-head views, no copy."""
    qkv = _torch(np.random.default_rng(8).standard_normal((2, n, 3 * d)), "bfloat16", cuda)
    before = ops.launch_counts()
    out = ops.qkv_attention(qkv, 1)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["flash_attention_kv_blocked"] == before["flash_attention_kv_blocked"] + 1
    assert after["qkv_attention"] == before["qkv_attention"]
    q, k, v = (t.reshape(2, n, 1, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    ref = tfa.reference_attention_kv_blocked(q, k, v, block_k=tfa.KV_CHUNK)
    ref = ref.transpose(1, 2).reshape(2, n, d)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dim", [147, 1323])
def test_mlp_kernel_at_t2t_widths_matches_twin(cuda, x_dtype, dim):
    rng = np.random.default_rng(dim)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    m = dict(x=_torch(r(2, 77, dim), x_dtype, cuda),
             w1=_torch(r(dim, dim) / dim**0.5, "bfloat16", cuda), b1=_torch(0.1 * r(dim), device=cuda),
             w2=_torch(r(dim, dim) / dim**0.5, "bfloat16", cuda), b2=_torch(0.1 * r(dim), device=cuda),
             ln_scale=_torch(1 + 0.1 * r(dim), device=cuda), ln_bias=_torch(0.1 * r(dim), device=cuda))
    before = ops.launch_counts()["fused_mlp"]
    out = ops.mlp(**m, residual=False, ln_eps=1e-5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_mlp"] == before + 1
    ref = tfm.reference_mlp(**m, residual=False, ln_eps=1e-5)
    assert out.dtype == m["x"].dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(3136, 147), (784, 1323), (2304, 1323)])
def test_kv_blocked_kernel_is_batch_invariant(cuda, n, d):
    """At both T2T stages (and stage 1 at image_size 384, p in device
    memory) sample 1 alone comes out bitwise as it does in a batch of 3: a
    row's sums do not depend on the batch or the block plan."""
    qkv = _torch(np.random.default_rng(9).standard_normal((3, n, 3 * d)), "bfloat16", cuda)
    full = ops.qkv_attention(qkv, 1)
    alone = ops.qkv_attention(qkv[1:2].contiguous(), 1)
    torch.testing.assert_close(alone, full[1:2], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nk,d,dv", [(nk, d, dv) for nk, d, dv, _ in KV_PLANS])
def test_kv_blocked_plan_mirrors_the_kernels(cuda, nk, d, dv):
    import ctypes

    from vit_tpu_torch.ops import _build

    got = (ctypes.c_int * 5)()
    _build.load_library().vt_kv_blocked_plan(nk, d, dv, ctypes.cast(got, ctypes.c_void_p))
    plan = tfa.kv_blocked_layout(nk, d, dv)
    assert (tfa.KV_VARIANTS[got[0]], *got[1:4]) == tuple(plan)[:4]
    assert got[4] == plan.bytes


# The fp32 route on the card: (B, H, Nq, Nk, D, Dv, bias, mask_self, views),
# views: q, k, v the split_heads views of fused rows (T2T's tokenizer and
# IWSA read so); T2T's stage 0 (one pass, 4-byte loads) and stage 1 (two
# phases), IWSA's and SSA's widths (16-byte loads), each bias pattern,
# mask_self, Nk not a multiple of 64, D past 160 with Dv below it, and
# widths that are no multiple of 4.
KV_F32_CARD = [
    (2, 1, 300, 300, 147, 147, None, False, True),
    (2, 1, 100, 784, 1323, 1323, None, False, True),
    (2, 2, 300, 1000, 32, 32, None, False, True),
    (2, 2, 256, 64, 40, 32, (1, 2), False, False),
    (2, 3, 40, 200, 16, 16, (1, 1), True, False),
    (2, 2, 33, 130, 32, 48, (2, 2), False, False),
    (2, 1, 70, 150, 147, 147, (2, 1), True, False),
    (2, 2, 65, 130, 200, 300, (2, 2), True, False),
    (1, 1, 50, 90, 400, 64, None, False, False),
    (2, 2, 37, 100, 3, 5, (2, 1), True, False),
    (1, 1, 5, 1, 32, 32, None, True, False),
]


def _kv_f32_operands(seed, b, h, nq, nk, d, dv, bias, views, device):
    inp = _inputs(seed, b, h, nq, nk, d, dv, bias)
    if views:  # fused [B, N, 3 H D] rows, as ops.qkv_attention splits them
        rows = np.random.default_rng(seed).standard_normal((b, nq, 3 * h * d))
        q, k, v = _torch(rows, device=device).view(b, nq, 3, h, d).permute(2, 0, 3, 1, 4)
    else:
        q, k, v = (_torch(inp[n], device=device) for n in "qkv")
    return q, k, v, None if bias is None else _torch(inp["bias"], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,nq,nk,d,dv,bias,mask_self,views", KV_F32_CARD)
def test_kv_blocked_f32_route_matches_twin(cuda, b, h, nq, nk, d, dv, bias, mask_self, views):
    """The fp32 route: one launch counted on it, fp32 out, within
    DOMAIN_F32_TOL of the twin's largest output at the kernel's chunk."""
    q, k, v, tb = _kv_f32_operands(17, b, h, nq, nk, d, dv, bias, views, cuda)
    before = tfa._build.fp32_launch_counts()["flash_attention_kv_blocked"]
    out = tfa.flash_attention_kv_blocked(q, k, v, tb, mask_self=mask_self)
    torch.cuda.synchronize()
    assert tfa._build.fp32_launch_counts()["flash_attention_kv_blocked"] == before + 1
    ref = tfa.reference_attention_kv_blocked(q, k, v, tb, mask_self=mask_self,
                                             block_k=tfa.KV_CHUNK)
    assert out.dtype == torch.float32 and out.shape == (b, h, nq, dv)
    err = (out - ref).abs().max().item()
    assert err <= DOMAIN_F32_TOL * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,d", [(3136, 1, 147), (784, 1, 1323), (4096, 2, 32)])
def test_kv_blocked_f32_route_is_batch_invariant(cuda, n, h, d):
    qkv = _torch(np.random.default_rng(18).standard_normal((3, n, 3 * h * d)), device=cuda)
    full = ops.qkv_attention(qkv, h)
    alone = ops.qkv_attention(qkv[1:2].contiguous(), h)
    torch.testing.assert_close(alone, full[1:2], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nk,d,dv", [(nk, d, dv) for nk, d, dv, _ in KV_F32_PLANS])
def test_kv_blocked_f32_plan_mirrors_the_kernel(cuda, nk, d, dv):
    from chip_smoke import kv_plan_c

    assert kv_plan_c(nk, d, dv, fp32=True) == tfa.kv_blocked_layout(nk, d, dv, fp32=True)


@pytest.mark.cuda
def test_kv_blocked_refuses_shapes_past_its_int_indices(cuda):
    """2^31 query rows (a stride-0 view, nothing allocated) pass the
    kernel's 32-bit row indices: refused before any launch."""
    q = torch.zeros(1, 1, 1, 16, device=cuda, dtype=torch.bfloat16).expand(1, 1, 2**31, 16)
    k = torch.zeros(1, 1, 8, 16, device=cuda, dtype=torch.bfloat16)
    before = ops.launch_counts()["flash_attention_kv_blocked"]
    with pytest.raises(NotImplementedError, match="2\\^31 - 1"):
        tfa.flash_attention_kv_blocked(q, k, k)
    assert ops.launch_counts()["flash_attention_kv_blocked"] == before


# -- the dispatch contract between kernels 4 and 5 --------------------------------

# core_fits (ops/flash_attention.py) at and around the limits of the
# resident core's shared-memory contract, pinned: (Nk, D, Dv) -> fits.
# Kernels 4 and 5 round differently, so which one a shape takes must not
# move when kernel 4's implementation does.
CORE_FITS = [
    (1, 16, 16, True), (197, 64, 64, True), (1024, 64, 64, True), (1088, 64, 64, True),
    (1089, 64, 64, False), (1152, 64, 64, False), (1024, 128, 128, True),
    (1025, 128, 128, False), (1024, 128, 64, True), (1025, 128, 64, False),
    (1088, 64, 128, True), (1089, 64, 128, False), (1088, 48, 48, True), (1089, 48, 48, False),
    (1088, 80, 80, True), (1089, 80, 80, False), (1089, 16, 16, True), (1, 144, 64, False),
    (64, 64, 72, False), (64, 72, 64, False),
]
# qkv_kernel_fits (ops/qkv_attention.py): (n, head width) -> fits.
QKV_FITS = [
    (1, 16, True), (197, 64, True), (1024, 128, True), (1025, 64, False), (1025, 16, False),
    (197, 72, False), (197, 144, False), (1024, 144, False),
]


@pytest.mark.parametrize("nk,d,dv,fits", CORE_FITS)
def test_core_fits_is_pinned(nk, d, dv, fits):
    assert tfa.core_fits(nk, d, dv) is fits


@pytest.mark.parametrize("n,d,fits", QKV_FITS)
def test_qkv_kernel_fits_is_pinned(n, d, fits):
    assert tqa.qkv_kernel_fits(n, d) is fits
