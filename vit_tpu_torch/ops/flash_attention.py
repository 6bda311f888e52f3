"""Multi-head attention with separate q, k, v, a bias and the LSA diagonal.

Port of both kernels of ``vit_tpu/ops/flash_attention.py``:

- the resident-K/V kernel (``_attn_kernel``): ``flash_attention`` is the
  Hopper kernel (``csrc/flash_attention.cu``, on the register-resident core
  of ``csrc/attention_core_sm90.cuh`` it shares with the fused-qkv kernel);
  ``reference_attention`` is its plain PyTorch twin
  and mirrors JAX's op for op: fp32 scores of the stored operands, ``*
  scale``, ``+ bias`` in fp32, the ``mask_self`` diagonal set to
  ``MASK_VALUE``, ``jax.nn.softmax``'s max / exp / sum / divide order, P
  rounded to v's dtype before the fp32 P @ V, one rounding to v's dtype.
- the online-softmax kernel (``_kv_blocked_kernel``, entry
  ``flash_attention_kv_blocked``): ``flash_attention_kv_blocked`` is the
  Hopper kernel (``csrc/flash_attention_kv_blocked.cu``: bf16 on the tensor
  cores; fp32, the TPU kernel's ``Precision.HIGHEST``, on the CUDA cores
  with p never rounded), for widths and key counts the resident core cannot
  hold; ``reference_attention_kv_blocked`` is its twin, in the TPU kernel's
  op order over chunks of ``block_k`` keys: the running max, the running sum
  and the fp32 accumulator, the unnormalised p rounded to v's dtype (a
  no-op in fp32), one division at the end.

``flash_attention_op`` and ``flash_attention_kv_blocked_op`` are the two
kernels as ``torch.library`` operators (``_build.define_op``).

``FlashAttentionFn`` differentiates both kernels: the kernel forward, and
``flash_backward``, the port of ``vit_tpu``'s Q-chunked recompute backward
(``_flash_bwd``), which holds the scores of one chunk of queries at a time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vit_tpu_torch.core.utils import round_up
from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.block_attention import _mm, _softmax, fp32_bf16_sums

# -0.7 * float32 max: the mask_self fill, as vit_tpu/ops/flash_attention.py:40
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_SMEM = 232448  # 227 KB, the most shared memory one block may use

_KV_BLOCKED = "run the kv-blocked kernel, flash_attention_kv_blocked (ROADMAP.md Queue 2 item 5)"
KV_CHUNK = 64  # keys per chunk of the kv-blocked kernel (csrc kvb::KC)
KV_F32_SLICE = 160  # columns of a Q / K slice and of a V pass of its fp32 route (csrc kvf::SLICE)
KV_F32_ROWS = 32  # query rows a block of its fp32 route (csrc kvf::QT)
BLOCK_Q = 256  # queries per chunk of the backward (vit_tpu's block_q default)


def smem_bytes(nk: int, d: int, dv: int) -> int:
    """The resident core's limit on the keys of one (b, h): the shared memory
    a block of 32 query rows of ``attention_core.cuh`` took (``layout``: the
    Q tile, a 64-key K/V chunk, the fp32 score rows over all ``nk`` keys and
    the bf16 P rows). Kernel 4 now runs on ``attention_core_sm90.cuh``, whose
    score rows stay in registers and which takes any Nk; this function is
    kept as the dispatch contract between kernels 4 and 5, unchanged, so that
    no shape moves from one kernel's rounding to the other's
    (``core_fits``)."""
    a = lambda v: round_up(v, 128)
    n_pad = round_up(nk, 64)
    ldq, ldkv, lds, ldp = d + 8, max(d, dv) + 8, max(n_pad, dv) + 4, n_pad + 8
    s_off = a(a(32 * ldq * 2) + 64 * ldkv * 2)
    return a(a(s_off + 32 * lds * 4) + 32 * ldp * 2)


def check_core_shape(nk: int, d: int, dv: int) -> None:
    """Raise for a shape kernel 4 does not take (the dispatch contract)."""
    if d % 16 or d > 128 or dv % 16 or dv > 128:
        raise NotImplementedError(
            f"head widths D={d}, Dv={dv}: the kernel takes multiples of 16 up to 128; "
            f"other widths {_KV_BLOCKED}")
    if smem_bytes(nk, d, dv) > MAX_SMEM:
        raise NotImplementedError(
            f"{nk} keys: past kernel 4's limit at these widths (smem_bytes, the dispatch "
            f"contract); longer key sequences {_KV_BLOCKED}")


def f32_core_bytes(nk: int, d: int, dv: int) -> int:
    """Shared memory of a block of the fp32 core (``csrc/attention_f32.cuh``
    ``af32::layout``, mirrored): the fp32 Q tile of 32 rows, one chunk of 64
    K or V rows and the fp32 score rows of the tile over all ``nk`` keys,
    each row padded by 4 floats. Within the domain of each kernel that runs
    it (``core_fits``, ``qkv_kernel_fits``, the fused block's 1,024 tokens)
    it stays within ``MAX_SMEM``, so the fp32 routes take every shape their
    bf16 routes take."""
    a = lambda v: round_up(v, 128)
    n_pad = round_up(nk, 64)
    kv_off = a(32 * (d + 4) * 4)
    s_off = a(kv_off + 64 * (max(d, dv) + 4) * 4)
    return a(s_off + 32 * (n_pad + 4) * 4)


def core_fits(nk: int, d: int, dv: int) -> bool:
    """Whether kernel 4 takes this shape (the dispatch contract of
    ``check_core_shape``); if not, the dispatchers run the kv-blocked
    kernel."""
    try:
        check_core_shape(nk, d, dv)
    except NotImplementedError:
        return False
    return True


class KvPlan(NamedTuple):
    """How the kv-blocked kernel runs a shape (``csrc/flash_attention_kv_blocked.cu``
    ``Plan``): its variant, warps and query rows a block, ring stages and
    shared-memory bytes."""

    variant: str
    warps: int
    rows: int
    stages: int
    bytes: int


# csrc kvb::Variant and, for the fp32 route, kvf::Variant
KV_VARIANTS = {1: "registers", 2: "two-phase", 3: "two-phase-global", 4: "f32-one-pass",
               5: "f32-two-phase"}


def _f32_tile_ld(w4: int) -> int:
    """Row stride in floats of an fp32 tile ``w4`` columns wide (``kvf::
    tile_ld``): odd in float4s, so that 8 rows' float4 reads hit 8 distinct
    bank groups."""
    return w4 + 4 + 4 * ((w4 // 4) & 1)


def _kv_blocked_layout_f32(d: int, dv: int) -> KvPlan:
    """The plan of the kv-blocked kernel's fp32 route (``kvf::plan_for``),
    mirrored: 8 warps, 32 query rows a block, no ring. Shared memory holds a
    Q slice and a K slice (or a V pass) of up to ``KV_F32_SLICE`` columns
    (D and Dv padded to multiples of 4), the chunk's fp32 scores and p,
    alpha and l. ``f32-one-pass`` where Dv (padded) is at most
    ``KV_F32_SLICE``: the accumulator stays in registers. Wider,
    ``f32-two-phase``: p and alpha of every chunk go to the scratch in device
    memory (``kv_blocked_scratch``), and Dv is walked in passes. Any Nk."""
    a = lambda v: round_up(v, 128)
    d4, dv4 = round_up(d, 4), round_up(dv, 4)
    ldqk, ldv = _f32_tile_ld(min(d4, KV_F32_SLICE)), _f32_tile_ld(min(dv4, KV_F32_SLICE))
    nbytes = (a(KV_F32_ROWS * ldqk * 4) + a(KV_CHUNK * max(ldqk, ldv) * 4)
              + a(KV_F32_ROWS * (KV_CHUNK + 4) * 4) + 2 * a(KV_F32_ROWS * 4))
    variant = "f32-one-pass" if dv4 <= KV_F32_SLICE else "f32-two-phase"
    return KvPlan(variant, 8, KV_F32_ROWS, 1, nbytes)


def kv_blocked_layout(nk: int, d: int, dv: int, fp32: bool = False) -> KvPlan:
    """The plan of the kv-blocked kernel (``kvb::plan_for``), mirrored; with
    ``fp32``, that of its fp32 route (``_kv_blocked_layout_f32``). D and
    Dv are padded to multiples of 16 by the kernel's layout pass. Up to 160
    padded columns each, the register variant: 8 warps of 16 query rows, Q,
    the chunk's scores and the accumulator in registers, the Q tile and a
    two-stage ring of 64-key K and V chunks in shared memory, any Nk. Wider,
    the two-phase variant: 8 warps, 64 query rows, a ring of 128-column Q and
    K slices (phase 1) or 256-column V slices (phase 2), and the bf16 p and
    alpha of every 64-key chunk in shared memory: three stages up to 896
    keys, two up to 1,216. Past that, ``two-phase-global``: p and alpha in
    the scratch in device memory (``kv_blocked_scratch``), each chunk's p
    brought into the ring stage beside its V slice, three stages, any Nk."""
    if fp32:
        return _kv_blocked_layout_f32(d, dv)
    a = lambda v: round_up(v, 128)
    dp, dvp = round_up(d, 16), round_up(dv, 16)
    if dp <= 160 and dvp <= 160:
        ldq = max(dp, dvp) + 8
        stage = a(a(KV_CHUNK * (dp + 8) * 2) + KV_CHUNK * (dvp + 8) * 2)
        return KvPlan("registers", 8, 128, 2, a(128 * ldq * 2) + 2 * stage)
    nc = -(-nk // KV_CHUNK)
    qk, v_bytes = 2 * 64 * 136 * 2, KV_CHUNK * 264 * 2

    def wide(stages, pg):
        stage = a(max(qk, a(v_bytes) + 64 * (KV_CHUNK + 8) * 2 if pg else v_bytes))
        p_alpha = 0 if pg else a(64 * (nc * KV_CHUNK + 8) * 2) + a(nc * 64 * 4)
        return stages * stage + p_alpha + a(64 * 4) + a(4 * 64 * 4)

    for stages in (3, 2):
        if wide(stages, False) <= MAX_SMEM:
            return KvPlan("two-phase", 8, 64, stages, wide(stages, False))
    return KvPlan("two-phase-global", 8, 64, 3, wide(3, True))


def kv_blocked_scratch(b: int, h: int, nq: int, nk: int, d: int, dv: int,
                       fp32: bool = False) -> int:
    """bf16 elements of the kernel's scratch: q, k and v of every (b, h) as
    rows padded to multiples of 16 columns, as the layout pass writes them;
    under the ``two-phase-global`` plan then each block's bf16 p (64 rows x
    the keys padded to 64) and fp32 alpha (two bf16 elements each). With
    ``fp32``, fp32 elements of the fp32 route's: none in one pass (q, k and
    v are read in place); in two phases each block's p (32 rows x the keys
    padded to 64) and alpha (a value for each chunk and row)."""
    if fp32:
        if _kv_blocked_layout_f32(d, dv).variant == "f32-one-pass":
            return 0
        blocks, nc = b * h * -(-nq // KV_F32_ROWS), -(-nk // KV_CHUNK)
        return blocks * KV_F32_ROWS * nc * KV_CHUNK + blocks * nc * KV_F32_ROWS
    dp, dvp = round_up(d, 16), round_up(dv, 16)
    elems = b * h * (nq * dp + nk * dp + nk * dvp)
    if kv_blocked_layout(nk, d, dv).variant == "two-phase-global":
        blocks, nc = b * h * -(-nq // 64), -(-nk // KV_CHUNK)
        elems += blocks * 64 * nc * KV_CHUNK + 2 * blocks * nc * 64
    return elems


def reference_attention(q, k, v, bias=None, scale=None, mask_self=False):
    """Plain PyTorch twin (``vit_tpu``'s ``reference_attention``):
    ``[B, H, Nq, D]``, ``[B, H, Nk, D]``, ``[B, H, Nk, Dv]`` -> ``[B, H, Nq,
    Dv]`` in v's dtype; ``bias`` broadcastable to ``[B, H, Nq, Nk]``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _mm(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if mask_self:
        nq, nk = s.shape[-2:]
        s = s.masked_fill(torch.eye(nq, nk, dtype=torch.bool, device=s.device), MASK_VALUE)
    p = _softmax(s)
    return _mm(p.to(v.dtype), v, v.dtype)


def reference_attention_kv_blocked(q, k, v, bias=None, scale=None, mask_self=False,
                                   block_k=None):
    """Plain PyTorch twin of the kv-blocked kernel (``vit_tpu``'s
    ``_kv_blocked_kernel``, op for op), over chunks of ``block_k`` keys
    (default JAX's ``min(512, round_up(Nk, 128))``): fp32 scores ``* scale``
    ``+ bias``, the ``mask_self`` diagonal set to ``MASK_VALUE``; ``m_new =
    max(m, rowmax s)``, ``alpha = exp(m - m_new)``, ``p = exp(s - m_new)``,
    ``l = alpha * l + rowsum p``, ``acc = acc * alpha + p.to(v.dtype) @ v``
    in fp32; ``acc / l`` rounded once to v's dtype. A chunk's padded keys
    (past Nk) would score ``MASK_VALUE`` and add 0 to l and acc, so they are
    left out."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    if block_k is None:
        block_k = min(512, round_up(nk, 128))
    m = torch.full((b, h, nq, 1), -float("inf"), device=q.device)
    l = torch.zeros((b, h, nq, 1), device=q.device)
    acc = torch.zeros((b, h, nq, v.shape[3]), device=q.device)
    rows = torch.arange(nq, device=q.device)[:, None]
    for k0 in range(0, nk, block_k):
        kb, vb = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        s = _mm(q, kb.transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[..., k0:k0 + block_k].float()
        if mask_self:
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
            s = s.masked_fill(rows == cols, MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _mm(p.to(v.dtype), vb)
        m = m_new
    return (acc / l).to(v.dtype)


def _check_operands(name, q, k, v, bias):
    """Shapes, dtypes and devices of a flash kernel's operands (q, k, v all
    bf16, or all fp32); returns (b, h, nq, nk, d, dv, the bias as contiguous
    fp32 or None, bias_b, bias_h)."""
    _build.refuse_grad(name, q, k, v, bias)
    if not q.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, N, D], got {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be all bf16 or all fp32, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, h, nq, d = q.shape
    nk, dv = k.shape[2], v.shape[3]
    if tuple(k.shape) != (b, h, nk, d) or tuple(v.shape) != (b, h, nk, dv) or nq < 1 or nk < 1:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k, v must be on one device")
    bias_b = bias_h = 0
    if bias is not None:
        if bias.dim() != 4 or tuple(bias.shape[2:]) != (nq, nk) or bias.shape[0] not in (1, b) \
                or bias.shape[1] not in (1, h):
            raise ValueError(f"bias must be [1|{b}, 1|{h}, {nq}, {nk}], got {tuple(bias.shape)}")
        if bias.device != q.device:
            raise ValueError("bias must be on q's device")
        bias = bias.float().contiguous()
        bias_b, bias_h = int(bias.shape[0] == b and b > 1), int(bias.shape[1] == h and h > 1)
    return b, h, nq, nk, d, dv, bias, bias_b, bias_h


def _launch(name, entry, q, k, v, bias, bias_b, bias_h, scale, mask_self, scratch=None):
    b, h, nq, d = q.shape
    nk, dv = k.shape[2], v.shape[3]
    lib = _build.load_library()
    out = torch.empty(b, nq, h, dv, device=q.device, dtype=v.dtype).transpose(1, 2)
    strides = lambda t: (t.data_ptr(), *t.stride()[:3])
    extra = () if scratch is None else (scratch.data_ptr(),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            *strides(q), *strides(k), *strides(v), *strides(out),
            b, h, nq, nk, d, dv, float(d**-0.5 if scale is None else scale),
            None if bias is None else bias.data_ptr(), bias_b, bias_h, int(mask_self), *extra,
            stream,
        )
    _build.check(lib, rc, f"{name} kernel")
    _build.count_launch(name, fp32=q.dtype == torch.float32)
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_self: bool = False,
) -> torch.Tensor:
    """Attention of ``q`` ``[B, H, Nq, D]`` against ``k`` ``[B, H, Nk, D]``
    and ``v`` ``[B, H, Nk, Dv]``, bf16, or fp32 (the fp32 route, on the fp32
    core ``csrc/attention_f32.cuh``: every product fp32, P kept in fp32),
    on the card; an optional additive bias broadcastable as ``[B|1, H|1,
    Nq, Nk]`` (fp32 in the kernel); ``mask_self`` masks the diagonal ``col
    == row``. The operands are read through their strides (unit column
    stride, 16-byte aligned rows: the ``split_heads`` views of ``[B, N,
    H*D]`` rows need no copy). Returns ``[B, H, Nq, Dv]`` in v's dtype, laid
    out ``[B, Nq, H, Dv]`` in memory so that merging the heads is a view;
    computed on the current stream."""
    b, h, nq, nk, d, dv, bias, bias_b, bias_h = _check_operands("flash_attention", q, k, v, bias)
    check_core_shape(nk, d, dv)
    step = 16 // q.element_size()  # elements in 16 bytes
    if any(t.stride(-1) != 1 or any(s % step for s in t.stride()[:3]) or t.data_ptr() % 16
           for t in (q, k, v)):
        raise ValueError("q, k, v must have unit column stride and 16-byte aligned rows")
    entry = "vt_flash_attention_f32" if q.dtype == torch.float32 else "vt_flash_attention"
    return _launch("flash_attention", entry, q, k, v, bias, bias_b, bias_h, scale, mask_self)


def flash_attention_kv_blocked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    mask_self: bool = False,
) -> torch.Tensor:
    """The online-softmax kernel on the card, with ``flash_attention``'s
    contract: q, k, v all bf16 or all fp32, read through their strides, an
    optional fp32 bias ``[B|1, H|1, Nq, Nk]``, ``mask_self``; returns ``[B,
    H, Nq, Dv]`` in v's dtype laid out ``[B, Nq, H, Dv]``. Rows need unit
    column stride and element alignment only. bf16: the kernel's layout pass
    first copies q, k and v into scratch rows padded to multiples of 16
    columns (``kv_blocked_scratch``), so the ``split_heads`` views of T2T's
    fused qkv rows need no copy here; p is rounded to bf16, as the TPU
    kernel rounds it to v's dtype. fp32 (the TPU kernel's
    ``Precision.HIGHEST``): the fp32 route reads q, k and v in place, every
    product fp32 on the CUDA cores, p never rounded; its scratch holds p
    and alpha where Dv is too wide for one pass. Any D, Dv and Nk
    (``kv_blocked_layout``), while B*H times the blocks of a (b, h) and
    B*H*max(Nq, Nk) stay within 2^31 - 1 (the kernel's int indices). Its
    twin at ``block_k=KV_CHUNK`` rounds p at the same places (in fp32, at
    none)."""
    b, h, nq, nk, d, dv, bias, bias_b, bias_h = _check_operands(
        "flash_attention_kv_blocked", q, k, v, bias)
    fp32 = q.dtype == torch.float32
    rows = kv_blocked_layout(nk, d, dv, fp32=fp32).rows
    if b * h * -(-nq // rows) > 2**31 - 1 or b * h * max(nq, nk) > 2**31 - 1:
        raise NotImplementedError(
            f"B*H = {b * h} with Nq = {nq}, Nk = {nk}: the kv-blocked kernel indexes its blocks "
            f"and its padded rows with 32-bit ints, and these exceed 2^31 - 1")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must have unit column stride")
    scratch = torch.empty(kv_blocked_scratch(b, h, nq, nk, d, dv, fp32=fp32), device=q.device,
                          dtype=q.dtype)
    entry = "vt_flash_attention_kv_blocked_f32" if fp32 else "vt_flash_attention_kv_blocked"
    return _launch("flash_attention_kv_blocked", entry, q, k, v, bias, bias_b, bias_h, scale,
                   mask_self, scratch)


def _flash_fake(q, k, v, bias, scale, mask_self):
    """The output as each implementation lays it out: the kernels write
    ``[B, Nq, H, Dv]`` and return its ``[B, H, Nq, Dv]`` view; the twins a
    contiguous ``[B, H, Nq, Dv]``."""
    b, h, nq, _ = q.shape
    dv = v.shape[3]
    if q.device.type == "cuda":
        return v.new_empty(b, nq, h, dv).transpose(1, 2)
    return v.new_empty(b, h, nq, dv)


_FLASH_SCHEMA = "(Tensor q, Tensor k, Tensor v, Tensor? bias, float scale, bool mask_self) -> Tensor"
flash_attention_op = _build.define_op(
    "flash_attention" + _FLASH_SCHEMA,
    cuda=flash_attention, cpu=reference_attention, fake=_flash_fake,
)
flash_attention_kv_blocked_op = _build.define_op(
    "flash_attention_kv_blocked" + _FLASH_SCHEMA,
    cuda=flash_attention_kv_blocked, cpu=reference_attention_kv_blocked, fake=_flash_fake,
)


def kernel_name(nk: int, d: int, dv: int) -> str:
    """The kernel ``ops.attention`` runs at this shape: the resident-K/V
    kernel where its core takes it (``core_fits``), else the kv-blocked
    one. The one place that choice is made."""
    return "flash_attention" if core_fits(nk, d, dv) else "flash_attention_kv_blocked"


def query_chunk(t, r0: int, chunk: int):
    """Rows ``r0 .. r0 + chunk`` of ``t``'s query axis (dim 2), zero rows
    past its end: every chunk of the backward has ``chunk`` rows, as
    ``_flash_bwd`` pads q, g, out and the bias to whole chunks. (Its
    ``dynamic_slice`` would otherwise clamp the last chunk's start and read
    earlier rows again, ``vit_tpu/ops/flash_attention.py:545-547``.)"""
    part = t[:, :, r0:r0 + chunk]
    pad = chunk - part.shape[2]
    return torch.nn.functional.pad(part, (0, 0, 0, pad)) if pad else part


def _bmm_f32(a, b):
    """``a @ b`` over ``[n, i, k] x [n, k, j]`` with fp32 sums and an fp32
    result: two bf16 operands on the card are one cuBLAS bf16 GEMM that
    writes fp32, issued under ``fp32_bf16_sums`` (JAX's
    ``preferred_element_type=f32``); anything else an fp32 product."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        with fp32_bf16_sums():
            return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def flash_backward(q, k, v, bias, out, g, scale, mask_self=False):
    """Gradients ``(dq, dk, dv, dbias)`` of ``attention(q, k, v, bias)`` at
    the cotangent ``g``, from the forward's ``out``: ``vit_tpu``'s
    ``_flash_bwd`` (``vit_tpu/ops/flash_attention.py:509-597``), the
    backward of kernels 4 and 5, line by line.

    The queries run in chunks of ``min(BLOCK_Q, Nq)`` rows (``query_chunk``
    pads the last). A chunk's scores ``s`` are q times k in their own dtype
    summed in fp32 (``_bmm_f32``), ``* scale``, ``+ bias`` in fp32, the
    ``mask_self`` diagonal at ``MASK_VALUE``; ``p = softmax(s)`` in
    ``jax.nn.softmax``'s order. With g and out in fp32: ``dV += pᵀ g``,
    ``dP = g vᵀ``, ``delta = rowsum(g ∘ out)``, ``dS = p ∘ (dP - delta)``,
    ``dQ = scale · dS k``, ``dK += scale · dSᵀ q``, every product but the
    scores' of fp32 operands; ``dbias`` is ``dS`` summed over the bias's
    broadcast axes (``B|1``, ``H|1``). dK and dV add up in fp32 over the
    chunks; each gradient is cast once to its input's dtype. ``dbias`` is
    None without a bias. The extra memory is a few ``B * H * chunk * Nk``
    fp32 tensors (the scores and dP of one chunk), and fp32 copies of k, v,
    dK and dV."""
    b, h, nq, d = q.shape
    nk, dv = k.shape[2], v.shape[3]
    bh = b * h
    chunk = min(BLOCK_Q, nq)
    kt = k.reshape(bh, nk, d).transpose(1, 2)
    kf = k.float().reshape(bh, nk, d)
    vf = v.float().reshape(bh, nk, dv)
    dk = torch.zeros(bh, nk, d, device=q.device)
    dvv = torch.zeros(bh, nk, dv, device=q.device)
    dq = torch.empty(b, h, nq, d, device=q.device, dtype=q.dtype)
    db = None
    if bias is not None:
        db = torch.empty(bias.shape[0], bias.shape[1], nq, nk, device=q.device)
    cols = torch.arange(nk, device=q.device)
    for r0 in range(0, nq, chunk):
        rows = min(chunk, nq - r0)
        qc = query_chunk(q, r0, chunk).reshape(bh, chunk, d)
        gc = query_chunk(g, r0, chunk).float().reshape(bh, chunk, dv)
        oc = query_chunk(out, r0, chunk).float().reshape(bh, chunk, dv)
        s = _bmm_f32(qc, kt).mul_(scale).view(b, h, chunk, nk)
        if bias is not None:
            s.add_(query_chunk(bias, r0, chunk).float())
        if mask_self:
            diag = (torch.arange(r0, r0 + chunk, device=q.device)[:, None] == cols[None, :])
            s.masked_fill_(diag, MASK_VALUE)
        p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()  # jax.nn.softmax, in place
        p = p.div_(p.sum(dim=-1, keepdim=True)).view(bh, chunk, nk)
        dvv.baddbmm_(p.transpose(1, 2), gc)
        ds = torch.bmm(gc, vf.transpose(1, 2))  # dP
        ds.sub_((gc * oc).sum(dim=-1, keepdim=True)).mul_(p)  # p * (dP - delta)
        del p, s
        dq[:, :, r0:r0 + rows] = torch.bmm(ds, kf).mul_(scale).view(
            b, h, chunk, d)[:, :, :rows].to(q.dtype)
        dk.baddbmm_(ds.transpose(1, 2), qc.float(), alpha=scale)
        if db is not None:
            dbc = ds.view(b, h, chunk, nk)
            if bias.shape[0] == 1:
                dbc = dbc.sum(dim=0, keepdim=True)
            if bias.shape[1] == 1:
                dbc = dbc.sum(dim=1, keepdim=True)
            db[:, :, r0:r0 + rows] = dbc[:, :, :rows]
        del ds
    return (dq, dk.view(b, h, nk, d).to(k.dtype), dvv.view(b, h, nk, dv).to(v.dtype),
            None if db is None else db.to(bias.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """Kernels 4 and 5 as an autograd Function (``vit_tpu``'s
    ``_flash_attention_ad`` and ``_flash_kv_blocked_ad``,
    ``vit_tpu/ops/flash_attention.py:447-600``).

    Forward: ``forward_fn`` (on the main path the kernel ``ops.attention``
    picks, ``flash_attention`` or ``flash_attention_kv_blocked``; a CPU test
    passes a twin), saving ``(q, k, v, bias, out)`` as ``_flash_fwd`` does:
    ``out`` stands in for the softmax statistics (``delta``). Backward:
    ``flash_backward`` at the cotangent, counted as a recompute of the
    kernel the shape dispatches to (``kernel_name``).

    ``apply(forward_fn, q, k, v, bias, scale, mask_self)``."""

    @staticmethod
    def forward(ctx, forward_fn, q, k, v, bias, scale, mask_self):
        out = forward_fn(q, k, v, bias, scale, mask_self)
        ctx.save_for_backward(q, k, v, bias, out)
        ctx.config = (scale, mask_self)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out = ctx.saved_tensors
        scale, mask_self = ctx.config
        grads = flash_backward(q, k, v, bias, out, g, scale, mask_self)
        _build.count_recompute(kernel_name(k.shape[2], q.shape[3], v.shape[3]))
        need = ctx.needs_input_grad[1:5]
        return (None, *(t if n else None for t, n in zip(grads, need)), None, None)
