"""Multi-head attention with separate q, k, v, a bias and the LSA diagonal.

Port of the resident-K/V kernel of ``vit_tpu/ops/flash_attention.py``
(``_attn_kernel``). ``flash_attention`` is the Hopper kernel
(``csrc/flash_attention.cu``, on the attention core the other attention
kernels share); ``reference_attention`` is its plain PyTorch twin and mirrors
JAX's op for op: fp32 scores of the stored operands, ``* scale``, ``+ bias``
in fp32, the ``mask_self`` diagonal set to ``MASK_VALUE``,
``jax.nn.softmax``'s max / exp / sum / divide order, P rounded to v's dtype
before the fp32 P @ V, one rounding to v's dtype.

The online-softmax kernel of the same file (``_kv_blocked_kernel``, the
long-context route) is not ported yet: shapes that would need it raise and
name its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_tpu_torch.core.utils import round_up
from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.block_attention import _mm, _softmax

# -0.7 * float32 max: the mask_self fill, as vit_tpu/ops/flash_attention.py:40
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_SMEM = 232448  # 227 KB, the most shared memory one block may use

_KV_BLOCKED = "needs the kv-blocked flash kernel, not ported yet (ROADMAP.md Queue 2 item 5)"


def smem_bytes(nk: int, d: int, dv: int) -> int:
    """Shared memory of one block of the attention core (``attention_core.cuh``
    ``layout``): a 32-row Q tile, a 64-key K/V chunk, the fp32 score rows
    over all ``nk`` keys and the bf16 P rows."""
    a = lambda v: round_up(v, 128)
    n_pad = round_up(nk, 64)
    ldq, ldkv, lds, ldp = d + 8, max(d, dv) + 8, max(n_pad, dv) + 4, n_pad + 8
    s_off = a(a(32 * ldq * 2) + 64 * ldkv * 2)
    return a(a(s_off + 32 * lds * 4) + 32 * ldp * 2)


def check_core_shape(nk: int, d: int, dv: int) -> None:
    """Raise for a shape the attention core cannot take."""
    if d % 16 or d > 128 or dv % 16 or dv > 128:
        raise NotImplementedError(
            f"head widths D={d}, Dv={dv}: the kernel takes multiples of 16 up to 128; "
            f"other widths {_KV_BLOCKED}")
    if smem_bytes(nk, d, dv) > MAX_SMEM:
        raise NotImplementedError(
            f"{nk} keys: the fp32 score rows of a query tile do not fit 227 KB of shared "
            f"memory; longer key sequences {_KV_BLOCKED}")


def reference_attention(q, k, v, bias=None, *, scale=None, mask_self=False):
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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    mask_self: bool = False,
) -> torch.Tensor:
    """Attention of ``q`` ``[B, H, Nq, D]`` against ``k`` ``[B, H, Nk, D]``
    and ``v`` ``[B, H, Nk, Dv]``, bf16, on the card; an optional additive
    bias broadcastable as ``[B|1, H|1, Nq, Nk]`` (fp32 in the kernel);
    ``mask_self`` masks the diagonal ``col == row``. The operands are read
    through their strides (unit column stride, 16-byte aligned rows: the
    ``split_heads`` views of ``[B, N, H*D]`` rows need no copy). Returns
    ``[B, H, Nq, Dv]`` bf16, laid out ``[B, Nq, H, Dv]`` in memory so that
    merging the heads is a view; computed on the current stream."""
    if not q.is_cuda:
        raise ValueError("flash_attention takes CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, N, D], got {q.shape}, {k.shape}, {v.shape}")
    if q.dtype == torch.float32:
        raise NotImplementedError(
            f"fp32 operands (the TPU kernel's Precision.HIGHEST) {_KV_BLOCKED}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, nq, d = q.shape
    nk, dv = k.shape[2], v.shape[3]
    if tuple(k.shape) != (b, h, nk, d) or tuple(v.shape) != (b, h, nk, dv) or nq < 1 or nk < 1:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    check_core_shape(nk, d, dv)
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k, v must be on one device")
    if any(t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16
           for t in (q, k, v)):
        raise ValueError("q, k, v must have unit column stride and 16-byte aligned rows")
    bias_b = bias_h = 0
    if bias is not None:
        if bias.dim() != 4 or tuple(bias.shape[2:]) != (nq, nk) or bias.shape[0] not in (1, b) \
                or bias.shape[1] not in (1, h):
            raise ValueError(f"bias must be [1|{b}, 1|{h}, {nq}, {nk}], got {tuple(bias.shape)}")
        if bias.device != q.device:
            raise ValueError("bias must be on q's device")
        bias = bias.float().contiguous()
        bias_b, bias_h = int(bias.shape[0] == b and b > 1), int(bias.shape[1] == h and h > 1)
    if scale is None:
        scale = d**-0.5

    lib = _build.load_library()
    out = torch.empty(b, nq, h, dv, device=q.device, dtype=v.dtype).transpose(1, 2)
    strides = lambda t: (t.data_ptr(), *t.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vt_flash_attention(
            *strides(q), *strides(k), *strides(v), *strides(out),
            b, h, nq, nk, d, dv, float(scale),
            None if bias is None else bias.data_ptr(), bias_b, bias_h, int(mask_self), stream,
        )
    _build.check(lib, rc, "flash_attention kernel")
    _build.count_launch("flash_attention")
    return out
