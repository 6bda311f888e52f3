"""Fused self-attention block: LN -> qkv GEMM -> softmax attention -> out
GEMM -> +residual.

Port of ``vit_tpu/ops/block_attention.py``. ``fused_attention_block`` is the
Hopper kernel (``csrc/attention_block.cu``); ``xla_attention_block`` is its
plain PyTorch twin, which mirrors the JAX twin op for op: flax LayerNorm in
fp32, fp32 products of bf16-rounded operands (JAX's
``preferred_element_type=f32``), the same bf16 rounding sites, and
``jax.nn.softmax``'s max / exp / sum / divide order.

The TPU kernel keeps Wqkv and Wout resident in VMEM across the whole batch.
On Hopper that does not fit in shared memory, so the kernel splits at its
GEMM boundaries and stores only the tensors the TPU kernel itself rounds to
bf16 before their next use (``xn``, qkv, the attention output): the math is
unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_tpu_torch.ops import _build

MASK_VALUE = -1e30
MAX_TOKENS = 1024  # the score rows of one query tile live in shared memory


def _ln_f32(x, scale, bias, eps=1e-6):
    # flax.linen.LayerNorm's exact op sequence (fast variance, scale folded
    # into the rsqrt multiplier), as vit_tpu/ops/block_attention.py:_ln_f32.
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale
    return (x - mean) * mul + bias


def _mm(a, b, dtype=torch.float32):
    """fp32 product of operands already rounded to their storage dtype.
    (A bf16 matmul on the CPU rounds its output to bf16; JAX's
    ``preferred_element_type=f32`` does not.)"""
    return torch.matmul(a.float(), b.float()).to(dtype)


def key_mask(n: int, true_n: Optional[int], block_tokens: Optional[int], device):
    """``[n, n]`` bool mask of visible keys, or None when every key is
    visible: padded key columns (``col % bt >= true_n``) are hidden and, for a
    sample-packed stream (``bt < n``), keys of other samples too."""
    bt = block_tokens if block_tokens is not None else n
    if not ((true_n is not None and true_n != bt) or bt != n):
        return None
    cols = torch.arange(n, device=device)
    ok = (cols % bt < (true_n if true_n is not None else bt))[None, :].expand(n, n)
    if bt != n:
        ok = ok & ((cols[None, :] // bt) == (cols[:, None] // bt))
    return ok


def xla_attention_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, heads, scale, ln_eps=1e-6,
    true_n=None, block_tokens=None,
):
    """Plain PyTorch twin of the fused kernel (``vit_tpu``'s
    ``xla_attention_block``): ``x + out_proj(attention(qkv_proj(LN(x))))``
    in the dtype of ``x``."""
    b, n, dim = x.shape
    hd = wqkv.shape[1] // 3
    d = hd // heads
    xn = _ln_f32(x.float(), ln_scale.float(), ln_bias.float(), ln_eps).to(wqkv.dtype)
    qkv = _mm(xn, wqkv, wqkv.dtype)
    q, k, v = qkv.split(hd, dim=-1)
    split = lambda t: t.reshape(b, n, heads, d).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    s = _mm(q, k.transpose(-1, -2)) * scale
    ok = key_mask(n, true_n, block_tokens, x.device)
    if ok is not None:
        s = torch.where(ok, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    o = _mm(p.to(v.dtype), v, v.dtype)
    o = o.transpose(1, 2).reshape(b, n, hd).to(wout.dtype)
    out = _mm(o, wout) + bout.float() + x.float()
    return out.to(x.dtype)


def fused_attention_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    heads: int,
    *,
    scale: Optional[float] = None,
    ln_eps: float = 1e-6,
    true_n: Optional[int] = None,
    block_tokens: Optional[int] = None,
) -> torch.Tensor:
    """``x + out_proj(attention(qkv_proj(LN(x))))`` on the card.

    ``x`` ``[B, N, D]`` bf16 or fp32 (the mixed config's fp32 residual
    stream); ``wqkv`` ``[D, 3*H*Dh]`` and ``wout`` ``[H*Dh, D]`` bf16;
    ``ln_scale``, ``ln_bias`` and ``bout`` fp32 ``[D]``. ``true_n`` and
    ``block_tokens`` mask keys exactly as the twin does. Returns a new
    tensor of ``x``'s shape and dtype, computed on the current stream.
    """
    if not x.is_cuda:
        raise ValueError("fused_attention_block takes CUDA tensors")
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be [B, N, D] bf16 or fp32, got {tuple(x.shape)} {x.dtype}")
    if wqkv.dtype != torch.bfloat16 or wout.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the attention-block kernel takes bf16 weights (got {wqkv.dtype}, "
            f"{wout.dtype}); fp32 weights run only on the plain twin"
        )
    b, n, dim = x.shape
    hd = wqkv.shape[1] // 3
    if heads <= 0 or hd % heads:
        raise ValueError(f"{wqkv.shape[1]} qkv columns do not split into {heads} heads")
    d = hd // heads
    if tuple(wqkv.shape) != (dim, 3 * hd) or tuple(wout.shape) != (hd, dim):
        raise ValueError(f"weights {tuple(wqkv.shape)}, {tuple(wout.shape)} do not fit D={dim}")
    for name, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias), ("bout", bout)):
        if t.dtype != torch.float32 or tuple(t.shape) != (dim,):
            raise TypeError(f"{name} must be fp32 [{dim}], got {tuple(t.shape)} {t.dtype}")
    tensors = (x, ln_scale, ln_bias, wqkv, wout, bout)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if d % 16 or d > 128 or dim % 8:
        raise ValueError(f"the kernel takes dim_head % 16 == 0, <= 128 and D % 8 == 0 (got {d}, {dim})")
    if n > MAX_TOKENS:
        raise NotImplementedError(
            f"n={n} > {MAX_TOKENS}: long sequences need the kv-blocked kernel "
            "(ROADMAP.md Queue 2 item 5)"
        )
    if b * heads > 65535:
        raise ValueError(f"batch x heads = {b * heads} > 65535 (one CUDA grid dimension)")
    if block_tokens is not None and (true_n is None or n % block_tokens):
        raise ValueError("block_tokens needs true_n and must divide n")
    if scale is None:
        scale = d ** -0.5
    true_n = n if true_n is None else true_n
    bt = n if block_tokens is None else block_tokens

    lib = _build.load_library()
    rows = b * n
    opts = dict(device=x.device, dtype=torch.bfloat16)
    xn = torch.empty(rows, dim, **opts)
    qkv = torch.empty(rows, 3 * hd, **opts)
    attn = torch.empty(rows, hd, **opts)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vt_attention_block(
            x.data_ptr(), int(x.dtype == torch.float32),
            ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(),
            out.data_ptr(), xn.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
            b, n, dim, heads, d, float(scale), float(ln_eps), true_n, bt, stream,
        )
    _build.check(lib, rc, "attention_block kernel")
    _build.count_launch("attention_block")
    return out
