"""Int8 quantization primitives (port of ``vit_tpu/ops/quant.py``).

The repo's one symmetric recipe, kept exactly as the JAX package writes it:
  - ``scale = max(amax, 1e-12) / 127.0``, reduced over the given dims;
  - ``codes = clip(round(v / scale), -127, 127)``: a division (not a product
    with ``127 / amax``) and round half to even (``torch.round``);
  - weights per output channel, activations per row (dynamic).

``int8_matmul`` is an int8 x int8 -> int32 product with an fp32 epilogue.
In the JAX package it is an XLA ``dot_general``, not a Pallas kernel, so
here the product is ``torch._int_mm`` (cuBLASLt on the card). It is never a
float matmul of integer values: once ``K * 127^2 > 2^24`` such a sum is
inexact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize_symmetric(v: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 codes, fp32 scale)`` with ``v ~= codes * scale``; the scale
    keeps the reduced ``dims`` as size 1."""
    vf = v.float()
    return quantize_with_amax(vf, vf.abs().amax(dim=dims, keepdim=True))


def quantize_with_amax(vf: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recipe's codes and scale of fp32 ``vf`` given its ``amax``
    (reduced dims kept as size 1)."""
    # A tensor divisor, not the number 127.0: on CUDA, PyTorch divides by a
    # Python number as a product with its reciprocal, which is an ulp off the
    # true quotient for ~4% of values and then moves codes. full_like fills
    # on the device (a tensor made from a number would be a host copy).
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(vf / scale), -127, 127).to(torch.int8)
    return codes, scale


def quantize_channelwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 of a ``(..., K, N)`` weight: one scale per
    (leading index, N), the contraction axis reduced to 1."""
    return quantize_symmetric(w, -2)


def dequantize(w_i8: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (w_i8.float() * scale).to(dtype)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (per-token) dynamic int8 of ``(..., K)``; scale ``(..., 1)``."""
    return quantize_symmetric(x, -1)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 ``a [M, K]`` and ``b [K, N]``
    (``torch._int_mm``). On the card it wants M > 16 and K, N multiples of
    8, and it refused K = 32 and K = 64 on the H100; the int8 path's shapes
    (K = 1024 and 4096 at ViT-L, M = batch x 197) are all taken."""
    return torch._int_mm(a.contiguous(), b.contiguous())


def int8_matmul(
    x: torch.Tensor,
    w_i8: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x @ dequant(w)`` as int8 x int8 -> int32, with the JAX epilogue in
    its op order: ``acc * s_row * s_col`` (left to right), then ``+ bias``
    in fp32, then one cast. ``x`` ``(..., K)`` float; ``w_i8`` ``[K, N]``;
    ``w_scale`` ``[1, N]`` or ``[N]``."""
    x_i8, s_row = quantize_rows(x)
    lead = x.shape[:-1]
    acc = int_mm(x_i8.reshape(-1, x.shape[-1]), w_i8).reshape(*lead, w_i8.shape[1])
    out = acc.float() * s_row * w_scale.reshape(-1)
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype or x.dtype)
