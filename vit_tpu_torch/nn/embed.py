"""Patch embedding, the flax-named parameter containers and the token mean
(port of ``vit_tpu/nn/embed.py:PatchEmbed``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.ops.block_attention import _ln_f32, _mm


class Dense(nn.Module):
    """flax ``nn.Dense``, with the kernel in flax's ``[in, out]`` layout (not
    ``nn.Linear``'s ``[out, in]``) and fp32 parameters. ``dtype`` (None:
    fp32, what flax infers from fp32 parameters) is the computation dtype:
    the input and the kernel are cast to it, the product is rounded once to
    it, and the bias is cast to it and added in it. With ``dtype=bfloat16``
    the bias add is a bf16 add, unlike the raw-parameter blocks' fp32 bias."""

    def __init__(self, features_in: int, features: int, *, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.kernel = nn.Parameter(torch.zeros(features_in, features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x):
        y = _mm(x.to(self.dtype), self.kernel.to(self.dtype), self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype, use_bias=use_bias)``: the statistics
    and the fast-variance normalisation in fp32, the output cast to ``dtype``
    (None: fp32, what flax infers from fp32 parameters). Without a bias
    there is no ``bias`` parameter and nothing is added."""

    def __init__(self, dim: int, *, eps: float = 1e-6, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device)) if use_bias else None

    def forward(self, x):
        y = _ln_f32(x.float(), self.scale, 0.0 if self.bias is None else self.bias, self.eps)
        return y if self.dtype is None else y.to(self.dtype)


def mean_tokens(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=1)``: the tokens summed in fp32, divided by their
    count in fp32, rounded once to ``x``'s dtype (the mean pool)."""
    return (x.float().sum(dim=1) / x.shape[1]).to(x.dtype)


class PatchEmbed(nn.Module):
    """Non-overlapping patchify + fp32 projection, rounded once to
    ``out_dtype`` (the stream dtype; None keeps fp32). The GEMM is a plain
    ``torch.matmul``: it lies outside every TPU kernel."""

    def __init__(self, dim: int, patch_size: int, channels: int = 3, *,
                 out_dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.patch_size = patch_size
        self.out_dtype = out_dtype
        self.proj = Dense(patch_size * patch_size * channels, dim, device=device)

    def forward(self, img):
        x = self.proj(ops.patchify(img, self.patch_size))
        return x.to(self.out_dtype) if self.out_dtype is not None else x
