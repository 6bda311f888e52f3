"""Patch embedding and the flax-named parameter containers (port of
``vit_tpu/nn/embed.py:PatchEmbed``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.ops.block_attention import _ln_f32


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=float32)``: fp32 ``x @ kernel + bias``, with the
    kernel in flax's ``[in, out]`` layout (not ``nn.Linear``'s ``[out, in]``)."""

    def __init__(self, features_in: int, features: int, *, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(features_in, features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return torch.matmul(x.float(), self.kernel) + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: the fast-variance formula in fp32."""

    def __init__(self, dim: int, *, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return _ln_f32(x.float(), self.scale, self.bias, self.eps)


class PatchEmbed(nn.Module):
    """Non-overlapping patchify + fp32 projection, rounded once to
    ``out_dtype`` (the stream dtype; None keeps fp32). The GEMM is a plain
    ``torch.matmul``: it lies outside every TPU kernel."""

    def __init__(self, dim: int, patch_size: int, channels: int = 3, *,
                 out_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.out_dtype = out_dtype
        self.proj = Dense(patch_size * patch_size * channels, dim, device=device)

    def forward(self, img):
        x = self.proj(ops.patchify(img, self.patch_size))
        return x.to(self.out_dtype) if self.out_dtype is not None else x
