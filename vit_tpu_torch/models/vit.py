"""ViT — the vanilla Dosovitskiy encoder (port of ``vit_tpu/models/vit.py``).

Parameters are zeros and ones at construction; load weights with
``load_state_dict`` (``vit_tpu_torch.utils.from_jax_params`` converts a
``vit_tpu`` variables tree).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.blocks import Transformer
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed


class ViT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` fp32 logits.

    ``dtype``: the GEMM operand dtype of the encoder (None: the input's).
    ``residual_dtype``: the residual stream's dtype when it differs (the
    mixed config: ``dtype=bfloat16, residual_dtype=float32``).
    """

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls", dim_head: int = 64,
                 channels: int = 3, activation: str = "gelu", norm_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None,
                 residual_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        if ph != pw:
            raise ValueError("square patches only")
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.pool = pool
        num_patches = (ih // ph) * (iw // pw)
        self.patch_embed = PatchEmbed(dim, ph, channels, out_dtype=residual_dtype or dtype,
                                      device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim, device=device))
        self.encoder = Transformer(dim, depth, heads, dim_head, mlp_dim, activation=activation,
                                   norm_eps=norm_eps, dtype=dtype, device=device)
        self.head_norm = LayerNorm(dim, eps=norm_eps, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(img)
        b, _, dim = x.shape
        cls = self.cls.to(x.dtype).expand(b, 1, dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(x.dtype)
        x = self.encoder(x)
        x = x[:, 0] if self.pool == "cls" else x.mean(dim=1)
        return self.head(self.head_norm(x))
