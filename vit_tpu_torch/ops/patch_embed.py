"""Patch extraction (port of ``vit_tpu/ops/patch_embed.py:patchify``)."""

from __future__ import annotations

import torch


def patchify(x: torch.Tensor, patch_h: int, patch_w: int | None = None) -> torch.Tensor:
    """``[B, H, W, C] -> [B, (H/ph)*(W/pw), ph*pw*C]`` non-overlapping patches,
    features in einops ``'b (h p1) (w p2) c -> b (h w) (p1 p2 c)'`` order, so
    projection weights are interchangeable with ``vit_tpu``'s."""
    patch_w = patch_w if patch_w is not None else patch_h
    b, h, w, c = x.shape
    gh, gw = h // patch_h, w // patch_w
    x = x.reshape(b, gh, patch_h, gw, patch_w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_h * patch_w * c)
