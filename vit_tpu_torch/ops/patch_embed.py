"""Patch extraction and the fixed positional embedding (port of
``vit_tpu/ops/patch_embed.py``: ``patchify``, ``unpatchify``, ``extract_patches``,
``spt_shifts`` and ``posemb_sincos_2d``). Plain PyTorch and numpy: none is a Pallas kernel in
``vit_tpu``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def patchify(x: torch.Tensor, patch_h: int, patch_w: int | None = None) -> torch.Tensor:
    """``[B, H, W, C] -> [B, (H/ph)*(W/pw), ph*pw*C]`` non-overlapping patches,
    features in einops ``'b (h p1) (w p2) c -> b (h w) (p1 p2 c)'`` order, so
    projection weights are interchangeable with ``vit_tpu``'s."""
    patch_w = patch_w if patch_w is not None else patch_h
    b, h, w, c = x.shape
    gh, gw = h // patch_h, w // patch_w
    x = x.reshape(b, gh, patch_h, gw, patch_w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_h * patch_w * c)


def unpatchify(x: torch.Tensor, grid_h: int, grid_w: int, patch_h: int, patch_w: int,
               c: int) -> torch.Tensor:
    """The inverse of :func:`patchify`: ``[B, gh*gw, ph*pw*C] -> [B, gh*ph,
    gw*pw, C]``."""
    b = x.shape[0]
    x = x.reshape(b, grid_h, grid_w, patch_h, patch_w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid_h * patch_h, grid_w * patch_w, c)


def extract_patches(x: torch.Tensor, kernel: int, stride: int, padding: str = "SAME") -> torch.Tensor:
    """Overlapping ``kernel`` x ``kernel`` patches at ``stride``, as
    ``tf.image.extract_patches`` and ``vit_tpu``'s ``extract_patches``:
    ``[B, H, W, C] -> [B, Ho, Wo, kernel*kernel*C]``, features ordered (row,
    col, channel). ``SAME`` pads with zeros as TF does (a total of ``max((out
    - 1) * stride + kernel - n, 0)`` per axis, the smaller half before);
    ``VALID`` takes only whole windows. A gather, so bitwise equal to both."""
    b, h, w, c = x.shape
    if padding == "SAME":
        pads = []
        for n in (w, h):  # F.pad takes the last axis first
            total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x.permute(0, 3, 1, 2), pads)
    elif padding == "VALID":
        x = x.permute(0, 3, 1, 2)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    cols = F.unfold(x, kernel, stride=stride)  # [B, C*k*k, L], features (c, kh, kw)
    ho = (x.shape[2] - kernel) // stride + 1
    wo = (x.shape[3] - kernel) // stride + 1
    cols = cols.reshape(b, c, kernel * kernel, ho, wo).permute(0, 3, 4, 2, 1)
    return cols.reshape(b, ho, wo, kernel * kernel * c)


def spt_shifts(x: torch.Tensor) -> torch.Tensor:
    """Shifted Patch Tokenization's input expansion: the image and four
    zero-filled 1-px axis-aligned shifts of it, concatenated on channels in
    ``vit_tpu``'s order [x, right, left, down, up]: ``[B, H, W, C] -> [B, H,
    W, 5C]``. A gather, so bitwise equal to ``vit_tpu``'s."""
    h, w = x.shape[1], x.shape[2]
    pieces = [x]
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):  # (rows, columns) moved
        # F.pad takes the last axis first: channels, then columns, then rows
        padded = F.pad(x, (0, 0, max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)))
        y0, x0 = max(-dy, 0), max(-dx, 0)
        pieces.append(padded[:, y0:y0 + h, x0:x0 + w, :])
    return torch.cat(pieces, dim=-1)


def posemb_sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                     dtype=torch.float32) -> torch.Tensor:
    """Fixed 2-D sin-cos positional embedding ``[h*w, dim]`` (SimpleViT's),
    on the CPU. Computed in numpy float64 and cast once to ``dtype``, as
    ``vit_tpu``'s is, so the two are bitwise equal."""
    if dim % 4:
        raise ValueError(f"the sin-cos embedding needs dim % 4 == 0, got {dim}")
    y, x = np.mgrid[:h, :w]
    omega = np.arange(dim // 4) / (dim // 4 - 1)
    omega = 1.0 / (temperature**omega)
    y = y.flatten()[:, None] * omega[None, :]
    x = x.flatten()[:, None] * omega[None, :]
    pe = np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)], axis=1)
    return torch.from_numpy(pe).to(dtype)
