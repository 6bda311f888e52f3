"""Window partitions and their inverses (port of ``vit_tpu/ops/windows.py:16-53``).

Layout only (``reshape`` / ``permute`` / ``contiguous``): windows fold into
the leading axis, so the window attention block sees ``[B * windows, S, C]``.
"""

from __future__ import annotations

import torch


def window_partition(x: torch.Tensor, wsz: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B*nh*nw, wsz*wsz, C]`` contiguous windows."""
    b, h, w, c = x.shape
    nh, nw = h // wsz, w // wsz
    x = x.reshape(b, nh, wsz, nw, wsz, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, wsz * wsz, c)


def window_unpartition(x: torch.Tensor, wsz: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    nh, nw = h // wsz, w // wsz
    b = x.shape[0] // (nh * nw)
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, wsz, wsz, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def dilated_partition(x: torch.Tensor, wsz: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B*gh*gw, wsz*wsz, C]`` dilated (long-distance)
    windows: each window takes tokens strided by (H/wsz, W/wsz)."""
    b, h, w, c = x.shape
    gh, gw = h // wsz, w // wsz
    x = x.reshape(b, wsz, gh, wsz, gw, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b * gh * gw, wsz * wsz, c)


def dilated_unpartition(x: torch.Tensor, wsz: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`dilated_partition`."""
    gh, gw = h // wsz, w // wsz
    b = x.shape[0] // (gh * gw)
    c = x.shape[-1]
    x = x.reshape(b, gh, gw, wsz, wsz, c).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, h, w, c)
