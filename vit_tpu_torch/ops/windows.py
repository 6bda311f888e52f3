"""Window and block partitions and their inverses (port of
``vit_tpu/ops/windows.py:16-72``).

Layout only (``reshape`` / ``permute`` / ``contiguous``): windows fold into
the leading axis, so the window attention block sees ``[B * windows, S, C]``;
NesT's blocks keep their spatial layout, ``[B * blocks, H/n, W/n, C]``.
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


def block_partition(x: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """NesT's block split ``[B, H, W, C] -> [B*n*n, H/n, W/n, C]``: each
    block keeps its spatial layout."""
    b, h, w, c = x.shape
    bh, bw = h // n_blocks, w // n_blocks
    x = x.reshape(b, n_blocks, bh, n_blocks, bw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * n_blocks * n_blocks, bh, bw, c)


def block_unpartition(x: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Inverse of :func:`block_partition`."""
    bn, bh, bw, c = x.shape
    b = bn // (n_blocks * n_blocks)
    x = x.reshape(b, n_blocks, n_blocks, bh, bw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, n_blocks * bh, n_blocks * bw, c)
