"""Relative-position attention-bias tables (port of ``vit_tpu/nn/bias.py``):
LeViT's ``LeViTAttentionBias``, RegionViT's ``WindowRelPosBias`` and
``ReferenceWindowRelPosBias``, and CrossFormer's ``DynamicPositionBias``.

Each produces the additive fp32 ``bias`` that a window or attention kernel
adds to its scores. Plain PyTorch: ``vit_tpu`` computes the tables outside
every Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.nn.embed import Dense, LayerNorm


def _grid_coords(h: int, w: int) -> np.ndarray:
    """``[h*w, 2]`` (row, col) of an ``h`` x ``w`` grid, row-major."""
    y, x = np.mgrid[:h, :w]
    return np.stack([y.flatten(), x.flatten()], axis=-1)


class Embed(nn.Module):
    """flax ``nn.Embed``: an fp32 ``embedding`` table ``[num, features]``,
    read by index."""

    def __init__(self, num: int, features: int, *, device="cuda"):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features, device=device))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding[idx]


class LeViTAttentionBias(nn.Module):
    """LeViT's learned bias indexed by ``(|dy|, |dx|)``: a table
    ``pos_bias/embedding`` ``[kv_side**2, heads]``, read at ``|dy| * kv_side
    + |dx|`` for each query of the ``q_side`` x ``q_side`` map at its
    coordinates times ``q_stride`` (2 on a downsampling layer) against each
    key of the ``kv_side`` x ``kv_side`` map (the index a buffer, on the
    model's device). ``forward()`` returns fp32 ``[1, heads, q_side**2,
    kv_side**2]``."""

    def __init__(self, heads: int, fmap_size: int, q_fmap_size: Optional[int] = None,
                 q_stride: int = 1, *, device="cuda"):
        super().__init__()
        kv_side = fmap_size
        q_side = q_fmap_size or kv_side
        self.pos_bias = Embed(kv_side * kv_side, heads, device=device)
        q_coords = _grid_coords(q_side, q_side) * q_stride
        rel = np.abs(q_coords[:, None, :] - _grid_coords(kv_side, kv_side)[None, :, :])
        self.register_buffer("index", torch.as_tensor(rel[..., 0] * kv_side + rel[..., 1],
                                                      device=device), persistent=False)

    def forward(self) -> torch.Tensor:
        return self.pos_bias(self.index).permute(2, 0, 1)[None]


class _TableBias(nn.Module):
    """A learned ``(2w - 1)^2``-entry table (``rel_pos_bias``, one column a
    head), gathered at an ``[N, N]`` index, turned to ``[1, heads, N, N]``
    and zero-padded by ``pad`` leading rows and columns. fp32 whatever the
    model's dtype, as ``vit_tpu``'s."""

    def __init__(self, heads: int, window_size: int, device):
        super().__init__()
        span = 2 * window_size - 1
        self.rel_pos_bias = Embed(span * span, heads, device=device)

    def _gather(self, idx: torch.Tensor, pad: int) -> torch.Tensor:
        bias = self.rel_pos_bias(idx).permute(2, 0, 1)  # [heads, N, N]
        return F.pad(bias, (pad, 0, pad, 0))[None] if pad else bias[None].contiguous()


class WindowRelPosBias(_TableBias):
    """RegionViT's bias over a ``w`` x ``w`` window: the table entry of each
    (query, key) offset ``(dy + w - 1) * (2w - 1) + dx + w - 1`` (the index
    a buffer), with ``prepend_tokens`` leading zero rows and columns for the
    region token. ``forward()`` returns ``[1, heads, w*w + p, w*w + p]``."""

    def __init__(self, heads: int, window_size: int, prepend_tokens: int = 0, *, device="cuda"):
        super().__init__(heads, window_size, device)
        w = window_size
        coords = _grid_coords(w, w)
        rel = coords[:, None, :] - coords[None, :, :] + (w - 1)
        self.register_buffer("index", torch.as_tensor(rel[..., 0] * (2 * w - 1) + rel[..., 1],
                                                      device=device), persistent=False)
        self.prepend_tokens = prepend_tokens

    def forward(self) -> torch.Tensor:
        return self._gather(self.index, self.prepend_tokens)


class ReferenceWindowRelPosBias(_TableBias):
    """The reference's bias as it executes on the TPU, as ``vit_tpu``
    reproduces it: the table of the declared window ``w``, indexed over the
    actual ``window_h`` x ``window_w`` grid (the local/region ratio, which
    ``forward`` takes: ``vit_tpu`` reads it off the shapes of its first call)
    with the stride vector ``[1, 2w - 1]`` (rows and columns swapped against
    ``WindowRelPosBias``), the indices out of the table clipped to its ends
    (the TPU's gather clamps them; CPU JAX would read NaN), one leading zero
    row and column for the region token. ``forward(window_h, window_w)``
    returns ``[1, heads, N + 1, N + 1]``."""

    def __init__(self, heads: int, declared_window_size: int, *, device="cuda"):
        super().__init__(heads, declared_window_size, device)
        self.declared_window_size = declared_window_size

    def forward(self, window_h: int, window_w: int) -> torch.Tensor:
        w = self.declared_window_size
        span = 2 * w - 1
        gx, gy = np.meshgrid(np.arange(window_h), np.arange(window_w), indexing="ij")
        grid = np.stack([gx.flatten(), gy.flatten()])  # [2, N]
        rel = grid[:, :, None] - grid[:, None, :] + (w - 1)
        idx = np.clip(rel[0] + rel[1] * span, 0, span * span - 1)
        return self._gather(torch.as_tensor(idx, device=self.rel_pos_bias.embedding.device), 1)


class DynamicPositionBias(nn.Module):
    """CrossFormer's DPB: an MLP over relative offsets (three rounds of
    ``Dense -> LayerNorm(eps 1e-5, no bias) -> relu``, then a Dense), the
    bias of each (query, key) pair gathered from its offset's row.

    ``forward(window_size)`` returns ``[1, heads, w*w, w*w]`` fp32, the
    offsets on the ``(2w-1)^2`` grid. ``reference_quirks=True`` is the
    reference's DPB, as ``vit_tpu`` reproduces it: offsets on the
    ``(2w+1)^2`` grid, one output (``Dense(1)``), gathered with the stride
    ``2w-1``; it returns ``[1, 1, w*w, w*w]``. fp32 in both modes, whatever
    the model's dtype (flax's ``Dense`` without a dtype). Parameters:
    ``fc0..fc3/{kernel, bias}``, ``ln0..ln2/scale``."""

    def __init__(self, dim: int, heads: int, *, reference_quirks: bool = False, device="cuda"):
        super().__init__()
        self.reference_quirks = reference_quirks
        out = 1 if reference_quirks else heads
        for i, (d_in, d_out) in enumerate(((2, dim), (dim, dim), (dim, dim), (dim, out))):
            self.add_module(f"fc{i}", Dense(d_in, d_out, device=device))
        for i in range(3):
            self.add_module(f"ln{i}", LayerNorm(dim, eps=1e-5, use_bias=False, device=device))

    def forward(self, window_size: int) -> torch.Tensor:
        w = window_size
        # the offsets evaluated per axis, and the gather's stride
        span, lo, stride = (2 * w + 1, w, 2 * w - 1) if self.reference_quirks else \
            (2 * w - 1, w - 1, 2 * w - 1)
        offs = np.stack(np.meshgrid(np.arange(span), np.arange(span), indexing="ij"), -1)
        h = torch.as_tensor(offs.reshape(-1, 2) - lo, dtype=torch.float32,
                            device=self.fc0.kernel.device)
        for i in range(3):
            h = torch.relu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(h)))
        h = self.fc3(h)  # [span^2, out]
        coords = _grid_coords(w, w)
        rel = coords[:, None, :] - coords[None, :, :] + (w - 1)
        idx = torch.as_tensor((rel[..., 0] * stride + rel[..., 1]).reshape(-1), device=h.device)
        n = w * w
        return h[idx].reshape(n, n, -1).permute(2, 0, 1)[None]
