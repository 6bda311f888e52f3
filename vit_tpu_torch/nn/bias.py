"""Relative-position attention-bias tables (port of ``vit_tpu/nn/bias.py``):
CrossFormer's ``DynamicPositionBias`` so far.

Each produces the additive fp32 ``bias`` that a window or attention kernel
adds to its scores. Plain PyTorch: ``vit_tpu`` computes the tables outside
every Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vit_tpu_torch.nn.embed import Dense, LayerNorm


def _grid_coords(h: int, w: int) -> np.ndarray:
    """``[h*w, 2]`` (row, col) of an ``h`` x ``w`` grid, row-major."""
    y, x = np.mgrid[:h, :w]
    return np.stack([y.flatten(), x.flatten()], axis=-1)


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
