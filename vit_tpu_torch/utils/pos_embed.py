"""Learned position-embedding resolution transfer (port of
``vit_tpu/utils/pos_embed.py``).

A learned position table is tied to its training resolution. Interpolating
it in 2-D over the patch grid (ViT paper §3.2) runs a trained model at
another input size by rewriting one tensor. The resize is
``jax.image.resize``'s, method for method (``nearest``, ``linear``,
``cubic``, ``lanczos3``, ``lanczos5`` and their aliases), written as
``jax/_src/image/scale.py`` writes it: each resized axis is a product with
a ``[in, out]`` weight matrix whose columns are the kernel at the sample
points, the taps outside the input dropped and the rest renormalised, the
kernel widened by the scale when an axis shrinks (antialiasing). Its cubic
kernel is Keys' with a = -0.5, not PyTorch's bicubic (a = -0.75, edges
clamped), so none of ``F.interpolate``'s modes is used.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_F32_EPS = torch.finfo(torch.float32).eps


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x):
    """Keys' cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius):
    def kernel(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        safe = torch.where(x != 0, math.pi**2 * x**2, torch.ones_like(x))
        out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


# jax.image.ResizeMethod.from_string's names
_KERNELS = {name: _triangle for name in ("linear", "bilinear", "trilinear", "triangle")}
_KERNELS.update({name: _keys_cubic for name in ("cubic", "bicubic", "tricubic")})
_KERNELS.update(lanczos3=_lanczos(3.0), lanczos5=_lanczos(5.0))
METHODS = ("nearest", *_KERNELS)


def resize_weights(n_in: int, n_out: int, method: str, device=None) -> torch.Tensor:
    """The ``[n_in, n_out]`` fp32 weights of one axis resized from ``n_in``
    to ``n_out`` samples (``compute_weight_mat`` at translation 0, with
    antialiasing): column j holds the kernel at output sample j's place in
    the input, each column normalised to sum 1 (or zero where it sums to
    about nothing)."""
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(grid: torch.Tensor, size, method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize(grid, (B, *size, C), method)`` of an fp32 NHWC
    ``grid``: axes whose size stays are left as they are; ``nearest`` picks
    ``floor((j + 0.5) * n_in / n_out)`` (in fp32), the other methods take
    the product with ``resize_weights``."""
    if method not in METHODS:
        raise ValueError(f'Unknown resize method "{method}"; jax.image.resize takes {METHODS}')
    for axis, n_out in ((1, size[0]), (2, size[1])):
        n_in = grid.shape[axis]
        if n_in == n_out:
            continue
        if method == "nearest":
            pos = (torch.arange(n_out, dtype=torch.float32, device=grid.device) + 0.5) * n_in / n_out
            grid = grid.index_select(axis, pos.floor().long())
        else:
            w = resize_weights(n_in, n_out, method, device=grid.device)
            grid = torch.movedim(torch.movedim(grid, axis, -1) @ w, -1, axis)
    return grid


def interpolate_pos_embedding(pos: torch.Tensor, new_grid, old_grid=None, *,
                              num_prefix_tokens: int = 1, method: str = "bilinear"
                              ) -> torch.Tensor:
    """Resize a ``[1, P + N, D]`` table to a new patch grid: the ``P``
    prefix tokens (cls, distill) kept as they are, the ``N = gh * gw`` grid
    positions resized in fp32 by ``method`` (any of ``jax.image.resize``'s)
    and cast back to the table's dtype. ``new_grid``: ``(gh, gw)`` or an int
    for a square; ``old_grid``: inferred as square from ``N`` when omitted.
    Returns ``[1, P + gh' * gw', D]``."""
    if method not in METHODS:
        raise ValueError(f'Unknown resize method "{method}"; jax.image.resize takes {METHODS}')
    if isinstance(new_grid, int):
        new_grid = (new_grid, new_grid)
    if pos.dim() != 3 or pos.shape[0] != 1:
        raise ValueError(f"expected [1, N, D], got {tuple(pos.shape)}")
    prefix, spatial = pos[:, :num_prefix_tokens], pos[:, num_prefix_tokens:]
    n, d = spatial.shape[1], spatial.shape[2]
    if old_grid is None:
        side = int(round(n**0.5))
        if side * side != n:
            raise ValueError(f"{n} spatial positions is not square; pass old_grid explicitly")
        old_grid = (side, side)
    if old_grid[0] * old_grid[1] != n:
        raise ValueError(f"{old_grid} != {n} positions")
    grid = spatial.reshape(1, old_grid[0], old_grid[1], d).float()
    resized = resize(grid, tuple(new_grid), method)
    resized = resized.reshape(1, new_grid[0] * new_grid[1], d).to(pos.dtype)
    return torch.cat([prefix, resized], dim=1)


def adapt_vit_resolution(state: Dict[str, torch.Tensor], image_size: int, patch_size: int, *,
                         num_prefix_tokens: int = 1, method: str = "bilinear"
                         ) -> Dict[str, torch.Tensor]:
    """A ViT-family ``state_dict`` with its ``pos_embedding`` resized for a
    new input resolution by ``method`` (``vit_tpu``'s resizes bilinearly);
    the other entries are shared. Build the model at the new ``image_size``
    and load the result."""
    if "pos_embedding" not in state:
        raise KeyError("no top-level pos_embedding in this state dict")
    side = image_size // patch_size
    return {**state, "pos_embedding": interpolate_pos_embedding(
        state["pos_embedding"], (side, side), num_prefix_tokens=num_prefix_tokens,
        method=method)}
