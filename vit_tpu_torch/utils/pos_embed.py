"""Learned position-embedding resolution transfer (port of
``vit_tpu/utils/pos_embed.py``).

A learned position table is tied to its training resolution. Interpolating
it in 2-D over the patch grid (ViT paper §3.2) runs a trained model at
another input size by rewriting one tensor. The resize is
``pipeline.resize_bilinear``, antialiased as ``jax.image.resize`` is (it
matters when the grid shrinks). ``jax.image.resize``'s other methods are
not ported: its cubic kernel (a = -0.5) is not PyTorch's (a = -0.75).
"""

from __future__ import annotations

from typing import Dict

import torch

from vit_tpu_torch.pipeline import resize_bilinear

# jax.image.ResizeMethod's names of the linear kernel
_LINEAR = ("linear", "bilinear", "trilinear", "triangle")


def interpolate_pos_embedding(pos: torch.Tensor, new_grid, old_grid=None, *,
                              num_prefix_tokens: int = 1, method: str = "bilinear"
                              ) -> torch.Tensor:
    """Resize a ``[1, P + N, D]`` table to a new patch grid: the ``P``
    prefix tokens (cls, distill) kept as they are, the ``N = gh * gw`` grid
    positions resized in fp32 and cast back to the table's dtype.
    ``new_grid``: ``(gh, gw)`` or an int for a square; ``old_grid``:
    inferred as square from ``N`` when omitted. Returns ``[1, P + gh' *
    gw', D]``."""
    if method not in _LINEAR:
        raise NotImplementedError(f"method {method!r}: only the linear kernel is ported "
                                  "(ROADMAP.md Queue 1 item 5)")
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
    resized = resize_bilinear(grid, tuple(new_grid))
    resized = resized.reshape(1, new_grid[0] * new_grid[1], d).to(pos.dtype)
    return torch.cat([prefix, resized], dim=1)


def adapt_vit_resolution(state: Dict[str, torch.Tensor], image_size: int, patch_size: int, *,
                         num_prefix_tokens: int = 1) -> Dict[str, torch.Tensor]:
    """A ViT-family ``state_dict`` with its ``pos_embedding`` resized for a
    new input resolution; the other entries are shared. Build the model at
    the new ``image_size`` and load the result."""
    if "pos_embedding" not in state:
        raise KeyError("no top-level pos_embedding in this state dict")
    side = image_size // patch_size
    return {**state, "pos_embedding": interpolate_pos_embedding(
        state["pos_embedding"], (side, side), num_prefix_tokens=num_prefix_tokens)}
