"""Feed-forward block and encoder stack (port of ``vit_tpu/nn/blocks.py``,
plain stack only).

The depth is a Python loop over a ``ModuleList``: no ``nn.scan`` analogue,
no sample packing and no Mosaic row padding, so the stream runs at its real
token count (197 at ViT-L/16 @224).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.nn.attention import Attention


class FeedForward(nn.Module):
    """Pre-norm MLP ``LN -> Dense -> activation -> Dense`` as one
    ``ops.mlp`` call. Parameters keep ``vit_tpu``'s names and layout
    (``w1 [D, F]``, ``w2 [F, D]``); the residual add stays with the caller,
    as in the JAX module."""

    def __init__(self, dim: int, hidden_dim: int, *, activation: str = "gelu",
                 ln_eps: float = 1e-6, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.activation, self.ln_eps, self.dtype = activation, ln_eps, dtype
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        self.w1 = p(dim, hidden_dim)
        self.b1 = p(hidden_dim)
        self.w2 = p(hidden_dim, dim)
        self.b2 = p(dim)
        self.ln_scale = p(dim, fill=1.0)
        self.ln_bias = p(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        return ops.mlp(
            x, self.w1.to(dtype), self.b1, self.w2.to(dtype), self.b2,
            self.ln_scale, self.ln_bias,
            activation=self.activation, residual=False, ln_eps=self.ln_eps,
        )


class EncoderBlock(nn.Module):
    """One pre-norm residual block: fused attention (residual inside the
    kernel) then ``x + FeedForward(x)`` in the stream dtype."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, *,
                 activation: str = "gelu", norm_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.attn = Attention(dim, heads, dim_head, norm_eps=norm_eps, dtype=dtype, device=device)
        self.ff = FeedForward(dim, mlp_dim, activation=activation, ln_eps=norm_eps,
                              dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(x)
        return x + self.ff(x)


class Transformer(nn.Module):
    """Plain pre-norm encoder: ``depth`` ``EncoderBlock``s in a loop.
    ``blocks.{i}`` holds layer i of ``vit_tpu``'s stacked ``encoder/blocks``."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, *,
                 activation: str = "gelu", norm_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, heads, dim_head, mlp_dim, activation=activation,
                         norm_eps=norm_eps, dtype=dtype, device=device)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x
