"""Self-attention block (port of the raw-parameter, fully fusable branch of
``vit_tpu/nn/attention.py:Attention``, :196-305).

Pre-norm self-attention with a fused qkv projection and no qkv bias; the
whole block, residual included, is one ``ops.attention_block`` call. The
other branches of the JAX module (qkv bias, cross-attention, talking heads,
re-attention, LSA) are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops

_LATER = "not ported yet (ROADMAP.md Queue 1 item 4, attention variants)"


class Attention(nn.Module):
    """``x + out_proj(attention(qkv_proj(LN(x))))`` with ``vit_tpu``'s raw
    parameters: ``norm_scale``, ``norm_bias`` ``[D]``; ``qkv_kernel``
    ``[D, 3*H*Dh]``; ``out_kernel`` ``[H*Dh, D]``; ``out_bias`` ``[D]``, all
    fp32. The GEMM weights are cast to ``dtype`` (None: the stream dtype)
    per call; biases and LN parameters stay fp32."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, *,
                 qkv_bias: bool = False, talking_heads: bool = False,
                 reattention: bool = False, mask_self: bool = False,
                 norm_eps: float = 1e-6, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        if qkv_bias or talking_heads or reattention or mask_self:
            raise NotImplementedError(f"qkv_bias / talking_heads / reattention / mask_self: {_LATER}")
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm_eps, self.dtype = norm_eps, dtype
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        self.norm_scale = p(dim, fill=1.0)
        self.norm_bias = p(dim)
        self.qkv_kernel = p(dim, 3 * inner)
        self.out_kernel = p(inner, dim)
        self.out_bias = p(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if context is not None:
            raise NotImplementedError(f"cross-attention: {_LATER}")
        dtype = self.dtype or x.dtype
        return ops.attention_block(
            x, self.norm_scale, self.norm_bias,
            self.qkv_kernel.to(dtype), self.out_kernel.to(dtype), self.out_bias,
            self.heads, scale=self.dim_head**-0.5, ln_eps=self.norm_eps,
        )
