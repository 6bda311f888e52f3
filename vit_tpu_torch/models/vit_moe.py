"""ViT-MoE — a V-MoE-style sparse ViT (port of ``vit_tpu/models/vit_moe.py``).

The vanilla ViT trunk with the dense MLP of every ``moe_every``-th block
replaced by a top-k routed expert MLP (``nn.MoEFeedForward``). Like
``vit_tpu``'s, it is not in ``MODEL_REGISTRY``. The layers are a Python
loop, named as the flax tree names them: ``attn_{i}`` (the fused attention
block, kernel 1 on the card, with the residual inside), then ``moe_{i}`` or
``ff_{i}`` (kernel 2), each delta added to the stream by the model.

Training (``forward(img, train=True, generator=...)``): at ``dropout`` 0
the inference routes (on the card ``ops.AttentionBlockFn`` and
``ops.MlpFn``); above 0 each ``attn_{i}`` materializes with ``attn_drop``
and ``out_drop`` (``vit_tpu``'s ``needs_materialized``), then ``moe_{i}``
drops its expert hiddens or ``ff_{i}`` takes its plain path with
``drop1`` and ``drop2``, the masks drawn layer after layer in that order.
``vit_tpu`` scans nothing here, so there is nothing to remat.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree (nothing is scanned: ``jax_stages``
is empty).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.attention import Attention
from vit_tpu_torch.nn.blocks import FeedForward
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed, mean_tokens
from vit_tpu_torch.nn.moe import MoEFeedForward


class ViTMoE(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` fp32 logits.

    ``dtype``: the stream and GEMM operand dtype (None: fp32). ``dropout``
    reaches every attention, MoE layer and MLP, and acts only under
    ``forward(..., train=True)``. ``forward(img, return_aux=True)`` also
    returns the MoE layers' load-balance losses, in layer order
    (``vit_tpu`` sows them)."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, num_experts: int = 8,
                 num_selected: int = 2, moe_every: int = 2, capacity_factor: float = 1.25,
                 pool: str = "cls", dim_head: int = 64, dropout: float = 0.0,
                 norm_eps: float = 1e-6, dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        if ph != pw:
            raise ValueError("square patches only")
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.depth, self.moe_every, self.pool, self.dropout = depth, moe_every, pool, dropout
        self.jax_stages = {}
        num_patches = (ih // ph) * (iw // pw)
        self.patch_embed = PatchEmbed(dim, ph, out_dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim, device=device))
        for i in range(depth):
            self.add_module(f"attn_{i}", Attention(dim, heads, dim_head, fuse_residual=True,
                                                   norm_eps=norm_eps, dropout=dropout,
                                                   dtype=dtype, device=device))
            if self._is_moe(i):
                self.add_module(f"moe_{i}", MoEFeedForward(
                    dim, mlp_dim, num_experts=num_experts, num_selected=num_selected,
                    capacity_factor=capacity_factor, dropout=dropout, ln_eps=norm_eps,
                    dtype=dtype, device=device))
            else:
                self.add_module(f"ff_{i}", FeedForward(dim, mlp_dim, ln_eps=norm_eps,
                                                       dropout=dropout, dtype=dtype,
                                                       device=device))
        self.head_norm = LayerNorm(dim, eps=norm_eps, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def _is_moe(self, i: int) -> bool:
        return (i + 1) % self.moe_every == 0

    def forward(self, img: torch.Tensor, return_aux: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.patch_embed(img)
        b, _, dim = x.shape
        x = torch.cat([self.cls.to(x.dtype).expand(b, 1, dim), x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        aux = []
        kw = dict(train=train, generator=generator)
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x, **kw)
            if self._is_moe(i):
                delta = getattr(self, f"moe_{i}")(x, return_aux=return_aux, **kw)
                if return_aux:
                    delta, loss = delta
                    aux.append(loss)
            else:
                delta = getattr(self, f"ff_{i}")(x, **kw)
            x = x + delta
        x = x[:, 0] if self.pool == "cls" else mean_tokens(x)
        logits = self.head(self.head_norm(x))
        return (logits, aux) if return_aux else logits
