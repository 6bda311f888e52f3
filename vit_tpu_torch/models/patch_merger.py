"""PatchMerger-ViT — a ViT that merges its tokens mid-stack (port of
``vit_tpu/models/patch_merger.py``).

A patch embedding without a cls token and learned positions, then ``depth``
layers of standalone attention (``attn_{i}``, LayerNorm eps 1e-5) and
feed-forward (``ff_{i}``, eps 1e-5), each delta added to the stream outside
the module, as ``vit_tpu`` does: its layers are not a scanned stack, so
every attention takes the unfused branch (``ops.qkv_attention``: the
fused-qkv kernel on the card) and every feed-forward the MLP kernel. After
layer ``patch_merge_layer`` (default ``depth // 2``) a ``PatchMerger``
(``merger``) turns the tokens into ``patch_merge_num_tokens`` learned
queries' mixtures, in plain PyTorch. The mean of the tokens goes through a
LayerNorm and a Dense head in fp32.

Training (``forward(img, train=True, generator=..., remat=...)``):
``emb_drop`` (``emb_dropout``) after the position add, then ``dropout`` in
every layer's attention (materialized with ``attn_drop`` and ``out_drop``
above 0; on ``ops.QkvAttentionFn`` at 0) and feed-forward (its plain path
with ``drop1`` and ``drop2`` above 0; on ``ops.MlpFn`` at 0), as
``vit_tpu``'s (patch_merger.py:55-70); the merger under grad in plain
PyTorch. ``vit_tpu``'s layers are not a scanned stack, so ``remat``
checkpoints nothing.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree (nothing to unstack:
``jax_stages`` is empty).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.attention import Attention, dropout
from vit_tpu_torch.nn.blocks import FeedForward
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed, PatchMerger, mean_tokens


class PatchMergerViT(nn.Module):
    """``[B, H, W, C]`` images -> ``[B, num_classes]`` fp32 logits.
    ``vit_tpu``'s names: ``patch_embed``, ``pos_embedding``, ``attn_{i}``,
    ``ff_{i}``, ``merger``, ``head_norm``, ``head``. ``dropout`` and
    ``emb_dropout`` act only under ``forward(..., train=True)``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, patch_merge_layer: Optional[int] = None,
                 patch_merge_num_tokens: int = 8, dim_head: int = 64, channels: int = 3,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        if ph != pw:
            raise ValueError("square patches only")
        self.depth, self.jax_stages, self.emb_dropout = depth, {}, emb_dropout
        self.merge_at = patch_merge_layer if patch_merge_layer is not None else depth // 2
        self.patch_embed = PatchEmbed(dim, ph, channels, out_dtype=dtype, device=device)
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, (ih // ph) * (iw // pw), dim, device=device))
        for i in range(depth):
            self.add_module(f"attn_{i}", Attention(dim, heads, dim_head, norm_eps=1e-5,
                                                   dropout=dropout, dtype=dtype, device=device))
            self.add_module(f"ff_{i}", FeedForward(dim, mlp_dim, ln_eps=1e-5, dropout=dropout,
                                                   dtype=dtype, device=device))
        self.merger = PatchMerger(dim, patch_merge_num_tokens, dtype=dtype, device=device)
        self.head_norm = LayerNorm(dim, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        x = self.patch_embed(img)
        x = x + self.pos_embedding.to(x.dtype)
        if train:
            x = dropout(x, self.emb_dropout, generator)
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(x, train=train, generator=generator)
            x = x + getattr(self, f"ff_{i}")(x, train=train, generator=generator)
            if i + 1 == self.merge_at:
                x = self.merger(x)
        return self.head(self.head_norm(mean_tokens(x)))
