"""ParallelViT — "Three things everyone should know about vision
transformers" (port of ``vit_tpu/models/parallel_vit.py``).

A ViT whose layers sum parallel branches: EfficientViT's shell around the
port's ``Transformer`` with ``parallel_branches`` (LayerNorm eps 1e-5 in the
attention branches), registered as ``encoder``. The stack is never fused, so
each attention branch runs ``ops.qkv_attention`` (the fused-qkv kernel on
the card) and each feed-forward branch the MLP kernel. The cls token or the
mean of the tokens goes through a LayerNorm and a Dense head in fp32.

Training (``forward(img, train=True, generator=..., remat=...)``):
``emb_drop`` (``emb_dropout``) after the position add, then ``dropout`` in
every branch (``Transformer``: each attention branch materialized with its
dropouts above 0, on ``ops.QkvAttentionFn`` at 0; each feed-forward branch
on its plain path above 0, on ``ops.MlpFn`` at 0). ``vit_tpu`` never scans a
parallel stack, so ``remat`` checkpoints nothing.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_tpu_torch.models.efficient import EfficientViT
from vit_tpu_torch.nn.blocks import Transformer


class ParallelViT(EfficientViT):
    """``[B, H, W, C]`` images -> ``[B, num_classes]`` fp32 logits.
    ``vit_tpu``'s names: ``patch_embed``, ``cls``, ``pos_embedding``,
    ``encoder`` (``attn_{i}_{b}``, ``ff_{i}_{b}``), ``head_norm``, ``head``."""

    encoder_name = "encoder"

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls",
                 num_parallel_branches: int = 2, dim_head: int = 64, channels: int = 3,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        encoder = Transformer(dim, depth, heads, dim_head, mlp_dim, norm_eps=1e-5,
                              parallel_branches=num_parallel_branches, dropout=dropout,
                              dtype=dtype, device=device)
        super().__init__(image_size=image_size, patch_size=patch_size, num_classes=num_classes,
                         dim=dim, transformer=encoder, pool=pool, channels=channels,
                         emb_dropout=emb_dropout, dtype=dtype, device=device)
