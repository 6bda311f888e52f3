"""DeepViT — ViT with re-attention (port of ``vit_tpu/models/deepvit.py``).

The trunk of ViT, with every attention layer re-mixing its heads after the
softmax and normalising across them (``ops.reattention_block``: the
re-attention kernel on the card, its twin on the CPU). Parameters are zeros
and ones at construction, on the card unless the caller passes
``device="cpu"``; ``from_jax_params(tree, model.jax_stages)`` converts a
``vit_tpu`` variables tree.

Training (``forward(img, train=True, generator=..., remat=...)``):
``emb_drop`` after the position add, then the ``Transformer``'s routes
(``dropout`` above 0: the materialized re-attention with ``attn_drop`` and
``out_drop``, and the plain MLP; 0: the kernels), its stack of depth > 1
checkpointed per block under ``remat``, as ``vit_tpu`` remats its scanned
stack.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.blocks import Transformer
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed


class DeepViT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` fp32 logits.

    ``dtype``: the stream and GEMM operand dtype (None: fp32). ``dropout``
    and ``emb_dropout`` act only under ``forward(..., train=True)``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls", dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        if ph != pw:
            raise ValueError("square patches only")
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.pool, self.emb_dropout = pool, emb_dropout
        num_patches = (ih // ph) * (iw // pw)
        self.patch_embed = PatchEmbed(dim, ph, out_dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim, device=device))
        self.encoder = Transformer(dim, depth, heads, dim_head, mlp_dim, reattention=True,
                                   dropout=dropout, dtype=dtype, device=device)
        self.jax_stages = {f"encoder/{k}": v for k, v in self.encoder.jax_stages.items()}
        self.head_norm = LayerNorm(dim, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        x = self.patch_embed(img)
        b, _, dim = x.shape
        cls = self.cls.to(x.dtype).expand(b, 1, dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(x.dtype)
        if train:
            x = apply_dropout(x, self.emb_dropout, generator)
        x = self.encoder(x, train=train, generator=generator, remat=remat)
        x = x[:, 0] if self.pool == "cls" else x.mean(dim=1)
        return self.head(self.head_norm(x))
