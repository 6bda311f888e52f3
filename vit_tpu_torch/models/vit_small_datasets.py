"""ViT for small datasets — Shifted Patch Tokenization and Locality
Self-Attention (port of ``vit_tpu/models/vit_small_datasets.py``).

``SPT`` embeds the image and its four 1-px shifts; a cls token and learned
fp32 positions (added in the stream's dtype) go in front of an ``encoder``
Transformer with LSA in every layer (``mask_self``: no token attends
itself; ``learned_temperature``: the score scale ``exp(log_temperature)``,
learned; LayerNorm eps 1e-5). LSA keeps every layer on the unfused branch
and its score-materializing attention, in plain PyTorch, as ``vit_tpu``
runs it outside Pallas; each feed-forward is the MLP kernel. The cls token
or the mean of the tokens goes through a LayerNorm and a Dense head in fp32.

Training (``forward(img, train=True, generator=..., remat=...)``):
``emb_drop`` at ``emb_dropout`` after the positions, then the encoder's
dropout (``dropout``: each LSA layer's ``attn_drop`` and ``out_drop`` on
its materializing path, each MLP on its plain path above 0, kernel 2's
``ops.MlpFn`` at 0). ``log_temperature`` takes its gradient through
``torch.exp`` of the scores' scale; the masked diagonal carries none.
``remat`` checkpoints each block of an encoder deeper than 1, as
``vit_tpu`` scans and remats it.

Parameters are zeros and ones at construction (``log_temperature`` its
init, ``log(dim_head**-0.5)``), on the card unless the caller passes
``device="cpu"``; ``from_jax_params(tree, model.jax_stages)`` converts a
``vit_tpu`` variables tree.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.blocks import Transformer
from vit_tpu_torch.nn.embed import SPT, Dense, LayerNorm, mean_tokens


class ViTSmallDatasets(nn.Module):
    """``[B, H, W, C]`` images -> ``[B, num_classes]`` fp32 logits.
    ``vit_tpu``'s names: ``spt``, ``cls``, ``pos_embedding``, ``encoder``,
    ``head_norm``, ``head``. ``dropout`` and ``emb_dropout`` act only under
    ``forward(..., train=True)``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls", dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, channels: int = 3, dtype: Optional[torch.dtype] = None, device="cuda"):
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
        self.spt = SPT(dim, ph, channels, dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, (ih // ph) * (iw // pw) + 1, dim, device=device))
        self.encoder = Transformer(dim, depth, heads, dim_head, mlp_dim, mask_self=True,
                                   learned_temperature=True, norm_eps=1e-5, dropout=dropout,
                                   dtype=dtype, device=device)
        self.jax_stages = {f"encoder/{k}": v for k, v in self.encoder.jax_stages.items()}
        self.head_norm = LayerNorm(dim, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        x = self.spt(img)
        b, _, dim = x.shape
        x = torch.cat([self.cls.to(x.dtype).expand(b, 1, dim), x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        if train:
            x = apply_dropout(x, self.emb_dropout, generator)
        x = self.encoder(x, train=train, generator=generator, remat=remat)
        x = x[:, 0] if self.pool == "cls" else mean_tokens(x)
        return self.head(self.head_norm(x))
