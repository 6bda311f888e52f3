"""ViT — the vanilla Dosovitskiy encoder (port of ``vit_tpu/models/vit.py``).

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; load weights with ``load_state_dict``
(``vit_tpu_torch.utils.from_jax_params`` converts a ``vit_tpu`` variables
tree), or draw them as ``vit_tpu``'s ``init`` does with
``vit_tpu_torch.utils.init_params``.

``forward(img, train=True, generator=...)`` applies ``emb_dropout`` to the
embedded tokens and ``dropout`` in every block (``nn.blocks``);
``remat=True`` checkpoints each encoder block.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.attention import dropout
from vit_tpu_torch.nn.blocks import Transformer
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed, mean_tokens


class ViT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` fp32 logits.

    ``dtype``: the GEMM operand dtype of the encoder (None: the input's).
    ``residual_dtype``: the residual stream's dtype when it differs (the
    mixed config: ``dtype=bfloat16, residual_dtype=float32``).
    ``dropout``, ``emb_dropout``: ``vit_tpu``'s rates, used only by
    ``forward(..., train=True)``.
    ``qkv_bias``, ``activation="gelu_exact"`` and ``norm_eps``: the knobs of
    a Hugging Face or timm ViT checkpoint (``utils.interop``): each layer's
    attention then takes the flax branch with a qkv bias (``nn.Attention``).
    """

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls", dim_head: int = 64,
                 channels: int = 3, qkv_bias: bool = False, activation: str = "gelu",
                 norm_eps: float = 1e-6, dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 residual_dtype: Optional[torch.dtype] = None, device="cuda"):
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
        # the constructor's arguments, for quantize_vit to rebuild the model
        self.config = dict(image_size=image_size, patch_size=patch_size, num_classes=num_classes,
                           dim=dim, depth=depth, heads=heads, mlp_dim=mlp_dim, pool=pool,
                           dim_head=dim_head, channels=channels, qkv_bias=qkv_bias,
                           activation=activation, norm_eps=norm_eps, dtype=dtype)
        num_patches = (ih // ph) * (iw // pw)
        self.patch_embed = PatchEmbed(dim, ph, channels, out_dtype=residual_dtype or dtype,
                                      device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim, device=device))
        self.encoder = Transformer(dim, depth, heads, dim_head, mlp_dim, qkv_bias=qkv_bias,
                                   activation=activation, norm_eps=norm_eps, dropout=dropout,
                                   dtype=dtype, device=device)
        self.jax_stages = {f"encoder/{k}": v for k, v in self.encoder.jax_stages.items()}
        self.head_norm = LayerNorm(dim, eps=norm_eps, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        x = self.patch_embed(img)
        b, _, dim = x.shape
        cls = self.cls.to(x.dtype).expand(b, 1, dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(x.dtype)
        if train:
            x = dropout(x, self.emb_dropout, generator)
        x = self.encoder(x, train=train, generator=generator, remat=remat)
        x = x[:, 0] if self.pool == "cls" else mean_tokens(x)
        return self.head(self.head_norm(x))
