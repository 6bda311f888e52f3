"""T2T-ViT — progressive tokens-to-token aggregation (port of
``vit_tpu/models/t2t.py``).

The tokenizer alternates overlapping soft splits (``ops.extract_patches``,
TF's SAME padding and feature order) with tiny one-head transformers of
depth 1 (``dim_head = mlp_dim =`` the token width: 147 and 1323 from
3-channel images with ``t2t_layers ((7, 4), (3, 2), (3, 2))``), growing the
token width by ``kernel**2`` a stage. Each tokenizer layer runs the unfused
attention branch (no output projection, the residual added in the stream's
dtype): at those widths ``ops.qkv_attention`` takes the kv-blocked flash
kernel on the card. A Dense projects into the model width and a cls-token
encoder follows (the fused attention block and MLP kernels), then a
LayerNorm without bias and a Dense head in the model dtype, so a bf16 model
gives bf16 logits, as ``vit_tpu``'s does.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree, and ``utils.init_params`` draws them
as ``vit_tpu``'s ``init`` does.

Training: ``forward(img, train=True, generator=..., remat=...)`` applies
``emb_dropout`` to the embedded tokens and ``dropout`` in the tokenizer's
and the encoder's layers (``nn.blocks``). ``remat`` checkpoints the
encoder's blocks where its depth exceeds 1, the stack ``vit_tpu`` scans and
checkpoints; the tokenizer's one-layer stacks are not. On the card the
tokenizer's attention trains through ``ops.FlashAttentionFn`` on kernel 5
and its qkv product through ``MmRoundedFn``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.core.utils import conv_output_size
from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.blocks import Transformer
from vit_tpu_torch.nn.embed import Dense, LayerNorm, mean_tokens


class T2TViT(nn.Module):
    """``[B, H, W, C]`` images -> ``[B, num_classes]`` logits in ``dtype``
    (None: the input's). ``vit_tpu``'s names: ``t2t_{i}`` (the tokenizer
    transformers), ``proj``, ``cls``, ``pos_embedding``, ``encoder``,
    ``head_norm``, ``head``. ``dropout``, ``emb_dropout``: ``vit_tpu``'s
    rates, used only by ``forward(..., train=True)``."""

    def __init__(self, *, image_size: int, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, pool: str = "cls", channels: int = 3, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 t2t_layers: tuple = ((7, 4), (3, 2), (3, 2)),
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.pool, self.t2t_layers, self.emb_dropout = pool, tuple(t2t_layers), emb_dropout
        self.jax_stages = {}
        layer_dim, side = channels, image_size
        for i, (kernel, stride) in enumerate(self.t2t_layers):
            layer_dim *= kernel**2
            side = conv_output_size(side, kernel, stride, stride // 2)
            if i < len(self.t2t_layers) - 1:
                layer = Transformer(layer_dim, 1, 1, layer_dim, layer_dim, norm_eps=1e-5,
                                    dropout=dropout, dtype=dtype, device=device)
                self.add_module(f"t2t_{i}", layer)
                self.jax_stages.update({f"t2t_{i}/{k}": v for k, v in layer.jax_stages.items()})
        self.proj = Dense(layer_dim, dim, dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, side * side + 1, dim, device=device))
        self.encoder = Transformer(dim, depth, heads, dim_head, mlp_dim, norm_eps=1e-5,
                                   dropout=dropout, dtype=dtype, device=device)
        self.jax_stages.update({f"encoder/{k}": v for k, v in self.encoder.jax_stages.items()})
        self.head_norm = LayerNorm(dim, eps=1e-5, use_bias=False, dtype=dtype, device=device)
        self.head = Dense(dim, num_classes, dtype=dtype, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        x, b = img, img.shape[0]
        run = dict(train=train, generator=generator, remat=remat)
        for i, (kernel, stride) in enumerate(self.t2t_layers):
            x = ops.extract_patches(x, kernel, stride, padding="SAME")
            _, side, _, layer_dim = x.shape
            x = x.reshape(b, side * side, layer_dim)
            if i < len(self.t2t_layers) - 1:
                x = getattr(self, f"t2t_{i}")(x, **run).reshape(b, side, side, layer_dim)
        x = self.proj(x)
        dim = x.shape[-1]
        x = torch.cat([self.cls.to(x.dtype).expand(b, 1, dim), x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        if train:
            x = apply_dropout(x, self.emb_dropout, generator)
        x = self.encoder(x, **run)
        x = mean_tokens(x) if self.pool == "mean" else x[:, 0]
        return self.head(self.head_norm(x))
