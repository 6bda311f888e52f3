"""CaiT — class-attention image transformer (port of ``vit_tpu/models/cait.py``).

Two stages of LayerScale-gated blocks: ``depth`` layers of talking-heads
self-attention over the patch tokens (``ops.talking_heads_block``: the
talking-heads kernel on the card, its twin on the CPU), then ``cls_depth``
layers in which the class token cross-attends itself and the patch tokens
(the low-query cross-attention, plain PyTorch, as the JAX package computes
it outside any Pallas kernel). Every feed-forward is ``ops.mlp``. LayerNorm
eps is 1e-5 inside the blocks, flax's 1e-6 at the head.

Training (``forward(img, train=True, generator=...)``): ``emb_drop`` after
the position add; ``dropout`` above 0 takes ``vit_tpu``'s dropout routes in
every attention (the materialized scores, so no talking-heads kernel) and
feed-forward, 0 keeps the kernels; each LayerScale-gated delta passes the
per-sample stochastic-depth gate at ``layer_dropout``. Every mask and gate
is drawn by ``nn.attention.bernoulli`` from the caller's generator, in
``vit_tpu``'s order.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.attention import Attention, bernoulli
from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.blocks import FeedForward
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed


def layer_scale_eps(model_depth: int) -> float:
    """LayerScale's initial value by the model's depth (CaiT paper §3)."""
    if model_depth <= 18:
        return 0.1
    if model_depth <= 24:
        return 1e-5
    return 1e-6


class _CaiTBlock(nn.Module):
    """Talking-heads attention then feed-forward, each delta gated by its
    LayerScale (``ls_attn``, ``ls_ff``, at ``ls_eps`` from ``init``) before
    the residual add (``gated_residual``). ``cross``: the class-attention
    block of the class stage."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, ls_eps: float, *,
                 cross: bool, dropout: float, layer_dropout: float,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        self.ls_eps, self.layer_dropout = ls_eps, layer_dropout
        self.attn = Attention(dim, heads, dim_head, talking_heads=True, cross=cross,
                              norm_eps=1e-5, dropout=dropout, dtype=dtype, device=device)
        self.ff = FeedForward(dim, mlp_dim, ln_eps=1e-5, dropout=dropout, dtype=dtype,
                              device=device)
        self.ls_attn = nn.Parameter(torch.full((dim,), ls_eps, device=device))
        self.ls_ff = nn.Parameter(torch.full((dim,), ls_eps, device=device))

    def gated_residual(self, x, delta, scale, train, generator):
        """``x + delta * LayerScale`` (``vit_tpu/models/cait.py:45-57``), the
        product in the delta's dtype; in training with ``layer_dropout`` p
        above 0, the delta first passes one per-sample keep gate of shape
        ``(B, 1, 1)``, kept with probability ``1 - p``: ``delta * keep / (1 -
        p)``, in the delta's dtype (a bf16 delta stays bf16, as in JAX)."""
        delta = delta * scale.to(delta.dtype)
        p = self.layer_dropout
        if train and p > 0.0:
            keep = bernoulli(1.0 - p, (x.shape[0], 1, 1), generator, x.device)
            delta = delta * keep.to(delta.dtype) / (1.0 - p)
        return x + delta

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        kw = dict(train=train, generator=generator)
        if context is None:
            a = self.attn(x, **kw)
        else:
            a = self.attn(x, context, kv_include_self=True, **kw)
        x = self.gated_residual(x, a, self.ls_attn, **kw)
        return self.gated_residual(x, self.ff(x, **kw), self.ls_ff, **kw)


class _CaiTStage(nn.Module):
    """``depth`` CaiT blocks in a loop; ``blocks.{i}`` holds layer i of
    ``vit_tpu``'s ``<stage>/blocks``."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 model_depth: int, *, cross: bool, dropout: float, layer_dropout: float,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        eps = layer_scale_eps(model_depth)
        self.blocks = nn.ModuleList(
            _CaiTBlock(dim, heads, dim_head, mlp_dim, eps, cross=cross, dropout=dropout,
                       layer_dropout=layer_dropout, dtype=dtype, device=device)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, context, train, generator)
        return x


class CaiT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` fp32 logits.

    ``dtype``: the stream and GEMM operand dtype (None: fp32). ``dropout``,
    ``emb_dropout`` and ``layer_dropout`` act only under ``forward(...,
    train=True)``, as the module docstring says."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, cls_depth: int, heads: int, mlp_dim: int, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, layer_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        if ph != pw:
            raise ValueError("square patches only")
        self.jax_stages = {"patch_stage/blocks": depth, "cls_stage/blocks": cls_depth}
        num_patches = (ih // ph) * (iw // pw)
        self.emb_dropout = emb_dropout
        stage = dict(dim=dim, heads=heads, dim_head=dim_head, mlp_dim=mlp_dim, model_depth=depth,
                     dropout=dropout, layer_dropout=layer_dropout, dtype=dtype, device=device)
        self.patch_embed = PatchEmbed(dim, ph, out_dtype=dtype, device=device)
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches, dim, device=device))
        self.patch_stage = _CaiTStage(depth=depth, cross=False, **stage)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.cls_stage = _CaiTStage(depth=cls_depth, cross=True, **stage)
        self.head_norm = LayerNorm(dim, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        """Logits; ``train``, ``generator`` as the module docstring says.
        ``remat`` is accepted and ignored: ``vit_tpu``'s CaiT scans its stages
        without ``nn.remat`` (only its ``Transformer`` reads ``remat_scope``),
        so every activation is kept for the backward."""
        kw = dict(train=train, generator=generator)
        x = self.patch_embed(img)
        x = x + self.pos_embedding.to(x.dtype)
        if train:
            x = apply_dropout(x, self.emb_dropout, generator)
        x = self.patch_stage(x, **kw)
        b, _, dim = x.shape
        cls = self.cls_stage(self.cls.to(x.dtype).expand(b, 1, dim), context=x, **kw)
        return self.head(self.head_norm(cls[:, 0]))
