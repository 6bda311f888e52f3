"""CaiT — class-attention image transformer (port of ``vit_tpu/models/cait.py``).

Two stages of LayerScale-gated blocks: ``depth`` layers of talking-heads
self-attention over the patch tokens (``ops.talking_heads_block``: the
talking-heads kernel on the card, its twin on the CPU), then ``cls_depth``
layers in which the class token cross-attends itself and the patch tokens
(the low-query cross-attention, plain PyTorch, as the JAX package computes
it outside any Pallas kernel). Every feed-forward is ``ops.mlp``. LayerNorm
eps is 1e-5 inside the blocks, flax's 1e-6 at the head.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.attention import Attention
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
    LayerScale (``ls_attn``, ``ls_ff``: ``delta * scale`` in the delta's
    dtype) before the residual add. ``cross``: the class-attention block of
    the class stage."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, ls_eps: float, *,
                 cross: bool, dtype: Optional[torch.dtype], device):
        super().__init__()
        self.attn = Attention(dim, heads, dim_head, talking_heads=True, cross=cross,
                              norm_eps=1e-5, dtype=dtype, device=device)
        self.ff = FeedForward(dim, mlp_dim, ln_eps=1e-5, dtype=dtype, device=device)
        self.ls_attn = nn.Parameter(torch.full((dim,), ls_eps, device=device))
        self.ls_ff = nn.Parameter(torch.full((dim,), ls_eps, device=device))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if context is None:
            a = self.attn(x)
        else:
            a = self.attn(x, context, kv_include_self=True)
        x = x + a * self.ls_attn.to(a.dtype)
        f = self.ff(x)
        return x + f * self.ls_ff.to(f.dtype)


class _CaiTStage(nn.Module):
    """``depth`` CaiT blocks in a loop; ``blocks.{i}`` holds layer i of
    ``vit_tpu``'s ``<stage>/blocks``."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 model_depth: int, *, cross: bool, dtype: Optional[torch.dtype], device):
        super().__init__()
        eps = layer_scale_eps(model_depth)
        self.blocks = nn.ModuleList(
            _CaiTBlock(dim, heads, dim_head, mlp_dim, eps, cross=cross, dtype=dtype, device=device)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, context)
        return x


class CaiT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` fp32 logits.

    ``dtype``: the stream and GEMM operand dtype (None: fp32). ``dropout``,
    ``emb_dropout`` and ``layer_dropout`` are accepted and do nothing: the
    port serves, as ``vit_tpu`` does with ``train=False``."""

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
        stage = dict(dim=dim, heads=heads, dim_head=dim_head, mlp_dim=mlp_dim, model_depth=depth,
                     dtype=dtype, device=device)
        self.patch_embed = PatchEmbed(dim, ph, out_dtype=dtype, device=device)
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches, dim, device=device))
        self.patch_stage = _CaiTStage(depth=depth, cross=False, **stage)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.cls_stage = _CaiTStage(depth=cls_depth, cross=True, **stage)
        self.head_norm = LayerNorm(dim, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(img)
        x = self.patch_stage(x + self.pos_embedding.to(x.dtype))
        b, _, dim = x.shape
        cls = self.cls_stage(self.cls.to(x.dtype).expand(b, 1, dim), context=x)
        return self.head(self.head_norm(cls[:, 0]))
