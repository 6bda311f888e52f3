"""CvT — Convolutional vision Transformer (port of ``vit_tpu/models/cvt.py``).

Three stages, each a strided SAME conv embedding and a LayerNorm (eps
1e-5), then layers of conv-projection attention and a conv MLP, each a
residual branch. The attention takes its queries from a depthwise conv of
stride 1 and its keys and values from one of stride ``kv_proj_stride``
(``DepthWiseConv2d`` with a BatchNorm, no biases), runs ``mha_tokens``
(``ops.attention``: the flash kernel on the card) and a bias-free
``to_out`` Dense. The MLP is ``ConvMLP`` (``ops.mlp``: the fused MLP
kernel). No positional encoding. The mean pool and the head follow.

Training (``forward(img, train=True, generator=...)``): each BatchNorm
normalises with its batch's statistics and updates its running ones
(flax's default momentum 0.99); ``dropout`` above 0 drops the attention's
output after ``to_out`` and sends the MLP down its plain path with its two
dropouts, as ``vit_tpu``'s (``vit_tpu/models/cvt.py:58``, ``:110-117``).
The attention stays on the flash kernel either way, differentiated by
``ops.FlashAttentionFn``; the MLP at dropout 0 on kernel 2 (``ops.MlpFn``).

``fold_bn=True`` is the inference graph after ``utils.fold_batch_norm``:
each BatchNorm folded into its depthwise conv, which gains a bias. A bf16
model gives bf16 logits, as ``vit_tpu``'s does.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree (``params`` and, unfolded,
``batch_stats``; nothing is scanned, so ``jax_stages`` is empty).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.attention import mha_tokens
from vit_tpu_torch.nn.conv import Conv, ConvMLP, DepthWiseConv2d
from vit_tpu_torch.nn.embed import Dense, LayerNorm

STAGES = (1, 2, 3)


class _ConvAttention(nn.Module):
    """``norm`` (eps 1e-5), ``to_q`` and ``to_kv`` (depthwise-BatchNorm-
    pointwise, no biases; k and v are ``to_kv``'s two halves of channels, k
    first), attention at ``dim_head**-0.5``, ``to_out`` (a bias-free Dense);
    all in the model dtype; ``drop`` (flax ``Dropout(dropout)``) after
    ``to_out`` in training."""

    def __init__(self, dim: int, proj_kernel: int, kv_proj_stride: int, heads: int,
                 dim_head: int = 64, *, dropout: float = 0.0, fold_bn: bool,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        inner = heads * dim_head
        kw = dict(dtype=dtype, device=device)
        proj = dict(use_bias=False, batch_norm=True, fold_bn=fold_bn, **kw)
        self.heads, self.inner, self.scale = heads, inner, dim_head**-0.5
        self.dropout = dropout
        self.norm = LayerNorm(dim, eps=1e-5, **kw)
        self.to_q = DepthWiseConv2d(dim, inner, proj_kernel, 1, **proj)
        self.to_kv = DepthWiseConv2d(dim, inner * 2, proj_kernel, kv_proj_stride, **proj)
        self.to_out = Dense(inner, dim, use_bias=False, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        x = self.norm(x)
        q, kv = self.to_q(x, train), self.to_kv(x, train)
        k, v = kv.reshape(b, -1, 2 * self.inner).chunk(2, dim=-1)
        out = mha_tokens(q.reshape(b, h * w, self.inner), k, v, self.heads, scale=self.scale)
        out = self.to_out(out.reshape(b, h, w, self.inner))
        return apply_dropout(out, self.dropout, generator) if train else out


class CvT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` logits in the model
    dtype (None: fp32). ``vit_tpu``'s keyword arguments (``s{1,2,3}_*``) and
    names: ``embed_{s}``, ``embed_norm_{s}``, ``attn_{s}_{i}``,
    ``ff_{s}_{i}``, ``head``. ``dropout`` acts only under ``forward(...,
    train=True)``, as the module docstring says; a ``fold_bn`` model is
    inference only."""

    def __init__(self, *, num_classes: int,
                 s1_emb_dim=64, s1_emb_kernel=7, s1_emb_stride=4, s1_proj_kernel=3,
                 s1_kv_proj_stride=2, s1_heads=1, s1_depth=1, s1_mlp_mult=4,
                 s2_emb_dim=192, s2_emb_kernel=3, s2_emb_stride=2, s2_proj_kernel=3,
                 s2_kv_proj_stride=2, s2_heads=3, s2_depth=2, s2_mlp_mult=4,
                 s3_emb_dim=384, s3_emb_kernel=3, s3_emb_stride=2, s3_proj_kernel=3,
                 s3_kv_proj_stride=2, s3_heads=6, s3_depth=10, s3_mlp_mult=4,
                 dropout: float = 0.0, fold_bn: bool = False,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        cfg = locals()
        kw = dict(dtype=dtype, device=device)
        self.jax_stages = {}
        self.depths = {}
        dim_in = 3
        for s in STAGES:
            g = lambda k: cfg[f"s{s}_{k}"]
            dim = g("emb_dim")
            self.add_module(f"embed_{s}", Conv(dim_in, dim, g("emb_kernel"),
                                               strides=g("emb_stride"), **kw))
            self.add_module(f"embed_norm_{s}", LayerNorm(dim, eps=1e-5, **kw))
            for i in range(g("depth")):
                self.add_module(f"attn_{s}_{i}", _ConvAttention(
                    dim, g("proj_kernel"), g("kv_proj_stride"), g("heads"), dropout=dropout,
                    fold_bn=fold_bn, **kw))
                self.add_module(f"ff_{s}_{i}", ConvMLP(dim, g("mlp_mult"), dropout=dropout, **kw))
            self.depths[s] = g("depth")
            dim_in = dim
        self.head = Dense(dim_in, num_classes, **kw)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        """Logits; ``train``, ``generator`` as the module docstring says.
        ``remat`` is accepted and ignored, as in Twins-SVT: CvT has no
        scanned stack, so ``vit_tpu`` wraps nothing in ``nn.remat``, and no
        BatchNorm is ever run twice (a recompute would update its running
        statistics again)."""
        x = img
        kw = dict(train=train, generator=generator)
        for s in STAGES:
            x = getattr(self, f"embed_norm_{s}")(getattr(self, f"embed_{s}")(x))
            for i in range(self.depths[s]):
                x = x + getattr(self, f"attn_{s}_{i}")(x, **kw)
                x = x + getattr(self, f"ff_{s}_{i}")(x, **kw)
        # jnp.mean over bf16 sums in fp32 and returns bf16
        return self.head(x.float().mean(dim=(1, 2)).to(x.dtype))
