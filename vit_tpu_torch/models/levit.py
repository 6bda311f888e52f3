"""LeViT — a conv-stem hybrid with downsampling attention and a learned
attention bias (port of ``vit_tpu/models/levit.py``).

Four 3x3 stride-2 SAME convs reduce the image 16x. Stages of attention
(q, k, v and the output each a 1x1 conv and a BatchNorm of momentum 0.9) and a
hard-swish MLP without a norm (``ConvMLP``: ``ops.mlp``, the fused MLP
kernel without its LayerNorm) alternate with one downsampling layer (stride-2
queries, twice the heads, the next stage's width out). Positions enter as
``LeViTAttentionBias``, an fp32 ``[1, H, Nq, Nk]`` bias added to the scaled
scores inside ``mha_tokens`` (``ops.attention``: the flash kernel on the
card, key width ``dim_key``, value width ``dim_value``). flax's tanh GELU
follows the attention. The optional distillation head returns ``(out,
distill)``.

Training (``forward(img, train=True, generator=...)``): each BatchNorm
normalises with its batch's statistics and updates its running ones;
``dropout`` above 0 drops each attention's output after ``to_out_bn``
(``drop``) and sends each MLP down its plain path with its two dropouts
(``vit_tpu/models/levit.py:96``, ``:136-144``). The attention stays on the
flash kernel either way (``ops.FlashAttentionFn``, whose ``dbias`` reaches
the ``pos_bias`` tables through their gather); the MLP at dropout 0 on
kernel 2 without its LayerNorm (``ops.MlpFn``).

``fold_bn=True`` is the inference graph after ``utils.fold_batch_norm``:
each ``{p}_bn`` folded into its ``{p}_conv``, which then has a bias. A
bf16 model gives bf16 logits, as ``vit_tpu``'s does.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree (``params`` and, unfolded,
``batch_stats``; nothing is scanned, so ``jax_stages`` is empty).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.utils import cast_tuple
from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.attention import mha_tokens
from vit_tpu_torch.nn.bias import LeViTAttentionBias
from vit_tpu_torch.nn.conv import Conv, ConvMLP
from vit_tpu_torch.nn.embed import BatchNorm, Dense

STEM = (32, 64, 128)  # the stem's first three widths; the fourth is dim[0]


class _LeViTAttention(nn.Module):
    """``to_q`` (stride 2 when ``downsample``), ``to_k``, ``to_v``, attention
    at ``dim_key**-0.5`` with the ``pos_bias`` table, the tanh GELU, then
    ``to_out`` (a 1x1 conv with a bias, and BatchNorm unless folded) to
    ``dim_out`` (None: ``dim``). Names as ``vit_tpu``'s: ``{p}_conv`` and
    ``{p}_bn`` (momentum 0.9, as ``vit_tpu``'s). ``drop`` (flax
    ``Dropout(dropout)``) after ``to_out_bn`` in training."""

    def __init__(self, dim: int, fmap_size: int, heads: int, dim_key: int, dim_value: int, *,
                 dim_out: Optional[int], downsample: bool, fold_bn: bool, dropout: float = 0.0,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads, self.scale = heads, dim_key**-0.5
        q_stride = 2 if downsample else 1
        inner_k, inner_v = heads * dim_key, heads * dim_value
        projs = {"to_q": (dim, inner_k, q_stride, fold_bn), "to_k": (dim, inner_k, 1, fold_bn),
                 "to_v": (dim, inner_v, 1, fold_bn), "to_out": (inner_v, dim_out or dim, 1, True)}
        for p, (c_in, feat, stride, use_bias) in projs.items():
            self.add_module(f"{p}_conv", Conv(c_in, feat, 1, strides=stride, use_bias=use_bias,
                                              **kw))
            if not fold_bn:
                self.add_module(f"{p}_bn", BatchNorm(feat, momentum=0.9, **kw))
        self.fold_bn, self.dropout = fold_bn, dropout
        q_side = math.ceil(fmap_size / q_stride)
        self.pos_bias = LeViTAttentionBias(heads, fmap_size, q_fmap_size=q_side,
                                           q_stride=q_stride, device=device)

    def _conv_bn(self, p: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = getattr(self, f"{p}_conv")(x)
        return x if self.fold_bn else getattr(self, f"{p}_bn")(x, train)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train and self.fold_bn:
            raise ValueError("a BatchNorm-folded model is inference only (train=True)")
        b = x.shape[0]
        q, k, v = (self._conv_bn(p, x, train) for p in ("to_q", "to_k", "to_v"))
        q_side = q.shape[1]
        out = mha_tokens(q.reshape(b, q_side * q_side, -1), k.reshape(b, -1, k.shape[-1]),
                         v.reshape(b, -1, v.shape[-1]), self.heads, scale=self.scale,
                         bias=self.pos_bias())
        out = F.gelu(out.reshape(b, q_side, q_side, -1), approximate="tanh")  # flax's nn.gelu
        out = self._conv_bn("to_out", out, train)
        return apply_dropout(out, self.dropout, generator) if train else out


class LeViT(nn.Module):
    """``[B, image_size, image_size, 3]`` images -> ``[B, num_classes]``
    logits in the model dtype (None: fp32), and the distillation logits
    beside them with ``num_distill_classes``. ``vit_tpu``'s keyword
    arguments and names: ``stem_{0..3}``; ``stage_{s}_attn_{d}`` and
    ``stage_{s}_mlp_{d}``; ``down_{s}_attn_0`` and ``down_{s}_mlp_0``
    between stages; ``head``, ``distill_head``. ``dropout`` acts only under
    ``forward(..., train=True)``, as the module docstring says; a
    ``fold_bn`` model is inference only."""

    def __init__(self, *, image_size: int, num_classes: int, dim, depth, heads, mlp_mult: int,
                 stages: int = 3, dim_key: int = 32, dim_value: int = 64, dropout: float = 0.0,
                 num_distill_classes: Optional[int] = None, fold_bn: bool = False,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        dims, depths = cast_tuple(dim, stages), cast_tuple(depth, stages)
        layer_heads = cast_tuple(heads, stages)
        self.jax_stages = {}
        widths = (3, *STEM, dims[0])
        for i in range(4):
            self.add_module(f"stem_{i}", Conv(widths[i], widths[i + 1], 3, strides=2, **kw))
        self.layers = []  # (attention name, mlp name, residual around the attention)
        fmap = image_size // 16

        def add_stage(name, dim, depth, heads, fmap, dim_out=None, downsample=False):
            out = dim_out or dim
            for d in range(depth):
                self.add_module(f"{name}_attn_{d}", _LeViTAttention(
                    dim, fmap, heads, dim_key, dim_value, dim_out=dim_out,
                    downsample=downsample, fold_bn=fold_bn, dropout=dropout, **kw))
                self.add_module(f"{name}_mlp_{d}", ConvMLP(
                    out, mlp_mult, activation="hard_swish", pre_norm=False, dropout=dropout,
                    **kw))
                self.layers.append((f"{name}_attn_{d}", f"{name}_mlp_{d}",
                                    not downsample and dim == out))

        for s in range(stages):
            add_stage(f"stage_{s}", dims[s], depths[s], layer_heads[s], fmap)
            if s + 1 < stages:
                add_stage(f"down_{s}", dims[s], 1, layer_heads[s] * 2, fmap,
                          dim_out=dims[s + 1], downsample=True)
                fmap = math.ceil(fmap / 2)
        self.head = Dense(dims[-1], num_classes, **kw)
        self.distill_head = (Dense(dims[-1], num_distill_classes, **kw)
                             if num_distill_classes is not None else None)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False):
        """Logits (and the distillation logits); ``train``, ``generator`` as
        the module docstring says. ``remat`` is accepted and ignored: LeViT
        has no scanned stack, and no BatchNorm is ever run twice."""
        kw = dict(train=train, generator=generator)
        x = img
        for i in range(4):
            x = getattr(self, f"stem_{i}")(x)
        for attn, mlp, residual in self.layers:
            a = getattr(self, attn)(x, **kw)
            x = x + a if residual else a
            x = x + getattr(self, mlp)(x, **kw)
        # jnp.mean over bf16 sums in fp32 and returns bf16
        x = x.float().mean(dim=(1, 2)).to(x.dtype)
        out = self.head(x)
        return out if self.distill_head is None else (out, self.distill_head(x))
