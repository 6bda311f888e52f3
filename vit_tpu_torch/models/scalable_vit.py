"""ScalableViT — scalable self-attention and interactive windowed
self-attention (port of ``vit_tpu/models/scalable_vit.py``).

A 7x7 stride-4 ``patchify`` conv, then stages of [SSA, ConvMLP, IWSA,
ConvMLP] blocks, a Downsample between stages. SSA attends every token of
the map to keys and values reduced by r x r stride-r convs (``mha_tokens``:
``ops.attention``, the flash kernel where its core takes the widths, else
the kv-blocked one: at the preset's 40-wide keys, and kernel 4 at stage 3's
32). IWSA runs one fused q|k|v product, self-attention inside windows of
the map (``ops.qkv_attention``: the fused-qkv kernel up to 1,024 tokens, the
kv-blocked kernel on strided views of the fused rows beyond: the preset's
4,096-token window at stage 0) and adds back a 3x3 conv over the values
(the LIM). Every ConvMLP is ``ops.mlp``. The first block of each stage
carries the PEG between its halves, as ``vit_tpu`` splices it. A bf16
model gives bf16 logits, as ``vit_tpu``'s does.

``reference_block_order=True`` runs each block's second ConvMLP before its
IWSA, the reference's execution order as ``vit_tpu`` reproduces it.

Training (``forward(img, train=True, generator=..., remat=...)``): each
SSA's and IWSA's ``drop`` after ``to_out`` (``dropout``; their attention
stays on ``ops.attention`` / ``ops.qkv_attention``, so on the card
``ops.FlashAttentionFn`` and ``ops.QkvAttentionFn`` at every rate: at the
preset, kernel 5 on strided views of IWSA stage 0's fused rows and at
SSA's 40-wide keys, kernel 4 at SSA stage 3, kernel 3 at IWSA stages 1-3),
then each ConvMLP's ``drop1`` and ``drop2`` on its plain path above 0
(``ops.MlpFn`` at 0). Masks are drawn block after block in ``vit_tpu``'s
order: SSA, ff1, then IWSA and ff2 (ff2 and IWSA with
``reference_block_order``); a stage's scanned blocks each draw their own.
The PEG, the LIM and ``Downsample`` have no dropout. ``vit_tpu`` does not
remat a stage's scan, so ``remat`` checkpoints nothing.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree (``stage_{s}`` is scanned there when
it holds more than one block: ``jax_stages`` lists those; its conv kernels
are turned to OIHW).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.core.utils import cast_tuple
from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.attention import mha_tokens
from vit_tpu_torch.nn.conv import PEG, Conv, ConvMLP, Downsample
from vit_tpu_torch.nn.embed import Dense, LayerNorm, mm_rounded


class _SSA(nn.Module):
    """Scalable self-attention: ``norm`` (eps 1e-5), ``to_q`` (a bias-free
    Dense), ``to_k`` / ``to_v`` (bias-free r x r stride-r convs), attention
    at scale ``dim_key**-0.5``, ``to_out`` (a Dense, its bias added in the
    dtype after the rounding); all in the model dtype. ``drop`` at rate
    ``dropout`` after ``to_out`` under ``train``."""

    def __init__(self, dim: int, heads: int, dim_key: int, dim_value: int,
                 reduction_factor: int, *, dropout: float = 0.0, dtype: Optional[torch.dtype],
                 device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        hk, hv, r = dim_key * heads, dim_value * heads, reduction_factor
        self.heads, self.scale, self.dropout = heads, dim_key**-0.5, dropout
        self.norm = LayerNorm(dim, eps=1e-5, **kw)
        self.to_q = Dense(dim, hk, use_bias=False, **kw)
        self.to_k = Conv(dim, hk, r, strides=r, use_bias=False, **kw)
        self.to_v = Conv(dim, hv, r, strides=r, use_bias=False, **kw)
        self.to_out = Dense(hv, dim, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        x = self.norm(x)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        out = mha_tokens(q.reshape(b, h * w, -1), k.reshape(b, -1, k.shape[-1]),
                         v.reshape(b, -1, v.shape[-1]), self.heads, scale=self.scale)
        out = self.to_out(out.reshape(b, h, w, -1))
        return apply_dropout(out, self.dropout, generator) if train else out


class _IWSA(nn.Module):
    """Interactive windowed self-attention: ``norm`` (eps 1e-5), one product
    of the map with ``to_q | to_k | to_v`` (bias-free kernels in flax's
    ``[in, out]`` layout, held by Dense modules that are never called,
    concatenated per call; fp32 sums rounded once to the dtype), the LIM (``lim``: a 3x3 SAME conv with a bias over the value
    columns), attention inside ``window_size`` windows (None: the whole
    map), the LIM added back, then ``to_out`` and, under ``train``, ``drop``
    at rate ``dropout``. Under grad the fused product's weight gradient
    (``MmRoundedFn``) flattens the map's leading axes, and the strided q, k,
    v views of the fused rows send their gradients back into their thirds
    through autograd."""

    def __init__(self, dim: int, window_size: Optional[int], heads: int, dim_key: int,
                 dim_value: int, *, dropout: float = 0.0, dtype: Optional[torch.dtype],
                 device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        hk, hv = dim_key * heads, dim_value * heads
        self.window_size, self.heads, self.scale = window_size, heads, dim_key**-0.5
        self.dropout = dropout
        self.hk, self.fused = hk, dim_key == dim_value
        self.dtype = dtype
        self.norm = LayerNorm(dim, eps=1e-5, **kw)
        self.to_q = Dense(dim, hk, use_bias=False, device=device)
        self.to_k = Dense(dim, hk, use_bias=False, device=device)
        self.to_v = Dense(dim, hv, use_bias=False, device=device)
        self.lim = Conv(hv, hv, 3, **kw)
        self.to_out = Dense(hv, dim, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        wsz = self.window_size or h
        if h % wsz or w % wsz:
            raise ValueError(f"a {h} x {w} map does not split into windows of {wsz}")
        x = self.norm(x)
        dt = self.dtype or x.dtype
        wqkv = torch.cat([self.to_q.kernel, self.to_k.kernel, self.to_v.kernel], dim=1).to(dt)
        x = x.to(dt)
        qkv = mm_rounded(x, wqkv, dt)  # [b, h, w, 2hk + hv]
        hk = self.hk
        local_out = self.lim(qkv[..., 2 * hk:])
        if self.fused:
            out = ops.qkv_attention(ops.window_partition(qkv, wsz), self.heads, scale=self.scale)
        else:
            q, k, v = (ops.window_partition(t, wsz)
                       for t in (qkv[..., :hk], qkv[..., hk:2 * hk], qkv[..., 2 * hk:]))
            out = mha_tokens(q, k, v, self.heads, scale=self.scale)
        out = self.to_out(ops.window_unpartition(out, wsz, h, w) + local_out)
        return apply_dropout(out, self.dropout, generator) if train else out


def _block(x, ssa, ff1, iwsa, ff2, reference_block_order: bool, peg=None, train=False,
           generator=None):
    """One block, each module a residual branch: SSA, ff1, the PEG where
    given (a stage's first block), then IWSA and ff2, or ff2 and IWSA with
    ``reference_block_order``; under ``train`` each draws its masks in that
    order."""
    kw = dict(train=train, generator=generator)
    x = x + ssa(x, **kw)
    x = x + ff1(x, **kw)
    if peg is not None:
        x = peg(x)
    if reference_block_order:
        x = x + ff2(x, **kw)
        return x + iwsa(x, **kw)
    x = x + iwsa(x, **kw)
    return x + ff2(x, **kw)


class _ScalableBlock(nn.Module):
    """One SSA / ConvMLP / IWSA / ConvMLP block (``ssa``, ``ff1``, ``iwsa``,
    ``ff2``)."""

    def __init__(self, dim: int, heads: int, ssa_dim_key: int, ssa_dim_value: int,
                 reduction_factor: int, iwsa_dim_key: int, iwsa_dim_value: int,
                 window_size: Optional[int], ff_expansion_factor: int, *,
                 reference_block_order: bool, dropout: float = 0.0,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        kw = dict(dropout=dropout, dtype=dtype, device=device)
        self.reference_block_order = reference_block_order
        self.ssa = _SSA(dim, heads, ssa_dim_key, ssa_dim_value, reduction_factor, **kw)
        self.ff1 = ConvMLP(dim, ff_expansion_factor, **kw)
        self.iwsa = _IWSA(dim, window_size, heads, iwsa_dim_key, iwsa_dim_value, **kw)
        self.ff2 = ConvMLP(dim, ff_expansion_factor, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _block(x, self.ssa, self.ff1, self.iwsa, self.ff2, self.reference_block_order,
                      train=train, generator=generator)


class ScalableViT(nn.Module):
    """``[B, H, W, channels]`` images -> ``[B, num_classes]`` logits in the
    model dtype (None: fp32). Widths double from one stage to the next;
    ``vit_tpu``'s names: ``patchify``; a stage's first block as
    ``ssa_{s}_0``, ``ff1_{s}_0``, ``iwsa_{s}_0``, ``ff2_{s}_0`` with
    ``peg_{s}`` between its halves; ``stage_{s}`` holding its other blocks
    (a list when there are more than one, the block itself at one, absent at
    none); ``stage_norm_{s}`` (eps 1e-5); ``down_{s}``; ``head_norm``,
    ``head``. ``dropout`` acts only under ``forward(..., train=True)``."""

    def __init__(self, *, num_classes: int, dim: int, depth: tuple, heads, reduction_factor,
                 window_size=None, iwsa_dim_key=32, iwsa_dim_value=32, ssa_dim_key=32,
                 ssa_dim_value=32, ff_expansion_factor: int = 4, channels: int = 3,
                 dropout: float = 0.0, reference_block_order: bool = False,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        n = len(depth)
        dims = [2**i * dim for i in range(n)]
        per = [cast_tuple(v, n) for v in (heads, ssa_dim_key, ssa_dim_value, reduction_factor,
                                           iwsa_dim_key, iwsa_dim_value, window_size)]
        kw = dict(dtype=dtype, device=device)
        self.n_stages, self.jax_stages = n, {}
        self.patchify = Conv(channels, dim, 7, strides=4, **kw)
        for s in range(n):
            h, sk, sv, r, ik, iv, wsz = (p[s] for p in per)
            block = lambda: _ScalableBlock(dims[s], h, sk, sv, r, ik, iv, wsz,
                                           ff_expansion_factor,
                                           reference_block_order=reference_block_order,
                                           dropout=dropout, **kw)
            for name, mod in block().named_children():  # the first block, unscanned
                self.add_module(f"{name}_{s}_0", mod)
            self.add_module(f"peg_{s}", PEG(dims[s], **kw))
            rest = depth[s] - 1
            if rest > 1:
                setattr(self, f"stage_{s}", nn.ModuleList(block() for _ in range(rest)))
                self.jax_stages[f"stage_{s}"] = rest
            elif rest == 1:
                setattr(self, f"stage_{s}", block())
            self.add_module(f"stage_norm_{s}", LayerNorm(dims[s], eps=1e-5, **kw))
            if s + 1 < n:
                self.add_module(f"down_{s}", Downsample(dims[s], dims[s + 1], **kw))
        self.reference_block_order = reference_block_order
        self.head_norm = LayerNorm(dims[-1], eps=1e-5, **kw)
        self.head = Dense(dims[-1], num_classes, **kw)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        x = self.patchify(img)
        for s in range(self.n_stages):
            x = _block(x, *(getattr(self, f"{m}_{s}_0") for m in ("ssa", "ff1", "iwsa", "ff2")),
                       self.reference_block_order, getattr(self, f"peg_{s}"), train, generator)
            rest = getattr(self, f"stage_{s}", None)
            for block in (rest if isinstance(rest, nn.ModuleList) else
                          () if rest is None else (rest,)):
                x = block(x, train, generator)
            x = getattr(self, f"stage_norm_{s}")(x)
            if s + 1 < self.n_stages:
                x = getattr(self, f"down_{s}")(x)
        # jnp.mean over bf16 sums in fp32 and returns bf16
        x = self.head_norm(x.float().mean(dim=(1, 2)).to(x.dtype))
        return self.head(x)
