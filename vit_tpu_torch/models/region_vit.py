"""RegionViT — regional-to-local attention (port of
``vit_tpu/models/region_vit.py``).

Local tokens come from an 8x8 stride-4 conv (or, with
``tokenize_local_3_conv``, three 3x3 convs with bias-free LayerNorms and the
tanh GELU), region tokens from the image's ``local_patch_size *
window_size`` patches (``ops.patchify``) through ``region_proj``. In each
stage, each block's one attention module (heads of 32, eps 1e-5) first runs
over the region tokens, then over each window of local tokens with its
region token in front, a learned relative-position bias on those joint
tokens; an MLP follows on the joint tokens. Every attention is the unfused
raw-parameter branch of ``nn.Attention`` on ``ops.qkv_attention`` (the
fused-qkv kernel on the card), every MLP ``ops.mlp``. A bf16 model gives
bf16 logits, as ``vit_tpu``'s does.

``reference_quirks=True`` is the reference as ``vit_tpu`` reproduces it:
region tokens space-to-depthed (channel-major) from the local map, so the
windows span the local/region ratio; one Downsample shared by both token
sets; the clipped out-of-range bias gather; the 4-D unpooled logits.

Training (``forward(img, train=True, generator=..., remat=...)``): each
layer's one ``attn`` runs the regional and the joint pass, so its gradients
add up over both uses (vit_tpu/models/region_vit.py:52-79). At
``attn_dropout`` 0 both passes run ``ops.qkv_attention`` (on the card
``ops.QkvAttentionFn``), the joint one with the stage's relative-position
bias, whose ``dbias`` autograd sums over the ``b * n_win`` windows and
scatters back into the gathered table (with ``reference_quirks`` the clipped
indices gather one entry many times, and their gradients add). Above 0 both
passes materialize with ``attn_drop`` and ``out_drop``; ``ff_dropout`` puts
the MLP on its plain path with ``drop1`` and ``drop2``. Masks are drawn
layer after layer, regional pass, joint pass, MLP, as ``vit_tpu``'s
``nn.scan`` over a stage draws them. ``vit_tpu`` does not remat a stage's
scan, so ``remat`` checkpoints nothing.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree (a stage's ``blocks`` are scanned
there when deeper than 1: ``jax_stages`` lists those; the conv kernels are
turned to OIHW).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.nn.attention import Attention
from vit_tpu_torch.nn.bias import ReferenceWindowRelPosBias, WindowRelPosBias
from vit_tpu_torch.nn.blocks import FeedForward
from vit_tpu_torch.nn.conv import PEG, Conv, Downsample
from vit_tpu_torch.nn.embed import Dense, LayerNorm

HEADS, DIM_HEAD = 4, 32  # every stage's attention, as vit_tpu's _R2LStage defaults


class _R2LBlock(nn.Module):
    """One regional-to-local layer: ``attn`` (one module for the regional
    and the joint pass, dropout ``attn_dropout``) and ``ff`` (on the joint
    tokens, dropout ``ff_dropout``), LayerNorm eps 1e-5."""

    def __init__(self, dim: int, *, attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        self.attn = Attention(dim, HEADS, DIM_HEAD, norm_eps=1e-5, dropout=attn_dropout,
                              dtype=dtype, device=device)
        self.ff = FeedForward(dim, 4 * dim, ln_eps=1e-5, dropout=ff_dropout, dtype=dtype,
                              device=device)

    def forward(self, local_tokens, region, bias, window: int, train: bool = False,
                generator: Optional[torch.Generator] = None):
        b, lh, lw, d = local_tokens.shape
        n_win = region.shape[1]
        kw = dict(train=train, generator=generator)
        region = region + self.attn(region, **kw)
        # each window (ops.window_partition's row-major order) behind its region token
        joint = torch.cat([region.reshape(b * n_win, 1, d),
                           ops.window_partition(local_tokens, window)], dim=1)
        joint = joint + self.attn(joint, bias=bias, **kw)
        joint = joint + self.ff(joint, **kw)
        return (ops.window_unpartition(joint[:, 1:], window, lh, lw),
                joint[:, :1].reshape(b, n_win, d))


class _R2LStage(nn.Module):
    """A stage: ``rel_pos_bias`` and ``depth`` layers in ``blocks`` (a list
    at depth > 1, the layer itself at 1). Windows are ``window_size`` wide;
    with ``reference_quirks`` they span the local/region ratio of the
    stage's inputs, and the bias is ``ReferenceWindowRelPosBias`` of that
    grid."""

    def __init__(self, dim: int, window_size: int, depth: int, *, reference_quirks: bool,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        self.window_size, self.reference_quirks = window_size, reference_quirks
        if reference_quirks:
            self.rel_pos_bias = ReferenceWindowRelPosBias(HEADS, window_size, device=device)
        else:
            self.rel_pos_bias = WindowRelPosBias(HEADS, window_size, prepend_tokens=1,
                                                 device=device)
        block = lambda: _R2LBlock(dim, attn_dropout=attn_dropout, ff_dropout=ff_dropout,
                                  dtype=dtype, device=device)
        self.blocks = nn.ModuleList(block() for _ in range(depth)) if depth > 1 else block()

    def forward(self, local_tokens, region_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None):
        b, lh, lw, d = local_tokens.shape
        rh, rw = region_tokens.shape[1:3]
        wsz_h, wsz_w = lh // rh, lw // rw
        if self.reference_quirks:
            if wsz_h != wsz_w:
                raise ValueError(f"non-square local/region ratio {wsz_h}x{wsz_w}")
            bias = self.rel_pos_bias(wsz_h, wsz_w)
        elif wsz_h != self.window_size or wsz_w != self.window_size:
            raise ValueError(f"local/region ratio {wsz_h}x{wsz_w} != window_size "
                             f"{self.window_size}")
        else:
            bias = self.rel_pos_bias()
        region = region_tokens.reshape(b, rh * rw, d)
        blocks = self.blocks if isinstance(self.blocks, nn.ModuleList) else (self.blocks,)
        for block in blocks:
            local_tokens, region = block(local_tokens, region, bias, wsz_h, train, generator)
        return local_tokens, region.reshape(b, rh, rw, d)


class RegionViT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` logits in the model
    dtype (None: fp32); ``[B, rh, rw, num_classes]`` with
    ``reference_quirks``. ``vit_tpu``'s names: ``local_conv`` (or
    ``local_conv{0,1,2}`` and ``local_norm{0,1}``), ``region_proj``,
    ``local_down_{s}`` and ``region_down_{s}`` (one ``down_{s}`` with
    ``reference_quirks``), ``peg_{s}`` with ``use_peg``, ``stage_{s}``,
    ``head_norm`` (no bias), ``head``. ``attn_dropout`` and ``ff_dropout``
    act only under ``forward(..., train=True)``."""

    def __init__(self, *, dim=(64, 128, 256, 512), depth=(2, 2, 8, 2), window_size: int = 7,
                 num_classes: int = 1000, tokenize_local_3_conv: bool = False,
                 local_patch_size: int = 4, use_peg: bool = False, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, reference_quirks: bool = False,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d0 = dim[0]
        self.region_patch_size = local_patch_size * window_size
        self.tokenize_local_3_conv, self.use_peg = tokenize_local_3_conv, use_peg
        self.reference_quirks, self.n_stages = reference_quirks, len(dim)
        if tokenize_local_3_conv:
            self.local_conv0 = Conv(3, d0, 3, strides=2, **kw)
            self.local_norm0 = LayerNorm(d0, eps=1e-5, use_bias=False, **kw)
            self.local_conv1 = Conv(d0, d0, 3, strides=2, **kw)
            self.local_norm1 = LayerNorm(d0, eps=1e-5, use_bias=False, **kw)
            self.local_conv2 = Conv(d0, d0, 3, **kw)
        else:
            self.local_conv = Conv(3, d0, 8, strides=4, **kw)
        region_in = d0 if reference_quirks else 3
        self.region_proj = Dense(region_in * self.region_patch_size**2, d0, **kw)
        self.jax_stages = {}
        for s in range(self.n_stages):
            if s > 0:
                if reference_quirks:
                    self.add_module(f"down_{s}", Downsample(dim[s - 1], dim[s], **kw))
                else:
                    self.add_module(f"local_down_{s}", Downsample(dim[s - 1], dim[s], **kw))
                    self.add_module(f"region_down_{s}", Downsample(dim[s - 1], dim[s], **kw))
                if use_peg:
                    self.add_module(f"peg_{s}", PEG(dim[s], **kw))
            self.add_module(f"stage_{s}", _R2LStage(
                dim[s], window_size, depth[s], reference_quirks=reference_quirks,
                attn_dropout=attn_dropout, ff_dropout=ff_dropout, **kw))
            if depth[s] > 1:
                self.jax_stages[f"stage_{s}/blocks"] = depth[s]
        self.head_norm = LayerNorm(dim[-1], eps=1e-5, use_bias=False, **kw)
        self.head = Dense(dim[-1], num_classes, **kw)

    def _local_tokens(self, img):
        if not self.tokenize_local_3_conv:
            return self.local_conv(img)
        # flax nn.gelu: the tanh form, here on the fp32 values rounded once
        gelu = lambda t: F.gelu(t.float(), approximate="tanh").to(t.dtype)
        x = gelu(self.local_norm0(self.local_conv0(img)))
        x = gelu(self.local_norm1(self.local_conv1(x)))
        return self.local_conv2(x)

    def _region_tokens(self, img, local_tokens):
        p = self.region_patch_size
        if self.reference_quirks:  # channel-major space-to-depth of the local map
            b, lh, lw, c = local_tokens.shape
            xr = local_tokens.reshape(b, lh // p, p, lw // p, p, c).permute(0, 1, 3, 5, 2, 4)
            return self.region_proj(xr.reshape(b, lh // p, lw // p, c * p * p))
        b, h, w, _ = img.shape
        return self.region_proj(ops.patchify(img, p).reshape(b, h // p, w // p, -1))

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        _, h, w, _ = img.shape
        p = self.region_patch_size
        if h % p or w % p:
            raise ValueError(f"image {h} x {w} does not divide into region patches of {p}")
        local_tokens = self._local_tokens(img)
        region_tokens = self._region_tokens(img, local_tokens)
        for s in range(self.n_stages):
            if s > 0:
                if self.reference_quirks:
                    down = getattr(self, f"down_{s}")
                    local_tokens, region_tokens = down(local_tokens), down(region_tokens)
                else:
                    local_tokens = getattr(self, f"local_down_{s}")(local_tokens)
                    region_tokens = getattr(self, f"region_down_{s}")(region_tokens)
                if self.use_peg:
                    local_tokens = getattr(self, f"peg_{s}")(local_tokens)
            local_tokens, region_tokens = getattr(self, f"stage_{s}")(local_tokens, region_tokens,
                                                                      train, generator)
        if self.reference_quirks:  # the reference's unpooled 4-D logits
            return self.head(self.head_norm(region_tokens))
        # jnp.mean over bf16 sums in fp32 and returns bf16
        x = region_tokens.float().mean(dim=(1, 2)).to(region_tokens.dtype)
        return self.head(self.head_norm(x))
