"""Convolutional modules over NHWC feature maps (port of ``vit_tpu/nn/conv.py``:
``PEG``, ``Downsample``, ``PatchEmbedding``, ``DepthWiseConv2d`` (PiT's
flavour, and CvT's with an inference BatchNorm, folded or not), PiT's
``Pool``, CrossFormer's ``CrossEmbedLayer``, NesT's ``Aggregate`` and both
branches of ``ConvMLP``, on a flax-``nn.Conv`` container).

The convolutions lie outside every TPU kernel (XLA ran them on the TPU), so
they are ``F.conv2d``; ``ConvMLP``'s token branch is the fused MLP kernel
over the token view, as in the JAX package, and its BatchNorm branch is
plain PyTorch, as ``vit_tpu``'s is plain XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.utils import cdiv, pair
from vit_tpu_torch.nn.attention import dropout
from vit_tpu_torch.nn.blocks import FeedForward
from vit_tpu_torch.nn.embed import BatchNorm, Dense, LayerNorm
from vit_tpu_torch.ops.fused_mlp import _activate


def same_padding(n: int, k: int, s: int) -> tuple:
    """TF's SAME padding of one axis (flax ``padding="SAME"``): the total
    ``max((ceil(n/s) - 1)*s + k - n, 0)``, the odd pixel at the end."""
    total = max((cdiv(n, s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` over ``[B, H, W, C]``: ``padding`` "SAME" (the
    default) or flax's explicit ``[(low, high), (low, high)]`` zeros of the
    two spatial axes. The kernel is
    kept in PyTorch's OIHW layout (``from_jax_params`` turns flax's HWIO).
    ``dtype`` (None: fp32, what flax infers from fp32 parameters) is the
    computation dtype: input and kernel are cast to it, the convolution sums
    their products in fp32 and rounds once to it, and the bias is cast to it
    and added in it, after that rounding (``F.conv2d(..., bias)`` would add
    it before). On the card the convolution runs in the dtype (cuDNN sums
    bf16 products in fp32); on the CPU a bf16 one runs in fp32 on the
    rounded operands, because oneDNN's bf16 convolution is wrong at some
    shapes (16 input channels, 4x4 kernel, stride 4: off by the size of the
    output). A float32 convolution on the card honours ``torch.backends.
    cudnn.allow_tf32``: the caller turns TF32 off for an fp32 reference."""

    def __init__(self, features_in: int, features: int, kernel_size, *, strides=1,
                 padding="SAME", feature_group_count: int = 1, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.kernel_size, self.strides = pair(kernel_size), pair(strides)
        if padding != "SAME" and len(padding) != 2:
            raise ValueError(f"padding must be 'SAME' or two (low, high) pairs, got {padding!r}")
        self.padding = padding
        self.groups = feature_group_count
        self.dtype = dtype or torch.float32
        kh, kw = self.kernel_size
        self.kernel = nn.Parameter(torch.zeros(features, features_in // self.groups, kh, kw,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        if self.padding == "SAME":
            ph, pw = same_padding(h, kh, sh), same_padding(w, kw, sw)
        else:
            ph, pw = (tuple(p) for p in self.padding)
        xc = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        if any(ph + pw):
            xc = F.pad(xc, (*pw, *ph))
        w = self.kernel.to(self.dtype)
        if xc.is_cuda or self.dtype == torch.float32:
            y = F.conv2d(xc, w, stride=(sh, sw), groups=self.groups)
        else:
            y = F.conv2d(xc.float(), w.float(), stride=(sh, sw), groups=self.groups).to(self.dtype)
        y = y.permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class PEG(nn.Module):
    """Positional Encoding Generator: ``x + depthwise_conv(x)`` (``proj``)."""

    def __init__(self, dim: int, kernel_size: int = 3, *, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        self.proj = Conv(dim, dim, kernel_size, feature_group_count=dim, dtype=dtype,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.proj(x)


class Downsample(nn.Module):
    """The stage transition of ScalableViT and RegionViT: a 3x3 stride-2 SAME
    ``conv`` with a bias, ``dim_in -> dim`` channels."""

    def __init__(self, dim_in: int, dim: int, *, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        self.conv = Conv(dim_in, dim, 3, strides=2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class DepthWiseConv2d(nn.Module):
    """A depthwise conv (``depthwise``: ``dim_in`` groups, SAME padding,
    stride ``stride``), then with ``batch_norm`` a BatchNorm (``bn``, eps
    1e-5, in ``dtype``: CvT's projections), then a 1x1 conv (``pointwise``).
    ``use_bias`` gives both convs a bias (PiT's flavour: no BatchNorm). With
    ``fold_bn`` the BatchNorm is folded into the depthwise conv
    (``utils.fold_batch_norm``): there is no ``bn``, and the depthwise conv
    has a bias whatever ``use_bias``, added in ``dtype`` after the
    convolution's rounding, as flax adds it. ``forward(x, train=True)``
    normalises with the batch's statistics and updates the running ones
    (``BatchNorm``); a folded module is inference only and refuses it, as
    ``vit_tpu`` asserts."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, stride: int, *,
                 use_bias: bool = True, batch_norm: bool = False, fold_bn: bool = False,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        folded = batch_norm and fold_bn
        self.folded = folded
        self.depthwise = Conv(dim_in, dim_in, kernel_size, strides=stride,
                              feature_group_count=dim_in, use_bias=use_bias or folded,
                              dtype=dtype, device=device)
        self.bn = (BatchNorm(dim_in, dtype=dtype, device=device)
                   if batch_norm and not folded else None)
        self.pointwise = Conv(dim_in, dim_out, 1, use_bias=use_bias, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train and self.folded:
            raise ValueError("a BatchNorm-folded model is inference only (train=True)")
        x = self.depthwise(x)
        return self.pointwise(x if self.bn is None else self.bn(x, train))


class Pool(nn.Module):
    """PiT's token pooling: the patch tokens ``[B, 1 + side**2, dim_in]`` as a
    ``side`` x ``side`` map through ``downsample`` (``DepthWiseConv2d``, 3x3,
    stride 2, to ``dim``), the cls token through ``cls_proj`` (a flax Dense
    in ``dtype``), the cls token back in front. This is ``vit_tpu``'s Pool,
    which pools (the upstream one never runs: bug register #2)."""

    def __init__(self, dim_in: int, dim: int, *, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        self.downsample = DepthWiseConv2d(dim_in, dim, 3, 2, dtype=dtype, device=device)
        self.cls_proj = Dense(dim_in, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cls, tokens = x[:, :1], x[:, 1:]
        b, n, c = tokens.shape
        side = int(round(n**0.5))
        fmap = self.downsample(tokens.reshape(b, side, side, c))
        return torch.cat([self.cls_proj(cls), fmap.reshape(b, -1, fmap.shape[-1])], dim=1)


class PatchEmbedding(nn.Module):
    """Space-to-depth then a Dense (``proj``): ``[B, H, W, C] -> [B, H/p,
    W/p, dim_out]``. The patch features are channel-major ``(c p1 p2)``, as
    in ``vit_tpu`` (not ``ops.patchify``'s ``(p1 p2 c)``)."""

    def __init__(self, dim_in: int, dim_out: int, patch_size: int, *,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Dense(dim_in * patch_size * patch_size, dim_out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
        return self.proj(x.reshape(b, h // p, w // p, c * p * p))


class CrossEmbedLayer(nn.Module):
    """CrossFormer's cross-scale embedding: convs of the sorted
    ``kernel_sizes`` at one ``stride`` (``conv_{i}``), the channels halved
    from scale to scale (the last conv takes the remainder), each padded
    ``((k - s) // 2, (k - s + 1) // 2)`` explicitly (not SAME), the outputs
    concatenated on channels."""

    def __init__(self, dim_in: int, dim: int, kernel_sizes, stride: int = 2, *,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        kernels = sorted(kernel_sizes)
        dims = [dim // 2 ** (i + 1) for i in range(len(kernels))]
        dims[-1] = dim - sum(dims[:-1])
        for i, (k, d) in enumerate(zip(kernels, dims)):
            pad = ((k - stride) // 2, (k - stride + 1) // 2)
            self.add_module(f"conv_{i}", Conv(dim_in, d, k, strides=stride, padding=[pad, pad],
                                              dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([conv(x) for conv in self.children()], dim=-1)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")`` over
    ``[B, H, W, C]``: SAME's pads (the odd pixel at the end: ``(0, 1)`` at 56
    and 28) filled with -inf. ``F.max_pool2d(padding=...)`` pads both sides
    alike, which would shift every window."""
    _, h, w, _ = x.shape
    (pt, pb), (pl, pr) = same_padding(h, 3, 2), same_padding(w, 3, 2)
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1)


class Aggregate(nn.Module):
    """NesT's block aggregation: a 3x3 SAME ``conv``, a flax LayerNorm
    (``norm``, flax's default eps 1e-6) in ``dtype``, then a 3x3 max pool of
    stride 2, SAME (``max_pool_same``)."""

    def __init__(self, dim_in: int, dim: int, *, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        self.conv = Conv(dim_in, dim, 3, dtype=dtype, device=device)
        self.norm = LayerNorm(dim, eps=1e-6, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_same(self.norm(self.conv(x)))


class ConvMLP(nn.Module):
    """Conv-1x1 MLP over an NHWC map, ``dim -> dim * mult -> dim_out`` (None:
    ``dim``). Without ``batch_norm``: the tokens of the map through
    ``FeedForward`` (``ff``; with ``pre_norm`` its LayerNorm of eps
    ``ln_eps``), one ``ops.mlp`` call. With ``batch_norm`` (the LeViT
    flavour of ``vit_tpu``, run by no model): 1x1 conv ``up``, BatchNorm
    ``bn1``, hard-swish in ``dtype`` op by op, dropout, 1x1 conv ``down``,
    BatchNorm ``bn2``, plain PyTorch; the convs have a bias only with
    ``fold_bn``, where the two BatchNorms are folded into them (and
    ``train=True`` is refused). ``forward(x, train=True, generator=)``
    trains: the token branch's ``FeedForward`` takes its plain path with
    ``drop1`` and ``drop2`` where ``dropout`` is above 0, as ``vit_tpu``'s;
    the BatchNorm branch normalises with the batch's statistics and drops
    the activation at ``dropout``."""

    def __init__(self, dim: int, mult: int = 4, *, activation: str = "gelu",
                 pre_norm: bool = True, batch_norm: bool = False, fold_bn: bool = False,
                 dim_out: Optional[int] = None, ln_eps: float = 1e-5, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        dim_out = dim_out or dim
        self.batch_norm, self.fold_bn, self.dropout = batch_norm, fold_bn, dropout
        if not batch_norm:
            self.ff = FeedForward(dim, dim * mult, activation=activation, ln_eps=ln_eps,
                                  pre_norm=pre_norm, dim_out=dim_out, dropout=dropout,
                                  dtype=dtype, device=device)
            return
        kw = dict(dtype=dtype, device=device)
        self.up = Conv(dim, dim * mult, 1, use_bias=fold_bn, **kw)
        self.bn1 = None if fold_bn else BatchNorm(dim * mult, **kw)
        self.down = Conv(dim * mult, dim_out, 1, use_bias=fold_bn, **kw)
        self.bn2 = None if fold_bn else BatchNorm(dim_out, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.batch_norm:
            if train and self.fold_bn:
                raise ValueError("a BatchNorm-folded model is inference only (train=True)")
            norm = lambda bn, t: t if bn is None else bn(t, train)
            h = _activate(norm(self.bn1, self.up(x)), "hard_swish")
            if train:
                h = dropout(h, self.dropout, generator)
            return norm(self.bn2, self.down(h))
        b, h, w, c = x.shape
        return self.ff(x.reshape(b, h * w, c), train, generator).reshape(b, h, w, -1)
