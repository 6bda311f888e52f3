"""Patch embedding, the flax-named parameter containers (Dense, LayerNorm and
the BatchNorm), the token mean, and the token embedders of the
small-dataset and merging families (port of ``vit_tpu/nn/embed.py``:
``PatchEmbed``, ``SPT``, ``PatchMerger``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.block_attention import _ln_f32, _mm, _softmax, fp32_bf16_sums


def _mm_rounded(a, b, dtype):
    """``a @ b`` accumulated in fp32 and rounded once to ``dtype`` (JAX's
    ``preferred_element_type=f32`` then ``astype``): on the card a bf16
    product is one cuBLAS bf16 GEMM issued under ``fp32_bf16_sums`` (fp32
    sums, one rounding, whatever the caller's flag); a plain product outside
    any kernel, as XLA's is in ``vit_tpu``."""
    if a.is_cuda and a.dtype == b.dtype == dtype == torch.bfloat16:
        with fp32_bf16_sums():
            return torch.matmul(a, b)
    return _mm(a, b, dtype)


mm_rounded_op = _build.define_op(
    "mm_rounded(Tensor a, Tensor b, ScalarType dtype) -> Tensor",
    cuda=_mm_rounded, cpu=_mm,
    fake=lambda a, b, dtype: a.new_empty(*a.shape[:-1], b.shape[-1], dtype=dtype),
)


class MmRoundedFn(torch.autograd.Function):
    """A bf16 product ``a [..., K] @ b [K, N]`` on the card as an autograd
    Function: ``_mm_rounded`` forward; backward ``g @ bᵀ`` and ``aᵀ @ g``,
    each one cuBLAS bf16 GEMM issued under ``fp32_bf16_sums`` (fp32 sums,
    one rounding to bf16), as XLA transposes flax's ``Dense(dtype=bfloat16)``
    (bf16 dots of the bf16 cotangent). Without it autograd would issue the
    two products at the caller's cuBLAS flag, whose default adds split-K
    partials in bf16.

    ``apply(a, b)``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_rounded(a, b, torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        with fp32_bf16_sums():
            if ctx.needs_input_grad[0]:
                da = torch.matmul(g, b.t())
            if ctx.needs_input_grad[1]:
                db = torch.matmul(a.reshape(-1, a.shape[-1]).t(), g.reshape(-1, g.shape[-1]))
        return da, db


def _mm_rounded_kernel(a, b, dtype):
    """``_mm_rounded``, through ``MmRoundedFn`` where an operand needs
    grad."""
    return MmRoundedFn.apply(a, b) if ops.needs_grad(a, b) else _mm_rounded(a, b, dtype)


def mm_rounded(a, b, dtype):
    """The product of ``Dense``: ``_mm`` but for a bf16 product, which runs
    ``_mm_rounded`` on the card (under grad through ``MmRoundedFn``), ``_mm``
    on the CPU and under ``ops.force_backend("torch")`` (differentiated by
    autograd), and, while ``torch.export`` traces it, the operator
    ``vit_tpu_torch::mm_rounded``, so that ``fp32_bf16_sums`` travels into an
    exported program (``ops._route``)."""
    if a.dtype == b.dtype == dtype == torch.bfloat16:
        return ops._route(mm_rounded_op, _mm_rounded_kernel, _mm, a, b, dtype)(a, b, dtype)
    return _mm(a, b, dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``, with the kernel in flax's ``[in, out]`` layout (not
    ``nn.Linear``'s ``[out, in]``) and fp32 parameters. ``dtype`` (None:
    fp32, what flax infers from fp32 parameters) is the computation dtype:
    the input and the kernel are cast to it, the product is rounded once to
    it, and the bias is cast to it and added in it. With ``dtype=bfloat16``
    the bias add is a bf16 add, unlike the raw-parameter blocks' fp32 bias.

    The product: on a CUDA tensor in bf16, one cuBLAS bf16 GEMM
    (``_mm_rounded``: fp32 sums, one rounding; under grad its backward
    products too, ``MmRoundedFn``); in fp32, on the CPU and under
    ``ops.force_backend("torch")``, ``_mm`` (an fp32 product of the rounded
    operands). Both round at the same place, in other sum orders. An
    exported program holds the operator ``vit_tpu_torch::mm_rounded``
    (``mm_rounded``)."""

    def __init__(self, features_in: int, features: int, *, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.kernel = nn.Parameter(torch.zeros(features_in, features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x):
        x, w = x.to(self.dtype), self.kernel.to(self.dtype)
        y = mm_rounded(x, w, self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype, use_bias=use_bias)``: the statistics
    and the fast-variance normalisation in fp32, the output cast to ``dtype``
    (None: fp32, what flax infers from fp32 parameters). Without a bias
    there is no ``bias`` parameter and nothing is added."""

    def __init__(self, dim: int, *, eps: float = 1e-6, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device)) if use_bias else None

    def forward(self, x):
        y = _ln_f32(x.float(), self.scale, 0.0 if self.bias is None else self.bias, self.eps)
        return y if self.dtype is None else y.to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=not train, momentum=momentum,
    epsilon=eps, dtype=dtype)`` over the last axis (flax 0.12's
    ``_compute_stats`` and ``_normalize``): fp32 parameters ``scale`` and
    ``bias``, fp32 buffers ``mean`` and ``var`` (flax's ``batch_stats``).

    Both modes normalise as flax's ``_normalize``: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in fp32, rounded once to ``dtype``
    (None: fp32, what flax infers from the fp32 statistics). At inference
    ``mean`` and ``var`` are the running statistics. With ``train=True``
    they are the batch's, over every axis but the last, in fp32 whatever
    x's dtype: ``E[x]`` and flax's fast variance ``max(0, E[x^2] - E[x]^2)``
    (``torch.maximum`` splits the gradient of a tie as ``jnp.maximum``
    does), and the gradients flow through both. The running statistics then
    move without grad, in flax's convention: ``ra = momentum * ra + (1 -
    momentum) * batch``, the running variance the biased batch variance.
    (``F.batch_norm`` takes ``1 - momentum`` and keeps the unbiased
    variance.) Each training forward updates them once: a recompute of it
    would update them again."""

    def __init__(self, dim: int, *, eps: float = 1e-5, momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("mean", torch.zeros(dim, device=device))
        self.register_buffer("var", torch.ones(dim, device=device))

    def forward(self, x, train: bool = False):
        if train:
            # flax casts x to fp32 apart for the statistics and for the
            # normalisation: a bf16 x gets the two paths' gradients each
            # rounded to bf16, then summed
            xs = x.float()
            axes = tuple(range(x.dim() - 1))
            mean = xs.mean(dim=axes)
            var = torch.maximum(torch.zeros((), device=x.device),
                                (xs * xs).mean(dim=axes) - mean * mean)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (x.float() - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.dtype or torch.float32)


def mean_tokens(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=1)``: the tokens summed in fp32, divided by their
    count in fp32, rounded once to ``x``'s dtype (the mean pool)."""
    return (x.float().sum(dim=1) / x.shape[1]).to(x.dtype)


class PatchEmbed(nn.Module):
    """Non-overlapping patchify + fp32 projection, rounded once to
    ``out_dtype`` (the stream dtype; None keeps fp32). The GEMM is a plain
    ``torch.matmul``: it lies outside every TPU kernel."""

    def __init__(self, dim: int, patch_size: int, channels: int = 3, *,
                 out_dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.patch_size = patch_size
        self.out_dtype = out_dtype
        self.proj = Dense(patch_size * patch_size * channels, dim, device=device)

    def forward(self, img):
        x = self.proj(ops.patchify(img, self.patch_size))
        return x.to(self.out_dtype) if self.out_dtype is not None else x


class SPT(nn.Module):
    """Shifted Patch Tokenization (``vit_tpu/nn/embed.py:SPT``): the image and
    its four 1-px shifts (``ops.spt_shifts``), patchified, then a LayerNorm
    without bias (eps 1e-5) and a Dense ``proj``, both in ``dtype`` (None:
    fp32). Parameters: ``norm/scale``, ``proj/{kernel, bias}``."""

    def __init__(self, dim: int, patch_size: int, channels: int = 3, *,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.patch_size = patch_size
        patch_dim = patch_size * patch_size * 5 * channels
        self.norm = LayerNorm(patch_dim, eps=1e-5, use_bias=False, dtype=dtype, device=device)
        self.proj = Dense(patch_dim, dim, dtype=dtype, device=device)

    def forward(self, img):
        return self.proj(self.norm(ops.patchify(ops.spt_shifts(img), self.patch_size)))


class PatchMerger(nn.Module):
    """Learned-attention token merging (``vit_tpu/nn/embed.py:PatchMerger``):
    ``[B, N, D] -> [B, T, D]``, T learned fp32 ``queries`` ``[T, D]``
    attending the tokens normed by ``norm`` (a flax LayerNorm in ``dtype``,
    eps 1e-6). It rounds where ``vit_tpu`` run op by op rounds, in the
    stream's dtype throughout: the queries cast to it and then scaled by
    ``dim**-0.5``, both products summed in fp32 and rounded once (a bf16 dot
    without ``preferred_element_type``), and ``jax.nn.softmax``'s max / exp /
    sum / divide on the rounded scores, each op rounded. Plain PyTorch:
    ``vit_tpu`` computes it outside any Pallas kernel."""

    def __init__(self, dim: int, num_tokens_out: int, *, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        self.scale = dim**-0.5
        self.queries = nn.Parameter(torch.zeros(num_tokens_out, dim, device=device))
        self.norm = LayerNorm(dim, dtype=dtype, device=device)

    def forward(self, x):
        xn = self.norm(x)
        dt = xn.dtype
        q = self.queries.to(dt) * self.scale
        attn = torch.einsum("qd,bnd->bqn", q.float(), xn.float()).to(dt)
        p = _softmax(attn)
        return torch.einsum("bqn,bnd->bqd", p.float(), xn.float()).to(dt)


class ProjectInOut(nn.Module):
    """The width bridge of CrossViT's reference layout
    (``vit_tpu/nn/embed.py:ProjectInOut``): a Dense ``project_in`` from
    ``dim_in`` to ``dim_out``, a callable run at ``dim_out``, a Dense
    ``project_out`` back to ``dim_in``; both flax Denses in ``dtype`` (None:
    fp32). ``forward(x, fn, *args, **kwargs)``."""

    def __init__(self, dim_in: int, dim_out: int, *, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        self.project_in = Dense(dim_in, dim_out, dtype=dtype, device=device)
        self.project_out = Dense(dim_out, dim_in, dtype=dtype, device=device)

    def forward(self, x, fn, *args, **kwargs):
        return self.project_out(fn(self.project_in(x), *args, **kwargs))
