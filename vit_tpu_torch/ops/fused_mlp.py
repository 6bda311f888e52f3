"""Fused transformer MLP: (LN ->) x@W1 + b1 -> activation -> @W2 + b2 (+x).

Port of ``vit_tpu/ops/fused_mlp.py``. ``fused_mlp`` is the Hopper kernel
(``csrc/fused_mlp.cu``); ``reference_mlp`` is its plain PyTorch twin and
mirrors the JAX twin op for op (flax LayerNorm in fp32, fp32 products of
bf16-rounded operands, biases added on the fp32 accumulator, the hidden
activations rounded to the weight dtype once, between the two GEMMs).
``fused_mlp_op`` is the kernel as a ``torch.library`` operator
(``_build.define_op``).

Two routes, by the weights' dtype (``block_attention.weights_route``), as
``vit_tpu``'s kernel picks its precision (fused_mlp.py:83-90): bf16 weights
(x bf16 or fp32) run the bf16 products (``gemm_route``); fp32 weights on an
fp32 x run the fp32 route (``csrc/gemm_f32.cuh``, fp32 sums of fp32
operands, the hidden kept in fp32), ``Precision.HIGHEST``'s arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.block_attention import (
    ACTIVATIONS,
    _activate,
    _ln_f32,
    _mm,
    _require_aligned,
    recompute_vjp,
    weights_route,
)


def gemm_route(dim: int, f: int) -> str:
    """Which GEMM runs both products of the kernel at widths ``dim`` (D) and
    ``f`` (F), chosen in C before any launch (``csrc/fused_mlp.cu``
    ``mlp_route_wgmma``): ``"wgmma"`` (``csrc/gemm_sm90.cuh``, wgmma fed by
    TMA) when both are multiples of 8, TMA's 16-byte row strides; else
    ``"wmma"`` (``csrc/gemm.cuh``, tiles loaded 2 bytes at a time: T2T's
    tokenizer widths 147 and 1323)."""
    return "wgmma" if dim % 8 == 0 and f % 8 == 0 else "wmma"


def reference_mlp(
    x, w1, b1, w2, b2, ln_scale=None, ln_bias=None,
    activation: str = "gelu", residual: bool = True, ln_eps: float = 1e-6,
):
    """Plain PyTorch twin (``vit_tpu``'s ``reference_mlp``)."""
    h = x.float()
    if ln_scale is not None:
        lb = ln_bias if ln_bias is not None else torch.zeros_like(ln_scale)
        h = _ln_f32(h, ln_scale.float(), lb.float(), ln_eps)
    h = _mm(h.to(w1.dtype), w1)
    if b1 is not None:
        h = h + b1.float()
    h = _activate(h, activation)
    h = _mm(h.to(w2.dtype), w2)
    if b2 is not None:
        h = h + b2.float()
    if residual:
        h = h + x.float()
    return h.to(x.dtype)


def fused_mlp(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: Optional[torch.Tensor],
    ln_scale: Optional[torch.Tensor] = None,
    ln_bias: Optional[torch.Tensor] = None,
    activation: str = "gelu",
    residual: bool = True,
    ln_eps: float = 1e-6,
) -> torch.Tensor:
    """The MLP block on the card over tokens ``x`` ``[..., T, D]`` (bf16 or
    fp32); ``w1`` ``[D, F]`` and ``w2`` ``[F, D]`` bf16, or fp32 with an
    fp32 ``x`` (the fp32 route, any D and F); biases and LN parameters fp32
    or None. On the bf16 route D and F of any size: where both are multiples
    of 8 the two products run on the wgmma GEMM, and every operand must then
    start on a 16-byte boundary (else this raises); other widths (T2T's 147
    and 1323) run on the WMMA GEMM (``gemm_route``). Returns ``x``'s shape
    and dtype."""
    if not x.is_cuda:
        raise ValueError("fused_mlp takes CUDA tensors")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or fp32, got {x.dtype}")
    fp32 = weights_route(x, w1, w2) == "fp32"
    if activation not in ACTIVATIONS:
        raise ValueError(activation)
    dim = x.shape[-1]
    f = w1.shape[1]
    if tuple(w1.shape) != (dim, f) or tuple(w2.shape) != (f, dim):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)} do not fit D={dim}")
    vecs = {"b1": (b1, f), "b2": (b2, dim), "ln_scale": (ln_scale, dim), "ln_bias": (ln_bias, dim)}
    for name, (t, size) in vecs.items():
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (size,)):
            raise TypeError(f"{name} must be fp32 [{size}], got {tuple(t.shape)} {t.dtype}")
    tensors = [t for t in (x, w1, w2, b1, b2, ln_scale, ln_bias) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if ln_bias is not None and ln_scale is None:
        raise ValueError("ln_bias without ln_scale")

    if not fp32 and gemm_route(dim, f) == "wgmma":
        _require_aligned(**{name: t for name, t in
                            dict(x=x, w1=w1, b1=b1, w2=w2, b2=b2).items() if t is not None})
    lib = _build.load_library()
    t = x.numel() // dim
    opts = dict(device=x.device, dtype=torch.float32 if fp32 else torch.bfloat16)
    xn = torch.empty(t, dim, **opts)
    h = torch.empty(t, f, **opts)
    out = torch.empty_like(x)
    ptr = lambda a: None if a is None else a.data_ptr()
    head = (x.data_ptr(),) if fp32 else (x.data_ptr(), int(x.dtype == torch.float32))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = (lib.vt_fused_mlp_f32 if fp32 else lib.vt_fused_mlp)(
            *head, ptr(ln_scale), ptr(ln_bias),
            w1.data_ptr(), ptr(b1), w2.data_ptr(), ptr(b2),
            out.data_ptr(), xn.data_ptr(), h.data_ptr(),
            t, dim, f, ACTIVATIONS[activation], int(residual), float(ln_eps), stream,
        )
    _build.check(lib, rc, f"fused_mlp kernel ({'fp32' if fp32 else 'bf16'} route)")
    _build.count_launch("fused_mlp", fp32=fp32)
    return out


fused_mlp_op = _build.define_op(
    "fused_mlp(Tensor x, Tensor w1, Tensor? b1, Tensor w2, Tensor? b2, Tensor? ln_scale, "
    "Tensor? ln_bias, str activation, bool residual, float ln_eps) -> Tensor",
    cuda=fused_mlp, cpu=reference_mlp, fake=_build.contiguous_like,
)


class MlpFn(torch.autograd.Function):
    """The MLP block as an autograd Function (``vit_tpu``'s ``_mlp_ad``,
    ``vit_tpu/ops/fused_mlp.py:163-195``): ``forward_fn`` (the kernel,
    ``fused_mlp``; a CPU test passes the twin) forward, saving only the
    seven inputs as ``_mlp_fwd`` does; backward as ``_mlp_bwd``, the twin
    ``reference_mlp`` recomputed on them and differentiated at the
    cotangent cast to ``x``'s dtype (``block_attention.recompute_vjp``).
    ``b1``, ``b2``, ``ln_scale`` and ``ln_bias`` may be None, and get no
    gradient.

    ``apply(forward_fn, x, w1, b1, w2, b2, ln_scale, ln_bias, activation,
    residual, ln_eps)``."""

    @staticmethod
    def forward(ctx, forward_fn, x, w1, b1, w2, b2, ln_scale, ln_bias, activation, residual,
                ln_eps):
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_scale, ln_bias)
        ctx.config = dict(activation=activation, residual=residual, ln_eps=ln_eps)
        return forward_fn(x, w1, b1, w2, b2, ln_scale, ln_bias, **ctx.config)

    @staticmethod
    def backward(ctx, g):
        grads = recompute_vjp(lambda *a: reference_mlp(*a, **ctx.config), ctx.saved_tensors,
                              ctx.needs_input_grad[1:8], g)
        _build.count_recompute("fused_mlp")
        return (None, *grads, None, None, None)
