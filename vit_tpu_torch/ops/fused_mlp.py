"""Fused transformer MLP: (LN ->) x@W1 + b1 -> activation -> @W2 + b2 (+x).

Port of ``vit_tpu/ops/fused_mlp.py``. ``fused_mlp`` is the Hopper kernel
(``csrc/fused_mlp.cu``); ``reference_mlp`` is its plain PyTorch twin and
mirrors the JAX twin op for op (flax LayerNorm in fp32, fp32 products of
bf16-rounded operands, biases added on the fp32 accumulator, the hidden
activations rounded to the weight dtype once, between the two GEMMs).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.block_attention import _ln_f32, _mm

# Activation codes shared with csrc/gemm.cuh (enum Act).
ACTIVATIONS = {"gelu": 1, "gelu_exact": 2, "hard_swish": 3}


def _activate(h, activation: str):
    if activation == "gelu":  # flax nn.gelu's default: the tanh form
        return F.gelu(h, approximate="tanh")
    if activation == "gelu_exact":  # erf form, HF/timm ViTs
        return F.gelu(h)
    if activation == "hard_swish":  # LeViT MLP flavor
        return h * F.relu6(h + 3.0) / 6.0
    raise ValueError(activation)


def reference_mlp(
    x, w1, b1, w2, b2, ln_scale=None, ln_bias=None, *,
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
    *,
    activation: str = "gelu",
    residual: bool = True,
    ln_eps: float = 1e-6,
) -> torch.Tensor:
    """The MLP block on the card over tokens ``x`` ``[..., T, D]`` (bf16 or
    fp32); ``w1`` ``[D, F]`` and ``w2`` ``[F, D]`` bf16; biases and LN
    parameters fp32 or None. Returns ``x``'s shape and dtype."""
    if not x.is_cuda:
        raise ValueError("fused_mlp takes CUDA tensors")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or fp32, got {x.dtype}")
    if w1.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the MLP kernel takes bf16 weights (got {w1.dtype}, {w2.dtype}); "
            "fp32 weights run only on the plain twin"
        )
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
    if dim % 8 or f % 8:
        raise ValueError(f"the kernel takes D % 8 == 0 and F % 8 == 0 (got {dim}, {f})")
    if ln_bias is not None and ln_scale is None:
        raise ValueError("ln_bias without ln_scale")

    lib = _build.load_library()
    t = x.numel() // dim
    opts = dict(device=x.device, dtype=torch.bfloat16)
    xn = torch.empty(t, dim, **opts)
    h = torch.empty(t, f, **opts)
    out = torch.empty_like(x)
    ptr = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vt_fused_mlp(
            x.data_ptr(), int(x.dtype == torch.float32),
            ptr(ln_scale), ptr(ln_bias),
            w1.data_ptr(), ptr(b1), w2.data_ptr(), ptr(b2),
            out.data_ptr(), xn.data_ptr(), h.data_ptr(),
            t, dim, f, ACTIVATIONS[activation], int(residual), float(ln_eps), stream,
        )
    _build.check(lib, rc, "fused_mlp kernel")
    _build.count_launch("fused_mlp")
    return out
