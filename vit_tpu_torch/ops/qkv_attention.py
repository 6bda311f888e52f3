"""Self-attention straight off the fused qkv projection.

Port of ``vit_tpu/ops/qkv_attention.py``. ``fused_qkv_attention`` is the
Hopper kernel (``csrc/qkv_attention.cu``, on the register-resident core of
``csrc/attention_core_sm90.cuh`` it shares with the flash kernel);
``xla_qkv_attention`` is its plain PyTorch twin and
mirrors the JAX twin op for op: fp32 scores of the stored operands, ``*
scale``, ``+ bias`` in fp32, ``jax.nn.softmax``'s max / exp / sum / divide
order, P rounded to qkv's dtype before the fp32 P @ V, one rounding to
qkv's dtype.

Layout: ``qkv`` ``[B, N, 3*H*D]`` laid out ``[q | k | v]``, each part
``[H, D]``; the output is ``[B, N, H*D]``. No transposes or copies of the
heads: the kernel reads its head panels out of the fused rows. fp32 qkv
takes the kernel's fp32 route, on the fp32 core ``csrc/attention_f32.cuh``
(every product fp32, P kept in fp32), as the TPU kernel runs fp32 at
``Precision.HIGHEST``.
``qkv_attention_op`` is the kernel as a ``torch.library`` operator
(``_build.define_op``). ``QkvAttentionFn`` is its autograd Function: the
kernel forward, ``vit_tpu``'s recompute backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.block_attention import MAX_TOKENS, _mm, _softmax, recompute_vjp


def qkv_kernel_fits(n: int, d: int) -> bool:
    """Whether the fused-qkv kernel takes ``n`` tokens of head width ``d``."""
    return d % 16 == 0 and d <= 128 and n <= MAX_TOKENS


def xla_qkv_attention(qkv, heads, bias=None, scale=None):
    """Plain PyTorch twin (``vit_tpu``'s ``xla_qkv_attention``)."""
    b, n, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    if scale is None:
        scale = d**-0.5
    q, k, v = qkv.split(hd, dim=-1)
    split = lambda t: t.reshape(b, n, heads, d).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    s = _mm(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = _softmax(s)
    o = _mm(p.to(v.dtype), v, v.dtype)
    return o.transpose(1, 2).reshape(b, n, hd)


def fused_qkv_attention(
    qkv: torch.Tensor,
    heads: int,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of ``qkv`` ``[B, N, 3*H*D]`` bf16, or fp32 (the fp32
    route), on the card, with an optional additive fp32 bias ``[1|B, 1|H,
    N, N]``. Returns ``[B, N, H*D]`` in qkv's dtype, computed on the current
    stream."""
    _build.refuse_grad("fused_qkv_attention", qkv, bias)
    if not qkv.is_cuda:
        raise ValueError("fused_qkv_attention takes CUDA tensors")
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, N, 3*H*D], got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qkv must be bf16 or fp32, got {qkv.dtype}")
    fp32 = qkv.dtype == torch.float32
    b, n, three_hd = qkv.shape
    if three_hd % 3 or heads <= 0 or (three_hd // 3) % heads:
        raise ValueError(f"{three_hd} fused columns do not split into q, k, v of {heads} heads")
    hd = three_hd // 3
    d = hd // heads
    if d % 16 or d > 128:
        raise ValueError(f"the kernel takes dim_head % 16 == 0 and <= 128 (got {d}); "
                         "ops.qkv_attention runs other widths on the kv-blocked kernel")
    if n > MAX_TOKENS:
        raise NotImplementedError(
            f"n={n} > {MAX_TOKENS}: ops.qkv_attention runs long sequences on the kv-blocked "
            "kernel (ROADMAP.md Queue 2 item 5)"
        )
    bias_b = bias_h = 0
    if bias is not None:
        if bias.dim() != 4 or tuple(bias.shape[2:]) != (n, n) or bias.shape[0] not in (1, b) \
                or bias.shape[1] not in (1, heads):
            raise ValueError(f"bias must be [1|{b}, 1|{heads}, {n}, {n}], got {tuple(bias.shape)}")
        if bias.dtype != torch.float32 or bias.device != qkv.device or not bias.is_contiguous():
            raise TypeError("bias must be a contiguous fp32 tensor on qkv's device")
        bias_b, bias_h = int(bias.shape[0] == b and b > 1), int(bias.shape[1] == heads and heads > 1)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if scale is None:
        scale = d**-0.5

    lib = _build.load_library()
    out = torch.empty(b, n, hd, device=qkv.device, dtype=qkv.dtype)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = (lib.vt_qkv_attention_f32 if fp32 else lib.vt_qkv_attention)(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(), bias_b, bias_h,
            out.data_ptr(), b, n, heads, d, float(scale), stream,
        )
    _build.check(lib, rc, f"qkv_attention kernel ({'fp32' if fp32 else 'bf16'} route)")
    _build.count_launch("qkv_attention", fp32=fp32)
    return out


qkv_attention_op = _build.define_op(
    "qkv_attention(Tensor qkv, int heads, Tensor? bias, float scale) -> Tensor",
    cuda=fused_qkv_attention, cpu=xla_qkv_attention,
    fake=lambda qkv, heads, bias, scale: qkv.new_empty(*qkv.shape[:2], qkv.shape[2] // 3),
)


class QkvAttentionFn(torch.autograd.Function):
    """Attention on fused qkv rows as an autograd Function (``vit_tpu``'s
    ``_qkv_attention_ad``, ``vit_tpu/ops/qkv_attention.py:129-152``).

    Forward: ``forward_fn`` (the kernel, ``fused_qkv_attention``, on the
    main path; a CPU test passes the twin), saving only ``(qkv, bias)``, as
    ``_qkv_attention_fwd`` does. Backward, as ``_qkv_attention_bwd``: the
    twin ``xla_qkv_attention`` recomputed on them and differentiated
    (``block_attention.recompute_vjp``), with ``dbias`` where the bias needs
    a gradient (summed over its broadcast batch and head axes by autograd,
    as by ``jax.vjp``). The n x n scores exist only inside the backward.

    ``apply(forward_fn, qkv, heads, bias, scale)``."""

    @staticmethod
    def forward(ctx, forward_fn, qkv, heads, bias, scale):
        ctx.save_for_backward(qkv, bias)
        ctx.config = (heads, scale)
        return forward_fn(qkv, heads, bias, scale)

    @staticmethod
    def backward(ctx, g):
        heads, scale = ctx.config
        needs = (ctx.needs_input_grad[1], ctx.needs_input_grad[3])
        dqkv, dbias = recompute_vjp(lambda a, b: xla_qkv_attention(a, heads, b, scale),
                                    ctx.saved_tensors, needs, g)
        _build.count_recompute("qkv_attention")
        return None, dqkv, None, dbias, None
