"""Kernel layer: hand-written Hopper kernels beside their plain PyTorch twins.

Dispatch follows the tensor, not an environment variable:
  - a CPU tensor runs the plain twin;
  - a CUDA tensor launches the kernel, and a build or launch failure raises;
  - any other device raises.
Where two kernels compute one function (``attention``, ``qkv_attention``),
the shape picks one by the card's limits, on the CPU too: the twin that runs
is the twin of the kernel the card would run.
``force_backend("torch")`` is the one explicit way to run the twins on CUDA
(comparisons and timings use it; the serving path never does).

Each kernel is also a ``torch.library`` operator,
``torch.ops.vit_tpu_torch.<name>`` (``_build.define_op``): the kernel on a
CUDA tensor, the twin on a CPU tensor, and a fake implementation that gives
``torch.export`` the output's shape, dtype and strides. An entry calls the
operator only while a graph is traced (``_route``), so that an exported
program (``utils.aot``) holds one node per launch; an eager call runs the
kernel or the twin itself, outside the dispatcher, whose round trip into
Python would cost host time on every launch. Under ``force_backend("torch")``
the entries call the twins, never an operator.

Gradients: on the CPU the twins are plain PyTorch, differentiated by autograd:
under grad the entries call them directly. On the card a kernel writes its
output through raw pointers, outside the autograd graph, so the entries of
kernels 1-8 go through autograd Functions when grad mode is on and an operand
requires grad: the kernel forward, and ``vit_tpu``'s backward of that kernel
(``AttentionBlockFn``, ``MlpFn``, ``QkvAttentionFn``,
``WindowAttentionBlockFn``, ``TalkingHeadsBlockFn``, ``ReattentionBlockFn``:
its recompute through the twin; ``FlashAttentionFn`` for kernels 4 and 5:
the Q-chunked flash backward). Called directly under grad, a kernel wrapper
raises (``_build.refuse_grad``); kernels 9 and 10 have no Function (they are
inference only in ``vit_tpu`` too).

fp32: kernels 1-8 have fp32 routes, taken on fp32 operands (and, for the
blocks, fp32 weights on an fp32 stream: ``vit_tpu``'s default precision,
whose kernels run at ``Precision.HIGHEST``): fp32 products on
``csrc/gemm_f32.cuh``, the attention of kernels 1, 3, 4 and 6 on the fp32
core ``csrc/attention_f32.cuh``, kernel 5's fp32 online softmax
(``csrc/flash_attention_kv_blocked.cu``), nothing rounded to bf16. Their
Functions run that route forward under grad. The int8 kernels 9 and 10 take
an fp32 stream beside their int8 weights (kernel 9's attention on the fp32
core). No route hands an fp32 tensor on the card over to a twin.

Each kernel wrapper counts its launches: ``launch_counts()``, and those of
the fp32 routes also in ``fp32_launch_counts()``; each Function's backward
its recomputes: ``recompute_counts()``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from vit_tpu_torch.ops._build import (  # noqa: F401
    fp32_launch_counts,
    launch_counts,
    needs_grad,
    recompute_counts,
    reset_launch_counts,
)
from vit_tpu_torch.ops.block_attention import (
    AttentionBlockFn,
    attention_block_op,
    fused_attention_block,
    xla_attention_block,
)
from vit_tpu_torch.ops.flash_attention import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_kv_blocked,
    flash_attention_kv_blocked_op,
    flash_attention_op,
    kernel_name,
    reference_attention,
    reference_attention_kv_blocked,
)
from vit_tpu_torch.ops.fused_mlp import MlpFn, fused_mlp, fused_mlp_op, reference_mlp
from vit_tpu_torch.ops.patch_embed import (  # noqa: F401
    extract_patches,
    patchify,
    posemb_sincos_2d,
    spt_shifts,
    unpatchify,
)
from vit_tpu_torch.ops.qkv_attention import (
    QkvAttentionFn,
    fused_qkv_attention,
    qkv_attention_op,
    qkv_kernel_fits,
    xla_qkv_attention,
)
from vit_tpu_torch.ops.quant_block import (
    fused_quant_attention_block,
    fused_quant_mlp,
    kmajor as _kmajor,
    quant_attention_block_op,
    quant_mlp_op,
    reference_quant_mlp,
    xla_quant_attention_block,
)
from vit_tpu_torch.ops.reattention_block import (
    ReattentionBlockFn,
    TalkingHeadsBlockFn,
    fused_reattention_block,
    fused_talking_heads_block,
    reattention_block_op,
    talking_heads_block_op,
    xla_reattention_block,
    xla_talking_heads_block,
)
from vit_tpu_torch.ops.window_attention import (
    WindowAttentionBlockFn,
    fused_window_attention_block,
    window_attention_block_op,
    xla_window_attention_block,
)
from vit_tpu_torch.ops.windows import (  # noqa: F401
    block_partition,
    block_unpartition,
    dilated_partition,
    dilated_unpartition,
    window_partition,
    window_unpartition,
)

__all__ = [
    "attention",
    "attention_block",
    "mlp",
    "qkv_attention",
    "quant_attention_block",
    "quant_mlp",
    "talking_heads_block",
    "reattention_block",
    "window_attention_block",
    "force_backend",
    "launch_counts",
    "fp32_launch_counts",
    "recompute_counts",
    "reset_launch_counts",
    "needs_grad",
    "AttentionBlockFn",
    "MlpFn",
    "QkvAttentionFn",
    "FlashAttentionFn",
    "WindowAttentionBlockFn",
    "TalkingHeadsBlockFn",
    "ReattentionBlockFn",
    "fused_attention_block",
    "xla_attention_block",
    "fused_mlp",
    "reference_mlp",
    "fused_qkv_attention",
    "xla_qkv_attention",
    "fused_quant_attention_block",
    "xla_quant_attention_block",
    "fused_quant_mlp",
    "reference_quant_mlp",
    "fused_talking_heads_block",
    "xla_talking_heads_block",
    "fused_reattention_block",
    "xla_reattention_block",
    "flash_attention",
    "reference_attention",
    "flash_attention_kv_blocked",
    "reference_attention_kv_blocked",
    "fused_window_attention_block",
    "xla_window_attention_block",
    "patchify",
    "unpatchify",
    "extract_patches",
    "posemb_sincos_2d",
    "spt_shifts",
    "window_partition",
    "window_unpartition",
    "dilated_partition",
    "dilated_unpartition",
    "block_partition",
    "block_unpartition",
]

_backend_override: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "vit_tpu_torch_backend_override", default=None
)


@contextlib.contextmanager
def force_backend(mode: str):
    """Run the plain PyTorch twins, whatever the device, inside this scope."""
    if mode != "torch":
        raise ValueError(f"force_backend takes 'torch', got {mode!r}")
    token = _backend_override.set(mode)
    try:
        yield
    finally:
        _backend_override.reset(token)


def _forced() -> bool:
    """Whether ``force_backend("torch")`` is in force."""
    return _backend_override.get() == "torch"


def _check_device(x) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or twin for device {x.device}")


def _use_kernel(x) -> bool:
    _check_device(x)
    return not _forced() and x.device.type == "cuda"


def _route(op, kernel, twin, *args):
    """The one of ``op``, ``kernel`` and ``twin`` that an entry runs on
    ``args``; the three take the same positional arguments, the first a
    tensor. While ``torch.export`` (or ``torch.compile``) traces the call and
    no operand needs grad: the operator, one node of the graph. Otherwise, on
    a CUDA tensor the kernel (or its autograd Function), on a CPU tensor and
    under ``force_backend("torch")`` the twin."""
    if torch.compiler.is_compiling() and not _forced() and not needs_grad(*args):
        _check_device(args[0])
        return op
    return kernel if _use_kernel(args[0]) else twin


def _differentiable(function, kernel, args):
    """``kernel(*args)``, through its autograd ``function`` where an operand
    needs grad."""
    return function.apply(kernel, *args) if needs_grad(*args) else kernel(*args)


# The kernels' entries on the card; each reads its wrapper's module global at
# the call, so that a test can put a twin in a kernel's place.
def _attention_block_kernel(*args):
    return _differentiable(AttentionBlockFn, fused_attention_block, args)


def _mlp_kernel(*args):
    return _differentiable(MlpFn, fused_mlp, args)


def _qkv_attention_kernel(*args):
    return _differentiable(QkvAttentionFn, fused_qkv_attention, args)


def _flash_kernel(*args):
    return _differentiable(FlashAttentionFn, flash_attention, args)


def _kv_blocked_kernel(*args):
    return _differentiable(FlashAttentionFn, flash_attention_kv_blocked, args)


def _window_kernel(*args):
    return _differentiable(WindowAttentionBlockFn, fused_window_attention_block, args)


def _talking_heads_kernel(*args):
    return _differentiable(TalkingHeadsBlockFn, fused_talking_heads_block, args)


def _reattention_kernel(*args):
    return _differentiable(ReattentionBlockFn, fused_reattention_block, args)


def attention(q, k, v, bias=None, *, scale=None, mask_self: bool = False):
    """Multi-head attention ``[B, H, Nq, D]``, ``[B, H, Nk, D]``, ``[B, H,
    Nk, Dv]`` -> ``[B, H, Nq, Dv]``, with an optional additive bias
    ``[B|1, H|1, Nq, Nk]`` and the ``mask_self`` diagonal (LSA). The
    resident-K/V kernel where its core takes the shape (``kernel_name``, by
    ``core_fits``: D, Dv multiples of 16 up to 128, score rows within shared
    memory), else the kv-blocked kernel. On the card under grad, through
    ``FlashAttentionFn``."""
    args = (q, k, v, bias, float(q.shape[3] ** -0.5 if scale is None else scale),
            bool(mask_self))
    if kernel_name(k.shape[2], q.shape[3], v.shape[3]) == "flash_attention":
        fn = _route(flash_attention_op, _flash_kernel, reference_attention, *args)
    else:
        fn = _route(flash_attention_kv_blocked_op, _kv_blocked_kernel,
                    reference_attention_kv_blocked, *args)
    return fn(*args)


def attention_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, heads: int, *, scale=None, ln_eps=1e-6,
    true_n=None, block_tokens=None,
):
    """Fused attention block (LN -> qkv -> attention -> out-proj -> +residual).

    ``true_n``: real token count of a padded stream (padded key columns are
    masked). ``block_tokens``: per-sample stride of a sample-packed stream
    (block-diagonal attention). Both paths apply the same masks. On the card
    under grad, through ``AttentionBlockFn``."""
    if scale is None:
        scale = (wqkv.shape[1] // 3 // heads) ** -0.5
    args = (x, ln_scale, ln_bias, wqkv, wout, bout, int(heads), float(scale), float(ln_eps),
            true_n, block_tokens)
    return _route(attention_block_op, _attention_block_kernel, xla_attention_block, *args)(*args)


def mlp(
    x, w1, b1, w2, b2, ln_scale=None, ln_bias=None, *,
    activation: str = "gelu", residual: bool = True, ln_eps: float = 1e-6,
):
    """Fused MLP block over tokens ``[..., T, D]``. On the card under grad,
    through ``MlpFn``."""
    args = (x, w1, b1, w2, b2, ln_scale, ln_bias, activation, bool(residual), float(ln_eps))
    return _route(fused_mlp_op, _mlp_kernel, reference_mlp, *args)(*args)


def qkv_attention(qkv, heads: int, bias=None, *, scale=None):
    """Self-attention on the fused qkv layout ``[B, N, 3*H*D]`` ->
    ``[B, N, H*D]``, with an optional additive bias ``[1|B, 1|H, N, N]``.
    The fused-qkv kernel where its limits hold (``qkv_kernel_fits``), else
    ``attention`` on strided per-head views of the fused rows (no copy), as
    ``vit_tpu``'s dispatcher does for shapes its kernel cannot hold. On the
    card under grad, through ``QkvAttentionFn`` (or ``FlashAttentionFn`` on
    the views)."""
    b, n, three_hd = qkv.shape
    d = three_hd // 3 // heads
    if qkv_kernel_fits(n, d):
        args = (qkv, int(heads), bias, float(d**-0.5 if scale is None else scale))
        return _route(qkv_attention_op, _qkv_attention_kernel, xla_qkv_attention, *args)(*args)
    q, k, v = qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    out = attention(q, k, v, bias, scale=scale)
    return out.transpose(1, 2).reshape(b, n, three_hd // 3)


def quant_attention_block(
    x, ln_scale, ln_bias, wqkv_i8, sqkv, wout_i8, sout, bout, heads: int, *,
    scale=None, ln_eps=1e-6, true_n=None, kmajor=None,
):
    """W8A8 attention block (LN -> row quant -> int8 qkv -> attention -> row
    quant -> int8 out-proj -> +residual). ``true_n`` masks padded keys.
    ``wqkv_i8`` and ``wout_i8`` are vit_tpu's ``[in, out]`` codes; the
    kernel (and its operator) reads ``kmajor``, the pair of their K-major
    ``[out, in]`` copies (``QuantViT`` keeps them), and transposes the codes
    itself where it is not given."""
    if scale is None:
        scale = (wqkv_i8.shape[1] // 3 // heads) ** -0.5
    args = [x, ln_scale, ln_bias, wqkv_i8, sqkv, wout_i8, sout, bout, int(heads), float(scale),
            float(ln_eps), true_n]
    fn = _route(quant_attention_block_op, fused_quant_attention_block, xla_quant_attention_block,
                *args)
    if fn is not xla_quant_attention_block:
        args[3], args[5] = kmajor if kmajor is not None else (_kmajor(wqkv_i8),
                                                              _kmajor(wout_i8))
    return fn(*args)


def quant_mlp(
    x, ln_scale, ln_bias, w1_i8, s1, b1, w2_i8, s2, b2, *,
    activation: str = "gelu", ln_eps: float = 1e-6, kmajor=None,
):
    """W8A8 MLP block over tokens ``[..., T, D]``: LN, int8 GEMMs, residual.
    ``w1_i8`` and ``w2_i8`` are vit_tpu's ``[in, out]`` codes; the kernel
    (and its operator) reads ``kmajor``, the pair of their K-major ``[out,
    in]`` copies (``QuantViT`` keeps them), and transposes the codes itself
    where it is not given."""
    args = [x, ln_scale, ln_bias, w1_i8, s1, b1, w2_i8, s2, b2, activation, float(ln_eps)]
    fn = _route(quant_mlp_op, fused_quant_mlp, reference_quant_mlp, *args)
    if fn is not reference_quant_mlp:
        args[3], args[6] = kmajor if kmajor is not None else (_kmajor(w1_i8), _kmajor(w2_i8))
    return fn(*args)


def talking_heads_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post, heads: int, *,
    scale=None, ln_eps=1e-5, residual=False,
):
    """CaiT talking-heads block (LN -> qkv -> scores -> pre-softmax head mix
    -> softmax -> post-softmax head mix -> P V -> out-proj [-> +residual]).
    On the card under grad, through ``TalkingHeadsBlockFn``."""
    if scale is None:
        scale = (wqkv.shape[1] // 3 // heads) ** -0.5
    args = (x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post, int(heads), float(scale),
            float(ln_eps), bool(residual))
    return _route(talking_heads_block_op, _talking_heads_kernel, xla_talking_heads_block,
                  *args)(*args)


def reattention_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias, heads: int, *,
    scale=None, ln_eps=1e-6, reattn_eps=1e-6,
):
    """DeepViT re-attention block (LN -> qkv -> softmax -> head mix ->
    LayerNorm across heads -> P V -> out-proj -> +residual). On the card
    under grad, through ``ReattentionBlockFn``."""
    if scale is None:
        scale = (wqkv.shape[1] // 3 // heads) ** -0.5
    args = (x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias, int(heads),
            float(scale), float(ln_eps), float(reattn_eps))
    return _route(reattention_block_op, _reattention_kernel, xla_reattention_block,
                  *args)(*args)


def window_attention_block(
    xw, ln_scale, ln_bias, wqkv, wout, bout, heads: int, bias=None, *, scale=None, ln_eps=1e-5,
):
    """Fused multi-window attention block over windowed tokens ``[NW, S, C]``
    (LN -> qkv -> per-window attention (+ a shared bias ``[1|H, S, S]``) ->
    out-proj + bias), without the residual. On the card under grad, through
    ``WindowAttentionBlockFn``."""
    if scale is None:
        scale = (wqkv.shape[1] // 3 // heads) ** -0.5
    args = (xw, ln_scale, ln_bias, wqkv, wout, bout, int(heads), bias, float(scale),
            float(ln_eps))
    return _route(window_attention_block_op, _window_kernel, xla_window_attention_block,
                  *args)(*args)
