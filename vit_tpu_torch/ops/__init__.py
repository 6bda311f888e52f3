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

Gradients: on the CPU the twins are plain PyTorch, differentiated by autograd.
On the card a kernel writes its output through raw pointers, outside the
autograd graph, so ``attention_block`` and ``mlp`` go through autograd
Functions (``AttentionBlockFn``, ``MlpFn``) when grad mode is on and an
operand requires grad: the kernel forward, and ``vit_tpu``'s recompute
backward through the twin. Otherwise (serving runs under
``torch.inference_mode()``) they launch the kernel exactly as before. The
wrappers of kernels 3-10 have no Function yet and raise under grad
(``_build.refuse_grad``).

Each kernel wrapper counts its launches: ``launch_counts()``; each
Function's backward its recomputes: ``recompute_counts()``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from vit_tpu_torch.ops._build import (  # noqa: F401
    launch_counts,
    needs_grad,
    recompute_counts,
    reset_launch_counts,
)
from vit_tpu_torch.ops.block_attention import (
    AttentionBlockFn,
    fused_attention_block,
    xla_attention_block,
)
from vit_tpu_torch.ops.flash_attention import (
    core_fits,
    flash_attention,
    flash_attention_kv_blocked,
    reference_attention,
    reference_attention_kv_blocked,
)
from vit_tpu_torch.ops.fused_mlp import MlpFn, fused_mlp, reference_mlp
from vit_tpu_torch.ops.patch_embed import (  # noqa: F401
    extract_patches,
    patchify,
    posemb_sincos_2d,
    spt_shifts,
)
from vit_tpu_torch.ops.qkv_attention import fused_qkv_attention, qkv_kernel_fits, xla_qkv_attention
from vit_tpu_torch.ops.quant_block import (
    fused_quant_attention_block,
    fused_quant_mlp,
    kmajor as _kmajor,
    reference_quant_mlp,
    xla_quant_attention_block,
)
from vit_tpu_torch.ops.reattention_block import (
    fused_reattention_block,
    fused_talking_heads_block,
    xla_reattention_block,
    xla_talking_heads_block,
)
from vit_tpu_torch.ops.window_attention import (
    fused_window_attention_block,
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
    "recompute_counts",
    "reset_launch_counts",
    "needs_grad",
    "AttentionBlockFn",
    "MlpFn",
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


def _use_kernel(x) -> bool:
    if _backend_override.get() == "torch":
        return False
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or twin for device {x.device}")


def attention(q, k, v, bias=None, *, scale=None, mask_self: bool = False):
    """Multi-head attention ``[B, H, Nq, D]``, ``[B, H, Nk, D]``, ``[B, H,
    Nk, Dv]`` -> ``[B, H, Nq, Dv]``, with an optional additive bias
    ``[B|1, H|1, Nq, Nk]`` and the ``mask_self`` diagonal (LSA). The
    resident-K/V kernel where its core takes the shape (``core_fits``: D, Dv
    multiples of 16 up to 128, score rows within shared memory), else the
    kv-blocked kernel."""
    if core_fits(k.shape[2], q.shape[3], v.shape[3]):
        fn = flash_attention if _use_kernel(q) else reference_attention
    else:
        fn = flash_attention_kv_blocked if _use_kernel(q) else reference_attention_kv_blocked
    return fn(q, k, v, bias, scale=scale, mask_self=mask_self)


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
    if _use_kernel(x):
        operands = (x, ln_scale, ln_bias, wqkv, wout, bout)
        if needs_grad(*operands):
            return AttentionBlockFn.apply(fused_attention_block, *operands, heads, scale, ln_eps,
                                          true_n, block_tokens)
        return fused_attention_block(
            *operands, heads, scale=scale, ln_eps=ln_eps, true_n=true_n,
            block_tokens=block_tokens,
        )
    return xla_attention_block(
        x, ln_scale, ln_bias, wqkv, wout, bout, heads, scale, ln_eps, true_n,
        block_tokens,
    )


def mlp(
    x, w1, b1, w2, b2, ln_scale=None, ln_bias=None, *,
    activation: str = "gelu", residual: bool = True, ln_eps: float = 1e-6,
):
    """Fused MLP block over tokens ``[..., T, D]``. On the card under grad,
    through ``MlpFn``."""
    if _use_kernel(x) and needs_grad(x, w1, b1, w2, b2, ln_scale, ln_bias):
        return MlpFn.apply(fused_mlp, x, w1, b1, w2, b2, ln_scale, ln_bias, activation,
                           residual, ln_eps)
    fn = fused_mlp if _use_kernel(x) else reference_mlp
    return fn(
        x, w1, b1, w2, b2, ln_scale, ln_bias,
        activation=activation, residual=residual, ln_eps=ln_eps,
    )


def qkv_attention(qkv, heads: int, bias=None, *, scale=None):
    """Self-attention on the fused qkv layout ``[B, N, 3*H*D]`` ->
    ``[B, N, H*D]``, with an optional additive bias ``[1|B, 1|H, N, N]``.
    The fused-qkv kernel where its limits hold (``qkv_kernel_fits``), else
    ``attention`` on strided per-head views of the fused rows (no copy), as
    ``vit_tpu``'s dispatcher does for shapes its kernel cannot hold."""
    b, n, three_hd = qkv.shape
    if qkv_kernel_fits(n, three_hd // 3 // heads):
        if _use_kernel(qkv):
            return fused_qkv_attention(qkv, heads, bias, scale=scale)
        return xla_qkv_attention(qkv, heads, bias, scale=scale)
    q, k, v = qkv.view(b, n, 3, heads, three_hd // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)
    out = attention(q, k, v, bias, scale=scale)
    return out.transpose(1, 2).reshape(b, n, three_hd // 3)


def quant_attention_block(
    x, ln_scale, ln_bias, wqkv_i8, sqkv, wout_i8, sout, bout, heads: int, *,
    scale=None, ln_eps=1e-6, true_n=None, kmajor=None,
):
    """W8A8 attention block (LN -> row quant -> int8 qkv -> attention -> row
    quant -> int8 out-proj -> +residual). ``true_n`` masks padded keys.
    ``wqkv_i8`` and ``wout_i8`` are vit_tpu's ``[in, out]`` codes; the
    kernel reads ``kmajor``, the pair of their K-major ``[out, in]`` copies
    (``QuantViT`` keeps them), and transposes the codes itself where it is
    not given."""
    if _use_kernel(x):
        if kmajor is None:
            kmajor = (_kmajor(wqkv_i8), _kmajor(wout_i8))
        return fused_quant_attention_block(
            x, ln_scale, ln_bias, kmajor[0], sqkv, kmajor[1], sout, bout, heads,
            scale=scale, ln_eps=ln_eps, true_n=true_n,
        )
    if scale is None:
        scale = (wqkv_i8.shape[1] // 3 // heads) ** -0.5
    return xla_quant_attention_block(
        x, ln_scale, ln_bias, wqkv_i8, sqkv, wout_i8, sout, bout, heads, scale, ln_eps, true_n,
    )


def quant_mlp(
    x, ln_scale, ln_bias, w1_i8, s1, b1, w2_i8, s2, b2, *,
    activation: str = "gelu", ln_eps: float = 1e-6, kmajor=None,
):
    """W8A8 MLP block over tokens ``[..., T, D]``: LN, int8 GEMMs, residual.
    ``w1_i8`` and ``w2_i8`` are vit_tpu's ``[in, out]`` codes; the kernel
    reads ``kmajor``, the pair of their K-major ``[out, in]`` copies
    (``QuantViT`` keeps them), and transposes the codes itself where it is
    not given."""
    if _use_kernel(x):
        if kmajor is None:
            kmajor = (_kmajor(w1_i8), _kmajor(w2_i8))
        return fused_quant_mlp(
            x, ln_scale, ln_bias, kmajor[0], s1, b1, kmajor[1], s2, b2,
            activation=activation, ln_eps=ln_eps,
        )
    return reference_quant_mlp(
        x, ln_scale, ln_bias, w1_i8, s1, b1, w2_i8, s2, b2,
        activation=activation, ln_eps=ln_eps,
    )


def talking_heads_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post, heads: int, *,
    scale=None, ln_eps=1e-5, residual=False,
):
    """CaiT talking-heads block (LN -> qkv -> scores -> pre-softmax head mix
    -> softmax -> post-softmax head mix -> P V -> out-proj [-> +residual])."""
    if _use_kernel(x):
        return fused_talking_heads_block(
            x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post, heads,
            scale=scale, ln_eps=ln_eps, residual=residual,
        )
    if scale is None:
        scale = (wqkv.shape[1] // 3 // heads) ** -0.5
    return xla_talking_heads_block(
        x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post, heads, scale, ln_eps, residual,
    )


def reattention_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias, heads: int, *,
    scale=None, ln_eps=1e-6, reattn_eps=1e-6,
):
    """DeepViT re-attention block (LN -> qkv -> softmax -> head mix ->
    LayerNorm across heads -> P V -> out-proj -> +residual)."""
    if _use_kernel(x):
        return fused_reattention_block(
            x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias, heads,
            scale=scale, ln_eps=ln_eps, reattn_eps=reattn_eps,
        )
    if scale is None:
        scale = (wqkv.shape[1] // 3 // heads) ** -0.5
    return xla_reattention_block(
        x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias, heads, scale, ln_eps,
        reattn_eps,
    )


def window_attention_block(
    xw, ln_scale, ln_bias, wqkv, wout, bout, heads: int, bias=None, *, scale=None, ln_eps=1e-5,
):
    """Fused multi-window attention block over windowed tokens ``[NW, S, C]``
    (LN -> qkv -> per-window attention (+ a shared bias ``[1|H, S, S]``) ->
    out-proj + bias), without the residual."""
    fn = fused_window_attention_block if _use_kernel(xw) else xla_window_attention_block
    return fn(xw, ln_scale, ln_bias, wqkv, wout, bout, heads, bias, scale=scale, ln_eps=ln_eps)
