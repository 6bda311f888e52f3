"""Kernel layer: hand-written Hopper kernels beside their plain PyTorch twins.

Dispatch follows the tensor, not an environment variable:
  - a CPU tensor runs the plain twin;
  - a CUDA tensor launches the kernel, and a build or launch failure raises;
  - any other device raises.
``force_backend("torch")`` is the one explicit way to run the twins on CUDA
(comparisons and timings use it; the serving path never does).

Each kernel wrapper counts its launches: ``launch_counts()``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from vit_tpu_torch.ops._build import launch_counts, reset_launch_counts  # noqa: F401
from vit_tpu_torch.ops.block_attention import fused_attention_block, xla_attention_block
from vit_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp
from vit_tpu_torch.ops.patch_embed import patchify  # noqa: F401

__all__ = [
    "attention_block",
    "mlp",
    "force_backend",
    "launch_counts",
    "reset_launch_counts",
    "fused_attention_block",
    "xla_attention_block",
    "fused_mlp",
    "reference_mlp",
    "patchify",
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


def attention_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, heads: int, *, scale=None, ln_eps=1e-6,
    true_n=None, block_tokens=None,
):
    """Fused attention block (LN -> qkv -> attention -> out-proj -> +residual).

    ``true_n``: real token count of a padded stream (padded key columns are
    masked). ``block_tokens``: per-sample stride of a sample-packed stream
    (block-diagonal attention). Both paths apply the same masks."""
    if _use_kernel(x):
        return fused_attention_block(
            x, ln_scale, ln_bias, wqkv, wout, bout, heads,
            scale=scale, ln_eps=ln_eps, true_n=true_n, block_tokens=block_tokens,
        )
    if scale is None:
        scale = (wqkv.shape[1] // 3 // heads) ** -0.5
    return xla_attention_block(
        x, ln_scale, ln_bias, wqkv, wout, bout, heads, scale, ln_eps, true_n,
        block_tokens,
    )


def mlp(
    x, w1, b1, w2, b2, ln_scale=None, ln_bias=None, *,
    activation: str = "gelu", residual: bool = True, ln_eps: float = 1e-6,
):
    """Fused MLP block over tokens ``[..., T, D]``."""
    fn = fused_mlp if _use_kernel(x) else reference_mlp
    return fn(
        x, w1, b1, w2, b2, ln_scale, ln_bias,
        activation=activation, residual=residual, ln_eps=ln_eps,
    )
