"""Debugging utilities (port of ``vit_tpu/utils/debug.py``).

- ``checked(fn)``: raise on NaN or Inf in any output of ``fn``, naming the
  output and the first module whose forward produced a non-finite value
  (what ``jax.experimental.checkify`` reports as the error's location);
- ``debug_nans()``: raise at the first module whose forward produces a
  non-finite value, with autograd's anomaly mode on for the backward (the
  counterpart of ``jax_debug_nans``);
- ``kernel_sanitizer()``: the kernels' plain PyTorch twins in place of the
  CUDA kernels (``ops.force_backend("torch")``), as ``vit_tpu`` runs its
  Pallas kernels in interpret mode. On the card the kernels themselves are
  checked by NVIDIA's ``compute-sanitizer`` (chip_smoke's phase 21 where the
  machine lets it run).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator, List, Tuple

import torch
from torch import nn


def _leaves(out, path: str = "output") -> Iterator[Tuple[str, torch.Tensor]]:
    """The floating-point tensors of a nest of tuples, lists and dicts, with
    their paths (``output``, ``output[0]``, ``output['logits']``)."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() or out.is_complex():
            yield path, out
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            yield from _leaves(v, f"{path}[{i}]")


def _non_finite(out) -> List[str]:
    """Paths of the leaves of ``out`` that hold a NaN or an Inf."""
    return [p for p, t in _leaves(out) if not torch.isfinite(t).all().item()]


def _module_names(fn, args) -> dict:
    """Qualified names of the modules reachable from ``fn`` (a module, or a
    bound method of one) and from the modules among ``args``."""
    roots = [fn, getattr(fn, "__self__", None), *args]
    names = {}
    for root in roots:
        if isinstance(root, nn.Module):
            for name, m in root.named_modules():
                names.setdefault(m, name or type(root).__name__)
    return names


def _describe(module: nn.Module, names: dict) -> str:
    name = names.get(module)
    kind = type(module).__name__
    return f"{name!r} ({kind})" if name else kind


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that a NaN or Inf in any of its outputs raises
    ``FloatingPointError`` instead of flowing on::

        safe = checked(model)
        logits = safe(images)   # raises on NaN, naming the module

    The message names each non-finite output and the first module, in the
    order their forwards returned, whose output held a non-finite value.
    Forward hooks on every module record that while ``fn`` runs (one flag
    a module, kept on the device) and are removed afterwards."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        flags = []

        def hook(module, _inputs, output):
            leaves = [t for _, t in _leaves(output)]
            if leaves:
                flags.append((module, torch.stack([~torch.isfinite(t).all() for t in leaves])
                              .any()))

        handle = nn.modules.module.register_module_forward_hook(hook)
        try:
            out = fn(*args, **kwargs)
        finally:
            handle.remove()
        bad = _non_finite(out)
        if bad:
            first = next((m for m, f in flags if f.item()), None)
            where = ("no module's output held one" if first is None else
                     f"first produced by module {_describe(first, _module_names(fn, args))}")
            raise FloatingPointError(f"non-finite values in {', '.join(bad)}: {where}")
        return out

    return wrapper


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Inside the block, raise ``FloatingPointError`` at the first module
    whose forward returns a NaN or Inf (a forward hook on every module, which
    reads each output back) and run autograd's anomaly mode, which raises at
    the backward function that produced a NaN; both are restored on exit.
    ``enable=False`` turns both off for the block."""

    def hook(module, _inputs, output):
        bad = _non_finite(output)
        if bad:
            raise FloatingPointError(
                f"non-finite values in {', '.join(bad)} of module {type(module).__name__}")

    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    handle = nn.modules.module.register_module_forward_hook(hook) if enable else None
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        if handle is not None:
            handle.remove()
        torch.autograd.set_detect_anomaly(*prev)


@contextlib.contextmanager
def kernel_sanitizer():
    """Run every kernel entry on its plain PyTorch twin inside the block, on
    any device (``ops.force_backend("torch")``)."""
    from vit_tpu_torch import ops

    with ops.force_backend("torch"):
        yield
