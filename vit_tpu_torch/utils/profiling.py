"""Tracing, cost and timing hooks (port of ``vit_tpu/utils/profiling.py``):
a ``torch.profiler`` trace to a directory, the FLOPs of a call, a timer
synchronised with the card, and one-line JSON events."""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, Optional

import torch

from vit_tpu_torch import ops


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (the host and, where
    there is one, the card) and write a Chrome trace (``chrome://tracing``,
    Perfetto) into ``log_dir``, one file a scope. Yields the profiler; its
    ``key_averages()`` gives the table."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """The FLOPs of ``fn(*args, **kwargs)`` as ``torch.utils.flop_counter``
    counts them (products, convolutions and attention: 2 per multiply-add),
    run once without grad on the plain twins (``ops.force_backend("torch")``),
    so a layer counts the same FLOPs whatever implements it: a hand-written
    kernel's launch is invisible to the counter. Returns ``{"flops": total,
    "flops_by_op": {aten op: flops}}``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with ops.force_backend("torch"), torch.no_grad(), counter:
        fn(*args, **kwargs)
    by_op: Dict[str, int] = {}
    for per_module in counter.get_flop_counts().values():
        for op, n in per_module.items():
            by_op[str(op)] = max(by_op.get(str(op), 0), int(n))  # "Global" holds every op
    return {"flops": int(counter.get_total_flops()), "flops_by_op": by_op}


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 2,
              items_per_call: Optional[int] = None) -> Dict[str, float]:
    """Host-clock latency of ``fn(*args)``, each call waited for on the card
    (``torch.cuda.synchronize``): ``p50_s``, ``mean_s``, ``min_s``, and
    ``items_per_sec`` (``items_per_call`` over the p50) where given."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        samples.append(time.perf_counter() - t0)
    stats = {"p50_s": statistics.median(samples), "mean_s": statistics.fmean(samples),
             "min_s": min(samples)}
    if items_per_call:
        stats["items_per_sec"] = items_per_call / stats["p50_s"]
    return stats


def log_event(name: str, **fields) -> None:
    """One line of JSON on stdout: ``{"event": name, "time": ..., **fields}``."""
    print(json.dumps({"event": name, "time": time.time(), **fields}), flush=True)
