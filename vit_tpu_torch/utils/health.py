"""Failure detection and recovery (port of ``vit_tpu/utils/health.py``): a
per-device health probe at start-up, an idempotent batch-level retry
around inference calls, and the card's memory figures.

``vit_tpu``'s collective probe (a sum over a device mesh) waits for the
port's multi-GPU path (ROADMAP.md Queue 1 item 8), and its
``enable_compilation_cache`` (XLA's persistent cache) has no counterpart:
the port compiles no programs, and its kernel library is cached by the hash
of its sources (``ops/_build.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence

import torch

log = logging.getLogger("vit_tpu_torch.health")

_PROBE = 128


def probe_devices(devices: Optional[Sequence] = None) -> dict:
    """A small product on each device (every CUDA device by default), its
    sum checked: ``ones(128, 128) @ ones(128, 128)`` sums to 128^3.

    Returns ``{"devices", "ok", "details": [{"device", "ok", "latency_s"}]}``;
    raises RuntimeError if a device gives a wrong result, and where no device
    is given and none is there."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("device health probe: no CUDA device")
    devices = [torch.device(d) for d in devices]
    report = {"devices": len(devices), "ok": True, "details": []}
    for d in devices:
        t0 = time.perf_counter()
        x = torch.ones(_PROBE, _PROBE, device=d)
        val = float((x @ x).sum())  # computes on x's device, then reads back
        ok = abs(val - _PROBE**3) < 1e-3 * _PROBE**3
        report["details"].append({"device": str(d), "ok": ok,
                                  "latency_s": time.perf_counter() - t0})
        report["ok"] &= ok
    if not report["ok"]:
        raise RuntimeError(f"device health probe failed: {report}")
    return report


def with_retry(fn: Callable, *, attempts: int = 2, backoff_s: float = 1.0) -> Callable:
    """Idempotent retry wrapper for batch-level inference calls: a transient
    runtime failure re-executes the batch, after ``backoff_s * 2**i``
    seconds; the last failure is raised."""

    def wrapper(*args, **kwargs):
        last = None
        for i in range(attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # CUDA runtime errors share no base class
                last = e
                log.warning("batch attempt %d/%d failed: %s", i + 1, attempts, e)
                if i + 1 < attempts:
                    time.sleep(backoff_s * (2**i))
        raise last

    return wrapper


def memory_stats(device=None) -> dict:
    """The card's memory in use, its peak and its size, in bytes
    (``torch.cuda.memory_stats`` and the device's total memory); None for
    each where the device is not a CUDA card."""
    d = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    if d.type != "cuda":
        return {"bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}
    stats = torch.cuda.memory_stats(d)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.get_device_properties(d).total_memory,
    }
