"""Small pure-Python helpers (mirrors ``vit_tpu/core/utils.py``)."""

from __future__ import annotations

from typing import Any, Tuple


def pair(t) -> Tuple[Any, Any]:
    """Return ``t`` as a 2-tuple, duplicating scalars."""
    return t if isinstance(t, tuple) else (t, t)


def cast_tuple(val, length: int = 1) -> tuple:
    """Broadcast a scalar to a tuple of ``length``; pass tuples through."""
    return val if isinstance(val, tuple) else ((val,) * length)


def conv_output_size(image_size: int, kernel_size: int, stride: int, padding: int = 0) -> int:
    return int(((image_size - kernel_size + (2 * padding)) / stride) + 1)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m
