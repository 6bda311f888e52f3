"""Small pure-Python helpers (mirrors ``vit_tpu/core/utils.py``)."""

from __future__ import annotations

from typing import Any, Tuple


def pair(t) -> Tuple[Any, Any]:
    """Return ``t`` as a 2-tuple, duplicating scalars."""
    return t if isinstance(t, tuple) else (t, t)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m
