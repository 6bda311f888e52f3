"""XLA's CPU fp32 math, copied in numpy where ``vit_tpu`` takes a value
from it bit for bit (LSA's initial temperature, PatchMerger's fixed draw).

Each fused multiply-add of XLA's lowering is taken in float64 and rounded
once to fp32 (a product of two fp32 values is exact in float64).
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32

# Cephes' logf polynomial, as XLA's CPU backend evaluates it.
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
           1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
           3.3333331174e-1)


def fma(a, b, c):
    """fp32 ``a * b + c`` rounded once."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def xla_logf(x):
    """XLA's CPU fp32 log of positive normal ``x`` (an fp32 array), Cephes'
    logf. It is one ulp from the correctly rounded log at some inputs."""
    bits = x.view(np.int32)
    e = _F32(1) + ((bits >> 23) - 0x7F).astype(_F32)
    m = ((bits & ~0x7F800000) | _F32(0.5).view(np.int32)).view(_F32)  # in [0.5, 1)
    below = m < _F32(0.707106781186547524)
    e = e - np.where(below, _F32(1), _F32(0))
    m = (m - _F32(1)) + np.where(below, m, _F32(0))
    x2 = m * m
    x3 = x2 * m
    p = _LOGF_P
    y = fma(fma(m, _F32(p[0]), _F32(p[1])), m, _F32(p[2]))
    y1 = fma(fma(m, _F32(p[3]), _F32(p[4])), m, _F32(p[5]))
    y2 = fma(fma(m, _F32(p[6]), _F32(p[7])), m, _F32(p[8]))
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, _F32(-2.12194440e-4) * e)
    m = (m - _F32(0.5) * x2) + y
    return m + _F32(0.693359375) * e


def lsa_log_temperature(dim_head: int) -> np.float32:
    """LSA's initial ``log_temperature``, ``log(dim_head ** -0.5)`` in fp32
    as ``vit_tpu`` computes it op by op on XLA's CPU: its model's ``init``
    (``vit_tpu/nn/attention.py:181-184``, unjitted in ``vit_tpu/train.py``)
    and its reference importer (``vit_tpu/utils/importer.py:66``). The scale
    is rounded to fp32 first. Under ``jax.jit`` XLA folds the constant with
    a correctly rounded log instead, one ulp away at about 2.5% of widths
    (29, 43, 133, ...)."""
    return xla_logf(np.asarray(dim_head**-0.5, _F32).reshape(1))[0]
