"""Parity calibration (port of ``vit_tpu/utils/parity.py``; see PARITY.md).

``fp64_vit_forward`` evaluates the reference ViT function exactly (host
numpy, float64): the ground truth that both the JAX reference and the
frameworks are held against. ``max_logit_err`` is the bench metric. Both
are numpy only, and the port keeps its own copy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _f64(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def max_logit_err(a, b) -> float:
    """max |a - b| in float64, of arrays or tensors."""
    return float(np.max(np.abs(_f64(a) - _f64(b))))


def fp64_vit_forward(
    ref_params: Dict[str, Any],
    img: np.ndarray,
    *,
    patch_size: int,
    depth: int,
    heads: int,
    dim_head: int = 64,
) -> np.ndarray:
    """Exact fp64 evaluation of the reference ``vit.py`` forward (dropout 0),
    from the reference's own parameter tree (``Dense_0``, ``Transformer_0``,
    ``PreNorm_{2i}`` ...): einops patchify order, flax LayerNorm (eps 1e-6),
    fused-qkv attention with post-matmul scaling, the tanh-approximate GELU,
    cls pooling."""
    p = ref_params["params"] if "params" in ref_params else ref_params
    a64 = _f64

    b, ih, iw, _ = img.shape
    ps = patch_size
    h, w = ih // ps, iw // ps
    x = _f64(img).reshape(b, h, ps, w, ps, 3)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(b, h * w, ps * ps * 3)
    x = x @ a64(p["Dense_0"]["kernel"]) + a64(p["Dense_0"]["bias"])
    dim = x.shape[-1]
    cls = np.broadcast_to(a64(p["cls"]), (b, 1, dim))
    x = np.concatenate([cls, x], axis=1)
    x = x + a64(p["pos_embedding"])

    def ln(x, sc, bi, eps=1e-6):
        mean = x.mean(-1, keepdims=True)
        var = ((x - mean) ** 2).mean(-1, keepdims=True)
        return (x - mean) / np.sqrt(var + eps) * sc + bi

    tr = p["Transformer_0"]
    for i in range(depth):
        an = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
        fn = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
        at = tr[f"Attention_{i}"]
        ff = tr[f"FeedForward_{i}"]
        xn = ln(x, a64(an["scale"]), a64(an["bias"]))
        qkv = xn @ a64(at["Dense_0"]["kernel"])
        n = x.shape[1]
        qkv = qkv.reshape(b, n, 3, heads, dim_head).transpose(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        s = np.einsum("bhid,bhjd->bhij", q, k) * dim_head**-0.5
        s = s - s.max(-1, keepdims=True)
        e = np.exp(s)
        pr = e / e.sum(-1, keepdims=True)
        o = np.einsum("bhij,bhjd->bhid", pr, v)
        o = o.transpose(0, 2, 1, 3).reshape(b, n, heads * dim_head)
        x = x + (o @ a64(at["Dense_1"]["kernel"]) + a64(at["Dense_1"]["bias"]))
        xn = ln(x, a64(fn["scale"]), a64(fn["bias"]))
        hmid = xn @ a64(ff["Dense_0"]["kernel"]) + a64(ff["Dense_0"]["bias"])
        hmid = 0.5 * hmid * (1.0 + np.tanh(
            np.sqrt(2.0 / np.pi) * (hmid + 0.044715 * hmid**3)))
        x = x + (hmid @ a64(ff["Dense_1"]["kernel"]) + a64(ff["Dense_1"]["bias"]))

    x = x[:, 0]
    hn = p["LayerNorm_0"]
    x = ln(x, a64(hn["scale"]), a64(hn["bias"]))
    return x @ a64(p["Dense_1"]["kernel"]) + a64(p["Dense_1"]["bias"])
