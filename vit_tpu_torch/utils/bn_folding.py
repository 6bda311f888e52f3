"""BatchNorm folding, the inference-time load transform of CvT and LeViT (a
numpy copy of ``vit_tpu/utils/bn_folding.py``, and its counterpart over the
port's own ``state_dict``).

At inference a BatchNorm with running statistics is the per-channel affine
map ``z -> a*z + c``, ``a = scale / sqrt(var + eps)``, ``c = bias - a*mean``.
Composed with the conv that produces ``z`` it is another conv:
``BN(W*x + b0) = (aW)*x + (a*b0 + c)``. So the BatchNorm leaves the graph
and its affine goes into the conv's kernel and bias.

Folded pairs, by name, in one parent scope:
  - ``DepthWiseConv2d``: ``depthwise`` <- ``bn``;
  - ``ConvMLP``'s BatchNorm branch: ``up`` <- ``bn1``, ``down`` <- ``bn2``;
  - LeViT's attention: ``{p}_conv`` <- ``{p}_bn``.

Usage::

    folded = fold_batch_norm(variables)     # no batch_stats left
    model = CvT(..., fold_bn=True)
    model.load_state_dict(from_jax_params(folded, model.jax_stages))

A model the port has trained folds from its own state (train -> fold ->
serve, as ``vit_tpu``'s flow goes)::

    folded = CvT(..., fold_bn=True)
    folded.load_state_dict(fold_batch_norm_state(trained.state_dict()))

The fold runs in float64 and casts back to the kernel's dtype, op for op as
``vit_tpu``'s, so all three give the same arrays bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# BN node name -> the conv (in the same parent scope) whose output it normalizes.
_STATIC_PAIRS = {"bn": "depthwise", "bn1": "up", "bn2": "down"}


def _conv_name_for(bn_name: str):
    if bn_name in _STATIC_PAIRS:
        return _STATIC_PAIRS[bn_name]
    if bn_name.endswith("_bn"):
        return bn_name[:-3] + "_conv"
    return None


def _is_bn(params_node, stats_node) -> bool:
    return (isinstance(params_node, dict) and set(params_node) == {"scale", "bias"}
            and isinstance(stats_node, dict) and set(stats_node) == {"mean", "var"})


def _fold_into_conv(conv: Dict[str, Any], bn_params, bn_stats, eps: float) -> None:
    a64 = np.asarray(bn_params["scale"], np.float64) / np.sqrt(
        np.asarray(bn_stats["var"], np.float64) + eps)
    c64 = np.asarray(bn_params["bias"], np.float64) - a64 * np.asarray(bn_stats["mean"],
                                                                      np.float64)
    kernel = np.asarray(conv["kernel"], np.float64)
    dtype = np.asarray(conv["kernel"]).dtype
    conv["kernel"] = (kernel * a64).astype(dtype)  # scale the output channels
    b0 = np.asarray(conv["bias"], np.float64) if "bias" in conv else 0.0
    conv["bias"] = (a64 * b0 + c64).astype(dtype)


def _walk(params: Dict[str, Any], stats: Dict[str, Any], eps: float) -> int:
    """Fold every (conv, bn) pair under this scope, recursively: changes
    ``params`` in place, deletes the folded entries from both trees, and
    returns the number of BatchNorms folded."""
    folded = 0
    for name in list(params):
        p_child, s_child = params.get(name), stats.get(name)
        if _is_bn(p_child, s_child):
            conv_name = _conv_name_for(name)
            if conv_name is None or conv_name not in params:
                raise ValueError(f"unrecognized BatchNorm '{name}' (no adjacent conv); "
                                 "fold_batch_norm only knows the CvT/LeViT patterns")
            _fold_into_conv(params[conv_name], p_child, s_child, eps)
            del params[name]
            del stats[name]
            folded += 1
        elif isinstance(p_child, dict):
            folded += _walk(p_child, s_child if isinstance(s_child, dict) else {}, eps)
            if isinstance(s_child, dict) and not s_child:
                stats.pop(name, None)
    return folded


def _plain(tree):
    """Nested mappings as nested dicts of numpy arrays (the input untouched)."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def fold_batch_norm(variables: Mapping[str, Any], *, eps: float = 1e-5) -> Dict[str, Any]:
    """Fold every BatchNorm of a ``{"params", "batch_stats"}`` tree into the
    conv that produces its input. Returns a new tree without
    ``batch_stats``, which a model built with ``fold_bn=True`` loads.
    ``eps`` is the BatchNorms' epsilon (1e-5 in every model that has them).
    Raises on a BatchNorm with no adjacent conv, when nothing is folded, and
    when statistics are left over."""
    params = _plain(variables["params"])
    stats = _plain(variables.get("batch_stats", {}))
    if _walk(params, stats, eps) == 0:
        raise ValueError("no BatchNorm found to fold")

    def remaining(d):
        return any(remaining(v) if isinstance(v, dict) else True for v in d.values())

    if stats and remaining(stats):
        raise ValueError(f"unfolded batch_stats remain: {list(stats)}")
    folded = {k: v for k, v in variables.items() if k not in ("params", "batch_stats")}
    folded["params"] = params
    return folded


def fold_batch_norm_state(state: Mapping[str, torch.Tensor], *,
                          eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """``fold_batch_norm`` over a port model's ``state_dict``: each
    BatchNorm ``<scope>.<bn>`` (``scale``, ``bias`` and the running ``mean``
    and ``var``) folded into the conv ``<scope>.<conv>`` that produces its
    input (the pairs above), whose OIHW ``kernel`` is scaled along its
    output channels and which gains (or updates) its ``bias``. Returns a new
    state dict without the BatchNorms, which a model built with
    ``fold_bn=True`` loads; ``state`` is left as it is. Raises where a
    BatchNorm has no conv beside it and where there is none to fold."""
    out = dict(state)
    folded = 0
    for key in state:
        if not key.endswith(".mean"):
            continue
        bn = key[:-len(".mean")]
        if any(f"{bn}.{leaf}" not in state for leaf in ("var", "scale", "bias")):
            continue
        scope, _, name = bn.rpartition(".")
        conv_name = _conv_name_for(name)
        conv = f"{scope}.{conv_name}" if scope else conv_name
        if conv_name is None or f"{conv}.kernel" not in state:
            raise ValueError(f"unrecognized BatchNorm '{bn}' (no adjacent conv); "
                             "fold_batch_norm_state only knows the CvT/LeViT patterns")
        f64 = lambda leaf: state[f"{bn}.{leaf}"].detach().double()
        a64 = f64("scale") / torch.sqrt(f64("var") + eps)
        c64 = f64("bias") - a64 * f64("mean")
        kernel = state[f"{conv}.kernel"]
        out[f"{conv}.kernel"] = (kernel.detach().double() * a64[:, None, None, None]).to(
            kernel.dtype)
        b0 = state.get(f"{conv}.bias")
        b64 = 0.0 if b0 is None else b0.detach().double()
        out[f"{conv}.bias"] = (a64 * b64 + c64).to(kernel.dtype)
        for leaf in ("mean", "var", "scale", "bias"):
            del out[f"{bn}.{leaf}"]
        folded += 1
    if folded == 0:
        raise ValueError("no BatchNorm found to fold")
    return out
