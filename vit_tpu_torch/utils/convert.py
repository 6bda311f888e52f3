"""``vit_tpu`` variables -> this package's ``state_dict``.

Both packages keep flax's names and layout (Dense kernels ``[in, out]``, as
the kernels consume them; ``vit_tpu/utils/interop.py`` documents the
transposes to ``nn.Linear``, which the port does not need). The one change
of layout is the encoder stack: ``vit_tpu`` scans its blocks, so every leaf
under ``encoder/blocks`` carries a leading depth axis, while the port holds
one module per layer (``encoder.blocks.{i}``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vit_tpu_torch.utils.quantize import QUANT_WEIGHTS

_STACKED = "encoder/blocks/"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = v
    return flat


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert ``ViT.init``'s variables (nested dicts of numpy arrays, with
    or without the top ``params`` key) into a ``state_dict`` for
    ``vit_tpu_torch.models.ViT`` that loads with ``strict=True``:

    - ``params/{cls, pos_embedding}`` -> ``cls``, ``pos_embedding``;
    - ``encoder/blocks/{attn,ff}/<name>[depth, ...]`` ->
      ``encoder.blocks.{i}.{attn,ff}.<name>``, one entry per layer;
    - every other ``a/b/c`` -> ``a.b.c``.
    """
    if "params" in tree:
        tree = tree["params"]
    state = {}
    for path, value in _flatten(tree).items():
        arr = torch.from_numpy(np.array(value, dtype=np.float32))
        if path.startswith(_STACKED):
            rest = path[len(_STACKED):].replace("/", ".")
            for i, layer in enumerate(arr.unbind(0)):
                state[f"encoder.blocks.{i}.{rest}"] = layer.clone()
        else:
            state[path.replace("/", ".")] = arr
    return state


# vit_tpu's quantize_vit names, in the order of the port's QUANT_WEIGHTS.
_QUANT_NAMES = ("to_qkv", "to_out", "w1", "w2")


def from_jax_quant(qvars: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert ``vit_tpu``'s ``quantize_vit(variables)`` output (``params``
    without the encoder GEMM kernels, and ``quant/{to_qkv, to_out, w1,
    w2}/{w, s}`` with int8 ``w`` ``(depth, K, N)`` and fp32 ``s`` ``(depth,
    1, N)``) into a ``state_dict`` for ``vit_tpu_torch.utils.QuantViT`` that
    loads with ``strict=True``. The codes stay int8 and keep their layout:
    layer i's ``quant/to_qkv/w[i]`` becomes ``encoder.blocks.{i}.attn.
    qkv_kernel``, its scale ``...qkv_kernel_scale``."""
    attn = qvars["params"]["encoder"]["blocks"]["attn"]
    if "qkv_bias" in attn:
        raise NotImplementedError(
            "quantized trees with a qkv bias (HF/timm imports) are not ported yet "
            "(ROADMAP.md Queue 1 item 4, qkv-bias layout)"
        )
    state = from_jax_params(qvars["params"])
    for name, (mod, weight) in zip(_QUANT_NAMES, QUANT_WEIGHTS):
        codes = np.asarray(qvars["quant"][name]["w"])
        if codes.dtype != np.int8:
            raise TypeError(f"quant/{name}/w must be int8, got {codes.dtype}")
        scales = np.asarray(qvars["quant"][name]["s"], dtype=np.float32)
        for i in range(codes.shape[0]):
            key = f"encoder.blocks.{i}.{mod}.{weight}"
            state[key] = torch.from_numpy(codes[i].copy())
            state[f"{key}_scale"] = torch.from_numpy(scales[i].copy())
    return state
