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
