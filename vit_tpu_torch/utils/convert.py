"""``vit_tpu`` variables -> this package's ``state_dict``.

Both packages keep flax's names, and the Dense layout (kernels ``[in,
out]``, as the kernels consume them; ``vit_tpu/utils/interop.py`` documents
the transposes to ``nn.Linear``, which the port does not need). Two layouts
change:

- A stack of blocks: ``vit_tpu`` scans a stage of depth > 1, so every leaf
  under its prefix (``encoder/blocks``, CaiT's ``patch_stage/blocks`` and
  ``cls_stage/blocks``, Twins-SVT's ``block_{a|b}_{s}/layers``) carries a
  leading depth axis, while the port holds one module per layer
  (``encoder.blocks.{i}``). A stage of depth 1 is not scanned: CaiT's and
  Twins' keep their prefix with unstacked leaves, the encoder's
  ``Transformer`` names its layer ``attn_0`` / ``ff_0``. So the stages are
  unstacked by the model's configuration (``model.jax_stages``), not by the
  shapes in the tree.
- A conv kernel: flax's HWIO ``[kh, kw, in/groups, out]`` becomes PyTorch's
  OIHW. Every leaf named ``kernel`` that is 4-D once unstacked is turned (a
  scanned conv kernel is 5-D and a scanned Dense kernel 3-D, so the turn
  comes after the unstacking).

A BatchNorm's running statistics (``batch_stats/<path>/{mean, var}``) go
to the buffers of the same path, beside the parameters.

Every variant of ``nn.Attention`` keeps ``vit_tpu``'s names, so its tree
maps by path: the flax branch's ``norm`` (absent without ``pre_norm``),
``to_qkv`` or ``to_q`` / ``to_kv`` (their ``bias`` only with ``qkv_bias``)
and ``to_out`` (absent without the output projection), with
``mix_heads_pre`` / ``mix_heads_post``, ``reattn_*`` and ``log_temperature``
beside them, as on the raw-parameter branch.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vit_tpu_torch.utils.quantize import QUANT_WEIGHTS

# vit_tpu's Transformer at depth 1 runs its layer unscanned, as attn_0 / ff_0
_UNSCANNED = re.compile(r"^(?P<stage>.+)/(?P<kind>attn|ff)_0/")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = v
    return flat


def from_jax_params(
    tree: Mapping[str, Any], stages: Optional[Mapping[str, Optional[int]]] = None,
) -> Dict[str, torch.Tensor]:
    """Convert a ``vit_tpu`` model's ``init`` variables (nested dicts of
    numpy arrays, with or without the top ``params`` key; with
    ``batch_stats`` beside ``params`` where the model has BatchNorms) into a
    ``state_dict`` for the port's model that loads with ``strict=True``.

    ``stages`` maps each stack's path prefix to its depth, as the port's
    models give it (``model.jax_stages``); the default, ``{"encoder/blocks":
    None}``, is a ViT encoder whose depth is read off the leading axis.

    - ``<stage>/<name>[depth, ...]`` -> ``<stage>.{i}.<name>``, one entry
      per layer (depth > 1, or None);
    - ``<stage>/<name>`` -> ``<stage>.0.<name>`` (depth 1), and likewise the
      unscanned ``encoder/attn_0/<name>`` -> ``encoder.blocks.0.attn.<name>``;
    - every other ``a/b/c`` -> ``a.b.c``;
    - a 4-D ``kernel`` (a conv's, HWIO) -> OIHW;
    - ``batch_stats/<path>/{mean, var}`` -> ``<path>.{mean, var}``, by the
      same rules.
    """
    leaves = _flatten(tree["params"] if "params" in tree else tree)
    stats = _flatten(tree.get("batch_stats", {})) if "params" in tree else {}
    shared = stats.keys() & leaves.keys()
    if shared:
        raise ValueError(f"batch_stats and params share paths: {sorted(shared)}")
    leaves.update(stats)
    stages = {"encoder/blocks": None} if stages is None else stages
    state, seen = {}, set()

    def put(key, arr):
        if key.rsplit(".", 1)[-1] == "kernel" and arr.dim() == 4:
            arr = arr.permute(3, 2, 0, 1).contiguous()
        state[key] = arr

    for path, value in leaves.items():
        arr = torch.from_numpy(np.array(value, dtype=np.float32))
        m = _UNSCANNED.match(path)
        if m and stages.get(f"{m['stage']}/blocks") == 1:
            path = f"{m['stage']}/blocks/{m['kind']}/{path[m.end():]}"
        stage = next((s for s in stages if path.startswith(s + "/")), None)
        if stage is None:
            put(path.replace("/", "."), arr)
            continue
        seen.add(stage)
        key = stage.replace("/", ".")
        rest = path[len(stage) + 1:].replace("/", ".")
        depth = stages[stage]
        if depth == 1:
            put(f"{key}.0.{rest}", arr)
            continue
        if depth is not None and arr.shape[:1] != (depth,):
            raise ValueError(f"{path}: leading axis {tuple(arr.shape)[:1]}, not the depth {depth}")
        for i, layer in enumerate(arr.unbind(0)):
            put(f"{key}.{i}.{rest}", layer.clone())
    missing = [s for s, depth in stages.items() if depth is not None and s not in seen]
    if missing:
        raise ValueError(f"no leaves under {missing} for the depths {[stages[s] for s in missing]}")
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
    qkv_kernel``, its scale ``...qkv_kernel_scale``. A tree with a qkv bias
    (a Hugging Face or timm import) gives ``encoder.blocks.{i}.attn.qkv_bias``
    too, for a ``QuantViT(qkv_bias=True)``."""
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
