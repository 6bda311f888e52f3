"""Hugging Face ViT checkpoints in and out (port of ``vit_tpu/utils/interop.py``).

A user moving from the PyTorch ecosystem arrives with a Hugging Face
``ViTForImageClassification`` (or bare ``ViTModel``, or a timm ViT of the
same layout) checkpoint. These functions map its ``state_dict`` onto the
port's ``ViT`` with the checkpoint's knobs (``qkv_bias=True``, the erf GELU
``activation="gelu_exact"``, the config's LayerNorm eps), whose attention
then takes the flax branch with a qkv bias (the flash kernel and the MLP
kernel on the card), and back.

None of them imports ``transformers``: the card's machine has none. A
checkpoint is a ``state_dict`` of tensors or numpy arrays (``torch.load`` of
``pytorch_model.bin``, or a safetensors file read by the caller), and a
config is an object with HF's attribute names (a ``ViTConfig``) or a plain
dict (``json.load`` of ``config.json``). Where a live HF model is given, its
``state_dict()`` and ``config`` are read.

The mapping is ``vit_tpu``'s, in numpy, onto ``vit_tpu``'s variables layout
(``hf_vit_params``), then ``from_jax_params``: the port's weights are
exactly those ``vit_tpu`` imports. Layout notes (``vit_tpu``'s): an
``nn.Linear`` weight ``(out, in)`` is transposed to a Dense kernel ``(in,
out)``; the patch conv ``(dim, c, p, p)`` flattens in the patchify order
``(p1, p2, c)``; q, k, v concatenate into ``to_qkv`` (both sides split the
inner axis as ``(heads, dim_head)``). HF normalises every token and then
takes the CLS token; the port takes the CLS token and normalises it: the
same function, LayerNorm being per token.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from vit_tpu_torch.utils.convert import from_jax_params

# HF's ViTConfig defaults (transformers/models/vit/configuration_vit.py) for
# keys a config.json may leave out.
_HF_DEFAULTS = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                    intermediate_size=3072, hidden_act="gelu", layer_norm_eps=1e-12,
                    image_size=224, patch_size=16, qkv_bias=True)
# The order in which HF's three projections make the fused to_qkv kernel.
QKV_ORDER = ("query", "key", "value")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _get(cfg, name: str):
    """An HF config value by attribute (a ``ViTConfig``) or key (a dict
    parsed from ``config.json``), with HF's default where a dict leaves it
    out."""
    if isinstance(cfg, Mapping):
        return cfg.get(name, _HF_DEFAULTS.get(name))
    return getattr(cfg, name)


def _num_labels(cfg) -> int:
    """``vit_tpu``'s ``getattr(hf_config, "num_labels", 0) or 0`` for a config
    object; for a parsed ``config.json``, what ``ViTConfig.from_dict`` makes
    of it: ``num_labels``, else the size of ``id2label``, else HF's 2."""
    if not isinstance(cfg, Mapping):
        return getattr(cfg, "num_labels", 0) or 0
    if cfg.get("num_labels") is not None:
        return int(cfg["num_labels"])
    return len(cfg["id2label"]) if cfg.get("id2label") else 2


def hf_vit_config(hf_config) -> Dict[str, Any]:
    """The port's ``ViT`` keyword arguments for an HF ViT config (an object
    with HF's attribute names, or a dict of ``config.json``)."""
    dim, heads = _get(hf_config, "hidden_size"), _get(hf_config, "num_attention_heads")
    if dim % heads:
        raise ValueError("hidden_size must be divisible by num_attention_heads")
    act = _get(hf_config, "hidden_act")
    qkv_bias = hf_config.get("qkv_bias", True) if isinstance(hf_config, Mapping) else getattr(
        hf_config, "qkv_bias", True)
    return dict(
        image_size=_get(hf_config, "image_size"),
        patch_size=_get(hf_config, "patch_size"),
        num_classes=_num_labels(hf_config),
        dim=dim,
        depth=_get(hf_config, "num_hidden_layers"),
        heads=heads,
        dim_head=dim // heads,
        mlp_dim=_get(hf_config, "intermediate_size"),
        pool="cls",
        qkv_bias=qkv_bias,
        activation="gelu_exact" if act == "gelu" else act,
        norm_eps=_get(hf_config, "layer_norm_eps"),
    )


def hf_vit_params(state_dict: Mapping[str, Any], depth: int, patch_size: int,
                  num_classes: Optional[int] = None) -> Dict[str, Any]:
    """An HF ViT ``state_dict`` as ``vit_tpu``'s ``ViT`` variables (numpy,
    stacked layers): ``vit_tpu``'s ``import_hf_vit_params``. Takes a
    ``ViTForImageClassification`` checkpoint (keys under ``vit.`` plus
    ``classifier.*``) or a bare ``ViTModel`` one (no prefix, no head: the
    head is then zeros at ``num_classes``, 2 when None, HF's default)."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    prefix = "vit." if any(k.startswith("vit.") for k in sd) else ""

    def g(key):
        return sd[prefix + key]

    emb, enc = "embeddings.", "encoder.layer."
    conv_w = g(emb + "patch_embeddings.projection.weight")  # (dim, c, p, p)
    dim = conv_w.shape[0]
    proj_kernel = conv_w.transpose(2, 3, 1, 0).reshape(patch_size * patch_size * conv_w.shape[1],
                                                       dim)

    def stack(fn):
        return np.stack([fn(f"{enc}{i}.") for i in range(depth)])

    def t(key):  # nn.Linear (out, in) -> Dense (in, out)
        return g(key).T

    params: Dict[str, Any] = {
        "cls": g(emb + "cls_token"),
        "pos_embedding": g(emb + "position_embeddings"),
        "patch_embed": {"proj": {"kernel": proj_kernel,
                                 "bias": g(emb + "patch_embeddings.projection.bias")}},
        "encoder": {"blocks": {
            "attn": {
                "norm": {"scale": stack(lambda l: g(l + "layernorm_before.weight")),
                         "bias": stack(lambda l: g(l + "layernorm_before.bias"))},
                "to_qkv": {
                    "kernel": stack(lambda l: np.concatenate(
                        [t(f"{l}attention.attention.{n}.weight") for n in QKV_ORDER], axis=1)),
                    "bias": stack(lambda l: np.concatenate(
                        [g(f"{l}attention.attention.{n}.bias") for n in QKV_ORDER])),
                },
                "to_out": {"kernel": stack(lambda l: t(l + "attention.output.dense.weight")),
                           "bias": stack(lambda l: g(l + "attention.output.dense.bias"))},
            },
            "ff": {
                "ln_scale": stack(lambda l: g(l + "layernorm_after.weight")),
                "ln_bias": stack(lambda l: g(l + "layernorm_after.bias")),
                "w1": stack(lambda l: t(l + "intermediate.dense.weight")),
                "b1": stack(lambda l: g(l + "intermediate.dense.bias")),
                "w2": stack(lambda l: t(l + "output.dense.weight")),
                "b2": stack(lambda l: g(l + "output.dense.bias")),
            },
        }},
        "head_norm": {"scale": g("layernorm.weight"), "bias": g("layernorm.bias")},
    }
    if "classifier.weight" in sd:
        params["head"] = {
            "kernel": sd["classifier.weight"].T,
            "bias": sd.get("classifier.bias",
                           np.zeros(sd["classifier.weight"].shape[0], np.float32)),
        }
    else:  # a bare ViTModel: no head in the checkpoint
        width = 2 if num_classes is None else num_classes
        params["head"] = {"kernel": np.zeros((dim, width), np.float32),
                          "bias": np.zeros((width,), np.float32)}
    return {"params": params}


def import_hf_vit_params(state_dict: Mapping[str, Any], depth: int, patch_size: int,
                         num_classes: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """An HF ViT ``state_dict`` as the port's: ``from_jax_params`` of
    ``hf_vit_params`` (``vit_tpu``'s mapping), for a ``ViT`` built from
    ``hf_vit_config`` to load with ``strict=True``. fp32 CPU tensors."""
    return from_jax_params(hf_vit_params(state_dict, depth, patch_size, num_classes))


def export_vit_to_hf(model: nn.Module, hf_model=None) -> Dict[str, torch.Tensor]:
    """The inverse mapping: the port's ``ViT`` (with or without a qkv bias;
    without, the HF q, k, v biases are zeros) as a
    ``ViTForImageClassification`` ``state_dict`` of fp32 CPU tensors, loaded
    into ``hf_model`` as well where one is given (``vit_tpu``'s
    ``export_vit_to_hf``). Exact: importing it gives the model's state
    back."""
    p = {k: _np(v) for k, v in model.state_dict().items()}
    dim, ps = model.config["dim"], model.config["patch_size"]
    depth = len(model.encoder.blocks)
    sd = {}
    emb, enc = "vit.embeddings.", "vit.encoder.layer."
    sd[emb + "cls_token"] = p["cls"]
    sd[emb + "position_embeddings"] = p["pos_embedding"]
    proj = p["patch_embed.proj.kernel"]
    c = proj.shape[0] // (ps * ps)
    sd[emb + "patch_embeddings.projection.weight"] = proj.reshape(ps, ps, c, dim).transpose(
        3, 2, 0, 1)
    sd[emb + "patch_embeddings.projection.bias"] = p["patch_embed.proj.bias"]
    for i in range(depth):
        a, f, l = f"encoder.blocks.{i}.attn.", f"encoder.blocks.{i}.ff.", f"{enc}{i}."
        if a + "to_qkv.kernel" in p:
            names = ("norm.scale", "norm.bias", "to_qkv.kernel", "to_out.kernel", "to_out.bias")
        else:
            names = ("norm_scale", "norm_bias", "qkv_kernel", "out_kernel", "out_bias")
        norm_s, norm_b, qkv_k, out_k, out_b = (p[a + n] for n in names)
        qkv_b = p.get(a + "to_qkv.bias")
        hd = qkv_k.shape[1] // 3
        sd[l + "layernorm_before.weight"] = norm_s
        sd[l + "layernorm_before.bias"] = norm_b
        for j, name in enumerate(QKV_ORDER):
            sd[l + f"attention.attention.{name}.weight"] = qkv_k[:, j * hd:(j + 1) * hd].T
            sd[l + f"attention.attention.{name}.bias"] = (
                qkv_b[j * hd:(j + 1) * hd] if qkv_b is not None else np.zeros(hd, np.float32))
        sd[l + "attention.output.dense.weight"] = out_k.T
        sd[l + "attention.output.dense.bias"] = out_b
        sd[l + "layernorm_after.weight"] = p[f + "ln_scale"]
        sd[l + "layernorm_after.bias"] = p[f + "ln_bias"]
        sd[l + "intermediate.dense.weight"] = p[f + "w1"].T
        sd[l + "intermediate.dense.bias"] = p[f + "b1"]
        sd[l + "output.dense.weight"] = p[f + "w2"].T
        sd[l + "output.dense.bias"] = p[f + "b2"]
    sd["vit.layernorm.weight"] = p["head_norm.scale"]
    sd["vit.layernorm.bias"] = p["head_norm.bias"]
    sd["classifier.weight"] = p["head.kernel"].T
    sd["classifier.bias"] = p["head.bias"]
    state = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if hf_model is not None:
        hf_model.load_state_dict(state)
    return state


def vit_from_hf(source, config=None, *, dtype: Optional[torch.dtype] = None,
                residual_dtype: Optional[torch.dtype] = None, device="cuda") -> nn.Module:
    """One call: an HF ViT -> the port's ``ViT``, weights loaded, in eval
    mode. ``source`` is a live HF model (its ``state_dict()`` and
    ``config``) or a ``state_dict``, with ``config`` (object or
    ``config.json`` dict) beside it. ``dtype=torch.bfloat16`` serves it on
    the kernels; the default keeps fp32 for parity checks."""
    from vit_tpu_torch.models import ViT

    if config is None:
        config = source.config
    state_dict = source.state_dict() if hasattr(source, "state_dict") else source
    cfg = hf_vit_config(config)
    model = ViT(**cfg, dtype=dtype, residual_dtype=residual_dtype, device=device)
    model.load_state_dict(import_hf_vit_params(state_dict, cfg["depth"], cfg["patch_size"],
                                               cfg["num_classes"]), strict=True)
    return model.eval()
