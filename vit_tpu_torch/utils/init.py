"""Parameter initialisation as ``vit_tpu``'s flax ``init`` draws it.

The port's constructors build zeros and ones (``models/vit.py``); a trainer
starts from ``init_params(model, generator)``, which gives each parameter of
every family of ``vit_tpu_torch.models`` and of ``ViTMoE`` the distribution
of its ``vit_tpu`` initializer:

- ``lecun_normal`` (flax's ``variance_scaling(1, "fan_in",
  "truncated_normal")``: a unit normal truncated at +-2, times
  ``sqrt(1 / fan_in) / 0.87962566103423978``, the truncated normal's
  standard deviation at 2) for the raw-parameter kernels ``qkv_kernel``,
  ``out_kernel``, ``w1``, ``w2`` (``vit_tpu/nn/attention.py:256-263``,
  ``nn/blocks.py:47-60``; Twins' local attention,
  ``vit_tpu/models/twins_svt.py:52-59``) and every flax ``Dense``
  ``kernel`` (``patch_embed/proj``, ``head``, Twins' ``to_q``, T2T's
  ``proj``, CrossViT's cross-attention projections, NesT's bias-free
  ``to_qkv`` and ``to_out``, ScalableViT's IWSA ``to_q`` / ``to_k`` /
  ``to_v``, CrossFormer's position-bias MLP ``fc0..fc3``, SPT's ``proj``,
  ViT-MoE's ``router``); fan-in is the kernel's ``[in, out]`` first axis.
  ViT-MoE's ``expert_w1`` ``[E, D, F]`` and ``expert_w2`` ``[E, F, D]``
  take flax's fan-in of a 3-D kernel, ``shape[-2] * shape[0]`` (D * E and
  F * E: ``lecun_normal`` over ``(8, 512, 2048)`` has std
  ``1 / sqrt(512 * 8)``). Every flax
  ``Conv`` ``kernel`` too (Twins' ``to_kv`` and PEG's depthwise ``proj``):
  flax's fan-in of an HWIO kernel is ``kh * kw * in / groups``, which over
  the port's OIHW kernel is ``I * kh * kw`` (``I`` already ``in /
  groups``; a depthwise kernel's fan-in is ``kh * kw``: CvT's projections,
  PiT's ``Pool``; NesT's aggregates, RegionViT's tokenizers, downsamples
  and PEGs; ScalableViT's SSA ``to_k`` / ``to_v``, LIM, PEGs and
  downsamples);
- ``truncated_normal(0.02)`` for ``cls`` and ``pos_embedding``
  (``vit_tpu/models/vit.py:60-69``, ``models/t2t.py:75-80``,
  ``models/pit.py:55-64``, each CrossViT embedder's,
  ``models/cross_vit.py:40-48``) and NesT's ``pos_emb_{li}``
  (``models/nest.py:93-98``);
- flax's ``normal(1.0)``, not truncated, for PatchMerger's ``queries``
  (``vit_tpu/nn/embed.py:74-79``);
- zeros for biases (conv biases too, ViT-MoE's ``expert_b1`` /
  ``expert_b2``), ones for LayerNorm and BatchNorm scales (``norm_scale``
  of Twins' local attention, the bias-free ``norm`` of SPT, CrossFormer's
  ``ln0..ln2``); a BatchNorm's running
  statistics (buffers, not parameters) go back to mean 0 and variance 1,
  flax's ``batch_stats`` at ``init``;
- flax ``nn.Embed``'s default for an ``embedding`` table (LeViT's
  ``pos_bias``, RegionViT's ``rel_pos_bias``): ``variance_scaling(1, "fan_in", "normal", out_axis=0)``,
  which over ``[num, features]`` is an untruncated normal of standard
  deviation ``sqrt(1 / features)``;
- flax's ``normal(0.02)``, not truncated, for the head mixes
  ``mix_heads_pre``, ``mix_heads_post`` and ``reattn_weights``
  (``vit_tpu/nn/attention.py:251-257``, ``:413-421``); ones for
  ``reattn_scale``, zeros for ``reattn_bias``;
- CaiT's LayerScales ``ls_attn`` and ``ls_ff``: the constant
  ``layer_scale_eps(model_depth)`` (``vit_tpu/models/cait.py:47-51``,
  ``:93-98``), which each block keeps as ``ls_eps``. Its cross-attention's
  ``to_q``, ``to_kv`` and ``to_out`` kernels are flax ``Dense`` kernels:
  lecun, as above;
- LSA's ``log_temperature`` (the small-dataset ViT): the constant
  ``nn.attention.log_temperature_init(dim_head)``, ``vit_tpu``'s fp32
  ``jnp.log(dim_head**-0.5)`` (``vit_tpu/nn/attention.py:181-184``).

The draws cannot be flax's (another generator); the distributions and the
shapes are. A parameter of another initializer raises.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vit_tpu_torch.nn.attention import log_temperature_init
from vit_tpu_torch.nn.embed import BatchNorm

# flax's truncated-normal correction: the std of a unit normal truncated at +-2
TRUNC_STD = 0.87962566103423978
_LECUN = ("qkv_kernel", "out_kernel", "w1", "w2", "kernel")
_TOKENS = ("cls", "pos_embedding")
_TOKENS_PREFIX = "pos_emb_"  # NesT's pos_emb_{li}
_UNIT_NORMAL = ("queries",)
_ZEROS = ("bias", "b1", "b2", "out_bias", "norm_bias", "ln_bias", "reattn_bias", "expert_b1",
          "expert_b2")
_EXPERTS = ("expert_w1", "expert_w2")  # [E, in, out]: flax's fan-in in * E
_ONES = ("scale", "norm_scale", "ln_scale", "reattn_scale")
_MIXES = ("mix_heads_pre", "mix_heads_post", "reattn_weights")
_EMBED = ("embedding",)
_LAYER_SCALES = ("ls_attn", "ls_ff")


def truncated_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """flax's ``truncated_normal(std)`` in place: a normal of standard
    deviation ``std`` truncated at +-2 ``std``."""
    return nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


def lecun_std(fan_in: int) -> float:
    """The scale of flax's ``lecun_normal`` before its truncation at +-2."""
    return math.sqrt(1.0 / fan_in) / TRUNC_STD


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` in place, in the order of
    ``named_parameters``, as ``vit_tpu``'s initializer of the same name
    draws it; returns ``model``. ``generator`` lies on the parameters'
    device."""
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if leaf in _LECUN and p.dim() == 2:
            truncated_normal_(p, lecun_std(p.shape[0]), generator)
        elif leaf == "kernel" and p.dim() == 4:  # a conv kernel, OIHW
            truncated_normal_(p, lecun_std(p[0].numel()), generator)
        elif leaf in _EXPERTS and p.dim() == 3:
            truncated_normal_(p, lecun_std(p.shape[0] * p.shape[1]), generator)
        elif leaf in _TOKENS or leaf.startswith(_TOKENS_PREFIX):
            truncated_normal_(p, 0.02, generator)
        elif leaf in _UNIT_NORMAL:
            nn.init.normal_(p, 0.0, 1.0, generator=generator)
        elif leaf in _ZEROS:
            p.zero_()
        elif leaf in _ONES:
            p.fill_(1.0)
        elif leaf in _MIXES:
            nn.init.normal_(p, 0.0, 0.02, generator=generator)
        elif leaf in _EMBED and p.dim() == 2:
            nn.init.normal_(p, 0.0, p.shape[1] ** -0.5, generator=generator)
        elif leaf in _LAYER_SCALES:
            p.fill_(modules[owner].ls_eps)
        elif leaf == "log_temperature" and p.dim() == 0:
            p.copy_(log_temperature_init(modules[owner].dim_head))
        else:
            raise NotImplementedError(
                f"{name} {tuple(p.shape)}: no vit_tpu initializer ported for it (init_params "
                "covers the parameters of the 18 families of vit_tpu_torch.models and of "
                "ViTMoE)")
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mean.zero_()
            m.var.fill_(1.0)
    return model
