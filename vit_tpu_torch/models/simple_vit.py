"""SimpleViT — "Better plain ViT baselines" (port of
``vit_tpu/models/simple_vit.py``).

No cls token and no dropout: the patch embedding plus the fixed 2-D sin-cos
embedding (``ops.posemb_sincos_2d``, added in the stream's dtype), the
port's ``Transformer`` (LayerNorm eps 1e-5; the fused attention block and
MLP kernels from depth 2), the mean of the tokens (``mean_tokens``, as
``jnp.mean``), then a LayerNorm without bias and a Dense head in fp32.
Images are NHWC; ``channels_first=True`` takes NCHW, as the upstream model.

Training (``forward(img, train=True, remat=...)``): there is no dropout, so
``train`` changes nothing; under grad ``remat`` checkpoints each encoder
block of a stack deeper than 1, as ``vit_tpu`` scans and remats it. The
kernels run forward and ``ops.AttentionBlockFn`` / ``ops.MlpFn``
differentiate them.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.blocks import Transformer
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed, mean_tokens


class SimpleViT(nn.Module):
    """``[B, H, W, C]`` images (``[B, C, H, W]`` with ``channels_first``) ->
    ``[B, num_classes]`` fp32 logits. ``vit_tpu``'s names: ``patch_embed``,
    ``encoder``, ``head_norm``, ``head``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, channels: int = 3, dim_head: int = 64,
                 channels_first: bool = False, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        if ph != pw:
            raise ValueError("square patches only")
        self.channels_first = channels_first
        # the constructor's arguments, for quantize_vit to build the int8 model
        self.config = dict(image_size=image_size, patch_size=patch_size, num_classes=num_classes,
                           dim=dim, depth=depth, heads=heads, mlp_dim=mlp_dim, channels=channels,
                           dim_head=dim_head, channels_first=channels_first, dtype=dtype)
        self.patch_embed = PatchEmbed(dim, ph, channels, out_dtype=dtype, device=device)
        # the sin-cos table in the stream's dtype, made once (not a parameter)
        self.register_buffer("pos_sincos", ops.posemb_sincos_2d(
            ih // ph, iw // pw, dim, dtype=dtype or torch.float32).to(device), persistent=False)
        self.encoder = Transformer(dim, depth, heads, dim_head, mlp_dim, norm_eps=1e-5,
                                   dtype=dtype, device=device)
        self.jax_stages = {f"encoder/{k}": v for k, v in self.encoder.jax_stages.items()}
        self.head_norm = LayerNorm(dim, eps=1e-5, use_bias=False, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        if self.channels_first:
            img = img.permute(0, 2, 3, 1)
        x = self.patch_embed(img)
        x = self.encoder(x + self.pos_sincos.to(x.dtype), train=train, generator=generator,
                         remat=remat)
        return self.head(self.head_norm(mean_tokens(x)))
