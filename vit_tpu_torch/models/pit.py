"""PiT — the pooling-based vision transformer (port of ``vit_tpu/models/pit.py``).

An overlapping patchify (``ops.extract_patches``, stride patch / 2, VALID)
and a Dense (``proj``) feed a cls-token stream through stages of encoder
blocks; between stages ``Pool`` halves the side of the token map with a
stride-2 depthwise conv and doubles the width, projecting the cls token with
a Dense. Each stage is the port's ``Transformer`` (LayerNorm eps 1e-5): a
stage deeper than 1 runs the fused attention block and MLP kernels, a stage
of depth 1 its one layer unfused, as ``vit_tpu`` does. A LayerNorm without
bias and a Dense head in the model dtype close it, so a bf16 model gives
bf16 logits, as ``vit_tpu``'s does.

Training (``forward(img, train=True, generator=..., remat=...)``):
``emb_drop`` (``emb_dropout``) after the position add, ``dropout`` in every
stage's attention and MLP (``Transformer``: ``vit_tpu``'s dropout routes
above 0, the fused kernels at 0, through ``ops.AttentionBlockFn`` and
``ops.MlpFn``), and ``remat`` checkpointing each block of a stage deeper
than 1, as ``vit_tpu`` scans and remats those stages.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.core.utils import cast_tuple, conv_output_size
from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.blocks import Transformer
from vit_tpu_torch.nn.conv import Pool
from vit_tpu_torch.nn.embed import Dense, LayerNorm


class PiT(nn.Module):
    """``[B, H, W, C]`` images -> ``[B, num_classes]`` logits in ``dtype``
    (None: fp32). ``vit_tpu``'s names: ``proj``, ``cls``, ``pos_embedding``,
    ``stage_{s}``, ``pool_{s}``, ``head_norm``, ``head``. ``dropout`` and
    ``emb_dropout`` act only under ``forward(..., train=True)``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: tuple, heads, mlp_dim: int, dim_head: int = 64, channels: int = 3,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("image size must divide by patch size")
        if not isinstance(depth, tuple):
            raise TypeError("depth must be a tuple: blocks per stage before each downsize")
        self.patch_size, self.stages = patch_size, len(depth)
        self.emb_dropout = emb_dropout
        side = conv_output_size(image_size, patch_size, patch_size // 2)
        self.proj = Dense(patch_size * patch_size * channels, dim, dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, side * side + 1, dim, device=device))
        self.jax_stages = {}
        for s, (stage_depth, stage_heads) in enumerate(zip(depth, cast_tuple(heads, len(depth)))):
            stage = Transformer(dim, stage_depth, stage_heads, dim_head, mlp_dim, norm_eps=1e-5,
                                dropout=dropout, dtype=dtype, device=device)
            self.add_module(f"stage_{s}", stage)
            self.jax_stages.update({f"stage_{s}/{k}": v for k, v in stage.jax_stages.items()})
            if s + 1 < len(depth):
                self.add_module(f"pool_{s}", Pool(dim, 2 * dim, dtype=dtype, device=device))
                dim *= 2
        self.head_norm = LayerNorm(dim, eps=1e-5, use_bias=False, dtype=dtype, device=device)
        self.head = Dense(dim, num_classes, dtype=dtype, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        p = self.patch_size
        x = ops.extract_patches(img, p, p // 2, padding="VALID")
        b = x.shape[0]
        x = self.proj(x.reshape(b, -1, x.shape[-1]))
        dim = x.shape[-1]
        x = torch.cat([self.cls.to(x.dtype).expand(b, 1, dim), x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        if train:
            x = apply_dropout(x, self.emb_dropout, generator)
        for s in range(self.stages):
            x = getattr(self, f"stage_{s}")(x, train=train, generator=generator, remat=remat)
            if s + 1 < self.stages:
                x = getattr(self, f"pool_{s}")(x)
        return self.head(self.head_norm(x[:, 0]))
