"""EfficientViT — the ViT shell around an injected encoder (port of
``vit_tpu/models/efficient.py``).

Patch embedding, cls token and positional embedding, then any encoder
module ``transformer(x)`` (the port's ``Transformer``, or another efficient
stack; or a dict of the port ``Transformer``'s keyword arguments, which the
shell builds in its own dtype and on its device), then the cls token or the
mean of the tokens through a LayerNorm and a Dense head in fp32. The encoder's parameters sit under ``transformer``, as
in ``vit_tpu``'s tree; ``jax_stages`` takes the encoder's own stacked
prefixes (``transformer.jax_stages``, where it has them).

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"`` (an encoder module is built by the caller,
on the same device); ``from_jax_params(tree, model.jax_stages)`` converts a
``vit_tpu`` variables tree.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.blocks import Transformer
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed, mean_tokens


class EfficientViT(nn.Module):
    """``[B, H, W, C]`` images -> ``[B, num_classes]`` fp32 logits.
    ``vit_tpu``'s names: ``patch_embed``, ``cls``, ``pos_embedding``,
    ``transformer`` (a subclass's ``encoder_name``), ``head_norm``,
    ``head``."""

    encoder_name = "transformer"

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 transformer: Union[nn.Module, Mapping[str, Any]], pool: str = "cls",
                 channels: int = 3, dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        if ph != pw:
            raise ValueError("square patches only")
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.pool = pool
        num_patches = (ih // ph) * (iw // pw)
        if isinstance(transformer, Mapping):
            transformer = Transformer(**transformer, dtype=dtype, device=device)
        self.patch_embed = PatchEmbed(dim, ph, channels, out_dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim, device=device))
        self.add_module(self.encoder_name, transformer)
        self.jax_stages = {f"{self.encoder_name}/{k}": v
                           for k, v in getattr(transformer, "jax_stages", {}).items()}
        self.head_norm = LayerNorm(dim, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(img)
        b, _, dim = x.shape
        x = torch.cat([self.cls.to(x.dtype).expand(b, 1, dim), x], dim=1)
        x = getattr(self, self.encoder_name)(x + self.pos_embedding.to(x.dtype))
        x = x[:, 0] if self.pool == "cls" else mean_tokens(x)
        return self.head(self.head_norm(x))
