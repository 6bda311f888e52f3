"""EfficientViT — the ViT shell around an injected encoder (port of
``vit_tpu/models/efficient.py``).

Patch embedding, cls token and positional embedding, then any encoder
module ``transformer(x)`` (the port's ``Transformer``, or another efficient
stack; or a dict of the port ``Transformer``'s keyword arguments, which the
shell builds in its own dtype and on its device), then the cls token or the
mean of the tokens through a LayerNorm and a Dense head in fp32. The encoder's parameters sit under ``transformer``, as
in ``vit_tpu``'s tree; ``jax_stages`` takes the encoder's own stacked
prefixes (``transformer.jax_stages``, where it has them).

Training (``forward(img, train=True, generator=..., remat=...)``):
``emb_drop`` (``emb_dropout``) after the position add, then the encoder
with each of ``train``, ``generator`` and ``remat`` that its ``forward``
takes. ``vit_tpu`` tries the encoder with ``deterministic`` and calls it
without on a ``TypeError`` (efficient.py:55-58); the port reads the
encoder's signature instead, so that a ``TypeError`` raised inside an
encoder is not taken for a signature that does not fit.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"`` (an encoder module is built by the caller,
on the same device); ``from_jax_params(tree, model.jax_stages)`` converts a
``vit_tpu`` variables tree.
"""

from __future__ import annotations

import inspect
from typing import Any, Mapping, Optional, Union

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.attention import dropout
from vit_tpu_torch.nn.blocks import Transformer
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed, mean_tokens


class EfficientViT(nn.Module):
    """``[B, H, W, C]`` images -> ``[B, num_classes]`` fp32 logits.
    ``vit_tpu``'s names: ``patch_embed``, ``cls``, ``pos_embedding``,
    ``transformer`` (a subclass's ``encoder_name``), ``head_norm``,
    ``head``. ``emb_dropout`` acts only under ``forward(..., train=True)``."""

    encoder_name = "transformer"

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 transformer: Union[nn.Module, Mapping[str, Any]], pool: str = "cls",
                 channels: int = 3, emb_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        if ph != pw:
            raise ValueError("square patches only")
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.pool, self.emb_dropout = pool, emb_dropout
        num_patches = (ih // ph) * (iw // pw)
        if isinstance(transformer, Mapping):
            transformer = Transformer(**transformer, dtype=dtype, device=device)
        self.patch_embed = PatchEmbed(dim, ph, channels, out_dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim, device=device))
        self.add_module(self.encoder_name, transformer)
        self._encoder_takes = _keywords(transformer, ("train", "generator", "remat"))
        self.jax_stages = {f"{self.encoder_name}/{k}": v
                           for k, v in getattr(transformer, "jax_stages", {}).items()}
        self.head_norm = LayerNorm(dim, device=device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        x = self.patch_embed(img)
        b, _, dim = x.shape
        x = torch.cat([self.cls.to(x.dtype).expand(b, 1, dim), x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        if train:
            x = dropout(x, self.emb_dropout, generator)
        given = dict(train=train, generator=generator, remat=remat)
        x = getattr(self, self.encoder_name)(x, **{k: given[k] for k in self._encoder_takes})
        x = x[:, 0] if self.pool == "cls" else mean_tokens(x)
        return self.head(self.head_norm(x))


def _keywords(module: nn.Module, names) -> tuple:
    """Those of ``names`` that ``module``'s ``forward`` takes by keyword
    (all of them where it takes ``**kwargs``)."""
    params = inspect.signature(module.forward).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return tuple(names)
    return tuple(n for n in names if n in params and params[n].kind in (
        inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY))
