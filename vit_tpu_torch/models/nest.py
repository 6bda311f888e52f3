"""NesT — a hierarchy of blocked transformers (port of
``vit_tpu/models/nest.py``).

The image is patchified and projected (``proj``, a Dense), then each
hierarchy, top-down, splits the map into ``2**level`` blocks a side
(``ops.block_partition``: the blocks fold into the batch axis), adds its
learned per-(token, channel) positions, runs ``block_repeats`` layers of
block attention (LayerNorm, fused qkv Dense, ``ops.qkv_attention``: the
fused-qkv kernel on the card, out Dense) and ConvMLP (``ops.mlp``), merges
the blocks back and, between hierarchies, aggregates (conv, LayerNorm, max
pool). The head is a LayerNorm, the token mean and a Dense, in the model
dtype, so a bf16 model gives bf16 logits, as ``vit_tpu``'s does.

Training (``forward(img, train=True, generator=..., remat=...)``), in
``vit_tpu``'s order of draws: each block attention's ``drop`` after
``to_out`` (``dropout``; its attention stays on ``ops.qkv_attention``, so
on the card ``ops.QkvAttentionFn`` at every rate), then each ConvMLP's
``drop1`` and ``drop2`` on its plain path above 0 (``ops.MlpFn`` at 0);
the aggregates' conv, LayerNorm and SAME max pool under grad in plain
PyTorch. ``vit_tpu``'s hierarchies are not scanned, so ``remat``
checkpoints nothing.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree (nothing is scanned: ``jax_stages``
is empty; the aggregates' conv kernels are turned to OIHW).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.core.utils import cast_tuple
from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.conv import Aggregate, ConvMLP
from vit_tpu_torch.nn.embed import Dense, LayerNorm


class _BlockAttention(nn.Module):
    """Full attention inside each block: ``norm`` (flax LayerNorm, eps
    1e-5), ``to_qkv`` and ``to_out`` (Dense without a bias), all in the
    model dtype; ``drop`` at rate ``dropout`` after ``to_out`` under
    ``train``."""

    def __init__(self, dim: int, heads: int, *, dropout: float = 0.0,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        self.dropout = dropout
        dim_head = dim // heads
        inner = dim_head * heads
        self.heads, self.scale = heads, dim_head**-0.5
        self.norm = LayerNorm(dim, eps=1e-5, dtype=dtype, device=device)
        self.to_qkv = Dense(dim, 3 * inner, use_bias=False, dtype=dtype, device=device)
        self.to_out = Dense(inner, dim, use_bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        qkv = self.to_qkv(self.norm(x))
        out = ops.qkv_attention(qkv.reshape(b, h * w, -1), self.heads, scale=self.scale)
        out = self.to_out(out.reshape(b, h, w, -1))
        return apply_dropout(out, self.dropout, generator) if train else out


class NesT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` logits in the model
    dtype (None: fp32). Widths and heads double from one hierarchy to the
    next; ``vit_tpu``'s names: ``proj``, ``pos_emb_{li}``,
    ``attn_{li}_{d}``, ``ff_{li}_{d}``, ``agg_{li}``, ``head_norm``,
    ``head``. ``dropout`` acts only under ``forward(..., train=True)``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int,
                 heads: int, num_hierarchies: int, block_repeats, mlp_mult: int = 4,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("image size must divide by patch size")
        self.patch_size, self.num_hierarchies = patch_size, num_hierarchies
        fmap = image_size // patch_size
        side = fmap // 2 ** (num_hierarchies - 1)  # a block's side, the same at every level
        dims = [2**i * dim for i in range(num_hierarchies)]
        self.repeats = cast_tuple(block_repeats, num_hierarchies)
        self.jax_stages = {}
        kw = dict(dtype=dtype, device=device)
        self.proj = Dense(patch_size * patch_size * 3, dims[0], **kw)
        for li, d in enumerate(dims):
            setattr(self, f"pos_emb_{li}", nn.Parameter(torch.zeros(1, side, side, d,
                                                                    device=device)))
            for r in range(self.repeats[li]):
                setattr(self, f"attn_{li}_{r}", _BlockAttention(d, 2**li * heads,
                                                                dropout=dropout, **kw))
                setattr(self, f"ff_{li}_{r}", ConvMLP(d, mlp_mult, dropout=dropout, **kw))
            if li + 1 < num_hierarchies:
                setattr(self, f"agg_{li}", Aggregate(d, dims[li + 1], **kw))
        self.head_norm = LayerNorm(dims[-1], eps=1e-5, **kw)
        self.head = Dense(dims[-1], num_classes, **kw)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        b, h, w, _ = img.shape
        p = self.patch_size
        x = self.proj(ops.patchify(img, p).reshape(b, h // p, w // p, -1))
        for li in range(self.num_hierarchies):
            n_blocks = 2 ** (self.num_hierarchies - 1 - li)  # top-down: most blocks first
            x = ops.block_partition(x, n_blocks)
            x = x + getattr(self, f"pos_emb_{li}").to(x.dtype)
            for r in range(self.repeats[li]):
                x = x + getattr(self, f"attn_{li}_{r}")(x, train, generator)
                x = x + getattr(self, f"ff_{li}_{r}")(x, train, generator)
            x = ops.block_unpartition(x, n_blocks)
            if li + 1 < self.num_hierarchies:
                x = getattr(self, f"agg_{li}")(x)
        x = self.head_norm(x)
        # jnp.mean over bf16 sums in fp32 and returns bf16
        return self.head(x.float().mean(dim=(1, 2)).to(x.dtype))
