"""CrossViT — the dual-branch multi-scale ViT (port of ``vit_tpu/models/cross_vit.py``).

Two patch scales embed the image into a small and a large token stream
(``sm_embedder``, ``lg_embedder``: patch embedding, cls token, learned
positions). Each of ``depth`` rounds runs each stream through its own
encoder (the port's ``Transformer`` with a final LayerNorm, eps 1e-5: a
stack deeper than 1 on the fused attention block and MLP kernels, a stack
of depth 1 its one layer unfused, as ``vit_tpu`` does), then
``cross_attn_depth`` exchanges in which each stream's cls token, projected
to the other stream's width by a Dense, cross-attends the other stream's
patch tokens and itself (``kv_include_self``) and is projected back and
added to the cls token. The cross-attention is the port's flax branch with
the low-query path at these shapes, in plain PyTorch, as ``vit_tpu``
computes it outside any Pallas kernel. The logits are the fp32 sum of two
heads (a bias-free LayerNorm and a Dense, in fp32) on the two cls tokens.

Training (``forward(img, train=True, generator=..., remat=...)``), in
``vit_tpu``'s order of draws: each embedder's ``drop`` (``emb_dropout``)
after its position add, small then large; each round's small and large
encoder (``dropout``: ``Transformer``'s routes, ``remat`` checkpointing the
blocks of an encoder deeper than 1, as ``vit_tpu`` scans and remats it);
then each exchange's ``sm_attends_lg`` and ``lg_attends_sm`` with
``attn_drop`` on the low-query path's probabilities and ``out_drop`` after
``to_out`` (``dropout``; vit_tpu/nn/attention.py:424-462, :409).

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch.core.utils import pair
from vit_tpu_torch.nn.attention import Attention, dropout
from vit_tpu_torch.nn.blocks import Transformer
from vit_tpu_torch.nn.embed import Dense, LayerNorm, PatchEmbed


class _ImageEmbedder(nn.Module):
    """Patchify and project (``patch_embed``, rounded once to ``dtype``), a
    ``cls`` token in front, learned ``pos_embedding`` added in the stream's
    dtype, then ``drop`` at rate ``dropout`` under ``train``."""

    def __init__(self, dim: int, image_size: int, patch_size: int, channels: int, *,
                 dropout: float = 0.0, dtype: Optional[torch.dtype], device):
        super().__init__()
        self.dropout = dropout
        ih, iw = pair(image_size)
        if ih % patch_size or iw % patch_size:
            raise ValueError("image size must divide by patch size")
        n = (ih // patch_size) * (iw // patch_size)
        self.patch_embed = PatchEmbed(dim, patch_size, channels, out_dtype=dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n + 1, dim, device=device))

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(img)
        b, _, dim = x.shape
        x = torch.cat([self.cls.to(x.dtype).expand(b, 1, dim), x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        return dropout(x, self.dropout, generator) if train else x


class _CrossAttendBlock(nn.Module):
    """One round of cls <-> patch cross-attention: ``sm_attends_lg`` (the
    small stream's cls token, projected to the large width by
    ``sm_attends_lg_proj_in``, attends the large stream's patches and itself,
    and ``sm_attends_lg_proj_out`` brings it back) and ``lg_attends_sm``
    likewise; the projections exist only where the two widths differ. Each
    attention drops at ``dropout`` under ``train``."""

    def __init__(self, sm_dim: int, lg_dim: int, heads: int, dim_head: int, *,
                 dropout: float = 0.0, dtype: Optional[torch.dtype], device):
        super().__init__()
        for name, dim_in, dim_out in (("sm_attends_lg", sm_dim, lg_dim),
                                      ("lg_attends_sm", lg_dim, sm_dim)):
            self.add_module(name, Attention(dim_out, heads, dim_head, cross=True,
                                            norm_eps=1e-5, dropout=dropout, dtype=dtype,
                                            device=device))
            if dim_in != dim_out:
                self.add_module(f"{name}_proj_in", Dense(dim_in, dim_out, dtype=dtype,
                                                         device=device))
                self.add_module(f"{name}_proj_out", Dense(dim_out, dim_in, dtype=dtype,
                                                          device=device))

    def _attend(self, name, cls, patches, train, generator):
        proj = hasattr(self, f"{name}_proj_in")
        q = getattr(self, f"{name}_proj_in")(cls) if proj else cls
        out = getattr(self, name)(q, patches, kv_include_self=True, train=train,
                                  generator=generator)
        if proj:
            out = getattr(self, f"{name}_proj_out")(out)
        return cls + out

    def forward(self, sm: torch.Tensor, lg: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        sm_cls = self._attend("sm_attends_lg", sm[:, :1], lg[:, 1:], train, generator)
        lg_cls = self._attend("lg_attends_sm", lg[:, :1], sm[:, 1:], train, generator)
        return torch.cat([sm_cls, sm[:, 1:]], dim=1), torch.cat([lg_cls, lg[:, 1:]], dim=1)


class CrossViT(nn.Module):
    """``[B, H, W, C]`` images -> ``[B, num_classes]`` fp32 logits.
    ``vit_tpu``'s names: ``sm_embedder``, ``lg_embedder``, ``sm_enc_{i}``,
    ``lg_enc_{i}`` (each with ``final_norm``), ``cross_{i}_{j}``,
    ``sm_head_norm``, ``lg_head_norm``, ``sm_head``, ``lg_head``.
    ``dropout`` and ``emb_dropout`` act only under ``forward(...,
    train=True)``."""

    def __init__(self, *, image_size: int, num_classes: int, sm_dim: int, lg_dim: int,
                 sm_patch_size: int = 12, sm_enc_depth: int = 1, sm_enc_heads: int = 8,
                 sm_enc_mlp_dim: int = 2048, sm_enc_dim_head: int = 64, lg_patch_size: int = 16,
                 lg_enc_depth: int = 4, lg_enc_heads: int = 8, lg_enc_mlp_dim: int = 2048,
                 lg_enc_dim_head: int = 64, cross_attn_depth: int = 2, cross_attn_heads: int = 8,
                 cross_attn_dim_head: int = 64, depth: int = 3, channels: int = 3,
                 dropout: float = 0.1, emb_dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.depth, self.cross_attn_depth = depth, cross_attn_depth
        self.sm_embedder = _ImageEmbedder(sm_dim, image_size, sm_patch_size, channels,
                                          dropout=emb_dropout, dtype=dtype, device=device)
        self.lg_embedder = _ImageEmbedder(lg_dim, image_size, lg_patch_size, channels,
                                          dropout=emb_dropout, dtype=dtype, device=device)
        self.jax_stages = {}
        for i in range(depth):
            for name, dim, enc_depth, heads, dim_head, mlp in (
                (f"sm_enc_{i}", sm_dim, sm_enc_depth, sm_enc_heads, sm_enc_dim_head,
                 sm_enc_mlp_dim),
                (f"lg_enc_{i}", lg_dim, lg_enc_depth, lg_enc_heads, lg_enc_dim_head,
                 lg_enc_mlp_dim),
            ):
                enc = Transformer(dim, enc_depth, heads, dim_head, mlp, final_norm=True,
                                  norm_eps=1e-5, dropout=dropout, dtype=dtype, device=device)
                self.add_module(name, enc)
                self.jax_stages.update({f"{name}/{k}": v for k, v in enc.jax_stages.items()})
            for j in range(cross_attn_depth):
                self.add_module(f"cross_{i}_{j}", _CrossAttendBlock(
                    sm_dim, lg_dim, cross_attn_heads, cross_attn_dim_head, dropout=dropout,
                    dtype=dtype, device=device))
        self.sm_head_norm = LayerNorm(sm_dim, eps=1e-5, use_bias=False, device=device)
        self.lg_head_norm = LayerNorm(lg_dim, eps=1e-5, use_bias=False, device=device)
        self.sm_head = Dense(sm_dim, num_classes, device=device)
        self.lg_head = Dense(lg_dim, num_classes, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        kw = dict(train=train, generator=generator)
        sm, lg = self.sm_embedder(img, **kw), self.lg_embedder(img, **kw)
        for i in range(self.depth):
            sm = getattr(self, f"sm_enc_{i}")(sm, remat=remat, **kw)
            lg = getattr(self, f"lg_enc_{i}")(lg, remat=remat, **kw)
            for j in range(self.cross_attn_depth):
                sm, lg = getattr(self, f"cross_{i}_{j}")(sm, lg, **kw)
        return (self.sm_head(self.sm_head_norm(sm[:, 0]))
                + self.lg_head(self.lg_head_norm(lg[:, 0])))
