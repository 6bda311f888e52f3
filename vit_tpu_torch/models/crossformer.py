"""CrossFormer — cross-scale embedding and long / short distance attention
(port of ``vit_tpu/models/crossformer.py``).

Four stages of ``CrossEmbedLayer`` -> ``depth`` x [SDA, ConvMLP, LDA,
ConvMLP]. SDA partitions the map into contiguous windows
(``ops.window_partition``), LDA into dilated ones (``ops.dilated_partition``);
each runs one ``ops.window_attention_block`` (the window-attention kernel on
the card) with the fp32 bias of its ``DynamicPositionBias`` and 32-wide
heads, then the inverse partition. Every ConvMLP is ``ops.mlp``. The pooled
features go through a Dense head in the model dtype, so a bf16 model gives
bf16 logits, as ``vit_tpu``'s does.

``reference_quirks=True`` takes the reference's DPB (one scalar per offset,
the misindexed gather) as ``vit_tpu`` reproduces it.

Training (``forward(img, train=True, generator=..., remat=...)``): each
attention's ``drop`` at ``attn_dropout`` after the inverse partition, so
its kernel runs at every rate (on the card ``ops.WindowAttentionBlockFn``,
whose ``dbias`` flows back through autograd into the attention's
``DynamicPositionBias`` MLP: the bias is computed anew each call, never
cached); each ConvMLP's ``drop1`` and ``drop2`` at ``ff_dropout`` on its
plain path above 0 (``ops.MlpFn`` at 0). Masks are drawn block after block,
SDA, mlp1, LDA, mlp2, as ``vit_tpu``'s ``nn.scan`` over a stage draws them.
``vit_tpu`` does not remat a stage's scan, so ``remat`` checkpoints
nothing.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree (a stage deeper than 1 is scanned
there, its leaves stacked; its conv kernels turned to OIHW).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.core.utils import cast_tuple
from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.bias import DynamicPositionBias
from vit_tpu_torch.nn.conv import ConvMLP, CrossEmbedLayer
from vit_tpu_torch.nn.embed import Dense

DIM_HEAD = 32  # every attention's head width, as vit_tpu's


class _LSDAttention(nn.Module):
    """Short- (``sda``) or long-distance (``lda``) windowed attention: LN,
    fused qkv, per-window attention with the DPB bias, out projection, one
    kernel call over the windows of the map. Raw parameters as
    ``vit_tpu``'s (``norm_scale``, ``norm_bias``, ``qkv_kernel``,
    ``out_kernel``, ``out_bias``), fp32, the GEMM weights cast to the model
    dtype per call; heads of DIM_HEAD. ``drop`` at rate ``dropout`` after
    the inverse partition under ``train``."""

    def __init__(self, dim: int, attn_type: str, window_size: int, *,
                 reference_quirks: bool = False, dropout: float = 0.0,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        if attn_type not in ("short", "long"):
            raise ValueError(f"attn_type must be 'short' or 'long', got {attn_type!r}")
        self.heads = dim // DIM_HEAD
        inner = self.heads * DIM_HEAD
        self.long, self.window_size, self.scale = attn_type == "long", window_size, DIM_HEAD**-0.5
        self.dtype, self.dropout = dtype, dropout
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        self.norm_scale = p(dim, fill=1.0)
        self.norm_bias = p(dim)
        self.qkv_kernel = p(dim, 3 * inner)
        self.out_kernel = p(inner, dim)
        self.out_bias = p(dim)
        self.dpb = DynamicPositionBias(dim // 4, self.heads, reference_quirks=reference_quirks,
                                       device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        wsz, dtype = self.window_size, self.dtype or x.dtype
        bias = self.dpb(wsz)  # [1, 1|H, S, S] fp32
        if self.long:
            part, unpart = ops.dilated_partition, ops.dilated_unpartition
        else:
            part, unpart = ops.window_partition, ops.window_unpartition
        out = ops.window_attention_block(
            part(x, wsz), self.norm_scale, self.norm_bias, self.qkv_kernel.to(dtype),
            self.out_kernel.to(dtype), self.out_bias, self.heads, bias,
            scale=self.scale, ln_eps=1e-5,
        )
        out = unpart(out, wsz, h, w)
        return apply_dropout(out, self.dropout, generator) if train else out


class _CrossFormerBlock(nn.Module):
    """One [SDA, MLP, LDA, MLP] block, each a residual branch, drawing its
    masks in that order under ``train``."""

    def __init__(self, dim: int, local_window_size: int, global_window_size: int, *,
                 reference_quirks: bool, attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        kw = dict(reference_quirks=reference_quirks, dropout=attn_dropout, dtype=dtype,
                  device=device)
        ff = dict(dropout=ff_dropout, dtype=dtype, device=device)
        self.sda = _LSDAttention(dim, "short", local_window_size, **kw)
        self.mlp1 = ConvMLP(dim, **ff)
        self.lda = _LSDAttention(dim, "long", global_window_size, **kw)
        self.mlp2 = ConvMLP(dim, **ff)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for branch in (self.sda, self.mlp1, self.lda, self.mlp2):
            x = x + branch(x, train, generator)
        return x


class CrossFormer(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` logits in the model
    dtype (None: fp32). ``stage_{s}`` holds the stage's blocks
    (``stage_{s}.{i}``: block i of ``vit_tpu``'s ``stage_{s}``, scanned when
    deeper than 1), ``embed_{s}`` its cross-scale embedding.
    ``attn_dropout`` and ``ff_dropout`` act only under ``forward(...,
    train=True)``."""

    def __init__(self, *, dim=(64, 128, 256, 512), depth=(2, 2, 8, 2),
                 global_window_size=(8, 4, 2, 1), local_window_size=7,
                 cross_embed_kernel_sizes=((4, 8, 16, 32), (2, 4), (2, 4), (2, 4)),
                 cross_embed_strides=(4, 2, 2, 2), num_classes: int = 1000,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 reference_quirks: bool = False, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        n_stages = len(dim)
        local_wsz = cast_tuple(local_window_size, n_stages)
        global_wsz = cast_tuple(global_window_size, n_stages)
        self.n_stages, self.jax_stages = n_stages, {}
        dim_in = 3
        for s in range(n_stages):
            setattr(self, f"embed_{s}", CrossEmbedLayer(
                dim_in, dim[s], cross_embed_kernel_sizes[s], cross_embed_strides[s], dtype=dtype,
                device=device))
            setattr(self, f"stage_{s}", nn.ModuleList(
                _CrossFormerBlock(dim[s], local_wsz[s], global_wsz[s],
                                  reference_quirks=reference_quirks, attn_dropout=attn_dropout,
                                  ff_dropout=ff_dropout, dtype=dtype, device=device)
                for _ in range(depth[s])))
            self.jax_stages[f"stage_{s}"] = depth[s]
            dim_in = dim[s]
        self.head = Dense(dim_in, num_classes, dtype=dtype, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        x = img
        for s in range(self.n_stages):
            x = getattr(self, f"embed_{s}")(x)
            for block in getattr(self, f"stage_{s}"):
                x = block(x, train, generator)
        # jnp.mean over bf16 sums in fp32 and returns bf16
        return self.head(x.float().mean(dim=(1, 2)).to(x.dtype))
