"""Twins-SVT — alternating local / global attention pyramid (port of
``vit_tpu/models/twins_svt.py:30-240``).

Per stage: ``PatchEmbedding`` -> ``depth`` layers -> ``PEG`` -> ``depth``
layers; a layer is [local attention, ConvMLP, global attention, ConvMLP],
stage 4 global only. Local attention (LSA) is a 7x7 window partition, one
``ops.window_attention_block`` (the window-attention kernel on the card)
and the inverse partition. Global attention (GSA) takes its keys and values
from a k x k conv of stride k and runs ``mha_tokens`` (the flash kernel on
the card). Every ConvMLP is ``ops.mlp``. The pooled features go through a
Dense head in the model dtype, so a bf16 model gives bf16 logits, as
``vit_tpu``'s does.

Parameters are zeros and ones at construction, on the card unless the
caller passes ``device="cpu"``; ``from_jax_params(tree, model.jax_stages)``
converts a ``vit_tpu`` variables tree (its conv kernels turned to OIHW), and
``utils.init_params`` draws them as ``vit_tpu``'s ``init`` does.

Training: ``forward(img, train=True, generator=...)`` applies ``dropout``
where ``vit_tpu`` does (each attention's output, ``drop``, and each
ConvMLP's ``drop1`` / ``drop2`` on its plain path), the masks drawn from
``generator``. ``remat`` does nothing: ``vit_tpu`` checkpoints only the
scanned ``Transformer`` blocks, and Twins has none. On the card the
backward runs through the Functions of kernels 6, 4 and 2
(``ops.WindowAttentionBlockFn``, ``ops.FlashAttentionFn``, ``ops.MlpFn``)
and the bf16 ``Dense`` products' ``MmRoundedFn``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.nn.attention import dropout, mha_tokens
from vit_tpu_torch.nn.conv import PEG, Conv, ConvMLP, PatchEmbedding
from vit_tpu_torch.nn.embed import Dense, LayerNorm


class _LocalAttention(nn.Module):
    """LN, fused qkv, per-window attention, out projection: one kernel call
    over the windows of the map. Raw parameters as ``vit_tpu``'s
    (``norm_scale``, ``norm_bias``, ``qkv_kernel``, ``out_kernel``,
    ``out_bias``), fp32, the GEMM weights cast to the model dtype per call."""

    def __init__(self, dim: int, heads: int, dim_head: int, patch_size: int, *,
                 dropout: float = 0.0, dtype: Optional[torch.dtype], device):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.scale, self.patch_size = heads, dim_head**-0.5, patch_size
        self.dtype, self.dropout = dtype, dropout
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        self.norm_scale = p(dim, fill=1.0)
        self.norm_bias = p(dim)
        self.qkv_kernel = p(dim, 3 * inner)
        self.out_kernel = p(inner, dim)
        self.out_bias = p(dim)

    def forward(self, fmap: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _, h, w, _ = fmap.shape
        dtype = self.dtype or fmap.dtype
        out = ops.window_attention_block(
            ops.window_partition(fmap, self.patch_size), self.norm_scale, self.norm_bias,
            self.qkv_kernel.to(dtype), self.out_kernel.to(dtype), self.out_bias, self.heads,
            scale=self.scale, ln_eps=1e-5,
        )
        out = ops.window_unpartition(out, self.patch_size, h, w)
        return dropout(out, self.dropout, generator) if train else out


class _GlobalAttention(nn.Module):
    """GSA: queries from every token, keys and values from a k x k conv of
    stride k (``to_kv``), flax modules in the model dtype."""

    def __init__(self, dim: int, heads: int, dim_head: int, k: int, *,
                 dropout: float = 0.0, dtype: Optional[torch.dtype], device):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.scale, self.dropout = heads, dim_head**-0.5, dropout
        self.norm = LayerNorm(dim, eps=1e-5, dtype=dtype, device=device)
        self.to_q = Dense(dim, inner, use_bias=False, dtype=dtype, device=device)
        self.to_kv = Conv(dim, 2 * inner, k, strides=k, use_bias=False, dtype=dtype, device=device)
        self.to_out = Dense(inner, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        x = self.norm(x)
        q = self.to_q(x)
        kv = self.to_kv(x)
        k, v = kv.reshape(b, -1, kv.shape[-1]).chunk(2, dim=-1)
        out = mha_tokens(q.reshape(b, h * w, -1), k, v, self.heads, scale=self.scale)
        out = self.to_out(out.reshape(b, h, w, -1))
        return dropout(out, self.dropout, generator) if train else out


def _rename_prefix(state_dict, old: str, new: str) -> None:
    """Rename the keys of ``state_dict`` that start with ``old`` to start
    with ``new``, in place, keeping the order of the keys."""
    keys = list(state_dict)
    first = next((i for i, k in enumerate(keys) if k.startswith(old)), len(keys))
    for k in keys[first:]:
        v = state_dict.pop(k)
        state_dict[new + k[len(old):] if k.startswith(old) else k] = v


def _global_name_out(module, state_dict, prefix, local_metadata) -> None:
    _rename_prefix(state_dict, prefix + "global_.", prefix + "global.")


def _global_name_in(module, state_dict, prefix, *args) -> None:
    _rename_prefix(state_dict, prefix + "global.", prefix + "global_.")


class _TwinsLayer(nn.Module):
    """One [local, ff1, global, ff2] layer (global-only without
    ``has_local``), each a pre-norm residual branch.

    "global" is a Python keyword, so the global attention is the attribute
    ``global_``: ``torch.export`` writes each parameter's path as Python
    code. The state dict keeps ``vit_tpu``'s name, ``global``: a hook renames
    the keys on the way out of ``state_dict`` and another on the way into
    ``load_state_dict``."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_mult: int,
                 local_patch_size: int, global_k: int, has_local: bool, *,
                 dropout: float = 0.0, dtype: Optional[torch.dtype], device):
        super().__init__()
        kw = dict(dropout=dropout, dtype=dtype, device=device)
        self.local = self.ff1 = None
        if has_local:
            self.local = _LocalAttention(dim, heads, dim_head, local_patch_size, **kw)
            self.ff1 = ConvMLP(dim, mlp_mult, **kw)
        self.global_ = _GlobalAttention(dim, heads, dim_head, global_k, **kw)
        self.ff2 = ConvMLP(dim, mlp_mult, **kw)
        self.register_state_dict_post_hook(_global_name_out)
        self.register_load_state_dict_pre_hook(_global_name_in)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.local is not None:
            x = x + self.local(x, train, generator)
            x = x + self.ff1(x, train, generator)
        x = x + self.global_(x, train, generator)
        return x + self.ff2(x, train, generator)


class _TwinsBlock(nn.Module):
    """``depth`` layers in a loop; ``layers.{i}`` holds layer i of
    ``vit_tpu``'s ``<block>/layers`` (scanned when depth > 1)."""

    def __init__(self, depth: int, **layer):
        super().__init__()
        self.layers = nn.ModuleList(_TwinsLayer(**layer) for _ in range(depth))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, train, generator)
        return x


class TwinsSVT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` logits in the model
    dtype (None: fp32). Stage s has ``s{s}_emb_dim``, ``s{s}_patch_size``,
    ``s{s}_local_patch_size``, ``s{s}_global_k`` and ``s{s}_depth``; 8 heads
    of 64 and an MLP of 4x in every stage, as ``vit_tpu``'s. ``dropout``:
    ``vit_tpu``'s rate, used only by ``forward(..., train=True)``."""

    def __init__(self, *, num_classes: int,
                 s1_emb_dim: int = 64, s1_patch_size: int = 4, s1_local_patch_size: int = 7,
                 s1_global_k: int = 7, s1_depth: int = 1,
                 s2_emb_dim: int = 128, s2_patch_size: int = 2, s2_local_patch_size: int = 7,
                 s2_global_k: int = 7, s2_depth: int = 1,
                 s3_emb_dim: int = 256, s3_patch_size: int = 2, s3_local_patch_size: int = 7,
                 s3_global_k: int = 7, s3_depth: int = 5,
                 s4_emb_dim: int = 512, s4_patch_size: int = 2, s4_local_patch_size: int = 7,
                 s4_global_k: int = 7, s4_depth: int = 4,
                 peg_kernel_size: int = 3, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        stages = (
            (s1_emb_dim, s1_patch_size, s1_local_patch_size, s1_global_k, s1_depth),
            (s2_emb_dim, s2_patch_size, s2_local_patch_size, s2_global_k, s2_depth),
            (s3_emb_dim, s3_patch_size, s3_local_patch_size, s3_global_k, s3_depth),
            (s4_emb_dim, s4_patch_size, s4_local_patch_size, s4_global_k, s4_depth),
        )
        self.jax_stages = {}
        dim_in = 3
        for s, (dim, patch_size, local_patch_size, global_k, depth) in enumerate(stages, start=1):
            layer = dict(dim=dim, heads=8, dim_head=64, mlp_mult=4,
                         local_patch_size=local_patch_size, global_k=global_k, has_local=s < 4,
                         dropout=dropout, dtype=dtype, device=device)
            setattr(self, f"embed_{s}", PatchEmbedding(dim_in, dim, patch_size, dtype=dtype,
                                                       device=device))
            setattr(self, f"block_a_{s}", _TwinsBlock(depth, **layer))
            setattr(self, f"peg_{s}", PEG(dim, peg_kernel_size, dtype=dtype, device=device))
            setattr(self, f"block_b_{s}", _TwinsBlock(depth, **layer))
            self.jax_stages.update({f"block_a_{s}/layers": depth, f"block_b_{s}/layers": depth})
            dim_in = dim
        self.head = Dense(dim_in, num_classes, dtype=dtype, device=device)

    def forward(self, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        x = img
        for s in range(1, 5):
            x = getattr(self, f"embed_{s}")(x)
            x = getattr(self, f"block_a_{s}")(x, train, generator)
            x = getattr(self, f"peg_{s}")(x)
            x = getattr(self, f"block_b_{s}")(x, train, generator)
        # jnp.mean over bf16 sums in fp32 and returns bf16
        return self.head(x.float().mean(dim=(1, 2)).to(x.dtype))
