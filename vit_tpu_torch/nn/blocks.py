"""Feed-forward block and encoder stack (port of ``vit_tpu/nn/blocks.py``:
the plain stack, DeepViT's re-attention stack, ParallelViT's parallel
branches, LSA's stack and the optional final LayerNorm).

The depth is a Python loop over a ``ModuleList``: no ``nn.scan`` analogue,
no sample packing and no Mosaic row padding, so the stream runs at its real
token count (197 at ViT-L/16 @224). ``vit_tpu`` scans only stacks deeper
than 1; its one unscanned layer takes the unfused attention branch and adds
each delta to the stream in the stream's dtype, and so does the port's
stack of depth 1.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.nn.attention import Attention
from vit_tpu_torch.nn.embed import LayerNorm


class FeedForward(nn.Module):
    """Pre-norm MLP ``LN -> Dense -> activation -> Dense`` as one
    ``ops.mlp`` call. Parameters keep ``vit_tpu``'s names and layout
    (``w1 [D, F]``, ``w2 [F, dim_out]``, ``dim_out`` None: D); the residual
    add stays with the caller, as in the JAX module. ``pre_norm=False`` has
    no LayerNorm and no ``ln_*`` parameters (LeViT's MLP): the kernel runs
    without its LayerNorm prologue. The kernel takes ``dim_out == D`` only,
    as ``vit_tpu``'s Pallas kernel does; another ``dim_out`` runs on the
    plain twin and raises on the card."""

    def __init__(self, dim: int, hidden_dim: int, *, activation: str = "gelu",
                 ln_eps: float = 1e-6, pre_norm: bool = True, dim_out: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        dim_out = dim_out or dim
        self.activation, self.ln_eps, self.dtype = activation, ln_eps, dtype
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        self.w1 = p(dim, hidden_dim)
        self.b1 = p(hidden_dim)
        self.w2 = p(hidden_dim, dim_out)
        self.b2 = p(dim_out)
        self.ln_scale = p(dim, fill=1.0) if pre_norm else None
        self.ln_bias = p(dim) if pre_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        return ops.mlp(
            x, self.w1.to(dtype), self.b1, self.w2.to(dtype), self.b2,
            self.ln_scale, self.ln_bias,
            activation=self.activation, residual=False, ln_eps=self.ln_eps,
        )


class EncoderBlock(nn.Module):
    """One pre-norm residual block: attention (with ``fuse_residual``, the
    residual inside the kernel; DeepViT's re-attention with
    ``reattention``; LSA with ``mask_self`` / ``learned_temperature``, never
    fused; without ``fuse_residual``, ``x + attn(x)``) then ``x +
    FeedForward(x)``, each sum in JAX's promotion of the two dtypes."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, *,
                 reattention: bool = False, mask_self: bool = False,
                 learned_temperature: bool = False, fuse_residual: bool = True,
                 activation: str = "gelu", norm_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.fuse_residual = fuse_residual
        self.attn = Attention(dim, heads, dim_head, reattention=reattention, mask_self=mask_self,
                              learned_temperature=learned_temperature,
                              fuse_residual=fuse_residual, norm_eps=norm_eps, dtype=dtype,
                              device=device)
        self.ff = FeedForward(dim, mlp_dim, activation=activation, ln_eps=norm_eps,
                              dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(x) if self.fuse_residual else x + self.attn(x)
        return x + self.ff(x)


class Transformer(nn.Module):
    """Plain pre-norm encoder: ``depth`` ``EncoderBlock``s in a loop.
    ``blocks.{i}`` holds layer i of ``vit_tpu``'s stacked ``encoder/blocks``
    (at depth 1, its unscanned ``attn_0`` / ``ff_0``). At depth 1 the layer
    is unfused, as ``vit_tpu``'s unscanned layer (blocks.py:350-357,
    :402-416): ``x + attn(x)``, then ``x + ff(x)``. Re-attention at depth 1
    (``vit_tpu``'s materializing path without the residual) builds and
    loads, and raises when called.

    With ``parallel_branches`` N > 1 (ParallelViT; blocks.py:430-460) the
    stack is never scanned or fused, at any depth: layer i adds to x the sum
    of N unfused attention branches ``attn_{i}_{b}`` of x (each
    ``ops.qkv_attention``), then the sum of N feed-forward branches
    ``ff_{i}_{b}``. The branches are summed in JAX's order, ``(0 + a0) +
    a1``, in the stream's dtype, and x is added after the sum.

    ``mask_self`` and ``learned_temperature`` (LSA) reach every layer's
    attention, which then takes the unfused branch at every depth
    (blocks.py:396-397 pass both to the scanned and unscanned layers).

    With ``final_norm`` a flax LayerNorm (eps ``norm_eps``, output in
    ``dtype``; None: fp32) named ``final_norm`` follows the stack, outside
    ``blocks`` (blocks.py:396-397, :460-461).

    ``jax_stages`` maps the stacked prefix under this module's name to the
    depth (``{"blocks": depth}``; none with parallel branches), for a model's
    own ``jax_stages``."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, *,
                 reattention: bool = False, mask_self: bool = False,
                 learned_temperature: bool = False, activation: str = "gelu",
                 norm_eps: float = 1e-6, parallel_branches: int = 1, final_norm: bool = False,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.depth, self.branches = depth, parallel_branches
        self.unported = depth == 1 and reattention
        self.final_norm = (LayerNorm(dim, eps=norm_eps, dtype=dtype, device=device)
                           if final_norm else None)
        if parallel_branches > 1:
            self.jax_stages = {}
            for i in range(depth):
                for b in range(parallel_branches):
                    self.add_module(f"attn_{i}_{b}", Attention(
                        dim, heads, dim_head, reattention=reattention, mask_self=mask_self,
                        learned_temperature=learned_temperature, norm_eps=norm_eps,
                        dtype=dtype, device=device))
                for b in range(parallel_branches):
                    # vit_tpu builds the FF branches without ln_eps and activation
                    # (blocks.py:453-457): LayerNorm eps 1e-6 and the tanh GELU,
                    # whatever norm_eps and activation the stack was given.
                    self.add_module(f"ff_{i}_{b}", FeedForward(dim, mlp_dim, dtype=dtype,
                                                               device=device))
            return
        self.jax_stages = {"blocks": depth}
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, heads, dim_head, mlp_dim, reattention=reattention,
                         mask_self=mask_self, learned_temperature=learned_temperature,
                         fuse_residual=depth > 1 or reattention, activation=activation,
                         norm_eps=norm_eps, dtype=dtype, device=device)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.unported:
            raise NotImplementedError(
                "re-attention in a stack of depth 1 (vit_tpu's materializing path without the "
                "residual) is not ported yet (ROADMAP.md Queue 1 item 5, attention variants)")
        if self.branches > 1:
            for i in range(self.depth):
                for kind in ("attn", "ff"):
                    x = x + sum(getattr(self, f"{kind}_{i}_{b}")(x) for b in range(self.branches))
        else:
            for block in self.blocks:
                x = block(x)
        return x if self.final_norm is None else self.final_norm(x)
