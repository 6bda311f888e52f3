"""Feed-forward block and encoder stack (port of ``vit_tpu/nn/blocks.py``:
the plain stack, DeepViT's re-attention stack, ParallelViT's parallel
branches, LSA's stack and the optional final LayerNorm).

The depth is a Python loop over a ``ModuleList``: no ``nn.scan`` analogue,
no sample packing and no Mosaic row padding, so the stream runs at its real
token count (197 at ViT-L/16 @224). ``vit_tpu`` scans only stacks deeper
than 1; its one unscanned layer takes the unfused attention branch and adds
each delta to the stream in the stream's dtype, and so does the port's
stack of depth 1.

Training: ``forward(x, train=True, generator=...)`` takes ``vit_tpu``'s
dropout routes where ``dropout`` is above 0 (the MLP on its plain path,
``FeedForward``; attention materialized, ``nn.Attention``), and the
inference routes where it is 0. ``Transformer.forward(..., remat=True)``
checkpoints each ``EncoderBlock`` of a stack deeper than 1
(``torch.utils.checkpoint``, non-reentrant), as ``vit_tpu`` wraps each
block of a scanned stack in ``nn.remat`` (blocks.py:365-370) and scans only
stacks deeper than 1: the backward runs the block's forward again. Each
block draws its dropout masks from a generator of its own, seeded from the
caller's once a step, so the recompute draws the same masks. A stack with
parallel branches is never scanned in ``vit_tpu``, so nothing there is
checkpointed: ``remat`` changes nothing on it, as on a stack of depth 1.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vit_tpu_torch import ops
from vit_tpu_torch.nn.attention import Attention, dropout
from vit_tpu_torch.nn.embed import LayerNorm
from vit_tpu_torch.ops.block_attention import _ln_f32, _mm
from vit_tpu_torch.ops.fused_mlp import _activate


class FeedForward(nn.Module):
    """Pre-norm MLP ``LN -> Dense -> activation -> Dense`` as one
    ``ops.mlp`` call. Parameters keep ``vit_tpu``'s names and layout
    (``w1 [D, F]``, ``w2 [F, dim_out]``, ``dim_out`` None: D); the residual
    add stays with the caller, as in the JAX module. ``pre_norm=False`` has
    no LayerNorm and no ``ln_*`` parameters (LeViT's MLP): the kernel runs
    without its LayerNorm prologue. The kernel takes ``dim_out == D`` only,
    as ``vit_tpu``'s Pallas kernel does; another ``dim_out`` runs on the
    plain twin and raises on the card.

    With ``forward(x, train=True)`` and ``dropout`` above 0, the plain path
    of ``vit_tpu`` (blocks.py:78-91) instead: fp32 LayerNorm, fp32 products
    of operands rounded to ``dtype`` plus the fp32 biases, dropout after the
    activation (``drop1``) and after the second product (``drop2``), then
    one rounding to x's dtype."""

    def __init__(self, dim: int, hidden_dim: int, *, activation: str = "gelu",
                 ln_eps: float = 1e-6, pre_norm: bool = True, dim_out: Optional[int] = None,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        dim_out = dim_out or dim
        self.activation, self.ln_eps, self.dtype = activation, ln_eps, dtype
        self.dropout = dropout
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        self.w1 = p(dim, hidden_dim)
        self.b1 = p(hidden_dim)
        self.w2 = p(hidden_dim, dim_out)
        self.b2 = p(dim_out)
        self.ln_scale = p(dim, fill=1.0) if pre_norm else None
        self.ln_bias = p(dim) if pre_norm else None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        if train and self.dropout > 0.0:
            return self._dropout_path(x, dtype, generator)
        return ops.mlp(
            x, self.w1.to(dtype), self.b1, self.w2.to(dtype), self.b2,
            self.ln_scale, self.ln_bias,
            activation=self.activation, residual=False, ln_eps=self.ln_eps,
        )

    def _dropout_path(self, x, dtype, generator):
        h = x.float()
        if self.ln_scale is not None:
            h = _ln_f32(h, self.ln_scale, self.ln_bias, self.ln_eps)
        h = _mm(h.to(dtype), self.w1.to(dtype)) + self.b1
        h = dropout(_activate(h, self.activation), self.dropout, generator)
        h = _mm(h.to(dtype), self.w2.to(dtype)) + self.b2
        return dropout(h, self.dropout, generator).to(x.dtype)


class EncoderBlock(nn.Module):
    """One pre-norm residual block: attention (with ``fuse_residual``, the
    residual inside the kernel; DeepViT's re-attention with
    ``reattention``; LSA with ``mask_self`` / ``learned_temperature``, never
    fused; with ``qkv_bias``, the flax branch, never fused; without
    ``fuse_residual``, ``x + attn(x)``) then ``x + FeedForward(x)``, each
    sum in JAX's promotion of the two dtypes."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, *,
                 reattention: bool = False, mask_self: bool = False,
                 learned_temperature: bool = False, qkv_bias: bool = False,
                 fuse_residual: bool = True, activation: str = "gelu", norm_eps: float = 1e-6,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.fuse_residual = fuse_residual
        self.attn = Attention(dim, heads, dim_head, reattention=reattention, mask_self=mask_self,
                              learned_temperature=learned_temperature, qkv_bias=qkv_bias,
                              fuse_residual=fuse_residual, norm_eps=norm_eps, dropout=dropout,
                              dtype=dtype, device=device)
        self.ff = FeedForward(dim, mlp_dim, activation=activation, ln_eps=norm_eps,
                              dropout=dropout, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.attn(x, train=train, generator=generator)
        x = a if self.fuse_residual else x + a
        return x + self.ff(x, train=train, generator=generator)


class Transformer(nn.Module):
    """Plain pre-norm encoder: ``depth`` ``EncoderBlock``s in a loop.
    ``blocks.{i}`` holds layer i of ``vit_tpu``'s stacked ``encoder/blocks``
    (at depth 1, its unscanned ``attn_0`` / ``ff_0``). At depth 1 the layer
    is unfused, as ``vit_tpu``'s unscanned layer (blocks.py:350-357,
    :402-416): ``x + attn(x)``, then ``x + ff(x)``; with re-attention that
    is ``vit_tpu``'s materializing path without the residual (the mix and
    the LayerNorm across the heads on the materialized scores).

    With ``parallel_branches`` N > 1 (ParallelViT; blocks.py:430-460) the
    stack is never scanned or fused, at any depth: layer i adds to x the sum
    of N unfused attention branches ``attn_{i}_{b}`` of x (each
    ``ops.qkv_attention``), then the sum of N feed-forward branches
    ``ff_{i}_{b}``. The branches are summed in JAX's order, ``(0 + a0) +
    a1``, in the stream's dtype, and x is added after the sum. Under
    ``train`` with ``dropout`` above 0 each branch drops as ``vit_tpu``'s
    (blocks.py:431-456): each attention branch materialized with
    ``attn_drop`` and ``out_drop``, each feed-forward branch on its plain
    path with ``drop1`` and ``drop2``, the masks drawn branch after branch
    in that order.

    ``mask_self`` and ``learned_temperature`` (LSA) reach every layer's
    attention, which then takes the unfused branch at every depth
    (blocks.py:396-397 pass both to the scanned and unscanned layers).

    ``qkv_bias`` (with the erf GELU, ``activation="gelu_exact"``, and the
    checkpoint's ``norm_eps``: Hugging Face and timm ViTs) gives every
    layer's attention a qkv bias: the flax branch (``nn.Attention``), never a
    block kernel (blocks.py:241-246). ``vit_tpu`` does not pad such a stack
    (blocks.py:312), and the port pads no stack.

    With ``final_norm`` a flax LayerNorm (eps ``norm_eps``, output in
    ``dtype``; None: fp32) named ``final_norm`` follows the stack, outside
    ``blocks`` (blocks.py:396-397, :460-461).

    ``jax_stages`` maps the stacked prefix under this module's name to the
    depth (``{"blocks": depth}``; none with parallel branches), for a model's
    own ``jax_stages``.

    ``dropout`` reaches every layer's attention and MLP (every branch's);
    ``forward(x, train=, generator=, remat=)`` as the module docstring
    says."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, *,
                 reattention: bool = False, mask_self: bool = False,
                 learned_temperature: bool = False, qkv_bias: bool = False,
                 activation: str = "gelu", norm_eps: float = 1e-6, parallel_branches: int = 1,
                 final_norm: bool = False, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        self.depth, self.branches, self.dropout = depth, parallel_branches, dropout
        self.final_norm = (LayerNorm(dim, eps=norm_eps, dtype=dtype, device=device)
                           if final_norm else None)
        if parallel_branches > 1:
            self.jax_stages = {}
            for i in range(depth):
                for b in range(parallel_branches):
                    self.add_module(f"attn_{i}_{b}", Attention(
                        dim, heads, dim_head, reattention=reattention, mask_self=mask_self,
                        learned_temperature=learned_temperature, qkv_bias=qkv_bias,
                        norm_eps=norm_eps, dropout=dropout, dtype=dtype, device=device))
                for b in range(parallel_branches):
                    # vit_tpu builds the FF branches without ln_eps and activation
                    # (blocks.py:453-457): LayerNorm eps 1e-6 and the tanh GELU,
                    # whatever norm_eps and activation the stack was given.
                    self.add_module(f"ff_{i}_{b}", FeedForward(dim, mlp_dim, dropout=dropout,
                                                               dtype=dtype, device=device))
            return
        self.jax_stages = {"blocks": depth}
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, heads, dim_head, mlp_dim, reattention=reattention,
                         mask_self=mask_self, learned_temperature=learned_temperature,
                         qkv_bias=qkv_bias, fuse_residual=depth > 1,
                         activation=activation,
                         norm_eps=norm_eps, dropout=dropout, dtype=dtype, device=device)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False
                ) -> torch.Tensor:
        if self.branches > 1:
            for i in range(self.depth):
                for kind in ("attn", "ff"):
                    branches = (getattr(self, f"{kind}_{i}_{b}") for b in range(self.branches))
                    x = x + sum(f(x, train=train, generator=generator) for f in branches)
        else:
            remat = remat and torch.is_grad_enabled() and self.depth > 1
            for block in self.blocks:
                seed = _draw_seed(generator) if train and self.dropout else None
                if remat:
                    x = checkpoint(_run_block, block, x, train, seed, use_reentrant=False)
                else:
                    x = _run_block(block, x, train, seed)
        return x if self.final_norm is None else self.final_norm(x)


def _draw_seed(generator: Optional[torch.Generator]) -> int:
    """One draw from ``generator`` (None: PyTorch's default CPU one): the
    seed of a block's own dropout generator."""
    device = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, 2**62, (1,), generator=generator, device=device))


def _run_block(block, x, train, seed):
    """A block with its dropout masks drawn from a generator of its own,
    made from ``seed``. ``torch.utils.checkpoint`` restores PyTorch's default
    generators for its recompute but not a caller's; a fresh generator from
    the same seed gives the recompute the forward's masks."""
    gen = None if seed is None else torch.Generator(x.device).manual_seed(seed)
    return block(x, train, gen)
