"""Mixture-of-Experts feed-forward (port of ``vit_tpu/nn/moe.py``).

A pre-norm block of ``num_experts`` expert MLPs, each token routed to its
top ``num_selected`` experts, step for step as ``vit_tpu`` routes it:

- flax's LayerNorm in fp32 (its output stays fp32), the router (a flax
  ``Dense`` in fp32), ``jax.nn.softmax``'s max / exp / sum / divide;
- top-k as ``vit_tpu``'s unrolled argmax loop: ``torch.argmax`` takes the
  first maximum, as ``jnp.argmax`` does, and the chosen expert is zeroed
  before the next pick (``torch.topk`` orders ties, and a row whose
  remainder is all zero, otherwise); the gates renormalised over their sum
  plus 1e-9;
- each expert holds ``capacity`` slots a sample. Positions count the
  choices of each sample's tokens in token order, the k-th choices after all
  (k-1)-th choices of that expert in that sample (GShard's priority); a
  choice at or past the capacity is dropped, and a token whose choices are
  all dropped gets a zero delta.

``vit_tpu`` dispatches and combines through dense one-hot einsums over
``[B, S, E, C]``. The port moves rows by index instead, which is exact: a
slot holds at most one token, and each token's delta sums its kept ``gate *
out`` terms in fp32 in expert order, as the einsum's contraction adds them.
The expert products take operands in the compute dtype with fp32 sums and an
fp32 result (JAX's ``preferred_element_type``): on the card a bf16 batched
GEMM over the experts that returns fp32, issued under ``fp32_bf16_sums``;
elsewhere an fp32 product of the rounded operands. Plain PyTorch throughout:
``vit_tpu`` runs this block in XLA, outside every Pallas kernel.

Training (``forward(x, train=True, generator=...)``): the expert-hidden
dropout at rate ``dropout``, after the activation and before the cast to
the compute dtype (``vit_tpu/nn/moe.py:121-124``), its mask drawn over the
buffer as flax draws it over ``[E, B, C, F]``, empty capacity slots
included. Gradients reach the router through the gates (top-k, the
positions and the dispatch are integer bookkeeping), as in ``vit_tpu``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.nn.attention import dropout as apply_dropout
from vit_tpu_torch.nn.embed import Dense, fp32_bf16_sums
from vit_tpu_torch.ops.block_attention import _ln_f32, _softmax
from vit_tpu_torch.ops.fused_mlp import _activate


def expert_capacity(tokens: int, k: int, num_experts: int, capacity_factor: float) -> int:
    """Slots an expert holds a sample: ``ceil(k * tokens * cf / E)``, at least
    1 and at most ``tokens``, in ``vit_tpu``'s float arithmetic."""
    return min(tokens, max(1, -(-k * tokens * capacity_factor // num_experts).__int__()))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, S, E]`` router probabilities -> the chosen experts ``[B, S, k]``
    (int64, in the order picked) and their renormalised fp32 gates."""
    remaining, idx, gates = probs, [], []
    for _ in range(k):
        i = remaining.argmax(dim=-1, keepdim=True)
        gates.append(remaining.gather(-1, i))
        idx.append(i)
        remaining = remaining.scatter(-1, i, 0.0)
    denom = sum(gates) + 1e-9
    return torch.cat(idx, dim=-1), torch.cat([g / denom for g in gates], dim=-1)


def positions(idx: torch.Tensor, num_experts: int, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each choice's slot in its expert's buffer of the sample, ``[B, S, k]``
    int64, and whether it is kept (slot < ``capacity``). Choice j counts the
    sample's earlier tokens that chose the same expert as their j-th choice,
    after all choices of rank < j."""
    prior = idx.new_zeros(idx.shape[0], 1, num_experts)
    pos = []
    for j in range(idx.shape[-1]):
        onehot = nn.functional.one_hot(idx[..., j], num_experts)
        pos.append((onehot.cumsum(dim=1) - onehot + prior).gather(-1, idx[..., j:j + 1]))
        prior = prior + onehot.sum(dim=1, keepdim=True)
    pos = torch.cat(pos, dim=-1)
    return pos, pos < capacity


def _slots(idx, pos, capacity):
    """Flat row of each choice in the ``[E, B, C]`` buffers."""
    sample = torch.arange(idx.shape[0], device=idx.device).view(-1, 1, 1)
    return (idx * idx.shape[0] + sample) * capacity + pos


def dispatch(xn, idx, pos, keep, num_experts: int, capacity: int, dtype) -> torch.Tensor:
    """The experts' inputs ``[E, B * C, D]`` in ``dtype``: each kept choice
    writes its token's row into its slot, every other slot stays zero (the
    dropped choices go to a spare row that is cut off)."""
    b, s, d = xn.shape
    k = idx.shape[-1]
    spare = num_experts * b * capacity
    rows = torch.where(keep, _slots(idx, pos, capacity), spare).reshape(-1)
    buf = xn.new_zeros(spare + 1, d, dtype=dtype)
    buf.index_copy_(0, rows, xn.to(dtype).unsqueeze(2).expand(b, s, k, d).reshape(-1, d))
    return buf[:spare].view(num_experts, b * capacity, d)


def combine(out, idx, pos, keep, gates, capacity: int) -> torch.Tensor:
    """Each token's delta ``[B, S, D]`` in fp32: its kept choices' ``gate *
    out`` rows summed in expert order (a dropped choice adds nothing)."""
    b, s, k = idx.shape
    d = out.shape[-1]
    rows = torch.where(keep, _slots(idx, pos, capacity), 0).reshape(-1)
    terms = gates.unsqueeze(-1) * out.reshape(-1, d)[rows].view(b, s, k, d)
    terms = torch.where(keep.unsqueeze(-1), terms, 0.0)
    order = idx.argsort(dim=-1, stable=True)
    terms = terms.gather(2, order.unsqueeze(-1).expand(b, s, k, d))
    y = terms[:, :, 0]
    for j in range(1, k):
        y = y + terms[:, :, j]
    return y


def _bmm_f32(a, b):
    """``a @ b`` batched over the experts with fp32 sums and an fp32 result,
    operands already rounded to their dtype: on the card in bf16 one cuBLAS
    bf16 GEMM that writes fp32 (no bf16 rounding of the product), issued
    under ``fp32_bf16_sums``; else, and under grad (``bmm``'s ``out_dtype``
    form has no derivative), an fp32 product, which autograd differentiates
    in fp32 and casts back to each operand's dtype, as JAX transposes a dot
    with ``preferred_element_type=f32``."""
    if (a.is_cuda and ops._use_kernel(a) and a.dtype == b.dtype == torch.bfloat16
            and not ops.needs_grad(a, b)):
        with fp32_bf16_sums():
            return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class MoEFeedForward(nn.Module):
    """Pre-norm top-k routed expert MLP, ``[B, S, D] -> [B, S, D]``: returns
    the delta, in x's dtype (the caller adds the residual, so a dropped
    token passes through unchanged). Parameters keep ``vit_tpu``'s names and
    layouts, fp32: ``expert_w1 [E, D, F]``, ``expert_b1 [E, F]``,
    ``expert_w2 [E, F, D]``, ``expert_b2 [E, D]``, ``ln_scale``, ``ln_bias``
    ``[D]``, ``router`` (``kernel [D, E]``, ``bias [E]``). ``dtype`` (None:
    x's) is the expert products' operand dtype. ``dropout``: the rate of
    the expert-hidden dropout under ``forward(..., train=True)``."""

    def __init__(self, dim: int, hidden_dim: int, *, num_experts: int = 8,
                 num_selected: int = 2, capacity_factor: float = 1.25, dropout: float = 0.0,
                 activation: str = "gelu", ln_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        if num_selected > num_experts:
            raise ValueError(f"num_selected {num_selected} > num_experts {num_experts}")
        self.num_experts, self.num_selected = num_experts, num_selected
        self.capacity_factor, self.activation = capacity_factor, activation
        self.ln_eps, self.dtype, self.dropout = ln_eps, dtype, dropout
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        e = num_experts
        self.expert_w1 = p(e, dim, hidden_dim)
        self.expert_b1 = p(e, hidden_dim)
        self.expert_w2 = p(e, hidden_dim, dim)
        self.expert_b2 = p(e, dim)
        self.ln_scale = p(dim, fill=1.0)
        self.ln_bias = p(dim)
        self.router = Dense(dim, e, device=device)

    def route(self, x: torch.Tensor):
        """(fp32 LayerNorm output ``[B, S, D]``, router probabilities ``[B, S,
        E]``, chosen experts ``[B, S, k]``, gates ``[B, S, k]``)."""
        xn = _ln_f32(x.float(), self.ln_scale, self.ln_bias, self.ln_eps)
        probs = _softmax(self.router(xn))
        return (xn, probs, *top_k(probs, self.num_selected))

    def experts(self, h: torch.Tensor, drop=None) -> torch.Tensor:
        """``[E, M, D]`` expert inputs in the compute dtype -> ``[E, M, D]``
        fp32: ``x W1 + b1``, the activation in fp32, ``drop`` (training's
        dropout, None: none) on it, rounded to the dtype, ``. W2 + b2``."""
        dt = h.dtype
        h = _bmm_f32(h, self.expert_w1.to(dt)) + self.expert_b1.unsqueeze(1)
        h = _activate(h, self.activation)
        if drop is not None:
            h = drop(h)
        h = h.to(dt)
        return _bmm_f32(h, self.expert_w2.to(dt)) + self.expert_b2.unsqueeze(1)

    def aux_loss(self, probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Switch's load-balance loss ``E * sum_e f_e p_e``: f the share of
        tokens whose first choice is e, p the mean router probability."""
        e = self.num_experts
        frac = nn.functional.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
        return e * (frac * probs.mean(dim=(0, 1))).sum()

    def forward(self, x: torch.Tensor, return_aux: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        b, s, _ = x.shape
        e = self.num_experts
        capacity = expert_capacity(s, self.num_selected, e, self.capacity_factor)
        xn, probs, idx, gates = self.route(x)
        pos, keep = positions(idx, e, capacity)
        drop = None
        if train and self.dropout > 0.0:  # flax's mask over [E, B, C, F]
            drop = lambda h: apply_dropout(h.view(e, b, capacity, -1), self.dropout,
                                           generator).view_as(h)
        out = self.experts(dispatch(xn, idx, pos, keep, e, capacity, self.dtype or x.dtype), drop)
        y = combine(out, idx, pos, keep, gates, capacity).to(x.dtype)
        return (y, self.aux_loss(probs, idx)) if return_aux else y
