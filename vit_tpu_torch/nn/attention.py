"""Attention module (port of ``vit_tpu/nn/attention.py:Attention``, :148-504).

Both of the JAX module's branches are ported, with its parameter names; the
branch is fixed at construction (``raw``: pre-norm self-attention without a
qkv bias; else the flax branch, self-attention or, with ``cross``,
cross-attention), because a PyTorch module owns its parameters before its
first call:

- **self-attention with raw parameters** (:196-354): pre-norm, a fused qkv
  projection without bias. With an output projection the block is one
  kernel call: ``ops.talking_heads_block`` (CaiT; the residual inside only
  with ``fuse_residual``), or, with ``fuse_residual``,
  ``ops.reattention_block`` (DeepViT) or ``ops.attention_block`` (ViT).
  On the CPU each runs its plain twin, in the kernel's op order. A layer
  fuses only inside ``vit_tpu``'s two terms (:213-221; n <= 1024 tokens,
  dim x inner x 3 bf16 weights <= 8 MiB: ``Attention.fuses``), and neither
  with both head mixes (talking heads with re-attention), nor with LSA, a
  bias or dropout, nor without the output projection (``project_out``
  False, or None with ``heads == 1`` and ``dim_head == dim``: T2T's
  tokenizer), nor, for re-attention and the plain block, without
  ``fuse_residual`` (a stack of depth 1, which ``vit_tpu`` does not scan).
  Such a layer takes the unfused branch (:307-354): the LayerNorm and the
  qkv product outside any kernel, ``ops.qkv_attention`` or, with a head mix,
  LSA or dropout, the materializing path (the pre-softmax mix, the softmax,
  the post-softmax mix, then the re-attention mix and the LayerNorm across
  the heads, :471-504), the optional output projection rounded to the
  residual's dtype, and the delta returned (the residual added only with
  ``fuse_residual``). On the card a bf16 output projection runs on the
  wgmma GEMM of kernels 1 and 2 (``ops.block_attention.gemm_sm90``; in an
  exported program the operator ``vit_tpu_torch::gemm_sm90``), its fp32
  bias in the epilogue, wherever the width and the inner width are
  multiples of 8 (every preset's); elsewhere, in fp32, on the CPU (its twin
  ``reference_gemm``), under grad and under ``ops.force_backend("torch")``,
  an fp32 product of the rounded operands.
- **an additive bias** on that branch (``forward(x, bias=...)``, fp32
  ``[1|B, 1|H, N, N]``: RegionViT's relative positions): a bias keeps the
  layer off every block kernel, as ``vit_tpu``'s ``bias is None`` term does
  (:213-221); ``ops.qkv_attention`` or the materializing path adds it to
  the scaled scores.
- **LSA** (Locality Self-Attention, :178-194, :471-481): ``mask_self`` sets
  the score diagonal to ``flash_attention.MASK_VALUE``,
  ``learned_temperature`` scales the scores by ``exp(log_temperature)``
  (an fp32 scalar, ``log(dim_head**-0.5)`` at init). On the raw branch
  either flag takes the materializing path at every depth, as
  ``vit_tpu``'s fusion gates exclude both: no LSA layer reaches a block
  kernel. On the flax branch ``mask_self`` alone runs ``ops.attention(...,
  mask_self=True)`` (kernel 4 on the card, :398-402), and the learned
  temperature materializes.
- **the flax branch** (:356-410): ``norm`` (a flax LayerNorm in fp32, only
  with ``pre_norm``; on the queries only unless ``norm_context``),
  ``to_qkv`` (self-attention) or ``to_q`` and ``to_kv`` (cross-attention,
  ``forward(x, context, kv_include_self)``), each a flax ``nn.Dense`` in
  the module dtype with a bias under ``qkv_bias`` (the product rounded
  once, then the bias added in that dtype), ``to_out`` with the output
  projection; the head mixes, ``reattn_*`` and ``log_temperature`` as on
  the raw branch. Hugging Face and timm ViTs take it (a qkv bias: vit_tpu
  fuses a layer only without one, :196). The attention: ``ops.attention``
  on the q, k, v views with the bias and ``mask_self`` (the flash kernel,
  kernel 4, on the card), or, with a head mix, the learned temperature or
  dropout, the materializing path. Few queries against many keys take the
  reassociated low-query path (``lowq_cross``; the FLOP gate of :387; never
  with a qkv bias, re-attention, ``mask_self`` or a bias, :379-386), in
  plain PyTorch, as the JAX package computes it outside any Pallas kernel.
  The residual is the input before the norm, added with ``fuse_residual``.

**Dropout** (``dropout``, :183-194, :329-349, :502-503): with
``forward(..., train=True)`` and ``dropout`` above 0 every branch takes the
materialized scores, as ``vit_tpu``'s ``needs_materialized`` does: dropout
on the probabilities (``attn_drop``) and on the output projection
(``out_drop``), flax's ``Dropout`` (keep with probability ``1 - p``, kept
values divided by it), its masks drawn from the ``generator`` passed in
(``bernoulli``). ``train=True`` with ``dropout`` 0 takes the inference
routes, as ``vit_tpu``'s ``th_fusable`` and ``reattn_fusable`` (:227-249)
do: the talking-heads and re-attention kernels only there. The low-query
path drops after its post-softmax mix (:462).

``mha_tokens`` (:70-91) is the functional attention of the window and
pyramid families over ``[B, N, H*D]`` tokens (Twins-SVT's GSA).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.core.xla_math import lsa_log_temperature
from vit_tpu_torch.nn.embed import Dense, LayerNorm, mm_rounded
from vit_tpu_torch.ops.block_attention import (
    _ln_f32, _mm, _softmax, gemm_sm90, gemm_sm90_op, reference_gemm,
)
from vit_tpu_torch.ops.flash_attention import MASK_VALUE

# vit_tpu/nn/attention.py:213-221: vit_tpu fuses a layer into one block
# kernel only when the fp32 score rows of n tokens and the bf16 qkv and out
# weights fit the TPU's VMEM. Outside these terms it rounds the attention
# delta and the residual sum apart, so the port applies the same two terms
# as a rule of numerics.
FUSE_MAX_TOKENS = 1024
FUSE_MAX_WEIGHT_BYTES = 8 * 1024 * 1024  # dim * inner * 3 bf16 values


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B, N, H*D] -> [B, H, N, D]``."""
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, N, D] -> [B, N, H*D]``."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def mha_tokens(q, k, v, heads: int, *, scale=None, bias=None) -> torch.Tensor:
    """Multi-head attention over token layouts ``[B, N, H*D]`` -> ``[B, N,
    H*Dv]`` (``vit_tpu/nn/attention.py:70-91``): split the heads, one
    ``ops.attention`` (the flash kernel on the card) with the additive
    ``bias`` ``[B|1, H|1, Nq, Nk]`` where given, merge the heads. The splits
    are views; on the card merging the heads is one too."""
    q, k, v = (split_heads(t, heads) for t in (q, k, v))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return merge_heads(ops.attention(q, k, v, bias, scale=scale))


def bernoulli(keep_prob: float, shape, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """The port's ``jax.random.bernoulli``: a bool tensor of ``shape``, each
    value True with probability ``keep_prob``, drawn from ``generator``
    (None: PyTorch's default). Every dropout mask and CaiT's
    stochastic-depth gate is drawn here."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in training: each value kept with
    probability ``1 - rate`` and divided by it, else zero (in ``x``'s
    dtype), the mask drawn from ``generator`` (None: PyTorch's default)."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = bernoulli(keep_prob, x.shape, generator, x.device)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def log_temperature_init(dim_head: int, device="cpu") -> torch.Tensor:
    """LSA's ``log_temperature`` at init, ``vit_tpu``'s fp32
    ``jnp.log(dim_head**-0.5)`` (vit_tpu/nn/attention.py:181-184) as its
    unjitted ``init`` takes it on XLA's CPU, bit for bit at every width:
    ``core.xla_math.lsa_log_temperature``, which the importer uses too."""
    return torch.tensor(lsa_log_temperature(dim_head), dtype=torch.float32, device=device)


def _einsum(eq, a, b, dtype=torch.float32):
    """fp32 einsum of operands already rounded to their dtype (JAX's
    ``preferred_element_type=f32``), rounded once to ``dtype``."""
    return torch.einsum(eq, a.float(), b.float()).to(dtype)


class Attention(nn.Module):
    """Multi-head attention with ``vit_tpu``'s parameter names.

    Self-attention (``cross=False``): ``norm_scale``, ``norm_bias`` ``[D]``;
    ``qkv_kernel`` ``[D, 3*H*Dh]``; ``out_kernel`` ``[H*Dh, D]``;
    ``out_bias`` ``[D]``; ``mix_heads_pre`` / ``mix_heads_post`` ``[H, H]``
    with ``talking_heads``; ``reattn_weights`` ``[H, H]``, ``reattn_scale``,
    ``reattn_bias`` ``[H]`` with ``reattention``; ``log_temperature`` (0-d)
    with ``learned_temperature``. All fp32; the GEMM weights are cast to
    ``dtype`` (None: the stream dtype) per call. ``dropout``: the rate of
    ``attn_drop`` and ``out_drop`` under ``forward(..., train=True)``.

    Cross-attention (``cross=True``): ``norm`` (``scale``, ``bias``),
    ``norm_context`` with ``norm_context``, ``to_q/kernel``,
    ``to_kv/kernel`` (each with a ``bias`` under ``qkv_bias``),
    ``to_out/{kernel, bias}``, and the head mixes as above.
    ``forward(x, context, kv_include_self)``.

    Self-attention on the flax branch (``qkv_bias``, or ``pre_norm=False``):
    ``norm`` (``scale``, ``bias``; none without ``pre_norm``),
    ``to_qkv/{kernel, bias}`` ``[D, 3*H*Dh]`` (the bias only with
    ``qkv_bias``), ``to_out/{kernel, bias}`` (without the output projection,
    none), and the head mixes and ``log_temperature`` as above.

    ``project_out``: None projects unless ``heads == 1`` and ``dim_head ==
    dim``; True or False forces it, as ``vit_tpu``'s field does.
    """

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, *,
                 qkv_bias: bool = False, talking_heads: bool = False,
                 reattention: bool = False, mask_self: bool = False,
                 learned_temperature: bool = False, fuse_residual: bool = False,
                 cross: bool = False, norm_context: bool = False,
                 lowq_cross: Optional[bool] = None, norm_eps: float = 1e-6,
                 pre_norm: bool = True, project_out: Optional[bool] = None,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None, device="cuda"):
        super().__init__()
        # vit_tpu/nn/attention.py:157-162: None skips the projection where
        # heads == 1 and dim_head == dim, as the reference does
        self.project_out = (not (heads == 1 and dim_head == dim) if project_out is None
                            else bool(project_out))
        # vit_tpu/nn/attention.py:251: the raw-parameter branch is pre-norm
        # self-attention without a qkv bias; every other layer is the flax branch
        self.raw = not cross and pre_norm and not qkv_bias
        inner = heads * dim_head
        self.dim, self.heads, self.dim_head, self.scale = dim, heads, dim_head, dim_head**-0.5
        self.talking_heads, self.reattention = talking_heads, reattention
        self.mask_self, self.learned_temperature = mask_self, learned_temperature
        self.fuse_residual, self.cross, self.lowq_cross = fuse_residual, cross, lowq_cross
        self.norm_eps, self.dtype, self.dropout, self.qkv_bias = norm_eps, dtype, dropout, qkv_bias
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        if not self.raw:
            self.norm = LayerNorm(dim, eps=norm_eps, device=device) if pre_norm else None
            if cross:
                self.norm_context = (LayerNorm(dim, eps=norm_eps, device=device)
                                     if pre_norm and norm_context else None)
                self.to_q = Dense(dim, inner, use_bias=qkv_bias, dtype=dtype, device=device)
                self.to_kv = Dense(dim, 2 * inner, use_bias=qkv_bias, dtype=dtype, device=device)
            else:
                self.to_qkv = Dense(dim, 3 * inner, use_bias=qkv_bias, dtype=dtype, device=device)
            if self.project_out:
                self.to_out = Dense(inner, dim, dtype=dtype, device=device)
        else:
            self.norm_scale = p(dim, fill=1.0)
            self.norm_bias = p(dim)
            self.qkv_kernel = p(dim, 3 * inner)
            if self.project_out:
                self.out_kernel = p(inner, dim)
                self.out_bias = p(dim)
        if learned_temperature:
            self.log_temperature = nn.Parameter(log_temperature_init(dim_head, device))
        if talking_heads:
            self.mix_heads_pre = p(heads, heads)
            self.mix_heads_post = p(heads, heads)
        if reattention:
            self.reattn_weights = p(heads, heads)
            self.reattn_scale = p(heads, fill=1.0)
            self.reattn_bias = p(heads)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                kv_include_self: bool = False, bias: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        drop = self.dropout if train else 0.0
        if self.cross:
            return self._cross_attention(x, context, kv_include_self, bias, drop, generator)
        if context is not None or kv_include_self:
            raise ValueError("a self-attention module takes no context; build it with cross=True")
        if not self.raw:
            return self._flax_self_attention(x, bias, drop, generator)
        dtype = self.dtype or x.dtype
        # vit_tpu/nn/attention.py:285-321: talking heads fuse with or without
        # the residual; re-attention and the plain block only with it; none
        # with both head mixes, LSA, a bias, dropout or without the projection
        th = self.talking_heads and not self.reattention
        ra = self.reattention and not self.talking_heads and self.fuse_residual
        plain = not (self.talking_heads or self.reattention) and self.fuse_residual
        if (drop or self.mask_self or self.learned_temperature or bias is not None
                or not self.project_out or not self.fuses(x.shape[1]) or not (th or ra or plain)):
            return self._unfused(x, dtype, bias, drop, generator)
        w = (x, self.norm_scale, self.norm_bias, self.qkv_kernel.to(dtype),
             self.out_kernel.to(dtype), self.out_bias)
        kw = dict(scale=self.scale, ln_eps=self.norm_eps)
        if th:
            return ops.talking_heads_block(*w, self.mix_heads_pre, self.mix_heads_post, self.heads,
                                           residual=self.fuse_residual, **kw)
        if ra:
            return ops.reattention_block(*w, self.reattn_weights, self.reattn_scale,
                                         self.reattn_bias, self.heads, **kw)
        return ops.attention_block(*w, self.heads, **kw)

    def _materialized(self, drop) -> bool:
        """vit_tpu's ``needs_materialized`` (:226-231): a head mix, dropout in
        training or the learned temperature keeps the scores in memory."""
        return bool(self.talking_heads or self.reattention or drop or self.learned_temperature)

    def _scale(self):
        """The score scale: ``exp(log_temperature)`` (LSA) or ``dim_head**-0.5``."""
        return torch.exp(self.log_temperature) if self.learned_temperature else self.scale

    def fuses(self, n: int) -> bool:
        """Whether a layer of ``n`` tokens runs as one block kernel: inside
        ``vit_tpu``'s two terms (``FUSE_MAX_TOKENS``,
        ``FUSE_MAX_WEIGHT_BYTES``), as ``vit_tpu`` decides it. Never with a
        qkv bias: the block kernels' qkv product has no bias input."""
        inner = self.heads * self.dim_head
        return (not self.qkv_bias and n <= FUSE_MAX_TOKENS
                and self.dim * inner * 3 * 2 <= FUSE_MAX_WEIGHT_BYTES)

    def _flax_self_attention(self, x, bias=None, drop=0.0, generator=None):
        """Self-attention on the flax branch (vit_tpu/nn/attention.py:356-410:
        a qkv bias, or ``pre_norm=False``): flax's LayerNorm in fp32 (with
        ``pre_norm``), ``to_qkv`` (rounded once to the module dtype, then its
        bias added in it), ``ops.attention`` on the q, k, v views with the
        bias and ``mask_self`` (the flash kernel, kernel 4, on the card) or,
        with a head mix, the learned temperature or dropout, the
        materializing path; ``to_out`` and ``out_drop`` with the output
        projection; the residual (the input before the norm) added with
        ``fuse_residual``."""
        residual = x
        if self.norm is not None:
            x = self.norm(x)
        q, k, v = (split_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=-1))
        if self._materialized(drop):
            out = self._materializing_attention(q, k, v, bias, drop, generator)
        else:
            out = ops.attention(q, k, v, bias, scale=self.scale, mask_self=self.mask_self)
        out = merge_heads(out)
        if self.project_out:
            out = dropout(self.to_out(out), drop, generator)
        return out + residual if self.fuse_residual else out

    def _unfused(self, x, dtype, bias=None, drop=0.0, generator=None):
        """The raw-parameter branch outside the fused block (vit_tpu/nn/
        attention.py:307-354): flax's LayerNorm in fp32 cast to ``dtype``,
        the qkv product rounded once, ``ops.qkv_attention`` (the fused-qkv
        kernel, or the kv-blocked one for widths and lengths it cannot
        hold) or, with a head mix, LSA or dropout (``drop``, its rate), the
        materializing path, either adding ``bias`` to the scaled scores; the
        output projection summed in fp32 plus its fp32 bias, rounded once to
        x's dtype, then ``out_drop``. Returns the delta, or the delta plus x
        with ``fuse_residual``."""
        xn = _ln_f32(x.float(), self.norm_scale, self.norm_bias, self.norm_eps).to(dtype)
        qkv = mm_rounded(xn, self.qkv_kernel.to(dtype), dtype)
        if (self.talking_heads or self.reattention or self.mask_self or self.learned_temperature
                or drop):
            q, k, v = (split_heads(t, self.heads) for t in qkv.chunk(3, dim=-1))
            out = merge_heads(self._materializing_attention(q, k, v, bias, drop, generator))
        else:
            out = ops.qkv_attention(qkv, self.heads, bias, scale=self.scale)
        if self.project_out:
            out = self._out_projection(out, self.out_kernel.to(dtype), x.dtype)
            out = dropout(out, drop, generator)
        return out + x if self.fuse_residual else out

    def _out_projection(self, out, w, out_dtype):
        """``round_once(out @ w + out_bias)`` to ``out_dtype`` (vit_tpu/nn/
        attention.py:345-348). With bf16 operands whose widths are
        multiples of 8 and no operand that needs grad (the GEMM has no
        backward): on the card the wgmma GEMM (``gemm_sm90``), the fp32 bias
        in its epilogue; on the CPU its twin (``ops._route``). Else an fp32
        product of the rounded operands."""
        k, n = w.shape
        if (out.dtype == w.dtype == torch.bfloat16 and n % 8 == 0 and k % 8 == 0
                and not ops.needs_grad(out, w, self.out_bias)):
            args = (out.reshape(-1, k).contiguous(), w, self.out_bias, None, out_dtype, None)
            y = ops._route(gemm_sm90_op, gemm_sm90, reference_gemm, *args)(*args)
            return y.reshape(*out.shape[:-1], n)
        return (_mm(out, w) + self.out_bias).to(out_dtype)

    def _cross_attention(self, x, context, kv_include_self, bias=None, drop=0.0,
                         generator=None):
        """The flax branch (vit_tpu/nn/attention.py:356-410), with dropout
        at rate ``drop``: ``attn_drop`` on the probabilities (the low-query
        path's after its post-softmax mix, :462; the materializing path's,
        :503), then ``out_drop`` after ``to_out`` (:409). ``mask_self`` masks
        the diagonal of the ``[Nq, Nk]`` scores and ``bias`` is added to them,
        on ``ops.attention`` (kernel 4 on the card) unless the scores are
        materialized; either keeps the layer off the low-query path (:379-386)."""
        if context is None:
            raise ValueError("cross-attention takes a context")
        residual = x
        if self.norm is not None:
            x = self.norm(x)  # fp32, as flax LayerNorm(dtype=float32)
        if self.norm_context is not None:
            context = self.norm_context(context)
        if kv_include_self:  # JAX's concatenate promotes: LN(x) fp32 with a bf16 context
            dt = torch.promote_types(x.dtype, context.dtype)
            kv_src = torch.cat([x.to(dt), context.to(dt)], dim=1)
        else:
            kv_src = context
        q = self.to_q(x)
        n_q, n_kv, inner = q.shape[1], kv_src.shape[1], self.heads * self.dim_head
        lowq = (
            not self.qkv_bias
            and not self.reattention
            and not self.mask_self
            and bias is None
            and (self.lowq_cross if self.lowq_cross is not None
                 else 4 * n_q * (inner + n_kv) <= n_kv * inner)
        )
        if lowq:
            out = self._lowq_cross_attention(q, kv_src, drop, generator)
        else:
            k, v = self.to_kv(kv_src).chunk(2, dim=-1)
            q, k, v = (split_heads(t, self.heads) for t in (q, k, v))
            if self._materialized(drop):
                out = merge_heads(self._materializing_attention(q, k, v, bias, drop, generator))
            else:
                out = merge_heads(ops.attention(q, k, v, bias, scale=self.scale,
                                                mask_self=self.mask_self))
        if self.project_out:
            out = dropout(self.to_out(out), drop, generator)
        return out + residual if self.fuse_residual else out

    def _lowq_cross_attention(self, q, context, drop=0.0, generator=None):
        """Reassociated cross-attention for few queries (vit_tpu/nn/
        attention.py:424-469): ``q (C W_k)^T = (q W_k^T) C^T`` and
        ``p (C W_v) = (p C) W_v``, so no op is proportional to the context
        length times the width twice. Scores stay materialized, so the
        talking-heads mixes and ``attn_drop`` (rate ``drop``) slot in
        unchanged."""
        h, e = self.heads, self.dim_head
        d_model = context.shape[-1]
        dtype = self.dtype or context.dtype
        wk, wv = self.to_kv.kernel.chunk(2, dim=-1)
        wk = wk.reshape(d_model, h, e).to(dtype)
        wv = wv.reshape(d_model, h, e).to(dtype)
        qh = split_heads(q, h).to(dtype)
        c = context.to(dtype)
        t = _einsum("bhqe,dhe->bhqd", qh, wk, dtype)
        s = _einsum("bhqd,bjd->bhqj", t, c) * self._scale()
        if self.talking_heads:
            s = torch.einsum("bhqj,hg->bgqj", s, self.mix_heads_pre)
        p = _softmax(s)
        if self.talking_heads:
            p = torch.einsum("bhqj,hg->bgqj", p, self.mix_heads_post)
        p = dropout(p, drop, generator)
        u = _einsum("bhqj,bjd->bhqd", p.to(c.dtype), c, dtype)
        return merge_heads(_einsum("bhqd,dhe->bhqe", u, wv, dtype))

    def _materializing_attention(self, q, k, v, bias=None, drop=0.0, generator=None):
        """The score-materializing path (vit_tpu/nn/attention.py:471-504):
        the bias, LSA's learned scale and masked diagonal, talking-heads
        mixes and re-attention on ``[B, H, Nq, Nk]`` fp32 scores, then
        ``attn_drop`` at rate ``drop`` on the probabilities."""
        s = _einsum("bhid,bhjd->bhij", q, k) * self._scale()
        if bias is not None:
            s = s + bias.float()
        if self.mask_self:
            nq, nk = s.shape[-2:]
            s = s.masked_fill(torch.eye(nq, nk, dtype=torch.bool, device=s.device), MASK_VALUE)
        if self.talking_heads:
            s = torch.einsum("bhij,hg->bgij", s, self.mix_heads_pre)
        p = _softmax(s)
        if self.talking_heads:
            p = torch.einsum("bhij,hg->bgij", p, self.mix_heads_post)
        if self.reattention:
            p = torch.einsum("bhij,hg->bgij", p, self.reattn_weights)
            p = _ln_f32(p.permute(0, 2, 3, 1), self.reattn_scale, self.reattn_bias, 1e-6)
            p = p.permute(0, 3, 1, 2).to(v.dtype)
        p = dropout(p, drop, generator)
        return _einsum("bhij,bhjd->bhid", p.to(v.dtype), v, v.dtype)
