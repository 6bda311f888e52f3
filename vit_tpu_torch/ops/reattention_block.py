"""The head-mixing attention blocks: CaiT's talking heads and DeepViT's
re-attention.

Port of ``vit_tpu/ops/reattention_block.py``. ``fused_talking_heads_block``
and ``fused_reattention_block`` are the Hopper kernels
(``csrc/talking_heads_block.cu``, ``csrc/reattention_block.cu``, on the core
of ``csrc/head_mix_core.cuh``); ``xla_talking_heads_block`` and
``xla_reattention_block`` are their plain PyTorch twins, written in the TPU
kernels' own op order (reattention_block.py:69-143, :184-244):

- flax LayerNorm in fp32, the qkv product rounded once to the weight dtype;
- fp32 scores ``(q . k) * scale`` per head;
- each head mix a sequential fp32 sum ``sum_h mix[h, g] * tile_h`` over
  h = 0..H-1 (one rounding per product and per add, no fused multiply-add);
- talking heads: pre-mix, padded keys (``col >= true_n``) masked to -1e30,
  ``jax.nn.softmax``'s order, post-mix;
- re-attention: masked softmax, mix, then a LayerNorm across the H values of
  each (i, j): ``mean = sum(r) * (1/H)``, ``var = max(sum(r*r) * (1/H) -
  mean^2, 0)``, ``(r_g - mean) * (rsqrt(var + eps) * scale_g) + bias_g``;
  padded key columns are zeroed after it (the LN bias turns them into
  ``bias_g``);
- P rounded to the weight dtype, fp32 P @ V, each head's output rounded to
  the weight dtype; the out product plus ``bout`` (plus ``x``) in fp32,
  rounded once.

The stage helpers (``_qkv``, ``_scores``, ``_talking_heads_probs``,
``_reattention_probs``, ``_pv_out``) compose the twins; ``chip_smoke.py``
runs them on a kernel's own intermediates to hold it stage by stage.
``talking_heads_block_op`` and ``reattention_block_op`` are the two kernels
as ``torch.library`` operators (``_build.define_op``).

Each kernel has two routes, chosen by the weights' dtype as ``vit_tpu``'s
kernels choose their precision (reattention_block.py:61, :176): bf16
weights (x bf16 or fp32) run the bf16 route (the wgmma GEMM, the head-mix
core on mma.sync, P and each head's output rounded to bf16); fp32 weights
with an fp32 x run the fp32 route (``csrc/gemm_f32.cuh`` and the fp32 core,
``head_mix_f32_kernel``: every product an fp32 sum of fp32 operands, nothing
rounded to bf16), as ``vit_tpu``'s kernels run fp32 weights at
``Precision.HIGHEST``. fp32 weights on a bf16 stream are no ``vit_tpu``
configuration and raise ``TypeError`` (``block_attention.weights_route``).

``TalkingHeadsBlockFn`` and ``ReattentionBlockFn`` are their autograd
Functions: the kernel forward, ``vit_tpu``'s recompute backward. What the
backward recomputes (``recompute_talking_heads_block``,
``recompute_reattention_block``) is ``vit_tpu``'s XLA twin: the twin's
function with each head mix one einsum and flax's LayerNorm across the
heads, which needs no bitwise match with the kernel and runs a mix in one
pass where the twin takes one a head.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.block_attention import (
    MASK_VALUE, _ln_f32, _mm, _require_aligned, _softmax, recompute_vjp, weights_route,
)

# the core's domain: vit_tpu fuses a head-mixing layer up to 1,024 tokens
# (vit_tpu/nn/attention.py:213-249); heads <= 16, dim_head % 16 == 0 up to 128
MAX_TOKENS = 1024
MAX_HEADS = 16
MAX_DIM_HEAD = 128

_LATER = ("ROADMAP.md Queue 2 rows 7 and 8: the head-mix core runs one warp a head; more "
          "than 16 heads or dim_head past 128 need another mapping, and vit_tpu fuses no "
          "head-mixing layer past 1,024 tokens")


# -- the twins' stages ----------------------------------------------------------


def _qkv(x, ln_scale, ln_bias, wqkv, ln_eps):
    """``[B, N, 3*H*Dh]``: flax LN in fp32, the product rounded once."""
    xn = _ln_f32(x.float(), ln_scale.float(), ln_bias.float(), ln_eps).to(wqkv.dtype)
    return _mm(xn, wqkv, wqkv.dtype)


def _scores(qkv, heads, scale):
    """fp32 ``(q . k) * scale`` ``[B, H, N, N]`` and ``v`` ``[B, H, N, Dh]``."""
    b, n, three_hd = qkv.shape
    d = three_hd // 3 // heads
    q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    return _mm(q, k.transpose(-1, -2)) * scale, v


def _mix_heads(t, mix):
    """``out[:, g] = sum_h mix[h, g] * t[:, h]``, summed over h in order."""
    mix = mix.float()
    w = lambda h: mix[h].view(1, -1, 1, 1)
    acc = w(0) * t[:, 0:1]
    for h in range(1, mix.shape[0]):
        acc = acc + w(h) * t[:, h:h + 1]
    return acc


def _sum_heads(t):
    acc = t[:, 0:1]
    for h in range(1, t.shape[1]):
        acc = acc + t[:, h:h + 1]
    return acc


def _key_cols(n, true_n, device):
    """``[n]`` bool: the real key columns, or None when all are real."""
    if true_n is None or true_n == n:
        return None
    return torch.arange(n, device=device) < true_n


def _mask_keys(s, true_n):
    ok = _key_cols(s.shape[-1], true_n, s.device)
    return s if ok is None else torch.where(ok, s, torch.full_like(s, MASK_VALUE))


def _zero_padded_keys(r, true_n):
    ok = _key_cols(r.shape[-1], true_n, r.device)
    return r if ok is None else torch.where(ok, r, torch.zeros_like(r))


def _talking_heads_probs(s, mix_pre, mix_post, true_n=None):
    """Scores -> (the pre-mixed, masked scores, the post-mixed P), fp32."""
    mixed = _mask_keys(_mix_heads(s, mix_pre), true_n)
    return mixed, _mix_heads(_softmax(mixed), mix_post)


def _head_layer_norm(r, rln_scale, rln_bias, eps):
    """LayerNorm across the head axis of ``r`` ``[B, H, N, N]``, in the TPU
    kernel's order (reattention_block.py:116-123)."""
    inv_h = 1.0 / r.shape[1]
    mean = _sum_heads(r) * inv_h
    var = torch.clamp(_sum_heads(r * r) * inv_h - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps)
    per_head = lambda t: t.float().view(1, -1, 1, 1)
    return (r - mean) * (mul * per_head(rln_scale)) + per_head(rln_bias)


def _reattention_probs(s, mix, rln_scale, rln_bias, reattn_eps, true_n=None):
    """Scores -> (the mixed softmax ``r``, the normalised ``r'`` with padded
    key columns zeroed), fp32."""
    mixed = _mix_heads(_softmax(_mask_keys(s, true_n)), mix)
    return mixed, _zero_padded_keys(_head_layer_norm(mixed, rln_scale, rln_bias, reattn_eps), true_n)


def _pv_out(p, v, x, wout, bout, residual):
    """P (rounded to V's dtype) @ V per head, rounded to the weight dtype,
    heads concatenated, then ``@ wout + bout (+ x)`` in fp32, rounded once."""
    b, h, n, d = v.shape
    o = _mm(p.to(v.dtype), v, wout.dtype).transpose(1, 2).reshape(b, n, h * d)
    out = _mm(o, wout) + bout.float()
    if residual:
        out = out + x.float()
    return out.to(x.dtype)


# -- the twins ----------------------------------------------------------------


def xla_talking_heads_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post, heads, scale,
    ln_eps=1e-5, residual=False, true_n=None,
):
    """Plain PyTorch twin of the talking-heads kernel (``vit_tpu``'s
    ``xla_talking_heads_block``): ``out_proj(th_attention(qkv_proj(LN(x))))``
    (``+ x`` if ``residual``) in the dtype of ``x``."""
    s, v = _scores(_qkv(x, ln_scale, ln_bias, wqkv, ln_eps), heads, scale)
    _, p = _talking_heads_probs(s, mix_pre, mix_post, true_n)
    return _pv_out(p, v, x, wout, bout, residual)


def xla_reattention_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias, heads, scale,
    ln_eps=1e-6, reattn_eps=1e-6, true_n=None,
):
    """Plain PyTorch twin of the re-attention kernel (``vit_tpu``'s
    ``xla_reattention_block``): ``x + out_proj(reattention(qkv_proj(LN(x))))``
    in the dtype of ``x``."""
    s, v = _scores(_qkv(x, ln_scale, ln_bias, wqkv, ln_eps), heads, scale)
    _, p = _reattention_probs(s, mix, rln_scale, rln_bias, reattn_eps, true_n)
    return _pv_out(p, v, x, wout, bout, True)


# -- the backwards' recomputes ---------------------------------------------------


def _einsum_mix(t, mix):
    """``_mix_heads`` as one product over the heads, ``vit_tpu``'s
    ``einsum('bhij,hg->bgij')``: the same function in another sum order."""
    return torch.einsum("bhij,hg->bgij", t, mix.float())


def recompute_talking_heads_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post, heads, scale,
    ln_eps=1e-5, residual=False,
):
    """What ``TalkingHeadsBlockFn``'s backward differentiates: ``vit_tpu``'s
    ``xla_talking_heads_block``, which its ``_th_bwd`` recomputes. The twin's
    stages, with each head mix one einsum (``_einsum_mix``) where the twin
    sums a head at a time in the kernel's order; the real tokens only, so
    no key is masked."""
    s, v = _scores(_qkv(x, ln_scale, ln_bias, wqkv, ln_eps), heads, scale)
    p = _einsum_mix(_softmax(_einsum_mix(s, mix_pre)), mix_post)
    return _pv_out(p, v, x, wout, bout, residual)


def recompute_reattention_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias, heads, scale,
    ln_eps=1e-6, reattn_eps=1e-6,
):
    """What ``ReattentionBlockFn``'s backward differentiates: ``vit_tpu``'s
    ``xla_reattention_block``, which its ``_reattn_bwd`` recomputes: the mix
    one einsum, the LayerNorm across the heads flax's (``_ln_f32`` over the
    head axis moved last); the real tokens only."""
    s, v = _scores(_qkv(x, ln_scale, ln_bias, wqkv, ln_eps), heads, scale)
    r = _einsum_mix(_softmax(s), mix).permute(0, 2, 3, 1)
    r = _ln_f32(r, rln_scale.float(), rln_bias.float(), reattn_eps).permute(0, 3, 1, 2)
    return _pv_out(r, v, x, wout, bout, True)


# -- the kernels ----------------------------------------------------------------

# The head-mix core's variants (csrc/head_mix_core.cuh hmix::plan_for): the
# scores of a warp's head in registers through the softmax, the whole row
# mixed at once; or recomputed in passes over the K tiles, the row mixed
# chunk by chunk of the slab's width.
HEAD_MIX_VARIANTS = ("streamed", "resident")
_HM_RESIDENT_TILES = 8
_HM_MAX_SMEM = 232448  # 227 KB, the most one block may use
_HM_PARAM_BYTES = (2 * MAX_HEADS * MAX_HEADS + 2 * MAX_HEADS) * 4
_HM_F32_SLAB_TILES = 4  # the fp32 core's slab (hmix::F32_SLAB_TILES)


class HeadMixPlan(NamedTuple):
    """How the head-mix core of kernels 7 and 8 runs a shape: its variant
    (``HEAD_MIX_VARIANTS``), the slab's width in 16-key tiles, the ring
    stages of each warp and a block's shared-memory bytes."""

    variant: str
    slab_tiles: int
    stages: int
    smem_bytes: int


def head_mix_plan(n: int, heads: int, d: int, fp32: bool = False) -> HeadMixPlan:
    """The core's plan for ``n`` tokens, ``heads`` heads of ``d``
    (``hmix::plan_for``, mirrored). A block is 16 query rows of one sample
    across every head, a warp a head. Its shared memory: the fp32 slab (16
    rows x 16 keys a tile, a plane a head), the mix parameters, and each
    warp's ring of 16 x (d + 8) bf16 stages. ``resident`` where the row has at
    most 8 key tiles and its whole slab fits beside rings of two stages, with
    the deepest ring (up to 4) that fits; else ``streamed``, with a 3-stage
    ring where that leaves a slab of 4 tiles (or the whole row), else 2
    stages and the widest slab that fits.

    ``fp32``: the fp32 route's core (``hmix::plan_f32``): always
    ``streamed``, a slab of up to ``_HM_F32_SLAB_TILES`` tiles and no ring
    (its products read the fp32 qkv rows through L1)."""
    nkt = -(-n // 16)
    if fp32:
        ct = min(nkt, _HM_F32_SLAB_TILES)
        return HeadMixPlan("streamed", ct, 0, heads * ct * 1024 + _HM_PARAM_BYTES)
    stage = 16 * (d + 8) * 2
    size = lambda ct, s: heads * ct * 1024 + _HM_PARAM_BYTES + heads * s * stage
    if nkt <= _HM_RESIDENT_TILES:
        for s in (4, 3, 2):
            if size(nkt, s) <= _HM_MAX_SMEM:
                return HeadMixPlan("resident", nkt, s, size(nkt, s))
    for s in (3, 2):
        room = _HM_MAX_SMEM - (_HM_PARAM_BYTES + heads * s * stage)
        ct = min(nkt, max(room, 0) // (heads * 1024))
        if ct >= min(nkt, 4) or (s == 2 and ct >= 1):
            return HeadMixPlan("streamed", ct, s, size(ct, s))
    return HeadMixPlan("streamed", 0, 0, 0)


def check_domain(name: str, n: int, heads: int, d: int) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP.md outside the domain of
    kernels 7 and 8 (both routes): n <= 1,024 tokens (where ``vit_tpu``
    fuses a head-mixing layer), heads <= 16, dim_head a multiple of 16 up to
    128."""
    if not (0 < n <= MAX_TOKENS and 0 < heads <= MAX_HEADS and d % 16 == 0
            and 0 < d <= MAX_DIM_HEAD):
        raise NotImplementedError(
            f"n={n}, heads={heads}, dim_head={d}: the {name} kernel takes n <= {MAX_TOKENS}, "
            f"heads <= {MAX_HEADS} and dim_head % 16 == 0, <= {MAX_DIM_HEAD} ({_LATER})"
        )


def _check_block(name, x, ln_scale, ln_bias, wqkv, wout, bout, heads, mixes):
    """Validates the operands of either kernel (``mixes``: the head-mix
    operands by name, each with its shape); returns (dim_head, the route)."""
    _build.refuse_grad(name, x, ln_scale, ln_bias, wqkv, wout, bout,
                       *(t for t, _ in mixes.values()))
    if not x.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be [B, N, D] bf16 or fp32, got {tuple(x.shape)} {x.dtype}")
    route = weights_route(x, wqkv, wout)
    b, n, dim = x.shape
    hd = wqkv.shape[1] // 3 if wqkv.dim() == 2 else -1
    if heads <= 0 or hd <= 0 or hd % heads:
        raise ValueError(f"wqkv {tuple(wqkv.shape)} does not split into q, k, v of {heads} heads")
    d = hd // heads
    if tuple(wqkv.shape) != (dim, 3 * hd) or tuple(wout.shape) != (hd, dim):
        raise ValueError(f"weights {tuple(wqkv.shape)}, {tuple(wout.shape)} do not fit D={dim}")
    vecs = {"ln_scale": (ln_scale, (dim,)), "ln_bias": (ln_bias, (dim,)), "bout": (bout, (dim,)),
            **mixes}
    for k, (t, shape) in vecs.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"{k} must be fp32 {list(shape)}, got {tuple(t.shape)} {t.dtype}")
    tensors = [x, wqkv, wout] + [t for t, _ in vecs.values()]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if route == "bf16" and dim % 8:
        raise ValueError(f"the kernel takes D % 8 == 0 (got {dim})")
    check_domain(name, n, heads, d)
    if b > 65535:
        raise ValueError(f"batch {b} > 65535 (one CUDA grid dimension)")
    return d, route


def _launch(name, x, heads, d, route, true_n, intermediates, tensors, scalars):
    """Allocates the output and scratch, runs the C entry ``vt_<name>`` (on
    the fp32 route ``vt_<name>_f32``) on the current stream with ``tensors``
    (after x) and ``scalars`` (after the shape), checks its rc and counts the
    launch."""
    b, n, dim = x.shape
    hd = heads * d
    true_n = n if true_n is None else int(true_n)
    if not 0 < true_n <= n:
        raise ValueError(f"true_n={true_n} outside (0, {n}]")
    lib = _build.load_library()
    rows = b * n
    fp32 = route == "fp32"
    opts = dict(device=x.device, dtype=torch.float32 if fp32 else torch.bfloat16)
    xn = torch.empty(rows, dim, **opts)
    qkv = torch.empty(rows, 3 * hd, **opts)
    attn = torch.empty(rows, hd, **opts)
    out = torch.empty_like(x)
    mixed = p = None
    if intermediates is not None:
        mixed = torch.empty(b, heads, n, n, device=x.device, dtype=torch.float32)
        p = torch.empty_like(mixed)
    ptr = lambda t: None if t is None else t.data_ptr()
    head = (x.data_ptr(),) if fp32 else (x.data_ptr(), int(x.dtype == torch.float32))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"vt_{name}_f32" if fp32 else f"vt_{name}")(
            *head, *(t.data_ptr() for t in tensors),
            out.data_ptr(), xn.data_ptr(), qkv.data_ptr(), attn.data_ptr(), ptr(mixed), ptr(p),
            b, n, dim, heads, d, *scalars, true_n, stream,
        )
    _build.check(lib, rc, f"{name} kernel ({route} route)")
    _build.count_launch(name, fp32=fp32)
    if intermediates is not None:
        intermediates.update(qkv=qkv, mixed=mixed, p=p, attn=attn)
    return out


def fused_talking_heads_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    mix_pre: torch.Tensor,
    mix_post: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    ln_eps: float = 1e-5,
    residual: bool = False,
    true_n: Optional[int] = None,
    intermediates: Optional[dict] = None,
) -> torch.Tensor:
    """``out_proj(talking_heads_attention(qkv_proj(LN(x))))`` (``+ x`` if
    ``residual``) on the card.

    ``x`` ``[B, N, D]`` bf16 or fp32; ``wqkv`` ``[D, 3*H*Dh]`` and ``wout``
    ``[H*Dh, D]`` bf16 (the bf16 route), or fp32 with an fp32 ``x`` (the
    fp32 route; the intermediates then fp32 too); n <= 1,024, H <= 16,
    Dh a multiple of 16 up to 128; ``ln_scale``, ``ln_bias``, ``bout`` fp32 ``[D]``;
    ``mix_pre``, ``mix_post`` fp32 ``[H, H]``. ``true_n`` masks padded keys.
    Returns a new tensor of ``x``'s shape and dtype, computed on the current
    stream. A dict passed as ``intermediates`` receives ``qkv`` ``[B*N,
    3*H*Dh]``, ``mixed`` (the pre-mixed, masked scores) and ``p`` (the
    post-mixed P), both fp32 ``[B, H, N, N]``, and ``attn`` ``[B*N, H*Dh]``."""
    hh = (heads, heads)
    d, route = _check_block("talking_heads_block", x, ln_scale, ln_bias, wqkv, wout, bout,
                            heads, {"mix_pre": (mix_pre, hh), "mix_post": (mix_post, hh)})
    if route == "bf16":  # both products on the wgmma GEMM, whose TMA loads need 16-byte starts
        _require_aligned(x=x, wqkv=wqkv, wout=wout, bout=bout)
    scale = d**-0.5 if scale is None else scale
    return _launch(
        "talking_heads_block", x, heads, d, route, true_n, intermediates,
        (ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post),
        (float(scale), float(ln_eps), int(residual)),
    )


def fused_reattention_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    mix: torch.Tensor,
    rln_scale: torch.Tensor,
    rln_bias: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    ln_eps: float = 1e-6,
    reattn_eps: float = 1e-6,
    true_n: Optional[int] = None,
    intermediates: Optional[dict] = None,
) -> torch.Tensor:
    """``x + out_proj(reattention(qkv_proj(LN(x))))`` on the card.

    Operands as in ``fused_talking_heads_block``, with ``mix`` fp32 ``[H,
    H]`` and ``rln_scale``, ``rln_bias`` fp32 ``[H]``. A dict passed as
    ``intermediates`` receives ``qkv``, ``mixed`` (the mixed softmax ``r``),
    ``p`` (the normalised ``r'``, padded key columns zeroed) and ``attn``."""
    d, route = _check_block(
        "reattention_block", x, ln_scale, ln_bias, wqkv, wout, bout, heads,
        {"mix": (mix, (heads, heads)), "rln_scale": (rln_scale, (heads,)),
         "rln_bias": (rln_bias, (heads,))},
    )
    if route == "bf16":  # both products on the wgmma GEMM, whose TMA loads need 16-byte starts
        _require_aligned(x=x, wqkv=wqkv, wout=wout, bout=bout)
    scale = d**-0.5 if scale is None else scale
    return _launch(
        "reattention_block", x, heads, d, route, true_n, intermediates,
        (ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias),
        (float(scale), float(ln_eps), float(reattn_eps)),
    )


talking_heads_block_op = _build.define_op(
    "talking_heads_block(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor wqkv, Tensor wout, "
    "Tensor bout, Tensor mix_pre, Tensor mix_post, int heads, float scale, float ln_eps, "
    "bool residual) -> Tensor",
    cuda=fused_talking_heads_block, cpu=xla_talking_heads_block, fake=_build.contiguous_like,
)
reattention_block_op = _build.define_op(
    "reattention_block(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor wqkv, Tensor wout, "
    "Tensor bout, Tensor mix, Tensor rln_scale, Tensor rln_bias, int heads, float scale, "
    "float ln_eps, float reattn_eps) -> Tensor",
    cuda=fused_reattention_block, cpu=xla_reattention_block, fake=_build.contiguous_like,
)


class TalkingHeadsBlockFn(torch.autograd.Function):
    """The talking-heads block as an autograd Function (``vit_tpu``'s
    ``_th_ad``, ``vit_tpu/ops/reattention_block.py:361-387``).

    Forward: ``forward_fn`` (the kernel, ``fused_talking_heads_block``, on
    the main path; a CPU test passes the twin), saving only the eight
    operands, as ``_th_fwd`` does. Backward, as ``_th_bwd``:
    ``recompute_talking_heads_block`` (the twin's function with einsum head
    mixes, as ``vit_tpu``'s XLA twin) run on them, with ``residual``, and
    differentiated at the cotangent cast to ``x``'s dtype
    (``block_attention.recompute_vjp``): gradients for ``x``, ``ln_scale``,
    ``ln_bias``, ``wqkv``, ``wout``, ``bout``, ``mix_pre`` and ``mix_post``.
    The ``[B, H, N, N]`` scores exist only inside the backward.

    ``apply(forward_fn, x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre,
    mix_post, heads, scale, ln_eps, residual)``."""

    @staticmethod
    def forward(ctx, forward_fn, x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post,
                heads, scale, ln_eps, residual):
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post)
        ctx.config = (heads, scale, ln_eps, residual)
        return forward_fn(x, ln_scale, ln_bias, wqkv, wout, bout, mix_pre, mix_post, heads, scale,
                          ln_eps, residual)

    @staticmethod
    def backward(ctx, g):
        heads, scale, ln_eps, residual = ctx.config
        grads = recompute_vjp(
            lambda *a: recompute_talking_heads_block(*a, heads, scale, ln_eps, residual),
            ctx.saved_tensors, ctx.needs_input_grad[1:9], g)
        _build.count_recompute("talking_heads_block")
        return (None, *grads, None, None, None, None)


class ReattentionBlockFn(torch.autograd.Function):
    """The re-attention block as an autograd Function (``vit_tpu``'s
    ``_reattn_ad``, ``vit_tpu/ops/reattention_block.py:544-570``).

    Forward: ``forward_fn`` (the kernel, ``fused_reattention_block``, which
    pads the tokens to a multiple of 16 inside and masks the padded keys; a
    CPU test passes the twin), saving only the nine operands as given: the
    unpadded ``x``, as ``_reattn_fwd`` saves it. Backward, as
    ``_reattn_bwd``: ``recompute_reattention_block`` (``vit_tpu``'s XLA
    twin: an einsum mix, flax's LayerNorm across the heads) run on the real
    tokens and differentiated at the cotangent cast to ``x``'s dtype,
    so no padded key column reaches a gradient: gradients for ``x``, the
    LayerNorm, the weights, ``mix``, ``rln_scale`` and ``rln_bias``.

    ``apply(forward_fn, x, ln_scale, ln_bias, wqkv, wout, bout, mix,
    rln_scale, rln_bias, heads, scale, ln_eps, reattn_eps)``."""

    @staticmethod
    def forward(ctx, forward_fn, x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias,
                heads, scale, ln_eps, reattn_eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias)
        ctx.config = (heads, scale, ln_eps, reattn_eps)
        return forward_fn(x, ln_scale, ln_bias, wqkv, wout, bout, mix, rln_scale, rln_bias, heads,
                          scale, ln_eps, reattn_eps)

    @staticmethod
    def backward(ctx, g):
        heads, scale, ln_eps, reattn_eps = ctx.config
        grads = recompute_vjp(
            lambda *a: recompute_reattention_block(*a, heads, scale, ln_eps, reattn_eps),
            ctx.saved_tensors, ctx.needs_input_grad[1:10], g)
        _build.count_recompute("reattention_block")
        return (None, *grads, None, None, None, None)
