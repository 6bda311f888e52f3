"""Multi-window attention block: LN -> qkv GEMM -> per-window attention (+ a
shared per-window bias) -> out GEMM + bias. No residual.

Port of ``vit_tpu/ops/window_attention.py``. ``fused_window_attention_block``
is the Hopper kernel (``csrc/window_attention_block.cu``): one fused launch
a group of windows up to 64 tokens, the four-launch pipeline for longer
windows, and for fp32 weights on an fp32 ``xw`` the fp32 route, four
launches on ``csrc/gemm_f32.cuh`` and the fp32 core
``csrc/attention_f32.cuh`` at any window size (``plan_for`` mirrors the
kernel's choice);
``xla_window_attention_block`` is its plain PyTorch twin and mirrors the JAX
twin op for op: flax LayerNorm in fp32 (``block_attention._ln_f32``, the
formula of ``window_attention.py:45-51``), fp32 products of bf16-rounded
operands, qkv and each head's P V rounded to the weights' dtype,
``jax.nn.softmax``'s order, the fp32 bias adds.

The TPU kernel packs G windows into one block-diagonal score tile, a device
for the TPU's matrix unit; every window's softmax sees only its own keys
there too, so the port computes each window on its own.

``window_attention_block_op`` is the kernel as a ``torch.library`` operator
(``_build.define_op``). ``WindowAttentionBlockFn`` is its autograd
Function: the kernel forward, ``vit_tpu``'s recompute backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vit_tpu_torch.core.utils import round_up
from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.block_attention import (
    _ln_f32, _mm, _softmax, recompute_vjp, weights_route,
)
from vit_tpu_torch.ops.flash_attention import MAX_SMEM, check_core_shape, f32_core_bytes

# The kernel's routes, by the C code of each (csrc/window_attention_block.cu
# win::Variant): the four-launch pipeline, and the fused kernel with the
# output's fp32 sums in registers or with every head's P V in an o tile;
# then the fp32 route (vt_window_attention_block_f32).
VARIANTS = ("four-launch", "registers", "o-tile", "fp32")
MAX_FUSED_S = 64  # the longest window of the fused kernel
_MAX_WARPS, _NC, _STAGES = 8, 64, 3


class WindowPlan(NamedTuple):
    """How the kernel runs a window shape (``win::plan_for``): its route
    (``VARIANTS``), the windows a block (0 on the four-launch and fp32
    routes) and a block's shared-memory bytes (on the fp32 route the fp32
    core's, ``f32_core_bytes``)."""

    route: str
    groups: int
    smem_bytes: int


def _smem_bytes(variant: str, g: int, s: int, c: int, heads: int, d: int):
    """``win::layout``: the bytes of a block (the xn tile, the K and V tiles
    or the output staging, the o tile of the o-tile variant, the weight ring
    of 64- or 128-row tiles), and of the region that stages rows of x (the
    K, V and o tiles)."""
    a = lambda v: round_up(v, 128)
    rows = g * round_up(s, 16)
    warps = rows // 16
    kv = max(2 * rows * (d + 8) * 2, warps * 16 * (_NC + 8) * 4)
    o_tile = a(rows * (heads * d + 8) * 2) if variant == "o-tile" else 0
    kr = 128 if c > 64 and d <= 64 else 64
    stage = a(kr * (max(d, _NC) + 8) * 2)
    return a(rows * (round_up(c, 16) + 8) * 2) + a(kv) + o_tile + _STAGES * stage, a(kv) + o_tile


def plan_for(s: int, c: int, heads: int, d: int, fp32: bool = False) -> WindowPlan:
    """The kernel's plan for windows of ``s`` tokens of width ``c``,
    ``heads`` heads of ``d``, operands on 16-byte boundaries
    (``win::plan_for``, mirrored). The fused routes take S <= 64, d % 16 == 0
    up to 128 and c % 8 == 0; ``registers`` also needs d == 64 and c <= 256
    (Twins' three LSA stages), ``o-tile`` takes the rest while a block of
    one window fits 227 KB; other shapes run the four-launch pipeline.
    Blocks of 8 warps (two windows of 33-64 tokens), fewer windows while the
    tiles exceed 227 KB or an fp32 row of x exceeds the bytes that stage
    it. ``fp32`` (fp32 weights on an fp32 ``xw``): the fp32 route at every
    window size, its core's block of 32 query rows a (window, head) taking
    ``f32_core_bytes(s, d, d)``."""
    if fp32:
        return WindowPlan("fp32", 0, f32_core_bytes(s, d, d))
    four = WindowPlan("four-launch", 0, 0)
    if not (1 <= s <= MAX_FUSED_S and d % 16 == 0 and 16 <= d <= 128 and c % 8 == 0 and c >= 8):
        return four

    def fit(variant):
        wpw = round_up(s, 16) // 16
        for g in range(max(1, _MAX_WARPS // wpw), 0, -1):
            nbytes, x_region = _smem_bytes(variant, g, s, c, heads, d)
            if nbytes <= MAX_SMEM and x_region >= 4 * c:
                return WindowPlan(variant, g, nbytes)
        return None

    return (fit("registers") if d == 64 and c <= 256 else None) or fit("o-tile") or four


def route(s: int, c: int, heads: int, d: int) -> str:
    """The kernel's route for this window shape (``plan_for``)."""
    return plan_for(s, c, heads, d).route


def xla_window_attention_block(
    xw, ln_scale, ln_bias, wqkv, wout, bout, heads, bias=None, scale=None, ln_eps=1e-5,
):
    """Plain PyTorch twin (``vit_tpu``'s ``xla_window_attention_block``):
    ``out_proj(window_attention(qkv_proj(LN(xw))))`` of ``xw`` ``[NW, S,
    C]`` in its dtype; ``bias`` reshapes to ``[1|H, S, S]``."""
    nw, s, _ = xw.shape
    hd = wqkv.shape[1] // 3
    d = hd // heads
    if scale is None:
        scale = d**-0.5
    xn = _ln_f32(xw.float(), ln_scale.float(), ln_bias.float(), ln_eps).to(wqkv.dtype)
    qkv = _mm(xn, wqkv, wqkv.dtype)
    split = lambda t: t.reshape(nw, s, heads, d).transpose(1, 2)
    q, k, v = (split(t) for t in qkv.split(hd, dim=-1))
    sc = _mm(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        sc = sc + bias.reshape(1, -1, s, s).float()
    p = _softmax(sc)
    o = _mm(p.to(v.dtype), v, v.dtype)
    o = o.transpose(1, 2).reshape(nw, s, hd).to(wout.dtype)
    return (_mm(o, wout) + bout.float()).to(xw.dtype)


def fused_window_attention_block(
    xw: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    heads: int,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """``out_proj(window_attention(qkv_proj(LN(xw))))`` on the card.

    ``xw`` ``[NW, S, C]`` bf16 or fp32 (NW = batch x windows); ``wqkv``
    ``[C, 3*H*Dh]`` and ``wout`` ``[H*Dh, C]`` bf16, or fp32 with an fp32
    ``xw`` (the fp32 route, its intermediates fp32 too); ``ln_scale``,
    ``ln_bias`` and ``bout`` fp32 ``[C]``; ``bias`` an optional per-window
    bias shared by every window, any shape that reshapes to ``[1|H, S, S]``
    (fp32 in the kernel). No residual. Returns a new tensor of ``xw``'s shape
    and dtype, computed on the current stream. The route follows
    ``plan_for``; an ``xw`` or weights that do not start on a 16-byte
    boundary take the four-launch pipeline."""
    _build.refuse_grad("fused_window_attention_block", xw, ln_scale, ln_bias, wqkv, wout, bout,
                       bias)
    if not xw.is_cuda:
        raise ValueError("fused_window_attention_block takes CUDA tensors")
    if xw.dim() != 3 or xw.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"xw must be [NW, S, C] bf16 or fp32, got {tuple(xw.shape)} {xw.dtype}")
    fp32 = weights_route(xw, wqkv, wout) == "fp32"
    nw, s, c = xw.shape
    hd = wqkv.shape[1] // 3
    if heads <= 0 or hd % heads:
        raise ValueError(f"{wqkv.shape[1]} qkv columns do not split into {heads} heads")
    d = hd // heads
    if tuple(wqkv.shape) != (c, 3 * hd) or tuple(wout.shape) != (hd, c):
        raise ValueError(f"weights {tuple(wqkv.shape)}, {tuple(wout.shape)} do not fit C={c}")
    for name, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias), ("bout", bout)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise TypeError(f"{name} must be fp32 [{c}], got {tuple(t.shape)} {t.dtype}")
    tensors = (xw, ln_scale, ln_bias, wqkv, wout, bout)
    if any(t.device != xw.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if c % 8:
        raise ValueError(f"the kernel takes C % 8 == 0 (got {c})")
    check_core_shape(s, d, d)
    bias_h = 0
    if bias is not None:
        if bias.numel() % (s * s) or bias.numel() // (s * s) not in (1, heads):
            raise ValueError(f"bias must reshape to [1|{heads}, {s}, {s}], got {tuple(bias.shape)}")
        if bias.device != xw.device:
            raise ValueError("bias must be on xw's device")
        bias = bias.reshape(-1, s, s).float().contiguous()
        bias_h = int(bias.shape[0] == heads and heads > 1)
    if scale is None:
        scale = d**-0.5

    # the kernel's choice, mirrored; the fused kernel copies x and the
    # weights 16 bytes at a time
    route = plan_for(s, c, heads, d, fp32).route
    stored = route in ("four-launch", "fp32") or any(t.data_ptr() % 16 for t in (xw, wqkv, wout))
    lib = _build.load_library()
    rows = nw * s
    opts = dict(device=xw.device, dtype=torch.float32 if fp32 else torch.bfloat16)
    scratch = [None] * 3  # xn, qkv, attn: only the four-launch pipelines store them
    if stored:
        scratch = [torch.empty(rows, n, **opts) for n in (c, 3 * hd, hd)]
    out = torch.empty_like(xw)
    head = (xw.data_ptr(),) if fp32 else (xw.data_ptr(), int(xw.dtype == torch.float32))
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = (lib.vt_window_attention_block_f32 if fp32 else lib.vt_window_attention_block)(
            *head, ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(),
            None if bias is None else bias.data_ptr(), bias_h,
            out.data_ptr(), *(None if t is None else t.data_ptr() for t in scratch),
            nw, s, c, heads, d, float(scale), float(ln_eps), stream,
        )
    _build.check(lib, rc, f"window_attention_block kernel ({route} route)")
    _build.count_launch("window_attention_block", fp32=fp32)
    return out


window_attention_block_op = _build.define_op(
    "window_attention_block(Tensor xw, Tensor ln_scale, Tensor ln_bias, Tensor wqkv, "
    "Tensor wout, Tensor bout, int heads, Tensor? bias, float scale, float ln_eps) -> Tensor",
    cuda=fused_window_attention_block, cpu=xla_window_attention_block,
    fake=_build.contiguous_like,
)


class WindowAttentionBlockFn(torch.autograd.Function):
    """The window-attention block as an autograd Function (``vit_tpu``'s
    ``_window_attention_block_ad``, ``vit_tpu/ops/window_attention.py:298-329``).

    Forward: ``forward_fn`` (the kernel, ``fused_window_attention_block``,
    however ``plan_for`` routes it; a CPU test passes the twin), saving only
    the seven inputs, as ``_wab_fwd`` does. Backward, as ``_wab_bwd``: the
    twin ``xla_window_attention_block`` recomputed on them and
    differentiated at the cotangent cast to ``xw``'s dtype
    (``block_attention.recompute_vjp``), ``dbias`` in the shape and dtype
    the shared bias came in (CrossFormer's comes from its position-bias
    MLPs, which it reaches through autograd).

    ``apply(forward_fn, xw, ln_scale, ln_bias, wqkv, wout, bout, heads,
    bias, scale, ln_eps)``."""

    @staticmethod
    def forward(ctx, forward_fn, xw, ln_scale, ln_bias, wqkv, wout, bout, heads, bias, scale,
                ln_eps):
        ctx.save_for_backward(xw, ln_scale, ln_bias, wqkv, wout, bout, bias)
        ctx.config = (heads, scale, ln_eps)
        return forward_fn(xw, ln_scale, ln_bias, wqkv, wout, bout, heads, bias, scale, ln_eps)

    @staticmethod
    def backward(ctx, g):
        heads, scale, ln_eps = ctx.config
        need = ctx.needs_input_grad
        grads = recompute_vjp(
            lambda xw, s, b, wq, wo, bo, bias: xla_window_attention_block(
                xw, s, b, wq, wo, bo, heads, bias, scale, ln_eps),
            ctx.saved_tensors, (*need[1:7], need[8]), g)
        _build.count_recompute("window_attention_block")
        return (None, *grads[:6], None, grads[6], None, None)
