"""Fused self-attention block: LN -> qkv GEMM -> softmax attention -> out
GEMM -> +residual.

Port of ``vit_tpu/ops/block_attention.py``. ``fused_attention_block`` is the
Hopper kernel (``csrc/attention_block.cu``); ``xla_attention_block`` is its
plain PyTorch twin, which mirrors the JAX twin op for op: flax LayerNorm in
fp32, fp32 products of bf16-rounded operands (JAX's
``preferred_element_type=f32``), the same bf16 rounding sites, and
``jax.nn.softmax``'s max / exp / sum / divide order.

The TPU kernel keeps Wqkv and Wout resident in VMEM across the whole batch.
On Hopper that does not fit in shared memory, so the kernel splits at its
GEMM boundaries and stores only the tensors the TPU kernel itself rounds to
bf16 before their next use (``xn``, qkv, the attention output): the math is
unchanged. Its two products run on a wgmma GEMM fed by TMA
(``csrc/gemm_sm90.cuh``); ``gemm_sm90`` calls that GEMM alone (the unfused
attention's output projection, and checks). With fp32 weights on an fp32
stream (``vit_tpu``'s default precision) the kernel takes its fp32 route
(``weights_route``): the products on ``csrc/gemm_f32.cuh`` and the
attention on the fp32 core ``csrc/attention_f32.cuh``, nothing rounded to
bf16, as the TPU kernel runs fp32 weights at ``Precision.HIGHEST``.

``attention_block_op`` and ``gemm_sm90_op`` are the two launches as
``torch.library`` operators (``_build.define_op``): the kernel on a CUDA
tensor, the twin on a CPU one, a fake for ``torch.export``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from vit_tpu_torch.ops import _build

MASK_VALUE = -1e30
# Activation codes of the GEMM epilogues (csrc/gemm.cuh enum Act; 0 is none).
ACTIVATIONS = {"gelu": 1, "gelu_exact": 2, "hard_swish": 3}
MAX_TOKENS = 1024  # the score rows of one query tile live in shared memory

# torch.exp on the CPU runs MKL's vector math, which sets itself up on its
# first call. When two threads of one parallel torch.exp make that first call
# together, one of them can get a low-accuracy exp (1.5e-4 relative instead
# of 1e-7; 4 of 240 fresh 2-thread processes on a Xeon with MKL 2024.2,
# tests/torch_exp_race.py). One call on one thread at import sets MKL up
# before any parallel call.
torch.exp(torch.zeros(1))


def _ln_f32(x, scale, bias, eps=1e-6):
    # flax.linen.LayerNorm's exact op sequence (fast variance, scale folded
    # into the rsqrt multiplier), as vit_tpu/ops/block_attention.py:_ln_f32.
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale
    return (x - mean) * mul + bias


def _mm(a, b, dtype=torch.float32):
    """fp32 product of operands already rounded to their storage dtype.
    (A bf16 matmul on the CPU rounds its output to bf16; JAX's
    ``preferred_element_type=f32`` does not.)"""
    return torch.matmul(a.float(), b.float()).to(dtype)


@contextlib.contextmanager
def fp32_bf16_sums():
    """Turn ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off inside the scope and give the caller's setting back after it, split-K
    part included where this PyTorch has one. PyTorch's default, on, lets
    cuBLAS add a bf16 GEMM's split-K partials in bf16; off, it sums in fp32
    and rounds once. PyTorch reads the flag when each matmul is issued, so
    only the products issued inside the scope see it. The flag is global to
    the process: a forward of the port runs on one thread at a time (the
    serving worker's), and a product issued by another thread during the
    scope would see it off too."""
    flags = torch.backends.cuda.matmul
    caller = flags.allow_bf16_reduced_precision_reduction
    split_k = getattr(flags, "allow_bf16_reduced_precision_reduction_split_k", None)
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = (
            caller if split_k is None else (caller, split_k))


def _activate(h, activation: str):
    """The epilogue activations of kernel 2 and the wgmma GEMM, on fp32."""
    if activation == "gelu":  # flax nn.gelu's default: the tanh form
        return F.gelu(h, approximate="tanh")
    if activation == "gelu_exact":  # erf form, HF/timm ViTs
        return F.gelu(h)
    if activation == "hard_swish":  # LeViT MLP flavor
        return h * F.relu6(h + 3.0) / 6.0
    raise ValueError(activation)


def _softmax(s):
    """``jax.nn.softmax``'s op order on fp32 scores: max, exp(s - max), sum,
    divide."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return p / p.sum(dim=-1, keepdim=True)


def key_mask(n: int, true_n: Optional[int], block_tokens: Optional[int], device):
    """``[n, n]`` bool mask of visible keys, or None when every key is
    visible: padded key columns (``col % bt >= true_n``) are hidden and, for a
    sample-packed stream (``bt < n``), keys of other samples too."""
    bt = block_tokens if block_tokens is not None else n
    if not ((true_n is not None and true_n != bt) or bt != n):
        return None
    cols = torch.arange(n, device=device)
    ok = (cols % bt < (true_n if true_n is not None else bt))[None, :].expand(n, n)
    if bt != n:
        ok = ok & ((cols[None, :] // bt) == (cols[:, None] // bt))
    return ok


def xla_attention_block(
    x, ln_scale, ln_bias, wqkv, wout, bout, heads, scale, ln_eps=1e-6,
    true_n=None, block_tokens=None,
):
    """Plain PyTorch twin of the fused kernel (``vit_tpu``'s
    ``xla_attention_block``): ``x + out_proj(attention(qkv_proj(LN(x))))``
    in the dtype of ``x``."""
    b, n, dim = x.shape
    hd = wqkv.shape[1] // 3
    d = hd // heads
    xn = _ln_f32(x.float(), ln_scale.float(), ln_bias.float(), ln_eps).to(wqkv.dtype)
    qkv = _mm(xn, wqkv, wqkv.dtype)
    q, k, v = qkv.split(hd, dim=-1)
    split = lambda t: t.reshape(b, n, heads, d).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    s = _mm(q, k.transpose(-1, -2)) * scale
    ok = key_mask(n, true_n, block_tokens, x.device)
    if ok is not None:
        s = torch.where(ok, s, torch.full_like(s, MASK_VALUE))
    p = _softmax(s)
    o = _mm(p.to(v.dtype), v, v.dtype)
    o = o.transpose(1, 2).reshape(b, n, hd).to(wout.dtype)
    out = _mm(o, wout) + bout.float() + x.float()
    return out.to(x.dtype)


def _require_aligned(**tensors) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary: the
    kernel's TMA loads and paired stores need it, and a view that starts
    inside its storage may not."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary "
                             f"(storage offset {t.storage_offset()})")


def weights_route(x, *weights) -> str:
    """The route of kernels 1, 2, 6, 7 and 8 for a stream ``x`` and its GEMM
    weights: ``"bf16"`` for bf16 weights (x bf16 or fp32), ``"fp32"`` for
    fp32 weights on an fp32 x. Anything else raises ``TypeError``: fp32
    weights on a bf16 stream, or weights of two dtypes."""
    dtypes = {w.dtype for w in weights}
    if dtypes == {torch.bfloat16}:
        return "bf16"
    if dtypes == {torch.float32}:
        if x.dtype != torch.float32:
            raise TypeError(f"fp32 weights take an fp32 stream (x is {x.dtype}): vit_tpu runs "
                            "fp32 weights at Precision.HIGHEST on fp32 activations only")
        return "fp32"
    raise TypeError(f"the weights must all be bf16 or all fp32, got {sorted(map(str, dtypes))}")


def gemm_sm90(a, b, bias=None, residual=None, out_dtype=torch.bfloat16, activation=None):
    """``round_once(act(a @ b + bias) + residual)`` on the card: the wgmma
    GEMM of kernels 1 and 2 (``csrc/gemm_sm90.cuh``) alone, for checks
    against an fp32 product of the same operands. ``a`` ``[M, K]`` and ``b``
    ``[K, N]`` bf16, N and K multiples of 8; ``bias`` fp32 ``[N]``;
    ``residual`` ``[M, N]`` of ``out_dtype`` (bf16 or fp32); ``activation``
    None or a key of ``ACTIVATIONS``. Returns a new ``[M, N]`` tensor."""
    _build.refuse_grad("gemm_sm90", a, b, bias, residual)
    if not a.is_cuda:
        raise ValueError("gemm_sm90 takes CUDA tensors")
    if activation is not None and activation not in ACTIVATIONS:
        raise ValueError(f"activation must be None or one of {sorted(ACTIVATIONS)}, got {activation}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or fp32, got {out_dtype}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.dim() != 2 or b.dim() != 2:
        raise TypeError(f"a and b must be 2-D bf16, got {a.dtype} {b.dtype}")
    (m, k), n = a.shape, b.shape[1]
    if b.shape[0] != k or n % 8 or k % 8:
        raise ValueError(f"a {tuple(a.shape)} @ b {tuple(b.shape)}: K must agree, N and K % 8 == 0")
    operands = dict(a=a, b=b)
    if bias is not None:
        if bias.dtype != torch.float32 or tuple(bias.shape) != (n,):
            raise TypeError(f"bias must be fp32 [{n}], got {tuple(bias.shape)} {bias.dtype}")
        operands["bias"] = bias
    if residual is not None:
        if residual.dtype != out_dtype or tuple(residual.shape) != (m, n):
            raise TypeError(f"residual must be {out_dtype} [{m}, {n}], got "
                            f"{tuple(residual.shape)} {residual.dtype}")
        operands["residual"] = residual
    if any(t.device != a.device for t in operands.values()):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in operands.values()):
        raise ValueError("operands must be contiguous")
    _require_aligned(**operands)
    lib = _build.load_library()
    c = torch.empty(m, n, device=a.device, dtype=out_dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.vt_gemm_bf16_sm90(
            a.data_ptr(), b.data_ptr(), c.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            residual.data_ptr() if residual is not None else None,
            ACTIVATIONS.get(activation, 0), int(out_dtype == torch.float32), m, n, k, stream,
        )
    _build.check(lib, rc, "gemm_sm90 kernel")
    return c


def reference_gemm(a, b, bias=None, residual=None, out_dtype=torch.bfloat16, activation=None):
    """Plain PyTorch twin of ``gemm_sm90``: the fp32 product of the stored
    operands, ``+ bias`` and the activation in fp32, ``+ residual`` in fp32,
    one rounding to ``out_dtype``."""
    y = _mm(a, b)
    if bias is not None:
        y = y + bias.float()
    if activation is not None:
        y = _activate(y, activation)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def gemm_f32(a, b, bias=None, residual=None, activation=None):
    """``act(a @ b + bias) + residual`` in fp32 on the card: the fp32 GEMM of
    the fp32 routes of kernels 2, 7 and 8 (``csrc/gemm_f32.cuh``: fp32 fused
    multiply-adds on the CUDA cores, no TF32) alone, for checks against an
    fp32 product of the same operands. ``a`` ``[M, K]``, ``b`` ``[K, N]``,
    ``bias`` ``[N]`` and ``residual`` ``[M, N]``, all fp32, of any widths;
    ``activation`` None or a key of ``ACTIVATIONS``. Its twin is
    ``reference_gemm(..., out_dtype=torch.float32)``."""
    _build.refuse_grad("gemm_f32", a, b, bias, residual)
    if not a.is_cuda:
        raise ValueError("gemm_f32 takes CUDA tensors")
    if activation is not None and activation not in ACTIVATIONS:
        raise ValueError(f"activation must be None or one of {sorted(ACTIVATIONS)}, "
                         f"got {activation}")
    operands = {k: t for k, t in dict(a=a, b=b, bias=bias, residual=residual).items()
                if t is not None}
    if any(t.dtype != torch.float32 for t in operands.values()) or a.dim() != 2 or b.dim() != 2:
        raise TypeError("operands must be fp32 and a, b 2-D, got "
                        f"{[t.dtype for t in operands.values()]}")
    (m, k), n = a.shape, b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"a {tuple(a.shape)} @ b {tuple(b.shape)}: K must agree")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual must be [{m}, {n}], got {tuple(residual.shape)}")
    if any(t.device != a.device for t in operands.values()):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in operands.values()):
        raise ValueError("operands must be contiguous")
    lib = _build.load_library()
    c = torch.empty(m, n, device=a.device, dtype=torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.vt_gemm_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(), ptr(bias), ptr(residual),
                             ACTIVATIONS.get(activation, 0), m, n, k, stream)
    _build.check(lib, rc, "gemm_f32 kernel")
    return c


gemm_sm90_op = _build.define_op(
    "gemm_sm90(Tensor a, Tensor b, Tensor? bias, Tensor? residual, ScalarType out_dtype, "
    "str? activation) -> Tensor",
    cuda=gemm_sm90, cpu=reference_gemm,
    fake=lambda a, b, bias, residual, out_dtype, activation: a.new_empty(
        a.shape[0], b.shape[1], dtype=out_dtype),
)


def fused_attention_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    ln_eps: float = 1e-6,
    true_n: Optional[int] = None,
    block_tokens: Optional[int] = None,
) -> torch.Tensor:
    """``x + out_proj(attention(qkv_proj(LN(x))))`` on the card.

    ``x`` ``[B, N, D]`` bf16 or fp32 (the mixed config's fp32 residual
    stream); ``wqkv`` ``[D, 3*H*Dh]`` and ``wout`` ``[H*Dh, D]`` bf16 (the
    bf16 route), or fp32 with an fp32 ``x`` (the fp32 route, its
    intermediates fp32 too); ``ln_scale``, ``ln_bias`` and ``bout`` fp32
    ``[D]``. ``true_n`` and ``block_tokens`` mask keys exactly as the twin
    does. Returns a new tensor of ``x``'s shape and dtype, computed on the
    current stream.
    """
    if not x.is_cuda:
        raise ValueError("fused_attention_block takes CUDA tensors")
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be [B, N, D] bf16 or fp32, got {tuple(x.shape)} {x.dtype}")
    fp32 = weights_route(x, wqkv, wout) == "fp32"
    b, n, dim = x.shape
    hd = wqkv.shape[1] // 3
    if heads <= 0 or hd % heads:
        raise ValueError(f"{wqkv.shape[1]} qkv columns do not split into {heads} heads")
    d = hd // heads
    if tuple(wqkv.shape) != (dim, 3 * hd) or tuple(wout.shape) != (hd, dim):
        raise ValueError(f"weights {tuple(wqkv.shape)}, {tuple(wout.shape)} do not fit D={dim}")
    for name, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias), ("bout", bout)):
        if t.dtype != torch.float32 or tuple(t.shape) != (dim,):
            raise TypeError(f"{name} must be fp32 [{dim}], got {tuple(t.shape)} {t.dtype}")
    tensors = (x, ln_scale, ln_bias, wqkv, wout, bout)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if not fp32:  # the wgmma GEMM's TMA loads
        _require_aligned(x=x, ln_scale=ln_scale, ln_bias=ln_bias, wqkv=wqkv, wout=wout, bout=bout)
    if d % 16 or d > 128 or dim % 8:
        raise ValueError(f"the kernel takes dim_head % 16 == 0, <= 128 and D % 8 == 0 (got {d}, {dim})")
    if n > MAX_TOKENS:
        raise NotImplementedError(
            f"n={n} > {MAX_TOKENS}: the fused block takes at most {MAX_TOKENS} tokens; "
            "nn.Attention keeps longer layers off it, as vit_tpu does, and runs them unfused "
            "(ops.qkv_attention)"
        )
    if block_tokens is not None and (true_n is None or n % block_tokens):
        raise ValueError("block_tokens needs true_n and must divide n")
    if scale is None:
        scale = d ** -0.5
    true_n = n if true_n is None else true_n
    bt = n if block_tokens is None else block_tokens

    lib = _build.load_library()
    rows = b * n
    opts = dict(device=x.device, dtype=torch.float32 if fp32 else torch.bfloat16)
    xn = torch.empty(rows, dim, **opts)
    qkv = torch.empty(rows, 3 * hd, **opts)
    attn = torch.empty(rows, hd, **opts)
    out = torch.empty_like(x)
    head = (x.data_ptr(),) if fp32 else (x.data_ptr(), int(x.dtype == torch.float32))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = (lib.vt_attention_block_f32 if fp32 else lib.vt_attention_block)(
            *head, ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(),
            out.data_ptr(), xn.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
            b, n, dim, heads, d, float(scale), float(ln_eps), true_n, bt, stream,
        )
    _build.check(lib, rc, f"attention_block kernel ({'fp32' if fp32 else 'bf16'} route)")
    _build.count_launch("attention_block", fp32=fp32)
    return out


attention_block_op = _build.define_op(
    "attention_block(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor wqkv, Tensor wout, "
    "Tensor bout, int heads, float scale, float ln_eps, int? true_n, int? block_tokens) -> Tensor",
    cuda=fused_attention_block, cpu=xla_attention_block, fake=_build.contiguous_like,
)


class AttentionBlockFn(torch.autograd.Function):
    """The attention block as an autograd Function (``vit_tpu``'s
    ``_attention_block_ad``, ``vit_tpu/ops/block_attention.py:284-323``).

    Forward: ``forward_fn`` (the kernel, ``fused_attention_block``, on the
    main path; a CPU test passes the twin), saving only the six inputs, as
    ``_ab_fwd`` does. Backward, as ``_ab_bwd``: the twin
    ``xla_attention_block`` run again on the saved inputs under grad mode
    and differentiated at the cotangent cast to ``x``'s dtype (PyTorch's
    engine hands a Function its cotangent already in the output's dtype,
    which is ``x``'s, so the cast never changes a value; it is kept to
    mirror ``_ab_bwd``). Nothing of the forward but its inputs is kept: the
    scores exist only inside the backward, in fp32, as in ``vit_tpu``.

    ``apply(forward_fn, x, ln_scale, ln_bias, wqkv, wout, bout, heads,
    scale, ln_eps, true_n, block_tokens)``."""

    @staticmethod
    def forward(ctx, forward_fn, x, ln_scale, ln_bias, wqkv, wout, bout, heads, scale, ln_eps,
                true_n, block_tokens):
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, wout, bout)
        ctx.config = (heads, scale, ln_eps, true_n, block_tokens)
        return forward_fn(x, ln_scale, ln_bias, wqkv, wout, bout, heads, scale=scale,
                          ln_eps=ln_eps, true_n=true_n, block_tokens=block_tokens)

    @staticmethod
    def backward(ctx, g):
        heads, scale, ln_eps, true_n, block_tokens = ctx.config
        grads = recompute_vjp(
            lambda *a: xla_attention_block(*a, heads, scale, ln_eps, true_n, block_tokens),
            ctx.saved_tensors, ctx.needs_input_grad[1:7], g)
        _build.count_recompute("attention_block")
        return (None, *grads, None, None, None, None, None)


def recompute_vjp(twin, saved, needs_grad, g):
    """The recompute backward of a kernel's Function: ``twin`` run again on
    the detached ``saved`` inputs under grad mode and differentiated at
    ``g`` cast to the first input's dtype (``jax.vjp(f, *res)`` then
    ``vjp(g.astype(res[0].dtype))``). Returns one gradient per saved input,
    None where the input is None or needs none."""
    with torch.enable_grad():
        args = [None if t is None else t.detach().requires_grad_(bool(need))
                for t, need in zip(saved, needs_grad)]
        out = twin(*args)
        wrt = [a for a in args if a is not None and a.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g.to(saved[0].dtype)))
    return [next(grads) if a is not None and a.requires_grad else None for a in args]
