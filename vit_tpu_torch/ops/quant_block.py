"""The W8A8 encoder blocks: the int8 attention block and the int8 MLP.

Port of ``vit_tpu/ops/quant_block.py``. ``fused_quant_attention_block`` and
``fused_quant_mlp`` are the Hopper kernels (``csrc/quant_block.cu``: both
run their products on the s8 wgmma GEMM of ``csrc/gemm_s8_sm90.cuh``, which
reads the int8 weights K-major; the attention block its attention on the
register-resident core, or on an fp32 stream on the fp32 core; the MLP
takes its hidden's row max in fc1's epilogue, by 128-column tile, and
quantizes the hidden in one read); both take a bf16 or an fp32 stream;
``xla_quant_attention_block`` and ``reference_quant_mlp`` are their plain
PyTorch twins, written in the TPU kernels' own op order
(quant_block.py:58-106, :204-221):

- flax LayerNorm in fp32, quantized per row from fp32 (never rounded first);
- exact int8 x int8 -> int32 products (``ops.quant.int_mm``);
- the dequant epilogue ``(acc * s_row) * s_col``, then ``+ bias``, then the
  residual in fp32, then one cast;
- attention: qkv in the stream's dtype, fp32 scores, padded keys
  (``col >= true_n``) masked to -1e30, ``jax.nn.softmax``'s order, P rounded
  to qkv's dtype, fp32 P @ V; the fp32 attention rows are quantized over all
  H*Dh columns;
- MLP: ``gelu`` (tanh form) or ``gelu_exact`` on the fp32 hidden, which is
  quantized over its whole width.

``quant_attention_block_op`` and ``quant_mlp_op`` are the two kernels as
``torch.library`` operators (``_build.define_op``); they take the int8
weights K-major, as the kernels do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.block_attention import (
    MASK_VALUE, MAX_TOKENS, _ln_f32, _mm, _require_aligned, _softmax,
)
from vit_tpu_torch.ops.quant import int_mm, quantize_rows, quantize_with_amax

# Activation codes shared with csrc/gemm.cuh (enum Act); the int8 MLP takes two.
ACTIVATIONS = {"gelu": 1, "gelu_exact": 2}
# Columns of one output tile of the s8 wgmma GEMM (csrc/gemm_s8_sm90.cuh, BN):
# the MLP kernel's fc1 writes each row's max |h| over each such tile.
S8_TILE_N = 128


def _quant_gemm(a_i8, s_row, w_i8, w_scale):
    """``(acc * s_row) * s_col`` in fp32 of the exact int32 product."""
    lead = a_i8.shape[:-1]
    acc = int_mm(a_i8.reshape(-1, a_i8.shape[-1]), w_i8).reshape(*lead, w_i8.shape[1])
    return acc.float() * s_row * w_scale.reshape(-1)


def _activate(h, activation: str):
    if activation == "gelu":  # jax.nn.gelu's default: the tanh form
        return F.gelu(h, approximate="tanh")
    if activation == "gelu_exact":
        return F.gelu(h)
    raise ValueError(f"the int8 MLP takes gelu or gelu_exact, got {activation!r}")


def _attention_f32(qkv, heads, scale, true_n=None):
    """The block's attention of ``qkv`` ``[B, N, 3*H*Dh]``: fp32 rows ``[B,
    N, H*Dh]``, not rounded (they are quantized next)."""
    b, n, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    q, k, v = qkv.split(hd, dim=-1)
    split = lambda t: t.reshape(b, n, heads, d).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    s = _mm(q, k.transpose(-1, -2)) * scale
    if true_n is not None and true_n != n:
        s = torch.where(torch.arange(n, device=qkv.device) < true_n, s, torch.full_like(s, MASK_VALUE))
    p = _softmax(s)
    return _mm(p.to(v.dtype), v).transpose(1, 2).reshape(b, n, hd)


def xla_quant_attention_block(
    x, ln_scale, ln_bias, wqkv_i8, sqkv, wout_i8, sout, bout, heads, scale,
    ln_eps=1e-6, true_n=None,
):
    """Plain PyTorch twin of the W8A8 attention block:
    ``x + out_proj_i8(attention(qkv_proj_i8(quant(LN(x)))))``."""
    xf = x.float()
    x_i8, s_row = quantize_rows(_ln_f32(xf, ln_scale.float(), ln_bias.float(), ln_eps))
    qkv = _quant_gemm(x_i8, s_row, wqkv_i8, sqkv).to(x.dtype)
    a_i8, s_row2 = quantize_rows(_attention_f32(qkv, heads, scale, true_n))
    out = _quant_gemm(a_i8, s_row2, wout_i8, sout)
    out = out + bout.float()
    out = out + xf
    return out.to(x.dtype)


def reference_quant_mlp(
    x, ln_scale, ln_bias, w1_i8, s1, b1, w2_i8, s2, b2,
    activation: str = "gelu", ln_eps: float = 1e-6,
):
    """Plain PyTorch twin of the W8A8 MLP:
    ``x + W2_i8(act(W1_i8(quant(LN(x)))))`` over tokens ``[..., D]``."""
    xf = x.float()
    x_i8, s_row = quantize_rows(_ln_f32(xf, ln_scale.float(), ln_bias.float(), ln_eps))
    h = _quant_gemm(x_i8, s_row, w1_i8, s1) + b1.float()
    h = _activate(h, activation)
    h_i8, s_row2 = quantize_rows(h)
    out = _quant_gemm(h_i8, s_row2, w2_i8, s2) + b2.float()
    return (out + xf).to(x.dtype)


def partial_row_amax(v: torch.Tensor, tile: int = S8_TILE_N) -> torch.Tensor:
    """max |v| of each row of ``v`` ``[rows, K]`` over each ``tile``
    columns (the last tile partial): ``[rows, ceil(K / tile)]`` fp32, what
    the MLP kernel's fc1 writes beside the hidden."""
    rows, k = v.shape
    parts = -(-k // tile)
    return F.pad(v.float().abs(), (0, parts * tile - k)).view(rows, parts, tile).amax(-1)


def quantize_rows_from_partials(v: torch.Tensor, amax_part: torch.Tensor):
    """Twin of the MLP kernel's hidden quantizer: ``quantize_rows``' codes
    and scales of ``v`` ``[rows, K]``, the row max taken as the max of its
    partials ``amax_part`` ``[rows, parts]`` (``partial_row_amax``). A max is
    exact in any order, so both give ``quantize_rows(v)`` bit for bit."""
    return quantize_with_amax(v.float(), amax_part.amax(-1, keepdim=True))


def _check_vec(name, t, size, device):
    if t.dtype != torch.float32 or t.numel() != size or t.device != device or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous fp32 tensor of {size} values on {device}, "
                        f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def kmajor(w_i8: torch.Tensor) -> torch.Tensor:
    """The K-major ``[out, in]`` copy of int8 codes ``[in, out]`` that both
    W8A8 kernels read (a contiguous transpose)."""
    return w_i8.t().contiguous()


def _check_weight(name, w, shape, device):
    if w.dtype != torch.int8 or tuple(w.shape) != shape or w.device != device or not w.is_contiguous():
        raise TypeError(f"{name} must be a contiguous int8 {list(shape)} tensor on {device}, "
                        f"got {tuple(w.shape)} {w.dtype} on {w.device}")


def fused_quant_attention_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv_i8: torch.Tensor,
    sqkv: torch.Tensor,
    wout_i8: torch.Tensor,
    sout: torch.Tensor,
    bout: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    ln_eps: float = 1e-6,
    true_n: Optional[int] = None,
    intermediates: Optional[dict] = None,
) -> torch.Tensor:
    """The W8A8 attention block on the card. ``x`` ``[B, N, D]`` bf16, or
    fp32 (``vit_tpu``'s default stream, whose kernel keeps qkv, the scores'
    operands and P in fp32: qkv written fp32 by the GEMM's epilogue, the
    attention on the fp32 core ``csrc/attention_f32.cuh``).

    The int8 weights come K-major, ``[out, in]``: ``wqkv_i8`` ``[3*H*Dh,
    D]`` and ``wout_i8`` ``[D, H*Dh]``, the transposes of vit_tpu's (and the
    twin's) ``[in, out]`` codes, since Hopper's 8-bit wgmma reads both
    operands K-major (``QuantViT`` keeps such copies; ``kmajor`` makes one).
    Per-output-channel fp32 scales (``[1, N]`` or ``[N]``); ``ln_scale``,
    ``ln_bias``, ``bout`` fp32 ``[D]``. ``true_n`` masks padded keys. Returns
    a new tensor of ``x``'s shape and dtype, computed on the current stream.
    A dict passed as ``intermediates`` receives the stages' rows, ``[B*N,
    ...]``, for checks: ``xq``, ``s_row`` (LN codes), ``qkv`` (in x's
    dtype), ``attn`` (fp32), ``aq``, ``s_row2``."""
    _build.refuse_grad("fused_quant_attention_block", x, ln_scale, ln_bias, sqkv, sout, bout)
    if not x.is_cuda:
        raise ValueError("fused_quant_attention_block takes CUDA tensors")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, n, dim = x.shape
    hd = wout_i8.shape[1] if wout_i8.dim() == 2 else -1
    if heads <= 0 or hd <= 0 or hd % heads:
        raise ValueError(f"wout {tuple(wout_i8.shape)} (K-major, [D, H*Dh]) does not split "
                         f"into {heads} heads")
    three_hd, d = 3 * hd, hd // heads
    _check_weight("wqkv_i8 (K-major)", wqkv_i8, (three_hd, dim), x.device)
    _check_weight("wout_i8 (K-major)", wout_i8, (dim, hd), x.device)
    _check_vec("sqkv", sqkv, three_hd, x.device)
    _check_vec("sout", sout, dim, x.device)
    for name, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias), ("bout", bout)):
        _check_vec(name, t, dim, x.device)
    if dim % 16 or d % 16 or d > 128:
        raise ValueError(f"the kernel takes D % 16 == 0 and dim_head % 16 == 0, <= 128 (got {dim}, {d})")
    if n > MAX_TOKENS:
        raise NotImplementedError(
            f"n={n} > {MAX_TOKENS}: the fused W8A8 block takes at most {MAX_TOKENS} tokens; "
            "nn.Attention keeps longer layers off the fused blocks, as vit_tpu does, and the "
            "int8 w8 / w8a8 modes run them unfused (ops.qkv_attention)"
        )
    true_n = n if true_n is None else int(true_n)
    if not 0 < true_n <= n:
        raise ValueError(f"true_n={true_n} outside (0, {n}]")
    if scale is None:
        scale = d**-0.5
    # the products' TMA loads need 16-byte starts
    _require_aligned(x=x, wqkv_i8=wqkv_i8, sqkv=sqkv, wout_i8=wout_i8, sout=sout, bout=bout)

    lib = _build.load_library()
    rows = b * n
    dev = x.device
    xq = torch.empty(rows, dim, device=dev, dtype=torch.int8)
    s_row = torch.empty(rows, device=dev, dtype=torch.float32)
    qkv = torch.empty(rows, three_hd, device=dev, dtype=x.dtype)
    attn = torch.empty(rows, hd, device=dev, dtype=torch.float32)
    aq = torch.empty(rows, hd, device=dev, dtype=torch.int8)
    s_row2 = torch.empty(rows, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vt_quant_attention_block(
            x.data_ptr(), int(x.dtype == torch.float32), ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv_i8.data_ptr(), sqkv.data_ptr(), wout_i8.data_ptr(), sout.data_ptr(),
            bout.data_ptr(), out.data_ptr(),
            xq.data_ptr(), s_row.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
            aq.data_ptr(), s_row2.data_ptr(),
            b, n, dim, heads, d, float(scale), float(ln_eps), true_n, stream,
        )
    _build.check(lib, rc, "quant_attention_block kernel")
    _build.count_launch("quant_attention_block", fp32=x.dtype == torch.float32)
    if intermediates is not None:
        intermediates.update(xq=xq, s_row=s_row, qkv=qkv, attn=attn, aq=aq, s_row2=s_row2)
    return out


def fused_quant_mlp(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1_i8: torch.Tensor,
    s1: torch.Tensor,
    b1: torch.Tensor,
    w2_i8: torch.Tensor,
    s2: torch.Tensor,
    b2: torch.Tensor,
    activation: str = "gelu",
    ln_eps: float = 1e-6,
    intermediates: Optional[dict] = None,
) -> torch.Tensor:
    """The W8A8 MLP on the card over tokens ``x`` ``[..., T, D]`` (bf16 or
    fp32): always LN, always the residual.

    The int8 weights come K-major, ``[out, in]``: ``w1_i8`` ``[F, D]`` and
    ``w2_i8`` ``[D, F]``, the transposes of vit_tpu's (and the twin's) ``[in,
    out]`` codes, as for ``fused_quant_attention_block`` (``QuantViT`` keeps
    such copies; ``kmajor`` makes one). Per-output-channel fp32 scales;
    biases and LN parameters fp32. Returns ``x``'s shape and dtype. A dict
    passed as ``intermediates`` receives the stages' rows for checks:
    ``xq``, ``s_row`` (LN codes), ``h`` (fp32 hidden after the activation),
    ``h_amax`` (its partial row maxes, ``partial_row_amax``), ``hq``,
    ``s_row2``."""
    _build.refuse_grad("fused_quant_mlp", x, ln_scale, ln_bias, s1, b1, s2, b2)
    if not x.is_cuda:
        raise ValueError("fused_quant_mlp takes CUDA tensors")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if activation not in ACTIVATIONS:
        raise ValueError(f"the int8 MLP takes gelu or gelu_exact, got {activation!r}")
    dim = x.shape[-1]
    f = w1_i8.shape[0] if w1_i8.dim() == 2 else -1
    _check_weight("w1_i8 (K-major)", w1_i8, (f, dim), x.device)
    _check_weight("w2_i8 (K-major)", w2_i8, (dim, f), x.device)
    for name, t, size in (("s1", s1, f), ("b1", b1, f), ("s2", s2, dim), ("b2", b2, dim),
                          ("ln_scale", ln_scale, dim), ("ln_bias", ln_bias, dim)):
        _check_vec(name, t, size, x.device)
    if dim % 16 or f % 16:
        raise ValueError(f"the kernel takes D % 16 == 0 and F % 16 == 0 (got {dim}, {f})")
    # the products' TMA loads and the epilogues' vector loads need 16-byte starts
    _require_aligned(x=x, w1_i8=w1_i8, s1=s1, b1=b1, w2_i8=w2_i8, s2=s2, b2=b2)

    lib = _build.load_library()
    t = x.numel() // dim
    dev = x.device
    xq = torch.empty(t, dim, device=dev, dtype=torch.int8)
    s_row = torch.empty(t, device=dev, dtype=torch.float32)
    h = torch.empty(t, f, device=dev, dtype=torch.float32)
    hq = torch.empty(t, f, device=dev, dtype=torch.int8)
    s_row2 = torch.empty(t, device=dev, dtype=torch.float32)
    h_amax = torch.empty(t, -(-f // S8_TILE_N), device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vt_quant_mlp(
            x.data_ptr(), int(x.dtype == torch.float32), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1_i8.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2_i8.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            xq.data_ptr(), s_row.data_ptr(), h.data_ptr(), hq.data_ptr(), s_row2.data_ptr(),
            h_amax.data_ptr(), t, dim, f, ACTIVATIONS[activation], float(ln_eps), stream,
        )
    _build.check(lib, rc, "quant_mlp kernel")
    _build.count_launch("quant_mlp", fp32=x.dtype == torch.float32)
    if intermediates is not None:
        intermediates.update(xq=xq, s_row=s_row, h=h, h_amax=h_amax, hq=hq, s_row2=s_row2)
    return out


quant_attention_block_op = _build.define_op(
    "quant_attention_block(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor wqkv_kmajor, "
    "Tensor sqkv, Tensor wout_kmajor, Tensor sout, Tensor bout, int heads, float scale, "
    "float ln_eps, int? true_n) -> Tensor",
    cuda=fused_quant_attention_block,
    cpu=lambda x, ln_scale, ln_bias, wqkv_kmajor, sqkv, wout_kmajor, *rest:
    xla_quant_attention_block(x, ln_scale, ln_bias, wqkv_kmajor.t(), sqkv, wout_kmajor.t(), *rest),
    fake=_build.contiguous_like,
)
quant_mlp_op = _build.define_op(
    "quant_mlp(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w1_kmajor, Tensor s1, "
    "Tensor b1, Tensor w2_kmajor, Tensor s2, Tensor b2, str activation, float ln_eps) -> Tensor",
    cuda=fused_quant_mlp,
    cpu=lambda x, ln_scale, ln_bias, w1_kmajor, s1, b1, w2_kmajor, *rest:
    reference_quant_mlp(x, ln_scale, ln_bias, w1_kmajor.t(), s1, b1, w2_kmajor.t(), *rest),
    fake=_build.contiguous_like,
)


def _check_rows(v, name):
    if not v.is_cuda or v.dtype != torch.float32 or v.dim() != 2 or not v.is_contiguous():
        raise ValueError(f"{name} takes a contiguous fp32 [rows, K] CUDA tensor")


def quant_rows_f32(v: torch.Tensor):
    """The kernels' row quantizer alone: ``(int8 codes, fp32 row scales
    [rows])`` of fp32 rows ``v`` ``[rows, K]`` on the card. For checks
    against ``quantize_rows``; no model path calls it, and it counts no
    launch."""
    _check_rows(v, "quant_rows_f32")
    rows, k = v.shape
    lib = _build.load_library()
    q = torch.empty(rows, k, device=v.device, dtype=torch.int8)
    s = torch.empty(rows, device=v.device, dtype=torch.float32)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.vt_quant_rows(v.data_ptr(), q.data_ptr(), s.data_ptr(), rows, k, stream)
    _build.check(lib, rc, "quant_rows kernel")
    return q, s


def quant_rows_parts_f32(v: torch.Tensor, amax_part: torch.Tensor):
    """The MLP kernel's hidden quantizer alone: ``(int8 codes, fp32 row
    scales [rows])`` of fp32 rows ``v`` ``[rows, K]`` on the card, the row
    max taken from the partials ``amax_part`` ``[rows, parts]`` fp32
    (``partial_row_amax``). For checks against ``quantize_rows``; no model
    path calls it, and it counts no launch."""
    _check_rows(v, "quant_rows_parts_f32")
    rows, k = v.shape
    if k % 16:
        raise ValueError(f"K must be a multiple of 16, got {k}")
    _check_rows(amax_part, "quant_rows_parts_f32's partials")
    if amax_part.shape[0] != rows or amax_part.device != v.device:
        raise ValueError(f"partials {tuple(amax_part.shape)} for rows {tuple(v.shape)}")
    _require_aligned(v=v)
    lib = _build.load_library()
    q = torch.empty(rows, k, device=v.device, dtype=torch.int8)
    s = torch.empty(rows, device=v.device, dtype=torch.float32)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.vt_quant_rows_parts(v.data_ptr(), amax_part.data_ptr(), amax_part.shape[1],
                                     q.data_ptr(), s.data_ptr(), rows, k, stream)
    _build.check(lib, rc, "quant_rows_parts kernel")
    return q, s


def _check_s8_operands(name, a, b_nk):
    if not (a.is_cuda and b_nk.is_cuda) or a.dtype != torch.int8 or b_nk.dtype != torch.int8:
        raise ValueError(f"{name} takes int8 CUDA tensors")
    m, k = a.shape
    n = b_nk.shape[0]
    if (b_nk.shape[1] != k or k % 16 or n % 16 or not (a.is_contiguous() and b_nk.is_contiguous())):
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b_nk.shape)}^T: b is [N, K], and K "
                         "and N must be multiples of 16")
    _require_aligned(a=a, b_nk=b_nk)
    return m, n, k


def gemm_s8_sm90_i32(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """The W8A8 kernels' s8 wgmma GEMM alone: raw int32 sums of ``a [M, K]
    @ b_nk.T`` with ``b_nk`` ``[N, K]`` K-major (int8, on the card). For
    exactness checks against ``torch._int_mm``; no model path calls it, and
    it counts no launch."""
    m, n, k = _check_s8_operands("gemm_s8_sm90_i32", a, b_nk)
    lib = _build.load_library()
    c = torch.empty(m, n, device=a.device, dtype=torch.int32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.vt_gemm_s8_sm90_i32(a.data_ptr(), b_nk.data_ptr(), c.data_ptr(), m, n, k, stream)
    _build.check(lib, rc, "gemm_s8_sm90 kernel")
    return c


def gemm_s8_sm90_f32(a, b_nk, s_row, s_col, bias=None, activation=None, row_max=False):
    """The s8 wgmma GEMM alone with its fp32 dequant epilogue, as the MLP
    kernel's fc1 runs it: ``act((a @ b_nk.T) * s_row * s_col + bias)`` for
    int8 ``a`` ``[M, K]``, ``b_nk`` ``[N, K]`` and fp32 ``s_row`` ``[M]``,
    ``s_col`` and ``bias`` ``[N]``; ``activation`` None, "gelu" or
    "gelu_exact". With ``row_max`` it returns ``(c, partials)``, the
    partials ``[M, ceil(N / 128)]`` written by the epilogue. For checks; no
    model path calls it, and it counts no launch."""
    m, n, k = _check_s8_operands("gemm_s8_sm90_f32", a, b_nk)
    _check_vec("s_row", s_row, m, a.device)
    _check_vec("s_col", s_col, n, a.device)
    _require_aligned(s_col=s_col)
    if bias is not None:
        _check_vec("bias", bias, n, a.device)
        _require_aligned(bias=bias)
    act = 0 if activation is None else ACTIVATIONS[activation]
    lib = _build.load_library()
    c = torch.empty(m, n, device=a.device, dtype=torch.float32)
    parts = torch.empty(m, -(-n // S8_TILE_N), device=a.device) if row_max else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.vt_gemm_s8_sm90_f32(
            a.data_ptr(), b_nk.data_ptr(), c.data_ptr(), s_row.data_ptr(), s_col.data_ptr(),
            None if bias is None else bias.data_ptr(), act,
            None if parts is None else parts.data_ptr(), m, n, k, stream)
    _build.check(lib, rc, "gemm_s8_sm90 kernel")
    return (c, parts) if row_max else c
