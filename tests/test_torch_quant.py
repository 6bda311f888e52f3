"""The port's int8 ops against vit_tpu on the CPU, and its int8 Hopper
kernels against their twins on the card.

The same numpy inputs (``default_rng(seed)``) go through both packages:
the quantizers and ``int8_matmul`` (``ops/quant.py``), the fused-qkv
attention (kernel 3, ``ops/qkv_attention.py``) and the W8A8 attention block
and MLP (kernels 9 and 10, ``ops/quant_block.py``). vit_tpu's Pallas kernels
run in interpret mode, as its own tests run them on the CPU. JAX is imported
inside the tests that use it: the machine with the card has no JAX, and runs
this file's ``cuda`` tests with
``python -m pytest --noconftest -m cuda tests/test_torch_quant.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import (INT8_FAULTS, INT8_FP32_TOL, INT8_LAYER_DIFFER, INT8_LAYER_ULPS,
                        INT8_ROWS_TOL, bf16_ulps, check_quant_block, check_quant_block_f32,
                        codes_differ, int8_out_check, kernel_tol,
                        planted_fault, qblock_kernel_args, qmlp_kernel_args, quant_block_twin,
                        tie_rows)
from vit_tpu_torch import ops
from vit_tpu_torch.ops import quant as tq
from vit_tpu_torch.ops import quant_block as tqb

# ops/__init__ exports a function of the module's own name
tqa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")

torch.set_num_threads(2)


def _torch(a, dtype="float32", device="cpu"):
    a = np.asarray(a)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy()).to(device)
    return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=getattr(torch, dtype))


def _jnp(a, dtype="float32"):
    import jax.numpy as jnp

    a = np.asarray(a)
    if a.dtype == np.int8:
        return jnp.asarray(a)
    return jnp.asarray(a.astype(np.float32)).astype(getattr(jnp, dtype))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _channelwise(w):
    """numpy int8 codes and fp32 scales of a weight, by the port's recipe
    (equal to vit_tpu's: test_quantizers_match_jax)."""
    codes, scale = tq.quantize_channelwise(torch.from_numpy(np.asarray(w, np.float32)))
    return codes.numpy(), scale.numpy()


# -- the quantizers and int8_matmul: exact ------------------------------------


def _quant_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 40)).astype(np.float32) * 3
    # a row whose amax is 127, so scale = 1 and v / scale lands on halves:
    # round half to even gives 0, 2, 2, -2, 4 where half-away-from-zero
    # would give 1, 2, 3, -3, 5
    x[0, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, 4.5]
    x[1] = 0.0  # an all-zero row: the 1e-12 floor of the scale
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["quantize_rows", "quantize_channelwise", "quantize_symmetric"])
def test_quantizers_match_jax(fn, dtype):
    import jax.numpy as jnp
    from vit_tpu.ops import quant as jq

    x = _quant_inputs(0)
    args = {"quantize_symmetric": ((0, 1),)}.get(fn, ())
    jc, js = getattr(jq, fn)(_jnp(x, dtype), *args)
    tc, ts = getattr(tq, fn)(_torch(x, dtype), *args)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))  # codes: exact
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))  # scales: 0 ulp
    if fn == "quantize_rows":
        assert tc[0, :6].tolist() == [127, 0, 2, 2, -2, 4]
        assert ts[1].item() == np.float32(1e-12) / np.float32(127.0)
    np.testing.assert_array_equal(
        _np(tq.dequantize(tc, ts, getattr(torch, dtype))),
        _np(jq.dequantize(jc, js, getattr(jnp, dtype))),
    )


@pytest.mark.parametrize("out_dtype", [None, "float32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(dtype, out_dtype):
    """Same codes, exact int32 sums, the same epilogue ops in the same
    order: bitwise equal. K = 1100 > 1041, where an fp32 sum of int8
    products would no longer be exact."""
    import jax.numpy as jnp
    from vit_tpu.ops import quant as jq

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 1100)).astype(np.float32)
    w_i8, s = _channelwise(rng.standard_normal((1100, 24)) * 0.05)
    bias = rng.standard_normal(24).astype(np.float32)
    od = (getattr(torch, out_dtype), getattr(jnp, out_dtype)) if out_dtype else (None, None)
    for b in (None, bias):
        out = tq.int8_matmul(_torch(x, dtype), _torch(w_i8), _torch(s),
                             None if b is None else _torch(b), od[0])
        ref = jq.int8_matmul(_jnp(x, dtype), _jnp(w_i8), _jnp(s), None if b is None else _jnp(b), od[1])
        assert out.dtype == (od[0] or getattr(torch, dtype)) and out.shape == (2, 9, 24)
        np.testing.assert_array_equal(_np(out), _np(ref))


def test_int_mm_is_exact_at_the_extremes():
    a = torch.full((3, 4096), 127, dtype=torch.int8)
    b = torch.full((4096, 5), -127, dtype=torch.int8)
    assert (tq.int_mm(a, b) == -4096 * 127 * 127).all()


# -- kernel 3: fused-qkv attention ---------------------------------------------

# bias layouts [1|B, 1|H, N, N] of qkv_attention.py
BIASES = {"none": None, "shared": (1, 1), "per_head": (1, 4), "per_batch": (2, 1), "full": (2, 4)}


def _qkv_inputs(seed, b, n, heads, d, bias):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * heads * d))
    bi = None if bias is None else rng.standard_normal((*bias, n, n))
    return qkv, bi


# fp32: both sides sum fp32 products in different orders (~1e-6 relative).
# bf16: the output is rounded to bf16 once, and an fp32 score or P that lands
# an ulp apart can move it by one bf16 ulp of its magnitude (2^-8 relative);
# 2^-7 allows two such steps. Measured max |err| / max |out| here: fp32
# 2.7e-7, bf16 0.
def _tol(dtype, ref):
    return (2.0**-7 if dtype == "bfloat16" else 1e-5) * float(np.max(np.abs(ref)))


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", list(BIASES))
def test_qkv_attention_twin_matches_jax(bias, dtype, mode, monkeypatch):
    from vit_tpu import ops as jops

    jqa = importlib.import_module("vit_tpu.ops.qkv_attention")

    qkv, bi = _qkv_inputs(2, 2, 19, 4, 16, BIASES[bias])
    tb = None if bi is None else _torch(bi)
    out = ops.qkv_attention(_torch(qkv, dtype), 4, tb)
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, 19, 64)
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    jb = None if bi is None else _jnp(bi)
    ref = _np(jops.qkv_attention(_jnp(qkv, dtype), 4, jb))
    np.testing.assert_allclose(_np(out), ref, atol=_tol(dtype, ref), rtol=0)
    twin = _np(jqa.xla_qkv_attention(_jnp(qkv, dtype), 4, jb))
    np.testing.assert_allclose(_np(out), twin, atol=_tol(dtype, twin), rtol=0)


# -- kernels 9 and 10: the W8A8 attention block and MLP ---------------------------


def _qblock_inputs(seed, b, n, dim, heads, d):
    rng = np.random.default_rng(seed)
    wqkv_i8, sqkv = _channelwise(rng.normal(0, 0.08, (dim, 3 * heads * d)))
    wout_i8, sout = _channelwise(rng.normal(0, 0.08, (heads * d, dim)))
    return dict(
        x=rng.standard_normal((b, n, dim)),
        ln_scale=rng.normal(1, 0.1, dim), ln_bias=rng.normal(0, 0.1, dim),
        wqkv_i8=wqkv_i8, sqkv=sqkv, wout_i8=wout_i8, sout=sout,
        bout=rng.normal(0, 0.1, dim),
    )


def _qmlp_inputs(seed, t, dim, f, b=2, std=(0.08, 0.08)):
    rng = np.random.default_rng(seed)
    w1_i8, s1 = _channelwise(rng.normal(0, std[0], (dim, f)))
    w2_i8, s2 = _channelwise(rng.normal(0, std[1], (f, dim)))
    return dict(
        x=rng.standard_normal((b, t, dim)),
        ln_scale=rng.normal(1, 0.1, dim), ln_bias=rng.normal(0, 0.1, dim),
        w1_i8=w1_i8, s1=s1, b1=rng.normal(0, 0.1, f),
        w2_i8=w2_i8, s2=s2, b2=rng.normal(0, 0.1, dim),
    )


def _cast(inp, dtype, conv):
    """x in the stream dtype; int8 codes as they are; the rest fp32."""
    return {k: conv(v, dtype if k == "x" else "float32") for k, v in inp.items()}


QBLOCK_ARGS = ("x", "ln_scale", "ln_bias", "wqkv_i8", "sqkv", "wout_i8", "sout", "bout")
QMLP_ARGS = ("x", "ln_scale", "ln_bias", "w1_i8", "s1", "b1", "w2_i8", "s2", "b2")

# Against vit_tpu's interpret-mode kernels. Where both sides quantize the
# same fp32 values they give the same codes, and the int32 sums are exact;
# a value that lands an ulp apart (the LN and the softmax sum in other
# orders; torch's and XLA's GELU differ in the last bit of a third of their
# values) can cross a rounding boundary and move one code by one step, which
# moves an output by about one quantization step of the row times a weight:
# ~1e-3 of the output's range here. Measured max |err| / max |out|: block
# fp32 6.3e-8, bf16 0 (no code moved); MLP fp32 1.2e-7, bf16 6.7e-6. The bound
# is 1e-2 of the output's range for fp32 (room for a few moved codes), plus
# one bf16 ulp (2^-7 with a second step) for a bf16 output.
def _qtol(dtype, ref):
    return (1e-2 + (2.0**-7 if dtype == "bfloat16" else 0.0)) * float(np.max(np.abs(ref)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,true_n", [(24, None), (24, 17), (50, None)])
def test_quant_attention_block_twin_matches_jax(n, true_n, dtype):
    from vit_tpu.ops import quant_block as jqb

    heads, d = 4, 16
    inp = _qblock_inputs(3, 2, n, 64, heads, d)
    ti, ji = _cast(inp, dtype, _torch), _cast(inp, dtype, _jnp)
    out = ops.quant_attention_block(*(ti[k] for k in QBLOCK_ARGS), heads, true_n=true_n)
    assert out.dtype == ti["x"].dtype and out.shape == ti["x"].shape
    ref = _np(jqb.fused_quant_attention_block(
        *(ji[k] for k in QBLOCK_ARGS), heads, true_n=true_n, interpret=True))
    err = np.abs(_np(out) - ref)
    if true_n is not None:  # the padded rows' values are don't-cares
        err = err[:, :true_n]
    assert err.max() <= _qtol(dtype, ref), err.max()


def test_quant_attention_block_true_n_masks_padded_keys():
    """A padded stream with true_n gives the real rows of the unpadded one
    (vit_tpu's tests/test_quant.py::test_fused_quant_block_kernel_padded_tokens)."""
    inp = _qblock_inputs(4, 2, 17, 64, 4, 16)
    ti = _cast(inp, "float32", _torch)
    args = [ti[k] for k in QBLOCK_ARGS]
    out17 = ops.quant_attention_block(*args, 4)
    x24 = torch.nn.functional.pad(ti["x"], (0, 0, 0, 7))
    out24 = ops.quant_attention_block(x24, *args[1:], 4, true_n=17)
    torch.testing.assert_close(out24[:, :17], out17, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["gelu", "gelu_exact"])
def test_quant_mlp_twin_matches_jax(activation, dtype):
    from vit_tpu.ops import quant_block as jqb

    inp = _qmlp_inputs(5, 50, 64, 128)
    ti, ji = _cast(inp, dtype, _torch), _cast(inp, dtype, _jnp)
    out = ops.quant_mlp(*(ti[k] for k in QMLP_ARGS), activation=activation)
    assert out.dtype == ti["x"].dtype and out.shape == ti["x"].shape
    ref = _np(jqb.fused_quant_mlp(*(ji[k] for k in QMLP_ARGS), activation=activation,
                                  interpret=True))
    assert np.abs(_np(out) - ref).max() <= _qtol(dtype, ref)


def test_quant_mlp_refuses_other_activations():
    ti = _cast(_qmlp_inputs(6, 4, 64, 128), "float32", _torch)
    with pytest.raises(ValueError, match="gelu"):
        ops.quant_mlp(*(ti[k] for k in QMLP_ARGS), activation="hard_swish")


def test_bf16_ulps_counts_ulps_above_the_floor():
    ref = torch.tensor([1.0, 3.0, 0.01, -0.75])
    out = ref + torch.tensor([2.0**-7, 2 * 2.0**-6, 2.0**-9, -(2.0**-8)])
    assert bf16_ulps(out, ref) == 2.0  # 3 + 2 ulps of [2, 4); 0.01 counts in ulps of 1/2
    assert bf16_ulps(ref[:1] + 2.0**-7, ref[:1]) == 1.0


def test_codes_differ_counts_codes_and_scale_ulps():
    q = torch.tensor([[3, -2, 127]], dtype=torch.int8)
    s = torch.tensor([[0.5]])
    assert codes_differ(q, s, q, s) == (0, 0, 0.0)
    q2 = torch.tensor([[3, -1, 126]], dtype=torch.int8)
    assert codes_differ(q, s + 2.0**-24 * 2, q2, s) == (2, 1, 2.0)


# The output check of kernels 9 and 10 against their twins (int8_out_check:
# 2 bf16 ulps of max(|ref|, 1/2), and few values not bitwise equal) must see
# a kernel that skips the activation quantization or rounds the quantized
# rows to bf16 first: the twin with that fault planted against the twin, on
# a bf16 stream.
@pytest.mark.parametrize("fault", INT8_FAULTS)
@pytest.mark.parametrize("kernel", ["quant_attention_block", "quant_mlp"])
def test_int8_bound_sees_planted_faults(kernel, fault):
    if kernel == "quant_mlp":
        ti = _cast(_qmlp_inputs(14, 197, 256, 1024), "bfloat16", _torch)
        args, kw = [ti[k] for k in QMLP_ARGS], {}
    else:
        ti = _cast(_qblock_inputs(14, 2, 197, 256, 4, 64), "bfloat16", _torch)
        args, kw = [ti[k] for k in QBLOCK_ARGS], dict(heads=4)
    ref = quant_block_twin(args, **kw)
    assert int8_out_check(quant_block_twin(args, **kw), ref) == (0.0, 0.0, True)
    with planted_fault(fault):
        bad = quant_block_twin(args, **kw)
    ulps, differ, ok = int8_out_check(bad, ref)
    assert not ok and ulps > 2 and differ > 0.05, (ulps, differ)


def test_int8_dispatch_on_cpu_runs_twins_and_counts_nothing():
    ops.reset_launch_counts()
    qkv, _ = _qkv_inputs(7, 1, 9, 2, 16, None)
    ops.qkv_attention(_torch(qkv), 2)
    ti = _cast(_qblock_inputs(7, 1, 9, 64, 4, 16), "float32", _torch)
    ops.quant_attention_block(*(ti[k] for k in QBLOCK_ARGS), 4)
    tm = _cast(_qmlp_inputs(7, 5, 64, 128), "float32", _torch)
    ops.quant_mlp(*(tm[k] for k in QMLP_ARGS))
    assert sum(ops.launch_counts().values()) == 0


def test_int8_kernel_wrappers_refuse_cpu_tensors():
    qkv, _ = _qkv_inputs(8, 1, 9, 2, 16, None)
    with pytest.raises(ValueError, match="CUDA"):
        tqa.fused_qkv_attention(_torch(qkv, "bfloat16"), 2)
    ti = _cast(_qblock_inputs(8, 1, 9, 64, 4, 16), "bfloat16", _torch)
    with pytest.raises(ValueError, match="CUDA"):
        tqb.fused_quant_attention_block(*(ti[k] for k in QBLOCK_ARGS), 4)
    tm = _cast(_qmlp_inputs(8, 5, 64, 128), "bfloat16", _torch)
    with pytest.raises(ValueError, match="CUDA"):
        tqb.fused_quant_mlp(*(tm[k] for k in QMLP_ARGS))


def test_quant_mlp_on_cpu_ignores_kmajor_and_counts_nothing():
    """On the CPU ``ops.quant_mlp`` runs the twin on the ``[in, out]``
    codes, with or without the K-major copies the kernel would read."""
    ops.reset_launch_counts()
    tm = _cast(_qmlp_inputs(21, 9, 64, 128), "bfloat16", _torch)
    args = [tm[k] for k in QMLP_ARGS]
    plain = ops.quant_mlp(*args)
    km = qmlp_kernel_args(args)
    given = ops.quant_mlp(*args, kmajor=(km[3], km[6]))
    torch.testing.assert_close(given, plain, rtol=0, atol=0)
    torch.testing.assert_close(plain, tqb.reference_quant_mlp(*args), rtol=0, atol=0)
    assert tuple(km[3].shape) == (128, 64) and tuple(km[6].shape) == (64, 128)
    assert sum(ops.launch_counts().values()) == 0


def _hidden_rows(kind, k):
    """fp32 rows of width k whose max lies in the first tile of 128 columns
    in some rows and in the last (partial at k = 208, 528) in the others."""
    gen = torch.Generator().manual_seed(k)
    if kind == "zeros":
        return torch.zeros(6, k)
    if kind == "ties":  # land on halves (chip_smoke.tie_rows); row 1 all zero
        v = tie_rows(gen, 8, k, torch.device("cpu"))
        v[::2, [0, -1]] = v[::2, [-1, 0]]
        return v
    v = torch.randn(8, k, generator=gen) * 3
    v[::2, -1] = 40.0
    v[1::2, 5] = -40.0
    return v


@pytest.mark.parametrize("k", [208, 528])
@pytest.mark.parametrize("kind", ["random", "ties", "zeros"])
def test_quantize_rows_from_partials_is_quantize_rows(kind, k):
    """The twin of kernel 10's hidden quantizer (the row max from partial
    maxes of 128 columns, then the scale, then the codes) gives
    quantize_rows' codes and scales bit for bit."""
    v = _hidden_rows(kind, k)
    parts = tqb.partial_row_amax(v)
    assert tuple(parts.shape) == (v.shape[0], -(-k // tqb.S8_TILE_N))
    last = v[:, (parts.shape[1] - 1) * tqb.S8_TILE_N:]  # 80 or 16 columns
    torch.testing.assert_close(parts[:, -1], last.abs().amax(-1), rtol=0, atol=0)
    codes, scale = tqb.quantize_rows_from_partials(v, parts)
    ref_codes, ref_scale = tq.quantize_rows(v)
    assert codes_differ(codes, scale, ref_codes, ref_scale) == (0, 0, 0.0)
    torch.testing.assert_close(scale, ref_scale, rtol=0, atol=0)


# -- on the card: each kernel against its twin --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# The s8 wgmma GEMM of kernels 9 and 10 (csrc/gemm_s8_sm90.cuh, b K-major [N,
# K]): kernel 9's qkv and out products at ViT-L batch 1 and 8, kernel 10's
# fc1 and fc2 at batch 8 and 128, the 4096 x 1024 x 1024 dot of
# scripts/probe_int8.py, and tails: M 5 and 197, N and K multiples of 16
# that do not fill a 128 x 128 x 128 tile.
S8_SM90_SHAPES = [(197, 1024, 3072), (197, 1024, 1024), (1576, 1024, 3072), (1576, 1024, 1024),
                  (1576, 1024, 4096), (1576, 4096, 1024), (25216, 1024, 4096),
                  (25216, 4096, 1024), (4096, 1024, 1024), (5, 64, 48), (197, 1040, 16),
                  (300, 208, 144), (5, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", S8_SM90_SHAPES)
def test_gemm_s8_sm90_is_exact(cuda, m, k, n):
    """The s8 wgmma GEMM gives torch._int_mm's int32 sums bit for bit (on
    the card from 17 rows, else on the CPU, which takes every shape)."""
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda, dtype=torch.int8)
    b_nk = torch.randint(-127, 128, (n, k), generator=gen, device=cuda, dtype=torch.int8)
    ref = tq.int_mm(a, b_nk.t()) if m > 16 else tq.int_mm(a.cpu(), b_nk.cpu().t()).to(cuda)
    torch.testing.assert_close(tqb.gemm_s8_sm90_i32(a, b_nk), ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", [None, "gelu", "gelu_exact"])
@pytest.mark.parametrize("m,k,n", [(1576, 1024, 4096), (150, 256, 528), (37, 1040, 16)])
def test_gemm_s8_sm90_applies_dequant_bias_and_gelu(cuda, m, k, n, activation):
    """Kernel 10's fc1 alone: ``(acc * s_row) * s_col + bias``, bitwise the
    twin's (``_quant_gemm``); the GELU within INT8_ROWS_TOL of torch's; and
    the partial row maxes by 128-column tile (N tails at 528 and 16) bitwise
    those of its own fp32 output."""
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda, dtype=torch.int8)
    w, s_col = tq.quantize_rows(torch.randn(n, k, generator=gen, device=cuda))
    s_row = torch.rand(m, generator=gen, device=cuda) / 127 / k**0.5
    bias = 0.1 * torch.randn(n, generator=gen, device=cuda)
    h, parts = tqb.gemm_s8_sm90_f32(a, w, s_row, s_col.reshape(-1), bias, activation,
                                    row_max=True)
    dequant = tqb._quant_gemm(a, s_row.view(-1, 1), w.t(), s_col)
    pre = dequant + bias
    if activation is None:
        torch.testing.assert_close(h, pre, rtol=0, atol=0)
    else:
        ref = tqb._activate(pre, activation)
        rel = ((h - ref).abs().max() / ref.abs().max()).item()
        assert rel <= INT8_ROWS_TOL["hidden"], rel
    torch.testing.assert_close(parts, tqb.partial_row_amax(h), rtol=0, atol=0)
    plain = tqb.gemm_s8_sm90_f32(a, w, s_row, s_col.reshape(-1))  # no bias, no activation
    torch.testing.assert_close(plain, dequant, rtol=0, atol=0)


@pytest.mark.cuda
def test_gemm_s8_sm90_refuses_what_tma_cannot_read(cuda):
    a = torch.zeros(32, 40, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 16"):
        tqb.gemm_s8_sm90_i32(a, torch.zeros(32, 40, device=cuda, dtype=torch.int8))
    a = torch.zeros(32 * 64 + 1, device=cuda, dtype=torch.int8)[1:].view(32, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tqb.gemm_s8_sm90_i32(a, torch.zeros(32, 64, device=cuda, dtype=torch.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["quantize_rows", "quantize_channelwise"])
def test_quantizers_on_the_card_match_the_cpu(cuda, fn):
    """Bit for bit (the CPU's equal JAX's: test_quantizers_match_jax). On
    the card PyTorch divides by a Python number through its reciprocal, an
    ulp off for ~4% of scales; the port divides by a tensor."""
    x = torch.randn(512, 1024, generator=torch.Generator().manual_seed(16)) * 3
    codes, scale = getattr(tq, fn)(x.to(cuda))
    ref_codes, ref_scale = getattr(tq, fn)(x)
    torch.testing.assert_close(scale.cpu(), ref_scale, rtol=0, atol=0)
    torch.testing.assert_close(codes.cpu(), ref_codes, rtol=0, atol=0)


@pytest.mark.cuda
def test_quant_rows_kernel_rounds_half_to_even(cuda):
    """The kernels' row quantizer gives quantize_rows' codes and scales bit
    for bit on rows whose values land on halves."""
    v = tie_rows(torch.Generator(device=cuda).manual_seed(15), 16, 1024, cuda)
    assert codes_differ(*tqb.quant_rows_f32(v), *tq.quantize_rows(v)) == (0, 0, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [208, 528, 4096])
@pytest.mark.parametrize("kind", ["random", "ties", "zeros"])
def test_quant_rows_parts_kernel_is_quantize_rows(cuda, kind, k):
    """Kernel 10's hidden quantizer, the row max taken from partials of 128
    columns, gives quantize_rows' codes and scales bit for bit."""
    v = _hidden_rows(kind, k).to(cuda)
    got = tqb.quant_rows_parts_f32(v, tqb.partial_row_amax(v))
    assert codes_differ(*got, *tq.quantize_rows(v)) == (0, 0, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", list(BIASES))
@pytest.mark.parametrize("b,n,heads,d", [(3, 197, 4, 64), (2, 19, 4, 16), (1, 1024, 2, 128)])
def test_qkv_attention_kernel_matches_twin(cuda, bias, b, n, heads, d):
    shape = BIASES[bias]
    if shape is not None:
        shape = (b if shape[0] > 1 else 1, heads if shape[1] > 1 else 1)
    qkv, bi = _qkv_inputs(9, b, n, heads, d, shape)
    t = _torch(qkv, "bfloat16", cuda)
    tb = None if bi is None else _torch(bi, "float32", cuda)
    before = ops.launch_counts()["qkv_attention"]
    out = ops.qkv_attention(t, heads, tb)
    torch.cuda.synchronize()
    assert ops.launch_counts()["qkv_attention"] == before + 1
    with ops.force_backend("torch"):
        ref = ops.qkv_attention(t, heads, tb)
    assert ops.launch_counts()["qkv_attention"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, heads * d)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("n,true_n,heads,d", [(197, None, 4, 64), (224, 197, 4, 64), (48, 37, 4, 64)])
def test_quant_attention_block_kernel_matches_twin(cuda, n, true_n, heads, d):
    """Stage by stage (chip_smoke.check_quant_block): the codes, the
    epilogues, and the output within 2 bf16 ulps of the twin's."""
    inp = _qblock_inputs(10, 3, n, 256, heads, d)
    t = _cast(inp, "bfloat16", lambda a, dt: _torch(a, dt, cuda))
    args = [t[k] for k in QBLOCK_ARGS]
    before = ops.launch_counts()["quant_attention_block"]
    out, _, _, fails = check_quant_block("quant_attention_block", args, heads=heads, true_n=true_n)
    assert ops.launch_counts()["quant_attention_block"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == t["x"].shape
    assert not fails, fails


@pytest.mark.cuda
@pytest.mark.parametrize("n,heads,d", [(197, 16, 64), (48, 4, 64), (40, 4, 32), (300, 2, 64)])
def test_quant_attention_rows_are_fp32_on_the_sm90_core(cuda, n, heads, d):
    """Kernel 9's attention stage (the register-resident core with fp32 rows
    out: ViT-L's 197 tokens, 4 key tiles, the streamed variant at Dh 32 and
    past 208 keys) against the twin's on the kernel's own qkv."""
    inp = _qblock_inputs(17, 2, n, heads * d, heads, d)
    t = _cast(inp, "bfloat16", lambda a, dt: _torch(a, dt, cuda))
    args = [t[k] for k in QBLOCK_ARGS]
    st = {}
    tqb.fused_quant_attention_block(*qblock_kernel_args(args), heads, intermediates=st)
    torch.cuda.synchronize()
    assert st["attn"].dtype == torch.float32
    ref = tqb._attention_f32(st["qkv"].view(2, n, -1), heads, d**-0.5).reshape(2 * n, -1)
    rel = ((st["attn"] - ref).abs().max() / ref.abs().max()).item()
    assert rel <= INT8_ROWS_TOL["attention"], rel


@pytest.mark.cuda
def test_quant_attention_block_sees_wout_in_the_wrong_layout(cuda):
    """``wout`` is square at these widths (and at ViT-L's), so vit_tpu's
    [in, out] codes pass the K-major shape check: fed where [out, in]
    belongs, the output must fail kernel 9's bound."""
    t = _cast(_qblock_inputs(18, 2, 197, 256, 4, 64), "bfloat16", lambda a, dt: _torch(a, dt, cuda))
    args = [t[k] for k in QBLOCK_ARGS]
    bad = qblock_kernel_args(args)
    bad[5] = args[5]
    out = tqb.fused_quant_attention_block(*bad, 4)
    ulps, differ, ok = int8_out_check(out, quant_block_twin(args, heads=4))
    assert not ok and ulps > 2 * 8.0, (ulps, differ)


@pytest.mark.cuda
def test_quant_attention_block_refuses_wqkv_in_the_wrong_layout(cuda):
    t = _cast(_qblock_inputs(19, 1, 17, 64, 4, 16), "bfloat16", lambda a, dt: _torch(a, dt, cuda))
    with pytest.raises(TypeError, match="K-major"):
        tqb.fused_quant_attention_block(*(t[k] for k in QBLOCK_ARGS), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("activation", ["gelu", "gelu_exact"])
def test_quant_mlp_kernel_matches_twin(cuda, activation, dtype):
    t = _cast(_qmlp_inputs(11, 197, 256, 1024), dtype, lambda a, dt: _torch(a, dt, cuda))
    args = [t[k] for k in QMLP_ARGS]
    before = ops.launch_counts()["quant_mlp"]
    out, _, _, fails = check_quant_block("quant_mlp", args, activation=activation)
    assert ops.launch_counts()["quant_mlp"] == before + 1
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    assert not fails, fails


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b", [1, 8, 128])
def test_quant_mlp_kernel_matches_twin_at_vit_l(cuda, b, dtype):
    """Stage by stage at ViT-L's widths (1024 -> 4096) and 197 tokens: the
    codes and scales bitwise, fc1's partial row maxes bitwise, the output
    within int8_out_check's bound of the twin's. The weights are drawn at a
    layer's own scale, N(0, 1 / fan_in), as chip_smoke draws them: the small
    tests' 0.08 would make the output's std ~8 at these widths, and a row
    whose LN codes moved a step (the LN sums in another order than the
    twin's) then carries more than INT8_ULPS of noise at values near
    INT8_FLOOR."""
    inp = _qmlp_inputs(22, 197, 1024, 4096, b=b, std=(1024**-0.5, 4096**-0.5))
    t = _cast(inp, dtype, lambda a, dt: _torch(a, dt, cuda))
    out, _, _, fails = check_quant_block("quant_mlp", [t[k] for k in QMLP_ARGS])
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    assert not fails, fails


@pytest.mark.cuda
@pytest.mark.parametrize("dim,f", [(208, 528), (256, 1040), (1040, 208)])
def test_quant_mlp_kernel_matches_twin_at_n_tails(cuda, dim, f):
    """Widths that leave a partial last tile of 128 columns in fc1 (F) and
    in fc2 (D)."""
    t = _cast(_qmlp_inputs(23, 37, dim, f), "bfloat16", lambda a, dt: _torch(a, dt, cuda))
    out, _, _, fails = check_quant_block("quant_mlp", [t[k] for k in QMLP_ARGS])
    assert out.shape == t["x"].shape
    assert not fails, fails


@pytest.mark.cuda
def test_quant_mlp_sees_w2_in_the_wrong_layout(cuda):
    """At D = F, vit_tpu's [in, out] ``w2`` passes the K-major shape check:
    fed where [out, in] belongs, the output must fail kernel 10's bound."""
    t = _cast(_qmlp_inputs(24, 197, 256, 256), "bfloat16", lambda a, dt: _torch(a, dt, cuda))
    args = [t[k] for k in QMLP_ARGS]
    bad = qmlp_kernel_args(args)
    bad[6] = args[6]
    out = tqb.fused_quant_mlp(*bad)
    ulps, differ, ok = int8_out_check(out, quant_block_twin(args))
    assert not ok and ulps > 2 * 8.0, (ulps, differ)


@pytest.mark.cuda
def test_quant_mlp_refuses_w1_in_the_wrong_layout(cuda):
    t = _cast(_qmlp_inputs(25, 17, 64, 128), "bfloat16", lambda a, dt: _torch(a, dt, cuda))
    with pytest.raises(TypeError, match="K-major"):
        tqb.fused_quant_mlp(*(t[k] for k in QMLP_ARGS))


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["x", "w1", "b2"])
def test_quant_mlp_refuses_a_misaligned_operand(cuda, operand):
    """Every operand of kernel 10 must start on a 16-byte boundary (its TMA
    loads and vector loads); a view that starts inside its storage is
    refused before any launch."""
    t = _cast(_qmlp_inputs(26, 17, 64, 128), "bfloat16", lambda a, dt: _torch(a, dt, cuda))
    args = qmlp_kernel_args([t[k] for k in QMLP_ARGS])
    i = QMLP_ARGS.index(operand + ("_i8" if operand.startswith("w") else ""))
    a = args[i]
    shifted = torch.empty(a.numel() + 16, dtype=a.dtype, device=cuda)[1:1 + a.numel()]
    args[i] = shifted.view(a.shape).copy_(a)
    before = ops.launch_counts()["quant_mlp"]
    with pytest.raises(ValueError, match="16-byte"):
        tqb.fused_quant_mlp(*args)
    assert ops.launch_counts()["quant_mlp"] == before


@pytest.mark.cuda
def test_int8_kernels_refuse_fp32_attention(cuda):
    """Neither kernel refuses an fp32 attention any longer: kernel 3 runs
    fp32 qkv on its fp32 route (the fp32 core, csrc/attention_f32.cuh) and
    kernel 9 an fp32 stream, each launch counted on its fp32 route, kernel
    3 within 1e-4 of the twin's largest output and kernel 9 within
    kernel_tol (at dim 256: the twin's torch._int_mm refuses K = 64 on the
    card)."""
    qkv, _ = _qkv_inputs(12, 1, 17, 2, 16, None)
    t32 = _torch(qkv, "float32", cuda)
    before = ops.fp32_launch_counts()["qkv_attention"]
    out = ops.qkv_attention(t32, 2)
    assert ops.fp32_launch_counts()["qkv_attention"] == before + 1
    with ops.force_backend("torch"):
        ref = ops.qkv_attention(t32, 2)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    t = _cast(_qblock_inputs(12, 1, 17, 256, 4, 64), "float32", lambda a, dt: _torch(a, dt, cuda))
    args = [t[k] for k in QBLOCK_ARGS]
    before = ops.fp32_launch_counts()["quant_attention_block"]
    out = ops.quant_attention_block(*args, 4)
    assert ops.fp32_launch_counts()["quant_attention_block"] == before + 1
    ref = quant_block_twin(args, 4)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= kernel_tol(ref, args[0], out.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n,true_n,heads,d", [(197, None, 4, 64), (224, 197, 4, 64), (48, 37, 4, 32)])
def test_quant_attention_block_fp32_stream_matches_twin(cuda, n, true_n, heads, d):
    """Kernel 9 on an fp32 stream stage by stage (chip_smoke.
    check_quant_block_f32): the LN codes, qkv in fp32 within an ulp of the
    epilogue, the fp32 attention rows within 1e-4 of the twin's, the codes
    and the output epilogue bitwise, each stage's planted fault failing its
    bound; one launch counted on the fp32 route."""
    t = _cast(_qblock_inputs(19, 3, n, 256, heads, d), "float32",
              lambda a, dt: _torch(a, dt, cuda))
    before = ops.fp32_launch_counts()["quant_attention_block"]
    check_quant_block_f32(f"n {n}", [t[k] for k in QBLOCK_ARGS], heads, true_n)
    assert ops.fp32_launch_counts()["quant_attention_block"] == before + 1


@pytest.mark.cuda
def test_quant_vit_fp32_stream_at_batch_8(cuda):
    """QuantViT with dtype None (vit_tpu's default) at batch 8 in the auto
    mode: kernels 9 and 10 on the fp32 stream, once each a layer, every
    launch on its fp32 route; held as chip_smoke holds the int8 model: each
    layer through the kernels within INT8_LAYER_DIFFER / INT8_LAYER_ULPS of
    the same layer through its twins on the same input, and the logits
    within INT8_FP32_TOL of the plain fp32 ViT. (A code that crosses a
    rounding boundary moves by a whole step, so the logits are not held to
    DOMAIN_F32_E2E of the twins' path.)"""
    from vit_tpu_torch.models import ViT
    from vit_tpu_torch.utils import quantize_vit

    torch.manual_seed(20)
    model = ViT(image_size=64, patch_size=16, num_classes=10, dim=256, depth=2, heads=4,
                mlp_dim=512, device=cuda)
    qm = quantize_vit(model)
    assert qm.dtype is None
    img = _torch(np.random.default_rng(20).standard_normal((8, 64, 64, 3)), device=cuda)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = qm(img)
        got = {k: v for k, v in ops.fp32_launch_counts().items() if v}
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        h = qm.embed(img)
        for blk in qm.encoder.blocks:
            layer = lambda h: blk(h, "w8a8_kernel", torch.float32, qm.norm_eps, qm.activation)
            k = layer(h)
            with ops.force_backend("torch"):
                h = layer(h)
            ulps, differ, _ = int8_out_check(k, h)
            assert differ <= INT8_LAYER_DIFFER and ulps <= INT8_LAYER_ULPS, (differ, ulps)
        with ops.force_backend("torch"):
            ref32 = model(img)
    assert got == launched == {"quant_attention_block": 2, "quant_mlp": 2}
    assert out.dtype == torch.float32
    assert (out - ref32).abs().max().item() <= INT8_FP32_TOL


@pytest.mark.cuda
def test_int8_kernels_are_batch_invariant(cuda):
    """No split-K and no cross-row reduction but each row's own: a
    sample's rows come out bitwise the same alone as inside a batch."""
    qkv, _ = _qkv_inputs(13, 9, 197, 4, 64, None)
    t = _torch(qkv, "bfloat16", cuda)
    full = ops.qkv_attention(t, 4)
    torch.testing.assert_close(ops.qkv_attention(t[4:5].contiguous(), 4), full[4:5], rtol=0, atol=0)
    a = _cast(_qblock_inputs(13, 9, 197, 256, 4, 64), "bfloat16", lambda v, dt: _torch(v, dt, cuda))
    args = [a[k] for k in QBLOCK_ARGS]
    full = ops.quant_attention_block(*args, 4)
    alone = ops.quant_attention_block(args[0][4:5].contiguous(), *args[1:], 4)
    torch.testing.assert_close(alone, full[4:5], rtol=0, atol=0)
    m = _cast(_qmlp_inputs(13, 197, 256, 1024), "bfloat16", lambda v, dt: _torch(v, dt, cuda))
    m["x"] = m["x"].reshape(2 * 197, 256)
    full = ops.quant_mlp(*(m[k] for k in QMLP_ARGS))
    alone = ops.quant_mlp(m["x"][200:201].contiguous(), *(m[k] for k in QMLP_ARGS[1:]))
    torch.testing.assert_close(alone, full[200:201], rtol=0, atol=0)


# -- kernel 3 on the register-resident core (csrc/attention_core_sm90.cuh) -------


def _sm90_warps(b, h, nq, nk, d, dv):
    """Warps a block of kernels 3 and 4 take at this shape on this card."""
    from vit_tpu_torch.ops import _build

    return _build.load_library().vt_attention_sm90_warps(b, h, nq, nk, d, dv)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,heads,d,bias", [
    (2, 1, 4, 64, None), (2, 4, 4, 64, (1, 1)), (2, 16, 4, 64, (2, 4)), (2, 64, 4, 64, (1, 4)),
    (2, 197, 4, 64, (2, 1)), (2, 257, 4, 64, None), (2, 257, 2, 128, (2, 2)),
    (3, 197, 2, 16, None), (1, 1024, 1, 64, (1, 1)), (2, 100, 3, 48, (2, 3)),
])
def test_qkv_attention_kernel_edge_shapes(cuda, b, n, heads, d, bias):
    """Nk (= n) 1 to 1024 on either side of the core's resident and streamed
    variants (208 keys at D 64), widths 16 to 128, the bias patterns."""
    qkv, bi = _qkv_inputs(17, b, n, heads, d, bias)
    t = _torch(qkv, "bfloat16", cuda)
    tb = None if bi is None else _torch(bi, "float32", cuda)
    out = tqa.fused_qkv_attention(t, heads, tb)
    ref = tqa.xla_qkv_attention(t, heads, tb)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
def test_qkv_attention_kernel_at_vit_l(cuda, b):
    """ViT-L's 197 tokens, 16 heads of 64: batch 1 (the int8 w8 bucket)
    and 8."""
    qkv, _ = _qkv_inputs(18, b, 197, 16, 64, None)
    t = _torch(qkv, "bfloat16", cuda)
    out = tqa.fused_qkv_attention(t, 16)
    ref = tqa.xla_qkv_attention(t, 16)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
def test_qkv_attention_kernel_divides_exactly_past_e_minus_69(cuda):
    """A bias that puts scores 80 below their row's max (e ~ 1.8e-35): the
    warp leaves the hoisted-reciprocal division for __fdiv_rn, and the
    output stays within the bound of the twin."""
    qkv, bi = _qkv_inputs(19, 2, 64, 4, 64, (1, 4))
    bi[..., ::3] -= 80.0
    t = _torch(qkv, "bfloat16", cuda)
    tb = _torch(bi, "float32", cuda)
    out = tqa.fused_qkv_attention(t, 4, tb)
    ref = tqa.xla_qkv_attention(t, 4, tb)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
def test_qkv_attention_kernel_is_batch_invariant_across_tile_choices(cuda):
    """A sample alone (blocks of 5 warps) and inside a batch of 32 (blocks
    of 7) come out bitwise equal: a row's arithmetic does not depend on the
    tile choice."""
    assert _sm90_warps(1, 16, 197, 197, 64, 64) != _sm90_warps(32, 16, 197, 197, 64, 64)
    qkv, _ = _qkv_inputs(20, 32, 197, 16, 64, None)
    t = _torch(qkv, "bfloat16", cuda)
    full = tqa.fused_qkv_attention(t, 16)
    for i in (0, 17, 31):
        alone = tqa.fused_qkv_attention(t[i:i + 1].contiguous(), 16)
        torch.testing.assert_close(alone, full[i:i + 1], rtol=0, atol=0)
