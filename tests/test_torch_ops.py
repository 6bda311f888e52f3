"""Port kernels: the plain PyTorch twins against vit_tpu on the CPU, and the
Hopper kernels against their twins on the card.

The same numpy inputs (``default_rng(seed)``) go through both packages. JAX
is imported inside the tests that use it: the machine with the card has no
JAX, and runs this file's ``cuda`` tests with
``python -m pytest --noconftest -m cuda tests/test_torch_ops.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import GEMM_ROWS, GEMM_SHAPES, gemm_bound, kernel_tol
from vit_tpu_torch import ops
from vit_tpu_torch.ops import block_attention as tba

# ops/__init__ exports a function of the module's own name
tfm = importlib.import_module("vit_tpu_torch.ops.fused_mlp")

torch.set_num_threads(2)

# (x dtype, weight dtype) of the repo's precision configs.
PRECISIONS = {
    "fp32": ("float32", "float32"),
    "bf16": ("bfloat16", "bfloat16"),
    "mixed": ("float32", "bfloat16"),  # fp32 residual stream, bf16 GEMM operands
}


def _torch(a, dtype="float32", device="cpu"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=getattr(torch, dtype))


def _jnp(a, dtype="float32"):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dtype))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _attn_inputs(seed, b, n, dim, heads, d):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, n, dim)),
        ln_scale=1.0 + 0.1 * rng.standard_normal(dim),
        ln_bias=0.1 * rng.standard_normal(dim),
        wqkv=rng.standard_normal((dim, 3 * heads * d)) / np.sqrt(dim),
        wout=rng.standard_normal((heads * d, dim)) / np.sqrt(heads * d),
        bout=0.1 * rng.standard_normal(dim),
    )


def _mlp_inputs(seed, t, dim, f):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((2, t, dim)),
        w1=rng.standard_normal((dim, f)) / np.sqrt(dim),
        b1=0.1 * rng.standard_normal(f),
        w2=rng.standard_normal((f, dim)) / np.sqrt(f),
        b2=0.1 * rng.standard_normal(dim),
        ln_scale=1.0 + 0.1 * rng.standard_normal(dim),
        ln_bias=0.1 * rng.standard_normal(dim),
    )


def _cast(inp, precision, conv):
    """Inputs in a precision config: x in the stream dtype, GEMM weights in
    the weight dtype, biases and LN parameters fp32."""
    xd, wd = PRECISIONS[precision]
    weights = {"wqkv", "wout", "w1", "w2"}
    return {
        k: conv(v, xd if k == "x" else wd if k in weights else "float32")
        for k, v in inp.items()
    }


# Tolerances against JAX on the CPU. fp32: both sides are fp32 products
# summed in different orders (~1e-6 relative). bf16 outputs: the two sides'
# fp32 sums can round an intermediate (qkv, P, the MLP hidden) to neighbouring
# bf16 values, which moves an output by at most about one bf16 ulp of its
# magnitude (2^-8 relative; 2^-7 allows for two such steps).
def _tol(precision, ref):
    scale = float(np.max(np.abs(ref)))
    if precision == "bf16":
        return 2.0**-7 * scale
    if precision == "mixed":
        return 2e-3 * scale
    return 1e-5 * scale


ATTN_CASES = {
    "plain": dict(n=17, true_n=None, block_tokens=None),
    "padded": dict(n=24, true_n=17, block_tokens=None),
    "packed": dict(n=40, true_n=17, block_tokens=20),
}


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_block_twin_matches_jax(precision, case):
    from vit_tpu.ops import block_attention as jba

    c = ATTN_CASES[case]
    heads, d = 4, 16
    inp = _attn_inputs(0, 2, c["n"], 64, heads, d)
    masks = dict(true_n=c["true_n"], block_tokens=c["block_tokens"])
    ti = _cast(inp, precision, _torch)
    ji = _cast(inp, precision, _jnp)
    args = ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")
    out = tba.xla_attention_block(*(ti[k] for k in args), heads, d**-0.5, **masks)
    assert out.dtype == ti["x"].dtype and out.shape == ti["x"].shape
    ref = _np(jba.xla_attention_block(*(ji[k] for k in args), heads, d**-0.5, **masks))
    np.testing.assert_allclose(_np(out), ref, atol=_tol(precision, ref), rtol=0)
    if precision != "fp32" and case == "plain":
        return  # the interpret-mode kernel is checked at fp32 and on the masked cases
    pallas = _np(jba.fused_attention_block(*(ji[k] for k in args), heads, interpret=True, **masks))
    np.testing.assert_allclose(_np(out), pallas, atol=_tol(precision, pallas), rtol=0)


MLP_VARIANTS = {
    "ln": dict(ln=True, residual=False),  # FeedForward on the main path
    "res": dict(ln=False, residual=True),
    "ln_res": dict(ln=True, residual=True),
}


@pytest.mark.parametrize("activation", ["gelu", "gelu_exact", "hard_swish"])
@pytest.mark.parametrize("variant", list(MLP_VARIANTS))
def test_mlp_twin_matches_jax(activation, variant):
    jfm = importlib.import_module("vit_tpu.ops.fused_mlp")

    v = MLP_VARIANTS[variant]
    inp = _mlp_inputs(1, 24, 64, 128)
    if not v["ln"]:
        inp.pop("ln_scale"), inp.pop("ln_bias")
    kw = dict(activation=activation, residual=v["residual"])
    for precision in PRECISIONS:
        ti = _cast(inp, precision, _torch)
        ji = _cast(inp, precision, _jnp)
        out = tfm.reference_mlp(**ti, **kw)
        ref = _np(jfm.reference_mlp(**ji, **kw))
        np.testing.assert_allclose(_np(out), ref, atol=_tol(precision, ref), rtol=0)
    ji = _cast(inp, "fp32", _jnp)
    out = tfm.reference_mlp(**_cast(inp, "fp32", _torch), **kw)
    pallas = _np(jfm.fused_mlp(**ji, **kw, interpret=True))
    np.testing.assert_allclose(_np(out), pallas, atol=_tol("fp32", pallas), rtol=0)


def test_patchify_bit_exact():
    from vit_tpu.ops.patch_embed import patchify as jpatchify

    img = np.random.default_rng(2).standard_normal((2, 32, 24, 3)).astype(np.float32)
    out = ops.patchify(torch.from_numpy(img), 8)
    ref = np.asarray(jpatchify(_jnp(img), 8))
    assert out.shape == (2, 12, 192)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_dispatch_cpu_runs_twin_and_counts_nothing():
    ops.reset_launch_counts()
    inp = _attn_inputs(3, 1, 17, 64, 4, 16)
    t = {k: _torch(v) for k, v in inp.items()}
    out = ops.attention_block(*t.values(), 4)
    ref = tba.xla_attention_block(*t.values(), 4, 16**-0.5)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    m = _mlp_inputs(3, 5, 64, 128)
    tm = {k: _torch(v) for k, v in m.items()}
    torch.testing.assert_close(ops.mlp(**tm), tfm.reference_mlp(**tm), rtol=0, atol=0)
    assert ops.launch_counts() == dict.fromkeys(
        ("attention_block", "fused_mlp", "qkv_attention", "quant_attention_block", "quant_mlp",
         "talking_heads_block", "reattention_block", "flash_attention", "window_attention_block",
         "flash_attention_kv_blocked"),
        0,
    )


def test_force_backend_takes_only_torch():
    with pytest.raises(ValueError):
        with ops.force_backend("cuda"):
            pass


def test_kernel_wrappers_refuse_cpu_tensors():
    t = {k: _torch(v) for k, v in _attn_inputs(4, 1, 8, 32, 2, 16).items()}
    with pytest.raises(ValueError, match="CUDA"):
        tba.fused_attention_block(*t.values(), 2)
    m = {k: _torch(v) for k, v in _mlp_inputs(4, 8, 32, 64).items()}
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp(**m)


def test_operands_must_start_on_16_byte_boundaries():
    """The attention block's TMA loads need 16-byte aligned operands; a view
    that starts inside its storage is refused before any launch."""
    w = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16)
    tba._require_aligned(wqkv=w[:4096].view(64, 64), bout=torch.zeros(64))
    with pytest.raises(ValueError, match="wqkv does not start on a 16-byte boundary"):
        tba._require_aligned(wqkv=w[1:4097].view(64, 64))
    with pytest.raises(ValueError, match="bout"):
        tba._require_aligned(wqkv=w[8:4104].view(64, 64), bout=torch.zeros(68)[2:66])


# (D, F) of each model's MLP -> the GEMM both of kernel 2's products run on
# (fused_mlp.gemm_route, the mirror of csrc/fused_mlp.cu mlp_route_wgmma),
# pinned: ViT-L; Twins-SVT's four stages (x4); CaiT and DeepViT; T2T's
# encoder; T2T's tokenizer widths, whose rows are not 16-byte aligned.
MLP_ROUTES = [
    (1024, 4096, "wgmma"), (64, 256, "wgmma"), (128, 512, "wgmma"), (256, 1024, "wgmma"),
    (512, 2048, "wgmma"), (1024, 2048, "wgmma"), (512, 512, "wgmma"),
    (147, 147, "wmma"), (1323, 1323, "wmma"), (1024, 4100, "wmma"), (1028, 4096, "wmma"),
]


@pytest.mark.parametrize("dim,f,route", MLP_ROUTES)
def test_mlp_gemm_route_is_pinned(dim, f, route):
    assert tfm.gemm_route(dim, f) == route


def test_gemm_sm90_refuses_cpu_tensors():
    a, b = torch.zeros(4, 64, dtype=torch.bfloat16), torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tba.gemm_sm90(a, b)


# -- on the card: each kernel against its twin --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "mixed"])
@pytest.mark.parametrize(
    "n,true_n,block_tokens,heads,d",
    [(197, None, None, 4, 64), (208, 197, None, 4, 64), (80, 37, 40, 2, 64),
     (1024, None, None, 2, 128), (5, None, None, 2, 16)],
)
def test_attention_block_kernel_matches_twin(cuda, precision, n, true_n, block_tokens, heads, d):
    inp = _attn_inputs(5, 3, n, 256, heads, d)
    t = _cast(inp, precision, lambda a, dt: _torch(a, dt, cuda))
    args = [t[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
    masks = dict(true_n=true_n, block_tokens=block_tokens)
    before = ops.launch_counts()["attention_block"]
    out = ops.attention_block(*args, heads, **masks)
    torch.cuda.synchronize()
    assert ops.launch_counts()["attention_block"] == before + 1
    with ops.force_backend("torch"):
        ref = ops.attention_block(*args, heads, **masks)
    assert ops.launch_counts()["attention_block"] == before + 1
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, t["x"], out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "mixed"])
@pytest.mark.parametrize("activation", ["gelu", "gelu_exact", "hard_swish"])
@pytest.mark.parametrize("variant", list(MLP_VARIANTS))
def test_mlp_kernel_matches_twin(cuda, precision, activation, variant):
    v = MLP_VARIANTS[variant]
    inp = _mlp_inputs(6, 197, 256, 1024)
    if not v["ln"]:
        inp.pop("ln_scale"), inp.pop("ln_bias")
    t = _cast(inp, precision, lambda a, dt: _torch(a, dt, cuda))
    kw = dict(activation=activation, residual=v["residual"])
    before = ops.launch_counts()["fused_mlp"]
    out = ops.mlp(**t, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_mlp"] == before + 1
    with ops.force_backend("torch"):
        ref = ops.mlp(**t, **kw)
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    err = (out.float() - ref.float()).abs().max().item()
    base = t["x"] if v["residual"] else None
    assert err <= kernel_tol(ref, base, out.dtype), err


@pytest.mark.cuda
def test_kernels_refuse_fp32_weights(cuda):
    """Kernels 1 and 2 refused fp32 weights; both now run them on their fp32
    routes (kernel 1: csrc/gemm_f32.cuh and the fp32 core
    csrc/attention_f32.cuh; kernel 2: csrc/gemm_f32.cuh), each launch
    counted there, within 1e-4 of the twin's largest change
    (tests/test_torch_fp32_routes.py and tests/test_torch_head_mix_domain.py
    hold them at the model shapes)."""
    t = _cast(_attn_inputs(7, 1, 17, 64, 4, 16), "fp32", lambda a, dt: _torch(a, dt, cuda))
    before = ops.fp32_launch_counts()["attention_block"]
    out = ops.attention_block(*t.values(), 4)
    assert ops.fp32_launch_counts()["attention_block"] == before + 1
    with ops.force_backend("torch"):
        ref = ops.attention_block(*t.values(), 4)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-4 * (ref - t["x"]).abs().max().item()
    m = _cast(_mlp_inputs(7, 8, 64, 128), "fp32", lambda a, dt: _torch(a, dt, cuda))
    before = ops.fp32_launch_counts()["fused_mlp"]
    out = ops.mlp(**m)
    assert ops.fp32_launch_counts()["fused_mlp"] == before + 1
    with ops.force_backend("torch"):
        ref = ops.mlp(**m)
    assert (out - ref).abs().max().item() <= 1e-4 * (ref - m["x"]).abs().max().item()


@pytest.mark.cuda
def test_kernels_are_batch_invariant(cuda):
    """No split-K and no cross-row reduction: a sample's rows come out
    bitwise the same alone as inside a batch."""
    a = _cast(_attn_inputs(8, 9, 197, 256, 4, 64), "bf16", lambda v, dt: _torch(v, dt, cuda))
    args = [a[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
    full = ops.attention_block(*args, 4)
    alone = ops.attention_block(args[0][4:5].contiguous(), *args[1:], 4)
    torch.testing.assert_close(alone, full[4:5], rtol=0, atol=0)
    m = _cast(_mlp_inputs(8, 197, 256, 1024), "bf16", lambda v, dt: _torch(v, dt, cuda))
    m["x"] = m["x"].reshape(2 * 197, 256)
    full = ops.mlp(**m)
    alone = ops.mlp(**{**m, "x": m["x"][200:201].contiguous()})
    torch.testing.assert_close(alone, full[200:201], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", GEMM_ROWS)
@pytest.mark.parametrize("n,k", GEMM_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_sm90_matches_fp32_product(cuda, m, n, k, out_dtype):
    """The attention block's wgmma GEMM against an fp32 product of the same
    bf16 operands, at its tail shapes (rows past M, a partial N tile, K not
    a multiple of the 64-wide K slice), within chip_smoke's GEMM bound."""
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    b = (torch.randn(k, n, generator=gen, device=cuda) / k**0.5).bfloat16()
    bias = 0.1 * torch.randn(n, generator=gen, device=cuda)
    res = torch.randn(m, n, generator=gen, device=cuda).to(out_dtype)
    out = tba.gemm_sm90(a, b, bias, res, out_dtype)
    ref = a.float() @ b.float() + bias + res.float()
    assert out.dtype == out_dtype and out.shape == (m, n)
    err = (out.float() - ref).abs().max().item()
    assert err <= gemm_bound(a, b, ref), err


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_sm90_adds_bias_before_residual(cuda, out_dtype):
    """C = (A @ B + bias) + residual in fp32: with A @ B = 1, bias = 2^-24
    and residual = -1, 1 + 2^-24 rounds to 1 (a tie, to even) and C is 0;
    any other order leaves 2^-24."""
    m, n, k = 130, 136, 72
    a = torch.zeros(m, k, device=cuda, dtype=torch.bfloat16)
    a[:, 0] = 1
    b = torch.zeros(k, n, device=cuda, dtype=torch.bfloat16)
    b[0] = 1
    bias = torch.full((n,), 2.0**-24, device=cuda)
    res = torch.full((m, n), -1.0, device=cuda, dtype=out_dtype)
    out = tba.gemm_sm90(a, b, bias, res, out_dtype)
    torch.testing.assert_close(out, torch.zeros_like(out), rtol=0, atol=0)
    out = tba.gemm_sm90(a, b, bias, None, out_dtype)  # the bias alone still shows
    assert (out.float() == 1.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "mixed"])
def test_attention_block_is_batch_invariant_at_vit_l_width(cuda, precision):
    """At ViT-L's width (dim 1024, 16 heads of 64, 197 tokens) sample 4
    alone comes out bitwise as it does inside a batch of 9: the GEMMs'
    tiles and the attention plan change with the batch, a row's sums do
    not."""
    a = _cast(_attn_inputs(9, 9, 197, 1024, 16, 64), precision, lambda v, dt: _torch(v, dt, cuda))
    args = [a[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
    full = ops.attention_block(*args, 16)
    alone = ops.attention_block(args[0][4:5].contiguous(), *args[1:], 16)
    torch.testing.assert_close(alone, full[4:5], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,f,route", MLP_ROUTES)
def test_mlp_gemm_route_mirrors_the_kernels(cuda, dim, f, route):
    from vit_tpu_torch.ops import _build

    assert _build.load_library().vt_fused_mlp_route_wgmma(dim, f) == int(route == "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "mixed"])
@pytest.mark.parametrize("activation", ["gelu", "gelu_exact", "hard_swish"])
def test_mlp_kernel_on_the_wgmma_route_at_vit_l_width(cuda, precision, activation):
    """Kernel 2 at ViT-L's widths (1024 / 4096: the wgmma GEMM) over 2 x 197
    rows (M not a multiple of the 128-row tile), with LN and the residual,
    against its twin."""
    t = _cast(_mlp_inputs(10, 197, 1024, 4096), precision, lambda a, dt: _torch(a, dt, cuda))
    kw = dict(activation=activation, residual=True)
    out = ops.mlp(**t, **kw)
    with ops.force_backend("torch"):
        ref = ops.mlp(**t, **kw)
    torch.cuda.synchronize()
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= kernel_tol(ref, t["x"], out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "mixed"])
def test_mlp_is_batch_invariant_at_vit_l_width(cuda, precision):
    """Sample 4 alone comes out bitwise as it does inside a batch of 9 at
    ViT-L's widths, where both products run on the wgmma GEMM."""
    t = _cast(_mlp_inputs(11, 197, 1024, 4096), precision, lambda a, dt: _torch(a, dt, cuda))
    x = torch.cat([t["x"]] * 5)[:9].contiguous()
    full = ops.mlp(**{**t, "x": x})
    alone = ops.mlp(**{**t, "x": x[4:5].contiguous()})
    torch.testing.assert_close(alone, full[4:5], rtol=0, atol=0)


@pytest.mark.cuda
def test_mlp_refuses_misaligned_operands_on_the_wgmma_route(cuda):
    """At widths the wgmma GEMM takes, an operand that does not start on a
    16-byte boundary raises before any launch; it is not sent to the WMMA
    GEMM instead."""
    t = _cast(_mlp_inputs(12, 8, 64, 256), "bf16", lambda a, dt: _torch(a, dt, cuda))
    flat = torch.zeros(t["x"].numel() + 1, device=cuda, dtype=torch.bfloat16)
    x = flat[1:].view_as(t["x"])
    x.copy_(t["x"])
    before = ops.launch_counts()["fused_mlp"]
    with pytest.raises(ValueError, match="x does not start on a 16-byte boundary"):
        tfm.fused_mlp(**{**t, "x": x})
    assert ops.launch_counts()["fused_mlp"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ["gelu", "gelu_exact", "hard_swish"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_sm90_applies_activation(cuda, activation, out_dtype):
    """The wgmma GEMM's epilogue activation, act(A @ B + bias), against the
    twin's activation of an fp32 product of the same operands, at kernel 2's
    fc1 widths (K 1024, N 4096) and M 197. Bound: chip_smoke's GEMM bound
    with the sum-order slack scaled by 1.5, the steepest slope of the three
    activations (hard_swish's (2h + 3) / 6 below h = 3), plus 1e-6 of the
    largest output for the fp32 formulas of tanh and erf against torch's."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    m, n, k = 197, 4096, 1024
    a = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    b = (torch.randn(k, n, generator=gen, device=cuda) / k**0.5).bfloat16()
    bias = 0.1 * torch.randn(n, generator=gen, device=cuda)
    out = tba.gemm_sm90(a, b, bias, None, out_dtype, activation=activation)
    ref = tfm._activate(a.float() @ b.float() + bias, activation)
    assert out.dtype == out_dtype and out.shape == (m, n)
    slack = 2 * k * 2.0**-24 * (a.float().abs() @ b.float().abs()).max().item()
    _, e = torch.frexp(ref.abs().max())
    bound = 2.0 ** (e.item() - 8) + 1.5 * slack + 1e-6 * ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    assert err <= bound, (err, bound)
