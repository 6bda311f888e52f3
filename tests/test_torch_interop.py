"""The qkv-bias attention branch and the Hugging Face interop of the port on
the CPU: ``Attention(qkv_bias=True)`` (self and cross), ``Transformer`` and
``ViT`` against vit_tpu's modules with converted parameters, in fp32, bf16
and mixed and in both JAX CPU modes; ``utils.interop`` against a tiny
``transformers`` ``ViTForImageClassification`` (built from a ``ViTConfig``,
nothing downloaded) and against vit_tpu's ``utils/interop.py``; the
LayerNorm at eps 1e-12; planted faults; the routes the card takes; serving.

JAX and transformers are imported inside the tests: the card runs this
file's ``cuda`` tests with ``python -m pytest --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

from vit_tpu_torch import ops
from vit_tpu_torch.models import ViT
from vit_tpu_torch.nn import Attention, Transformer
from vit_tpu_torch.nn import embed as tembed
from vit_tpu_torch.utils import (
    export_vit_to_hf,
    from_jax_params,
    hf_vit_config,
    import_hf_vit_params,
    vit_from_hf,
)
from vit_tpu_torch.utils import interop as tinterop

torch.set_num_threads(2)

CFG = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4,
           mlp_dim=128, dim_head=16, qkv_bias=True, activation="gelu_exact", norm_eps=1e-12)
CONFIGS = {"fp32": (None, None), "bf16": ("bfloat16", None), "mixed": ("bfloat16", "float32")}

# Max |logit| difference from vit_tpu's ViT (|logits| ~2), per config and
# vit_tpu mode. fp32: 1e-4 (measured 1.9e-6). bf16 and mixed: twice
# max(vit_tpu's own xla-vs-interpret gap, 0.02), as the other port tests
# take it: the gap is 9.5e-3 (bf16) and 0 (mixed) on this model, so 0.04.
# The port rounds where vit_tpu run op by op rounds (the stack: 7e-7 in
# both, test_qkv_bias_transformer_matches_flax; the bf16 ViT: 2.4e-7,
# test_bf16_vit_is_vit_tpu_run_op_by_op); under its scan, XLA keeps excess
# precision (a bf16 Dense output added before its rounding), measured
# 1.02e-2 (xla) and 1.30e-2 (interpret) in bf16, 1.22e-2 in mixed. At
# depth 1 vit_tpu's one layer runs unscanned: 2.4e-7 (bf16), 7.2e-7 (mixed).
TOL = {"fp32": 1e-4, "bf16": 0.04, "mixed": 0.04}
# The bf16 port against vit_tpu run op by op (jax.disable_jit, xla mode):
# measured 2.4e-7 at depth 2; a Dense whose bias is added before the bf16
# rounding of its product moves the logits by 2.4e-2 here (and dropping the
# qkv bias moves the fp32 logits by 0.22).
OP_BY_OP_TOL = 1e-5
# HF's torch logits: tests/test_interop.py's tolerances.
HF_ATOL, HF_RTOL = 2e-4, 1e-3


def _images(b=2, seed=0, size=32):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _perturbed(variables, seed=1):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.02 * rng.standard_normal(a.shape).astype(np.float32), variables)


def _dt(name, lib):
    return getattr(lib, name) if name else None


def _vit_pair(config, depth=2, **extra):
    """vit_tpu's qkv-bias ViT with perturbed init variables, and the port's
    loaded with them."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import ViT as JaxViT

    dt, rd = CONFIGS[config]
    cfg = dict(CFG, depth=depth, **extra)
    jm = JaxViT(**cfg, dtype=_dt(dt, jnp), residual_dtype=_dt(rd, jnp))
    v = _perturbed(jax.jit(jm.init)({"params": jax.random.PRNGKey(1)}, jnp.asarray(_images(1))))
    tm = ViT(**cfg, dtype=_dt(dt, torch), residual_dtype=_dt(rd, torch), device="cpu")
    tm.load_state_dict(from_jax_params(v, tm.jax_stages), strict=True)
    return jm, v, tm.eval()


def _logits(tm, img):
    with torch.inference_mode():
        return tm(torch.from_numpy(img)).float().numpy()


# -- the qkv-bias branch against vit_tpu --------------------------------------------


def _attention_pair(cross, dtype, **kw):
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.attention import Attention as JaxAttention

    jm = JaxAttention(dim=64, heads=4, dim_head=16, qkv_bias=True, norm_eps=1e-12,
                      dtype=_dt(dtype, jnp), **kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 40, 64)).astype(np.float32) if cross else None
    v = _perturbed(jm.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x),
                           None if ctx is None else jnp.asarray(ctx)))
    tm = Attention(64, 4, 16, qkv_bias=True, cross=cross, norm_eps=1e-12,
                   dtype=_dt(dtype, torch), device="cpu", **kw)
    tm.load_state_dict(from_jax_params(v, {}), strict=True)
    return jm, v, tm, x, ctx


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("cross", [False, True])
def test_qkv_bias_attention_matches_flax(cross, dtype, monkeypatch):
    """Self-attention (residual fused) and cross-attention with a qkv bias
    against vit_tpu's flax branch: fp32 in both CPU modes (1e-5), bf16 op by
    op on jax arrays (exact up to one bf16 ulp of the output's largest
    value)."""
    import jax
    import jax.numpy as jnp

    kw = dict(fuse_residual=not cross)
    jm, v, tm, x, ctx = _attention_pair(cross, dtype, **kw)
    dt = torch.bfloat16 if dtype else torch.float32
    xt = torch.from_numpy(x).to(dt)
    with torch.inference_mode():
        out = tm(xt, context=None if ctx is None else torch.from_numpy(ctx).to(dt)).float().numpy()
    assert tm.to_qkv.bias is not None if not cross else tm.to_q.bias is not None
    jx = jnp.asarray(x, _dt(dtype, jnp) or jnp.float32)
    jc = None if ctx is None else jnp.asarray(ctx, _dt(dtype, jnp) or jnp.float32)
    for mode in (("xla", "interpret") if dtype is None else ("xla",)):
        monkeypatch.setenv("VIT_TPU_BACKEND", mode)
        if dtype is None:
            ref = np.asarray(jm.apply(v, jx, jc), np.float32)
            tol = 1e-5
        else:
            with jax.disable_jit():
                ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, v), jx, jc), np.float32)
            tol = 2.0**-8 * np.abs(ref).max()
        assert np.abs(out - ref).max() <= tol, (mode, np.abs(out - ref).max())


def test_qkv_bias_attention_never_fuses_and_keeps_vit_tpus_names():
    a = Attention(64, 4, 16, qkv_bias=True, fuse_residual=True, device="cpu")
    assert not a.fuses(17)
    assert set(a.state_dict()) == {"norm.scale", "norm.bias", "to_qkv.kernel", "to_qkv.bias",
                                   "to_out.kernel", "to_out.bias"}
    cross = Attention(64, 4, 16, qkv_bias=True, cross=True, device="cpu")
    assert {"to_q.bias", "to_kv.bias"} <= set(cross.state_dict())


def test_qkv_bias_cross_attention_takes_no_low_query_path(monkeypatch):
    """A qkv bias turns the reassociated low-query path off (vit_tpu's
    :379-381), even where the FLOP gate or ``lowq_cross`` would take it."""
    tm = Attention(64, 4, 16, qkv_bias=True, cross=True, lowq_cross=True, device="cpu")
    monkeypatch.setattr(Attention, "_lowq_cross_attention",
                        lambda *a: pytest.fail("low-query path taken"))
    x, ctx = torch.randn(1, 1, 64), torch.randn(1, 60, 64)
    with torch.inference_mode():
        assert tm(x, context=ctx).shape == (1, 1, 64)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_qkv_bias_transformer_matches_flax(config, monkeypatch):
    """The encoder stack alone (depth 2, xla mode), from stacked flax
    parameters: fp32 under jit, bf16 and mixed op by op on jax arrays (the
    port rounds where vit_tpu's ops round: measured 7e-7 of |out| ~5)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.blocks import Transformer as JaxTransformer

    dt, _ = CONFIGS[config]
    x = np.random.default_rng(4).standard_normal((2, 17, 64)).astype(np.float32)
    jm = JaxTransformer(dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128, qkv_bias=True,
                        activation="gelu_exact", norm_eps=1e-12, dtype=_dt(dt, jnp))
    stream = jnp.float32 if config != "bf16" else jnp.bfloat16
    v = _perturbed(jm.init({"params": jax.random.PRNGKey(5)}, jnp.asarray(x, stream)))
    tm = Transformer(64, 2, 4, 16, 128, qkv_bias=True, activation="gelu_exact", norm_eps=1e-12,
                     dtype=_dt(dt, torch), device="cpu")
    tm.load_state_dict(from_jax_params(v, {"blocks": 2}), strict=True)
    monkeypatch.setenv("VIT_TPU_BACKEND", "xla")
    if config == "fp32":
        ref = np.asarray(jm.apply(v, jnp.asarray(x, stream)), np.float32)
    else:
        with jax.disable_jit():
            ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x, stream)),
                             np.float32)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x).to(getattr(torch, str(stream.dtype)))).float().numpy()
    assert np.abs(out - ref).max() <= 1e-5, np.abs(out - ref).max()


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_qkv_bias_vit_matches_jax(config, mode, monkeypatch):
    import jax.numpy as jnp

    img = _images()
    jm, v, tm = _vit_pair(config)
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    ref = np.asarray(jm.apply(v, jnp.asarray(img)), np.float32)
    out = _logits(tm, img)
    assert out.shape == (2, 10)
    assert np.abs(out - ref).max() <= TOL[config], np.abs(out - ref).max()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_qkv_bias_vit_at_depth_one_matches_jax(config, monkeypatch):
    """vit_tpu's one unscanned layer: ``attn_0`` / ``ff_0`` in its tree."""
    import jax.numpy as jnp

    img = _images()
    jm, v, tm = _vit_pair(config, depth=1)
    assert "attn_0" in v["params"]["encoder"]
    monkeypatch.setenv("VIT_TPU_BACKEND", "xla")
    ref = np.asarray(jm.apply(v, jnp.asarray(img)), np.float32)
    assert np.abs(_logits(tm, img) - ref).max() <= TOL[config]


def test_qkv_bias_dropout_takes_vit_tpus_materializing_route(monkeypatch):
    """With dropout in training, the qkv-bias branch materializes the scores
    (no ``ops.attention``) and drops both the probabilities and the output
    projection at the rate, as vit_tpu's ``needs_materialized`` does;
    without ``train`` it takes ``ops.attention`` and drops nothing."""
    from vit_tpu_torch.nn import attention as tattn

    calls, rates = [], []
    real_attention, real_dropout = ops.attention, tattn.dropout
    monkeypatch.setattr(ops, "attention", lambda *a, **k: calls.append(1) or real_attention(
        *a, **k))

    def probe(x, rate, generator):
        y = real_dropout(x, rate, generator)
        if rate:
            rates.append(float((y == 0).float().mean()))
        return y

    monkeypatch.setattr(tattn, "dropout", probe)
    from vit_tpu_torch.utils import init_params

    a = Attention(64, 4, 16, qkv_bias=True, fuse_residual=True, dropout=0.25, device="cpu")
    init_params(a, torch.Generator().manual_seed(1))
    x = torch.randn(4, 50, 64)
    a(x, train=True, generator=torch.Generator().manual_seed(0))
    assert not calls and len(rates) == 2 and all(abs(r - 0.25) <= 0.03 for r in rates), rates
    rates.clear()
    with torch.no_grad():
        a(x)
    assert calls == [1] and not rates


def _op_by_op(jm, v, img):
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops

    with jops.force_backend("xla"), jax.disable_jit():
        return np.asarray(jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(img)), np.float32)


def test_bf16_vit_is_vit_tpu_run_op_by_op():
    img = _images()
    jm, v, tm = _vit_pair("bf16")
    assert np.abs(_logits(tm, img) - _op_by_op(jm, v, img)).max() <= OP_BY_OP_TOL


def _bias_before_rounding(self, x):
    x, w = x.to(self.dtype), self.kernel.to(self.dtype)
    y = torch.matmul(x.float(), w.float())
    return (y if self.bias is None else y + self.bias).to(self.dtype)


def _drop_qkv_bias(tm):
    for block in tm.encoder.blocks:
        block.attn.to_qkv.bias = None


# Each fault, the config it is held in and the reference: fp32 faults against
# vit_tpu's fp32 logits (TOL["fp32"]), the rounding fault against vit_tpu run
# op by op in bf16 (OP_BY_OP_TOL).
MODEL_FAULTS = {
    "qkv bias dropped": ("fp32", _drop_qkv_bias),
    "tanh GELU in place of the erf": ("fp32", None),
    "Dense bias added before the bf16 rounding": ("bf16", None),
}


@pytest.mark.parametrize("fault", list(MODEL_FAULTS))
def test_planted_model_faults_fail_their_bounds(fault, monkeypatch):
    import jax.numpy as jnp

    config, plant = MODEL_FAULTS[fault]
    img = _images()
    jm, v, tm = _vit_pair(config)
    if fault.startswith("tanh"):
        bad = ViT(**dict(CFG, activation="gelu"), device="cpu")
        bad.load_state_dict(tm.state_dict(), strict=True)
        tm = bad.eval()
    elif fault.startswith("Dense"):
        monkeypatch.setattr(tembed.Dense, "forward", _bias_before_rounding)
    else:
        plant(tm)
    if config == "fp32":
        err = np.abs(_logits(tm, img) - np.asarray(jm.apply(v, jnp.asarray(img)))).max()
        bound = TOL["fp32"]
    else:
        err = np.abs(_logits(tm, img) - _op_by_op(jm, v, img)).max()
        bound = OP_BY_OP_TOL
    assert err > bound, (fault, err, bound)


# -- LayerNorm at eps 1e-12 -----------------------------------------------------------


def test_layer_norm_clamps_the_fast_variance_at_eps_1e_12():
    """At HF's eps 1e-12 the fast variance's cancellation is no longer covered
    by eps: on a constant row, E[x^2] - E[x]^2 comes out below 0 in fp32, and
    only the clamp at 0 keeps the output finite. The port's ``_ln_f32`` (and
    ``ln_rows``, card test below) clamps as flax's LayerNorm does: finite
    where the unclamped form gives NaN, each output within the amplified
    rounding of the mean (|x - mean| <= 8 ulps of x, times rsqrt(1e-12) =
    1e6, times the scale) of the bias, as flax's are; on an ordinary row equal
    to flax's within 1e-5."""
    import jax.numpy as jnp
    import flax.linen as fnn

    from vit_tpu_torch.ops.block_attention import _ln_f32

    x = np.full((4, 768), 0.1, np.float32)
    x[1] = 3.3
    x[2] = -0.7
    x[3] = np.random.default_rng(1).standard_normal(768)
    mean = x.mean(-1, keepdims=True, dtype=np.float32)
    raw = (x * x).mean(-1, keepdims=True, dtype=np.float32) - mean * mean
    assert (raw < 0).any()  # the cancellation the clamp must absorb
    rng = np.random.default_rng(0)
    scale = (1 + 0.1 * rng.standard_normal(768)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(768)).astype(np.float32)
    ln = fnn.LayerNorm(epsilon=1e-12, dtype=jnp.float32)
    ref = np.asarray(ln.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)))
    out = _ln_f32(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
                  1e-12).numpy()
    assert np.isfinite(out).all() and np.isfinite(ref).all()
    amplified = 8 * np.spacing(np.abs(x[:3]).max(-1, keepdims=True)) * 1e6 * np.abs(scale).max()
    for y in (out, ref):
        assert (np.abs(y[:3] - bias) <= amplified).all()
    np.testing.assert_allclose(out[3], ref[3], rtol=0, atol=1e-5)
    t = torch.from_numpy(x)
    m = t.mean(-1, keepdim=True)
    unclamped = (t - m) * torch.rsqrt((t * t).mean(-1, keepdim=True) - m * m + 1e-12)
    assert not torch.isfinite(unclamped).all()


def test_chip_smokes_gelu_tail_inputs_see_the_gelus_form():
    """chip_smoke holds kernel 2's erf GELU on ``gelu_tail_inputs``: there the
    tanh form's twin fails kernel_tol, which N(0, 1) inputs do not see."""
    import chip_smoke as cs

    gen = torch.Generator().manual_seed(0)
    kw = dict(activation="gelu_exact", residual=False, ln_eps=1e-12)
    for inp, sees in ((cs.gelu_tail_inputs(gen, 33, 96, 384, "cpu", b=2), True),
                      (cs.mlp_inputs(gen, 33, 96, 384, torch.bfloat16, "cpu", b=2), False)):
        ref = ops.reference_mlp(**inp, **kw)
        bad = ops.reference_mlp(**inp, **dict(kw, activation="gelu"))
        err = (bad.float() - ref.float()).abs().max().item()
        assert (err > cs.kernel_tol(ref, None, torch.bfloat16)) == sees, (sees, err)


# -- Hugging Face interop -------------------------------------------------------------


def _hf_model(num_labels=10, depth=3):
    transformers = pytest.importorskip("transformers")

    cfg = transformers.ViTConfig(hidden_size=64, num_hidden_layers=depth, num_attention_heads=4,
                                 intermediate_size=128, image_size=32, patch_size=8,
                                 num_labels=num_labels)
    torch.manual_seed(0)
    hf = transformers.ViTForImageClassification(cfg).eval()
    with torch.no_grad():  # HF zero-inits biases and LN: move them off 0 and 1
        for name, p in hf.named_parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape))
    return hf


def _hf_logits(hf, img):
    with torch.no_grad():
        return hf(torch.from_numpy(img.transpose(0, 3, 1, 2))).logits.numpy()


def test_hf_vit_logit_parity():
    hf = _hf_model()
    tm = vit_from_hf(hf, device="cpu")
    img = _images()
    np.testing.assert_allclose(_logits(tm, img), _hf_logits(hf, img), atol=HF_ATOL, rtol=HF_RTOL)


def test_hf_import_equals_vit_tpus_import():
    """The port's ``import_hf_vit_params`` is ``vit_tpu``'s followed by
    ``from_jax_params``, bit for bit; ``hf_vit_config`` is ``vit_tpu``'s."""
    from vit_tpu.utils import interop as jinterop

    hf = _hf_model(num_labels=7)
    assert hf_vit_config(hf.config) == jinterop.hf_vit_config(hf.config)
    sd = hf.state_dict()
    ours = import_hf_vit_params(sd, depth=3, patch_size=8, num_classes=7)
    ref = from_jax_params(jinterop.import_hf_vit_params(sd, depth=3, patch_size=8,
                                                        num_classes=7))
    assert set(ours) == set(ref)
    for k, t in ref.items():
        assert torch.equal(ours[k], t), k


def test_hf_import_from_a_plain_dict_config_and_numpy_state():
    """The card has no transformers: a ``config.json`` dict (its labels as
    ``id2label``, defaults left out) and a state dict of numpy arrays give
    the model the live HF objects give."""
    hf = _hf_model()
    cfg = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
           "intermediate_size": 128, "image_size": 32, "patch_size": 8,
           "id2label": {str(i): f"c{i}" for i in range(10)}}
    assert hf_vit_config(cfg) == hf_vit_config(hf.config)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    tm = vit_from_hf(sd, cfg, device="cpu")
    img = _images()
    np.testing.assert_array_equal(_logits(tm, img), _logits(vit_from_hf(hf, device="cpu"), img))
    assert hf_vit_config({})["num_classes"] == 2  # HF's default num_labels


def test_bare_vit_model_import_gets_a_zero_head():
    transformers = pytest.importorskip("transformers")

    hf = _hf_model()
    bare = transformers.ViTModel(hf.config, add_pooling_layer=True).eval()
    bare.load_state_dict({k[4:]: v for k, v in hf.state_dict().items() if k.startswith("vit.")},
                         strict=False)
    sd = bare.state_dict()
    assert not any(k.startswith("vit.") for k in sd) and "pooler.dense.weight" in sd
    state = import_hf_vit_params(sd, depth=3, patch_size=8, num_classes=5)
    assert state["head.kernel"].shape == (64, 5) and not state["head.kernel"].any()
    tm = ViT(**dict(hf_vit_config(hf.config), num_classes=5), device="cpu")
    tm.load_state_dict(state, strict=True)
    out = _logits(tm.eval(), _images())
    assert out.shape == (2, 5) and not out.any()


def test_export_round_trip_is_bit_equal_and_loads_into_hf():
    hf = _hf_model()
    tm = vit_from_hf(hf, device="cpu")
    sd = export_vit_to_hf(tm)
    back = import_hf_vit_params(sd, depth=3, patch_size=8, num_classes=10)
    for k, t in tm.state_dict().items():
        assert torch.equal(back[k], t), k
    ref_sd = hf.state_dict()
    for k, t in sd.items():
        assert torch.equal(t, ref_sd[k]), k
    other = _hf_model()
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    export_vit_to_hf(tm, other)
    img = _images()
    np.testing.assert_array_equal(_hf_logits(other, img), _hf_logits(hf, img))


def test_export_of_a_raw_layout_vit_serves_from_hf():
    """A ViT without a qkv bias (the fused layout) exports with zero q, k, v
    biases, and HF's torch forward gives its logits."""
    transformers = pytest.importorskip("transformers")
    from vit_tpu_torch.utils import init_params

    tm = ViT(**dict(CFG, qkv_bias=False), device="cpu")
    init_params(tm, torch.Generator().manual_seed(0))
    hf = transformers.ViTForImageClassification(transformers.ViTConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        image_size=32, patch_size=8, num_labels=10)).eval()
    sd = export_vit_to_hf(tm, hf)
    assert not sd["vit.encoder.layer.0.attention.attention.key.bias"].any()
    img = _images()
    np.testing.assert_allclose(_logits(tm.eval(), img), _hf_logits(hf, img), atol=HF_ATOL,
                               rtol=HF_RTOL)


def test_qkv_concatenated_in_the_wrong_order_fails_the_hf_bound(monkeypatch):
    hf = _hf_model()
    img = _images()
    monkeypatch.setattr(tinterop, "QKV_ORDER", ("key", "query", "value"))
    bad = _logits(vit_from_hf(hf, device="cpu"), img)
    ref = _hf_logits(hf, img)
    assert not np.allclose(bad, ref, atol=HF_ATOL, rtol=HF_RTOL)


def test_chip_smoke_hf_state_dict_has_hfs_layout_and_imports_as_vit_tpu_does():
    """chip_smoke draws the HF ViT-B/16 checkpoint with numpy
    (``hf_vit_state_dict``): at a tiny config, the keys and shapes of
    ``transformers``' model, imported as ``vit_tpu`` imports it."""
    transformers = pytest.importorskip("transformers")
    from vit_tpu.utils import interop as jinterop

    import chip_smoke as cs

    cfg = dict(cs.HF_VIT_B, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, image_size=32, patch_size=8, num_labels=10)
    sd = cs.hf_vit_state_dict(cfg, seed=0)
    hf = transformers.ViTForImageClassification(transformers.ViTConfig(**cfg))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in hf.state_dict().items()}
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    ours = import_hf_vit_params(sd, depth=2, patch_size=8, num_classes=10)
    ref = from_jax_params(jinterop.import_hf_vit_params(sd, depth=2, patch_size=8,
                                                        num_classes=10))
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    assert hf_vit_config(cs.HF_VIT_B) == dict(
        image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12, heads=12,
        dim_head=64, mlp_dim=3072, pool="cls", qkv_bias=True, activation="gelu_exact",
        norm_eps=1e-12)
    tm = vit_from_hf(sd, cfg, device="cpu")
    img = _images()
    np.testing.assert_allclose(_logits(tm, img), _hf_logits(hf.eval(), img), atol=HF_ATOL,
                               rtol=HF_RTOL)


# -- routes and serving -------------------------------------------------------------

TWINS = {"reference_attention_kv_blocked": "flash_attention_kv_blocked",
         "reference_attention": "flash_attention", "xla_qkv_attention": "qkv_attention",
         "reference_mlp": "fused_mlp", "xla_attention_block": "attention_block"}


def test_hf_vit_routes_as_the_card_would(monkeypatch):
    """A bf16 forward on the CPU calls kernel 4's twin and kernel 2's once a
    layer and no other twin, as chip_smoke's FAMILY_LAUNCHES["hf_vit"] wants
    of the card a forward (12 layers there, 2 here)."""
    from chip_smoke import FAMILY_LAUNCHES

    calls = {}
    for name, kernel in TWINS.items():
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _k=kernel, _f=fn, **kw: (
            calls.__setitem__(_k, calls.get(_k, 0) + 1), _f(*a, **kw))[1])
    _, _, tm = _vit_pair("bf16")
    _logits(tm, _images(1))
    per_layer = {k: n // 12 for k, n in FAMILY_LAUNCHES["hf_vit"].items() if n}
    assert calls == {k: 2 * n for k, n in per_layer.items()}


def test_hf_vit_serves_through_batching_server():
    from vit_tpu_torch.data import JpegDecoder
    from vit_tpu_torch.pipeline import InferencePipeline
    from vit_tpu_torch.serving import BatchingServer

    hf = _hf_model()
    tm = vit_from_hf(hf, dtype=torch.bfloat16, device="cpu")
    pipe = InferencePipeline(tm, image_size=32, batch_size=4)
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(6)]
    with BatchingServer(pipe, decoder=JpegDecoder(size=32), max_wait_ms=5) as server:
        rows = np.stack([f.result(timeout=60) for f in [server.submit(r) for r in reqs]])
    direct = np.concatenate([pipe(r[None]) for r in reqs])
    assert rows.shape == (6, 10) and np.isfinite(rows).all()
    assert np.abs(rows - direct).max() <= 0.05 * np.abs(direct).max()


def test_interop_imports_nothing_of_jax_or_transformers():
    import subprocess
    import sys

    code = ("import sys, vit_tpu_torch.utils, vit_tpu_torch.utils.interop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'transformers', 'vit_tpu')]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_mlp_kernel_clamps_near_constant_rows_at_eps_1e_12(cuda):
    """Kernel 2's LayerNorm prologue (``ln_rows``) at eps 1e-12 on constant
    rows, whose fast variance cancels below 0: finite, and within
    ``kernel_tol`` of its twin."""
    from chip_smoke import kernel_tol, mlp_inputs

    gen = torch.Generator(device=cuda).manual_seed(0)
    inp = mlp_inputs(gen, 197, 768, 3072, torch.bfloat16, cuda, b=2)
    inp["x"][0, :50] = 0.1
    inp["x"][1, 7] = -3.3
    kw = dict(activation="gelu_exact", residual=True, ln_eps=1e-12)
    out = ops.fused_mlp(**inp, **kw)
    ref = ops.reference_mlp(**inp, **kw)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= kernel_tol(ref, inp["x"],
                                                                        out.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["bf16", "mixed"])
def test_qkv_bias_vit_on_the_card_matches_its_twins(cuda, config):
    import chip_smoke as cs

    hf_cfg = dict(cs.HF_VIT_B, num_hidden_layers=2)
    sd = cs.hf_vit_state_dict(hf_cfg, seed=1)
    dt, rd = CONFIGS[config]
    tm = vit_from_hf(sd, hf_cfg, dtype=_dt(dt, torch), residual_dtype=_dt(rd, torch),
                     device=cuda)
    x = torch.randn(4, 224, 224, 3, device=cuda).bfloat16()
    before = ops.launch_counts()
    with torch.inference_mode():
        out = tm(x)
        with ops.force_backend("torch"):
            ref = tm(x)
    after = ops.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == 2
    assert after["fused_mlp"] - before["fused_mlp"] == 2
    assert after["attention_block"] == before["attention_block"]
    assert (out - ref).abs().max().item() <= 0.02 * ref.abs().max().item()
