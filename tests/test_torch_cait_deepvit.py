"""The port's tiny CaiT and DeepViT against vit_tpu on the CPU, from the same
converted parameters and the same numpy images; the cross-attention branch
against vit_tpu's ``Attention``; the converter's stage layouts; serving.

vit_tpu runs in both of its CPU modes: ``xla`` (the default off-TPU) and
``interpret`` (the Pallas kernels in interpreter mode).
"""

import importlib

import numpy as np
import pytest
import torch

from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import CaiT, DeepViT
from vit_tpu_torch.nn import Attention, Dense
from vit_tpu_torch.pipeline import InferencePipeline
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

TINY = dict(image_size=32, patch_size=8, num_classes=10, dim=64, heads=4, mlp_dim=128,
            dim_head=16)

# Max |logit| difference allowed, per model (CaiT by its class-stage depth),
# dtype and vit_tpu mode; |logits| ~ 2. Measured: the port on these inputs.
# fp32: 1e-4; the port measured up to 1.2e-6 against both modes.
# bf16 / interpret: the port rounds where the Pallas kernels and vit_tpu's
#   modules do: 2.4e-7 (CaiT, one class layer) and 4.8e-7 (DeepViT); 4e-3.
#   With two class layers vit_tpu scans the class stage, and XLA's default
#   --xla_allow_excess_precision then skips a bf16 rounding inside the scan:
#   5.9e-3 (6e-7 with that flag off). 1.2e-2 is about twice it.
# bf16 / xla: vit_tpu's XLA path rounds the attention delta apart from the
#   residual add and, in DeepViT, takes the materializing re-attention, so
#   its two modes differ by 5.9e-3 / 1.4e-2 (CaiT with one / two class
#   layers) and 7.2e-3 (DeepViT); the port follows the kernel path and
#   measured 5.9e-3 / 1.2e-2 / 7.2e-3. About twice the gaps: 1.2e-2, 2.8e-2
#   and 1.5e-2.
TOL = {
    **{(m, "float32", mode): 1e-4 for m in ("cait1", "cait2", "deepvit")
       for mode in ("xla", "interpret")},
    ("cait1", "bfloat16", "interpret"): 4e-3, ("cait1", "bfloat16", "xla"): 1.2e-2,
    ("cait2", "bfloat16", "interpret"): 1.2e-2, ("cait2", "bfloat16", "xla"): 2.8e-2,
    ("deepvit", "bfloat16", "interpret"): 4e-3, ("deepvit", "bfloat16", "xla"): 1.5e-2,
}


def _perturbed(tree, seed):
    """``init`` parameters as numpy, perturbed so that biases, LN parameters
    and LayerScales are not constants."""
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        tree,
    )


def _models(family, dtype, **kw):
    import jax.numpy as jnp
    from vit_tpu import models as jm

    jd = getattr(jnp, dtype) if dtype != "float32" else None
    td = getattr(torch, dtype) if dtype != "float32" else None
    if family == "cait":
        cfg = dict(TINY, depth=2, cls_depth=kw.get("cls_depth", 2))
        return jm.CaiT(**cfg, dtype=jd), CaiT(**cfg, dtype=td, device="cpu")
    cfg = dict(TINY, depth=kw.get("depth", 2))
    return jm.DeepViT(**cfg, dtype=jd), DeepViT(**cfg, dtype=td, device="cpu")


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 32, 32, 3)).astype(np.float32)


def _jax_vars(jax_model, img, seed=1):
    import jax
    import jax.numpy as jnp

    return _perturbed(jax.jit(jax_model.init)({"params": jax.random.PRNGKey(seed)},
                                               jnp.asarray(img)), seed)


def _logits_err(family, dtype, mode, monkeypatch, **kw):
    import jax.numpy as jnp

    img = _images()
    jm, tm = _models(family, dtype, **kw)
    variables = _jax_vars(jm, img)
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    ref = np.asarray(jm.apply(variables, jnp.asarray(img)), np.float32)
    tm.load_state_dict(from_jax_params(variables, tm.jax_stages), strict=True)
    with torch.inference_mode():
        out = tm(torch.from_numpy(img))
    assert out.dtype == torch.float32 and out.shape == (2, 10)
    return float(np.abs(out.numpy() - ref).max())


@pytest.mark.parametrize("cls_depth", [1, 2])
@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cait_matches_jax(dtype, mode, cls_depth, monkeypatch):
    err = _logits_err("cait", dtype, mode, monkeypatch, cls_depth=cls_depth)
    assert err <= TOL[(f"cait{cls_depth}", dtype, mode)], err


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepvit_matches_jax(dtype, mode, monkeypatch):
    err = _logits_err("deepvit", dtype, mode, monkeypatch)
    assert err <= TOL[("deepvit", dtype, mode)], err


@pytest.mark.parametrize(
    "family,kw", [("cait", dict(cls_depth=1)), ("cait", dict(cls_depth=2)),
                  ("deepvit", dict(depth=1)), ("deepvit", dict(depth=2))],
)
def test_converter_unstacks_by_the_model(family, kw):
    """Scanned stages carry a leading depth axis, stages of depth 1 do not
    (CaiT's class stage keeps its prefix, vit_tpu's Transformer names its one
    layer ``attn_0``): every tree loads with ``strict=True``, value for value."""
    jm, tm = _models(family, "float32", **kw)
    variables = _jax_vars(jm, _images())
    state = from_jax_params(variables, tm.jax_stages)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state, strict=True)
    if family == "cait":
        key = "cls_stage.blocks.0.attn.to_kv.kernel"
        leaf = variables["params"]["cls_stage"]["blocks"]["attn"]["to_kv"]["kernel"]
        np.testing.assert_array_equal(state[key].numpy(), leaf if kw["cls_depth"] == 1 else leaf[0])
    with pytest.raises(ValueError, match="depth"):
        from_jax_params(variables, {s: d + 1 for s, d in tm.jax_stages.items()})


# -- the cross-attention branch against vit_tpu's Attention -------------------


def _cross(lowq, talking_heads, dtype="float32", norm_context=False, reattention=False):
    """vit_tpu's TestLowQueryCrossAttention geometry: one query against a
    65-token context, ``kv_include_self``."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.attention import Attention as JaxAttention

    jd = getattr(jnp, dtype) if dtype != "float32" else None
    kw = dict(dim=128, heads=4, dim_head=32, lowq_cross=lowq, talking_heads=talking_heads,
              norm_context=norm_context, reattention=reattention)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, 65, 128)).astype(np.float32)
    jmod = JaxAttention(**kw, dtype=jd)
    v = _perturbed(jmod.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x), jnp.asarray(ctx),
                             True), 3)
    for name in ("mix_heads_pre", "mix_heads_post", "reattn_weights"):
        if name in v["params"]:  # mixes of unit scale, so that a wrong mix shows
            v["params"][name] = v["params"][name] * 25
    ref = np.asarray(jmod.apply(v, jnp.asarray(x, jd), jnp.asarray(ctx, jd), True), np.float32)
    tmod = Attention(cross=True, norm_eps=1e-6, device="cpu",
                     dtype=getattr(torch, dtype) if dtype != "float32" else None,
                     **kw)
    tmod.load_state_dict(from_jax_params(v, {}), strict=True)
    td = getattr(torch, dtype)
    return tmod, torch.from_numpy(x).to(td), torch.from_numpy(ctx).to(td), ref


@pytest.mark.parametrize("talking_heads", [True, False])
@pytest.mark.parametrize("lowq", [True, False])
def test_cross_attention_matches_jax(lowq, talking_heads):
    tmod, x, ctx, ref = _cross(lowq, talking_heads)
    with torch.inference_mode():
        out = tmod(x, ctx, kv_include_self=True).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["xla", "interpret"])
def test_cross_attention_flash_route_matches_jax(mode, dtype, monkeypatch):
    """No head mix and no low-query path: both packages run ``ops.attention``
    (vit_tpu/nn/attention.py:401-402), JAX's flash kernel in interpret mode
    or its XLA reference, the port its twin on the CPU (the flash kernel on
    the card). fp32 within 2e-5 of the largest output, bf16 within one bf16
    ulp of it."""
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    tmod, x, ctx, ref = _cross(False, False, dtype)
    with torch.inference_mode():
        out = tmod(x, ctx, kv_include_self=True).float().numpy()
    tol = 2e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max(), rtol=0)


def test_cross_attention_norm_context_matches_jax():
    """``norm_context``: the context is normed too (its own ``norm_context``
    LayerNorm), on both paths."""
    for lowq in (True, False):
        tmod, x, ctx, ref = _cross(lowq, True, norm_context=True)
        with torch.inference_mode():
            out = tmod(x, ctx, kv_include_self=True).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


def test_cross_attention_reattention_matches_jax():
    """Re-attention in the cross branch: no low-query path (the gate
    excludes it), the materializing path's head mix and LayerNorm."""
    tmod, x, ctx, ref = _cross(None, False, reattention=True)
    with torch.inference_mode():
        out = tmod(x, ctx, kv_include_self=True).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("lowq", [True, False])
def test_cross_attention_bf16_matches_jax(lowq):
    """bf16: flax's Dense(dtype=bf16) rounds its product and adds its bias in
    bf16; the promoted fp32 keys (LN(x) beside a bf16 context) are cast back
    to bf16 by the low-query path. One bf16 ulp of the largest output."""
    tmod, x, ctx, ref = _cross(lowq, True, "bfloat16")
    with torch.inference_mode():
        out = tmod(x, ctx, kv_include_self=True).float().numpy()
    np.testing.assert_allclose(out, ref, atol=2.0**-7 * np.abs(ref).max(), rtol=0)


def test_lowq_gate_fires_at_the_cait_shape():
    """The FLOP gate of vit_tpu/nn/attention.py:387, ported as it is: one
    query against CaiT's 65 keys takes the low-query path; with it forced
    off, the materializing path gives the same values."""
    tmod, x, ctx, _ = _cross(None, True)
    calls = []
    tmod._lowq_cross_attention = lambda *a, f=tmod._lowq_cross_attention: calls.append(1) or f(*a)
    with torch.inference_mode():
        on = tmod(x, ctx, kv_include_self=True)
        tmod.lowq_cross = False
        off = tmod(x, ctx, kv_include_self=True)
    assert calls == [1]
    torch.testing.assert_close(on, off, atol=2e-5 * off.abs().max().item(), rtol=0)


def test_dense_bf16_is_flax_dense():
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    mod = fnn.Dense(16, dtype=jnp.bfloat16)
    v = _perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    ref = np.asarray(mod.apply(v, jnp.asarray(x)).astype(jnp.float32))
    dense = Dense(24, 16, dtype=torch.bfloat16, device="cpu")
    dense.load_state_dict(from_jax_params(v, {}), strict=True)
    with torch.inference_mode():
        out = dense(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2.0**-8 * np.abs(ref).max(), rtol=0)


# -- serving -------------------------------------------------------------------


@pytest.mark.parametrize("family", ["cait", "deepvit"])
def test_server_answers_requests(family):
    jm, tm = _models(family, "float32")
    tm.load_state_dict(from_jax_params(_jax_vars(jm, _images()), tm.jax_stages), strict=True)
    pipe = InferencePipeline(tm, image_size=32, batch_size=4, dtype=torch.float32)
    imgs = np.random.default_rng(2).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    with BatchingServer(pipe, decoder=JpegDecoder(size=32), max_wait_ms=20) as server:
        futures = [server.submit(im) for im in imgs]
        rows = np.stack([f.result(timeout=60) for f in futures])
    direct = np.concatenate([pipe(imgs[i: i + 1]) for i in range(6)])
    assert rows.shape == (6, 10) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, direct, atol=1e-5, rtol=0)


def test_models_export_and_count_no_launch_on_the_cpu():
    ops = importlib.import_module("vit_tpu_torch.ops")
    ops.reset_launch_counts()
    for family in ("cait", "deepvit"):
        _, tm = _models(family, "bfloat16")
        with torch.inference_mode():
            assert tm(torch.from_numpy(_images())).shape == (2, 10)
    assert sum(ops.launch_counts().values()) == 0
