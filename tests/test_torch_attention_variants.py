"""The attention variants of ``vit_tpu``'s ``Attention`` that take its
materializing path or kernel 4 (vit_tpu/nn/attention.py:356-504), against
vit_tpu on the CPU, from the same converted parameters and numpy inputs:

- (a) a qkv bias with talking heads, re-attention, ``mask_self`` (the flash
  route, ``ops.attention(mask_self=True)``) or the learned temperature;
- (b) cross-attention with ``mask_self`` (the flash route; the low-query
  gate excludes it), the learned temperature (the low-query path and the
  materializing one) or a bias (the flash route with the bias);
- (c) talking heads together with re-attention (pre-mix, softmax, post-mix,
  re-attention mix, LayerNorm across the heads);
- (d) a head mix without the output projection;
- (e) re-attention without ``fuse_residual``: the delta alone;
- (f) ``pre_norm=False`` (the flax branch without its LayerNorm) and an
  explicit ``project_out``;

and the depth-1 DeepViT stack (re-attention on the materializing path,
without the residual). vit_tpu runs in both of its CPU modes, ``xla`` and
``interpret`` (Pallas in interpreter mode). Each variant's planted fault
must fail the same bound.
"""

import functools

import numpy as np
import pytest
import torch

from vit_tpu_torch import ops
from vit_tpu_torch.nn import Attention
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

DIM, HEADS, DIM_HEAD = 32, 4, 8

# (flags, query tokens, context tokens or None, bias): cross-attention takes
# its queries against ``kv_include_self`` keys (the queries, then the context).
VARIANTS = {
    "a: qkv bias, talking heads": (dict(qkv_bias=True, talking_heads=True), 9, None, False),
    "a: qkv bias, re-attention": (dict(qkv_bias=True, reattention=True, fuse_residual=True), 9,
                                  None, False),
    "a: qkv bias, mask_self": (dict(qkv_bias=True, mask_self=True), 9, None, False),
    "a: qkv bias, learned temperature": (dict(qkv_bias=True, learned_temperature=True), 9, None,
                                         False),
    "b: cross, mask_self": (dict(cross=True, mask_self=True), 5, 7, False),
    "b: cross, learned temperature, low-query": (dict(cross=True, learned_temperature=True), 1,
                                                 65, False),
    "b: cross, learned temperature, materialized": (
        dict(cross=True, learned_temperature=True, lowq_cross=False), 1, 65, False),
    "b: cross, bias": (dict(cross=True), 5, 7, True),
    "c: talking heads and re-attention": (dict(talking_heads=True, reattention=True,
                                               fuse_residual=True), 9, None, False),
    "c: cross, talking heads and re-attention": (dict(cross=True, talking_heads=True,
                                                      reattention=True), 5, 7, False),
    "d: talking heads, no projection": (dict(talking_heads=True, project_out=False,
                                             fuse_residual=True), 9, None, False),
    "d: re-attention, one head as wide as the token": (
        dict(reattention=True, fuse_residual=True), 9, None, False),
    "e: re-attention without the residual": (dict(reattention=True), 9, None, False),
    "f: post-norm self-attention": (dict(pre_norm=False), 9, None, False),
    "f: post-norm cross-attention, talking heads": (dict(cross=True, pre_norm=False,
                                                         talking_heads=True), 5, 7, False),
    "f: project_out forced on, one head": (dict(project_out=True, fuse_residual=True), 9, None,
                                           False),
    "f: project_out forced off": (dict(project_out=False), 9, None, False),
}
# one head of dim_head == dim: project_out None skips the projection
ONE_HEAD = ("d: re-attention, one head as wide as the token", "f: project_out forced on, one head")

# Max |out - ref| as a share of max |ref| (|ref| ~ 1-10). fp32: both sides sum
# fp32 products in their own orders (~1e-7 relative a product); the head
# LayerNorm of re-attention divides by the spread of the heads, which grows
# the sum-order noise. Measured at most 4.8e-7 over these cases in both
# modes: 2e-5. bf16 (the cases of BF16): the port rounds where vit_tpu's
# modules do, and an XLA dot may round an intermediate to the neighbouring
# bf16 value: one bf16 ulp of the largest output, 2^-7 (measured at most
# 5.2e-3; the planted faults move 0.019 to 1.1).
TOL = {"float32": 2e-5, "bfloat16": 2.0**-7}
BF16 = ("a: qkv bias, mask_self", "b: cross, bias", "c: talking heads and re-attention",
        "e: re-attention without the residual")


def _geometry(name):
    return (1, DIM) if name in ONE_HEAD else (HEADS, DIM_HEAD)


@functools.lru_cache(maxsize=None)
def _case(name, dtype):
    """vit_tpu's module for variant ``name``, its perturbed ``init`` variables
    (jitted), and the numpy inputs."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.attention import Attention as JaxAttention

    flags, n, n_ctx, biased = VARIANTS[name]
    heads, dim_head = _geometry(name)
    jflags = {k: v for k, v in flags.items() if k != "cross"}
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    jmod = JaxAttention(dim=DIM, heads=heads, dim_head=dim_head, dtype=jd, **jflags)
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((2, n, DIM)).astype(np.float32)
    ctx = None if n_ctx is None else rng.standard_normal((2, n_ctx, DIM)).astype(np.float32)
    n_k = n if ctx is None else n + n_ctx
    bias = 0.5 * rng.standard_normal((1, heads, n, n_k)).astype(np.float32) if biased else None
    kw = {} if ctx is None else dict(kv_include_self=True)
    init = jax.jit(functools.partial(jmod.init, **kw))
    args = (jnp.asarray(x),) if ctx is None else (jnp.asarray(x), jnp.asarray(ctx))
    v = init({"params": jax.random.PRNGKey(3)}, *args, bias=None if bias is None else
             jnp.asarray(bias))
    v = jax.tree.map(lambda a: np.asarray(a, np.float32)
                     + 0.02 * rng.standard_normal(a.shape).astype(np.float32), v)
    for key in ("mix_heads_pre", "mix_heads_post", "reattn_weights"):
        if key in v["params"]:  # mixes of unit scale, so that a wrong mix shows
            v["params"][key] = v["params"][key] * 25
    return jmod, v, x, ctx, bias


def _outputs(name, dtype, mode, monkeypatch, fault=None):
    """(the port's output, vit_tpu's) for variant ``name``; ``fault`` plants
    a fault in the port's module (or returns the bias to pass it)."""
    import jax.numpy as jnp

    jmod, v, x, ctx, bias = _case(name, dtype)
    jd = getattr(jnp, dtype)
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    jargs = (jnp.asarray(x, jd),) if ctx is None else (jnp.asarray(x, jd), jnp.asarray(ctx, jd),
                                                       True)
    ref = np.asarray(jmod.apply(v, *jargs, bias=None if bias is None else jnp.asarray(bias)),
                     np.float32)
    flags = VARIANTS[name][0]
    heads, dim_head = _geometry(name)
    td = getattr(torch, dtype)
    tmod = Attention(DIM, heads, dim_head, **flags, dtype=td if dtype != "float32" else None,
                     device="cpu")
    tmod.load_state_dict(from_jax_params(v, {}), strict=True)
    tb = None if bias is None else torch.from_numpy(bias)
    if fault is not None:
        tb = fault(tmod, tb)
    targs = (torch.from_numpy(x).to(td),) if ctx is None else (
        torch.from_numpy(x).to(td), torch.from_numpy(ctx).to(td), True)
    with torch.inference_mode():
        out = tmod(*targs, bias=tb).float().numpy()
    return out, ref


def _err(out, ref):
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_vit_tpu(name, mode, monkeypatch):
    out, ref = _outputs(name, "float32", mode, monkeypatch)
    assert _err(out, ref) <= TOL["float32"], _err(out, ref)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("name", BF16)
def test_variant_matches_vit_tpu_in_bf16(name, mode, monkeypatch):
    out, ref = _outputs(name, "bfloat16", mode, monkeypatch)
    assert _err(out, ref) <= TOL["bfloat16"], _err(out, ref)


def _transposed(attr):
    def plant(m, bias):
        getattr(m, attr).data = getattr(m, attr).data.t().contiguous()
        return bias
    return plant


def _set(attr, value):
    def plant(m, bias):
        setattr(m, attr, value)
        return bias
    return plant


# (variant, the fault planted in the port): each must fail TOL["float32"]
FAULTS = {
    "re-attention mix transposed": ("c: talking heads and re-attention",
                                    _transposed("reattn_weights")),
    "diagonal left unmasked (self)": ("a: qkv bias, mask_self", _set("mask_self", False)),
    "diagonal left unmasked (cross)": ("b: cross, mask_self", _set("mask_self", False)),
    "learned temperature ignored": ("b: cross, learned temperature, low-query",
                                    _set("learned_temperature", False)),
    "bias keys reversed": ("b: cross, bias", lambda m, bias: bias.flip(-1)),
    "residual added": ("e: re-attention without the residual", _set("fuse_residual", True)),
    "post-softmax mix transposed": ("d: talking heads, no projection",
                                    _transposed("mix_heads_post")),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_variant_faults_fail(fault, monkeypatch):
    name, plant = FAULTS[fault]
    out, ref = _outputs(name, "float32", "xla", monkeypatch, fault=plant)
    assert _err(out, ref) > 10 * TOL["float32"], _err(out, ref)


def test_no_variant_raises_and_the_routes_are_vit_tpus():
    """Every variant builds and runs; ``mask_self`` alone on the flax branch
    (with the diagonal masked), a biased or masked cross-attention,
    post-norm self-attention without a head mix and the raw branch without
    its projection (through ``ops.qkv_attention``, at a dim_head it cannot
    hold) reach ``ops.attention`` (kernel 4 on the card); every other
    variant here materializes; none reaches a block kernel but the forced
    projection's plain block."""
    calls = {}
    real = ops.attention
    x = torch.zeros(1, 9, DIM)
    ctx = torch.zeros(1, 7, DIM)
    want = {"a: qkv bias, mask_self": True, "b: cross, mask_self": True, "b: cross, bias": False,
            "f: post-norm self-attention": False, "f: project_out forced off": False}
    with pytest.MonkeyPatch.context() as mp:
        for name, (flags, _, n_ctx, biased) in VARIANTS.items():
            mp.setattr(ops, "attention", lambda *a, name=name, **k: calls.setdefault(
                name, bool(k.get("mask_self"))) is None or real(*a, **k))
            heads, dim_head = _geometry(name)
            m = Attention(DIM, heads, dim_head, **flags, device="cpu")
            ops.reset_launch_counts()
            args = (x,) if n_ctx is None else (x[:, :5], ctx, True)
            bias = torch.zeros(1, heads, 5, 12) if biased else None
            with torch.inference_mode():
                m(*args, bias=bias)
            assert sum(ops.launch_counts().values()) == 0
    assert calls == want


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32"])
def test_depth_one_deepvit_matches_vit_tpu(dtype, mode, monkeypatch):
    """DeepViT at depth 1: vit_tpu's unscanned layer, re-attention on the
    materializing path without the residual, then ``x + attn(x)``. fp32
    within 1e-4 of the logits (|logits| ~ 2; measured 1.3e-6; bf16, held by
    tests/test_torch_vit.py, measured 2.4e-7 against 4e-3). The transposed
    re-attention mix moves them by 1.4."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import models as jm

    from vit_tpu_torch.models import DeepViT

    cfg = dict(image_size=32, patch_size=8, num_classes=10, dim=64, heads=4, mlp_dim=128,
               dim_head=16, depth=1)
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    jmodel = jm.DeepViT(**cfg, dtype=jd)
    tmodel = DeepViT(**cfg, dtype=getattr(torch, dtype) if dtype != "float32" else None,
                     device="cpu")
    img = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    v = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(1)}, jnp.asarray(img))
    rng = np.random.default_rng(2)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32)
                     + 0.02 * rng.standard_normal(a.shape).astype(np.float32), v)
    v["params"]["encoder"]["attn_0"]["reattn_weights"] *= 25
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    ref = np.asarray(jmodel.apply(v, jnp.asarray(img)), np.float32)
    tmodel.load_state_dict(from_jax_params(v, tmodel.jax_stages), strict=True)
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(img)).numpy()
    err = float(np.abs(out - ref).max())
    assert err <= (1e-4 if dtype == "float32" else 4e-3), err
    # the planted fault: the re-attention mix read transposed
    mix = tmodel.encoder.blocks[0].attn.reattn_weights
    mix.data = mix.data.t().contiguous()
    with torch.inference_mode():
        bad = tmodel(torch.from_numpy(img)).numpy()
    assert float(np.abs(bad - ref).max()) > 10 * (1e-4 if dtype == "float32" else 4e-3)
