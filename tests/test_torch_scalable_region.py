"""The port's ScalableViT and RegionViT against vit_tpu's on the CPU:
``Downsample``, ScalableViT's ``_SSA`` and ``_IWSA``, RegionViT's two
relative-position tables and a biased ``Attention`` against the flax
modules, IWSA on one window past the fused-qkv kernel's 1,024 tokens (the
kv-blocked twin against vit_tpu's kernel 3 in interpret mode and its XLA
path), chip_smoke's weight draws against vit_tpu's init trees, the tiny
models in both of vit_tpu's CPU modes (``xla``, and ``interpret``: the
Pallas kernels in interpreter mode), planted faults, serving, and the scope
of ``Dense``'s cuBLAS flag. On the card: kernel 5 at ScalableViT's four
shapes, kernel 4 at its SSA stage 3, kernel 3 at the slice's eleven, kernel
2 at its eight, and a bf16 ``Dense`` at split-K shapes with the flag at
PyTorch's default.

The tiny models are vit_tpu's ``MODEL_REGISTRY`` configs (ScalableViT: two
stages of depth 1, 4 x 4 windows then the whole map; RegionViT: two stages
of depth 1 with a PEG), a ScalableViT at depth (2, 3) with 40-wide SSA keys
(the kv-blocked twin) and the reference's block order, a RegionViT with
scanned stages of depth 2 and the three-conv tokenizer, and one with
``reference_quirks`` (785-token joint windows, the clipped bias gather, 4-D
logits). Parameters are drawn by chip_smoke's ``*_tree`` functions and
perturbed, so that no bias or LayerNorm parameter is a constant.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from chip_smoke import (
    DENSE_SHAPES,
    KV_FAULTS,
    REGION_VIT,
    SCALABLE_VIT,
    ZOO4_FLASH,
    ZOO4_KV,
    ZOO4_KV_VARIANT,
    ZOO4_MLP,
    ZOO4_QKV,
    dense_excess,
    kernel_tol,
    kv_fault_twin,
    kv_plan_c,
    region_vit_tree,
    scalable_vit_tree,
)
from vit_tpu_torch import ops
from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import RegionViT, ScalableViT
from vit_tpu_torch.models import region_vit as trv
from vit_tpu_torch.models import scalable_vit as tsv
from vit_tpu_torch.nn import (
    PEG,
    Attention,
    Dense,
    Downsample,
    ReferenceWindowRelPosBias,
    WindowRelPosBias,
)
from vit_tpu_torch.nn import embed as tembed
from vit_tpu_torch.nn.attention import mha_tokens, split_heads
from vit_tpu_torch.pipeline import InferencePipeline
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

# ops/__init__ exports functions of the modules' own names
tfa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
tqa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")

MODELS = {"scalable_vit": ScalableViT, "region_vit": RegionViT}
TREES = {"scalable_vit": scalable_vit_tree, "region_vit": region_vit_tree}
PRESETS = {"scalable_vit": (SCALABLE_VIT, 256), "region_vit": (REGION_VIT, 224)}
# The tiny models: (family, changes to the registry config).
VARIANTS = {
    "scalable_vit": ("scalable_vit", {}),
    "scalable_vit D40 reference order": ("scalable_vit", dict(depth=(2, 3), ssa_dim_key=40,
                                                              reference_block_order=True)),
    "region_vit": ("region_vit", {}),
    "region_vit scanned 3-conv": ("region_vit", dict(depth=(2, 2), tokenize_local_3_conv=True)),
    "region_vit quirks": ("region_vit", dict(reference_quirks=True)),
}

# Max |logit| difference allowed (|logits| up to 3.2 on these inputs).
# fp32: every op in fp32 on both sides, summed in other orders: 1e-4
#   (measured 6.0e-7 to 1.3e-6, both modes).
# bf16: the port rounds where vit_tpu's modules round, but sums run in other
#   orders, under jit XLA keeps some bf16 values in fp32, and at 40-wide SSA
#   keys the port's kv-blocked twin rounds the unnormalised p where vit_tpu's
#   kernel 4 (interpret) or XLA (xla) rounds the normalised P. The bound is
#   twice the larger of vit_tpu's own xla-vs-interpret gap and 0.02, as in
#   tests/test_torch_crossformer_nest.py. Measured, the port from xla /
#   interpret (vit_tpu's own gap):
#     scalable_vit                       0.0156 / 0.0156 (0.0156)
#     scalable_vit D40 reference order   0.0117 / 0.0117 (0.0)
#     region_vit                         0.0195 / 0.0156 (0.0195)
#     region_vit scanned 3-conv          0.0156 / 0.0234 (0.0195)
#     region_vit quirks                  0.0078 / 0.0156 (0.0156)
#   so every bound is 0.04: the port sits 1-3 bf16 ulps of |logit| ~2-3 from
#   vit_tpu, as vit_tpu's two modes sit from each other.
TOL_FP32 = 1e-4
# Modules against flax (max |out - ref| as a share of max |ref|): fp32 sums in
# other orders, 1e-5; bf16 one bf16 ulp of the largest output (a sum in
# another order can round to the neighbouring value).
MODULE_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}


def _config(variant):
    """The tiny model's family, config and image size."""
    from vit_tpu.models import MODEL_REGISTRY

    fam, changes = VARIANTS[variant]
    _, cfg, size = MODEL_REGISTRY[fam]
    return fam, dict(cfg, **changes), size


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    perturb = lambda a: a + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32)
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else perturb(v) for k, v in t.items()}
    return walk(tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


def _jax_model(fam):
    from vit_tpu import models as jm

    return {"scalable_vit": jm.ScalableViT, "region_vit": jm.RegionViT}[fam]


def _jax_logits(fam, cfg, tree, img, dtype, mode):
    import jax
    import jax.numpy as jnp

    jd = getattr(jnp, dtype) if dtype != "float32" else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIT_TPU_BACKEND", mode)
        out = jax.jit(_jax_model(fam)(**cfg, dtype=jd).apply)(tree, jnp.asarray(img))
        return np.asarray(out.astype(jnp.float32))


def _loaded(fam, cfg, tree, dtype=None):
    model = MODELS[fam](**cfg, dtype=dtype, device="cpu")
    model.load_state_dict(from_jax_params(tree, model.jax_stages), strict=True)
    return model


@functools.lru_cache(maxsize=None)
def _preset_tree(fam):
    """The preset's tree, drawn once for the tests that read it."""
    return TREES[fam](PRESETS[fam][0], seed=0)


def _inputs(variant):
    fam, cfg, size = _config(variant)
    img = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    return fam, cfg, img, _perturbed(TREES[fam](cfg, seed=3), seed=4)


@pytest.fixture(scope="module", params=list(VARIANTS))
def tiny(request):
    """A tiny model's family, config, images, tree, and its vit_tpu logits by
    (dtype, mode), each computed once."""
    fam, cfg, img, tree = _inputs(request.param)
    cache = {}

    def logits(dtype, mode):
        if (dtype, mode) not in cache:
            cache[dtype, mode] = _jax_logits(fam, cfg, tree, img, dtype, mode)
        return cache[dtype, mode]

    return fam, cfg, img, tree, logits


def _flax_apply(mod, tree, x, dtype, mode="xla"):
    """A flax module's output as fp32 numpy under vit_tpu's ``mode``: in bf16
    run op by op (``jax.disable_jit``, on jax arrays), where jit's excess
    precision would skip vit_tpu's roundings; in fp32 under jit."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops

    with jops.force_backend(mode):
        if dtype == "float32":
            return np.asarray(jax.jit(mod.apply)(tree, x), np.float32)
        with jax.disable_jit():
            return np.asarray(mod.apply(jax.tree.map(jnp.asarray, tree), x).astype(jnp.float32))


def _module_pair(jmod, tmod, x, dtype, seed, modes=("xla",)):
    """flax ``jmod`` initialised on ``x`` and perturbed, the port's ``tmod``
    loaded with the same tree; returns (port output, {mode: flax output},
    tree)."""
    import jax
    import jax.numpy as jnp

    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    tree = _perturbed(jax.tree.map(np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(0), xj)), seed)
    refs = {mode: _flax_apply(jmod, tree, xj, dtype, mode) for mode in modes}
    tmod.load_state_dict(from_jax_params(tree, {}), strict=True)
    with torch.inference_mode():
        out = tmod(torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype)))
    return out, refs, tree


def _module_err(out, ref):
    """max |out - ref| as a share of max |ref|, or inf where the shapes
    differ."""
    if tuple(out.shape) != ref.shape:
        return float("inf")
    return float(np.abs(out.float().numpy() - ref).max() / np.abs(ref).max())


def _dtypes(dtype):
    import jax.numpy as jnp

    return (getattr(jnp, dtype), getattr(torch, dtype)) if dtype != "float32" else (None, None)


# -- the modules -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", [16, 7])
def test_downsample_matches_flax(side, dtype):
    """The 3x3 stride-2 SAME conv with a bias, on an even map and an odd one
    (SAME's odd pixel at the end)."""
    from vit_tpu.nn.conv import Downsample as JaxDownsample

    jd, td = _dtypes(dtype)
    x = np.random.default_rng(side).standard_normal((2, side, side, 8)).astype(np.float32)
    out, refs, _ = _module_pair(JaxDownsample(16, dtype=jd), Downsample(8, 16, dtype=td,
                                                                        device="cpu"), x, dtype, 1)
    assert out.shape == (2, (side + 1) // 2, (side + 1) // 2, 16)
    assert out.dtype == getattr(torch, dtype)
    assert _module_err(out, refs["xla"]) <= MODULE_TOL[dtype]


# SSA cases: (dim, heads, dim_key, dim_value, reduction, map side). Key width 40
# fails core_fits: the port runs the kv-blocked twin where vit_tpu runs XLA
# (xla) or its kernel 4 (interpret); width 16 runs kernel 4's twin on both.
# (Reduction 1: the tiny models' stage 1.)
SSA_CASES = [(32, 2, 40, 16, 2, 8), (32, 2, 16, 16, 2, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,heads,dk,dv,r,side", SSA_CASES)
def test_ssa_matches_flax(dim, heads, dk, dv, r, side, dtype):
    """``_SSA`` against flax in both of vit_tpu's modes: LayerNorm eps 1e-5,
    the bias-free query Dense, the r x r stride-r key and value convs,
    attention at ``dim_key**-0.5``, the out Dense. bf16 within one ulp of the
    largest output: at key width 40 the port rounds the online softmax's
    unnormalised p where vit_tpu rounds P (measured within it)."""
    from vit_tpu.models.scalable_vit import _SSA as JaxSSA

    jd, td = _dtypes(dtype)
    x = np.random.default_rng(dk + side).standard_normal((2, side, side, dim)).astype(np.float32)
    tmod = tsv._SSA(dim, heads, dk, dv, r, dtype=td, device="cpu")
    out, refs, _ = _module_pair(JaxSSA(dim, heads, dk, dv, reduction_factor=r, dtype=jd), tmod,
                                x, dtype, 2, modes=("xla", "interpret"))
    assert out.dtype == getattr(torch, dtype)
    for mode, ref in refs.items():
        assert _module_err(out, ref) <= MODULE_TOL[dtype], mode


# IWSA cases: (dim, window, heads, dim_key, dim_value, map side). dim_key !=
# dim_value takes mha_tokens on three partitions. (A whole-map window: the tiny
# models' stage 1, and the 36 x 36 case below.)
IWSA_CASES = [(32, 4, 2, 16, 16, 8), (64, 2, 4, 16, 32, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,wsz,heads,dk,dv,side", IWSA_CASES)
def test_iwsa_matches_flax(dim, wsz, heads, dk, dv, side, dtype):
    """``_IWSA`` against flax in both modes: the one q|k|v product of the
    three ``_Kernel`` parameters, the LIM over the value columns, window
    attention (fused-qkv or ``mha_tokens``), the LIM added before ``to_out``."""
    from vit_tpu.models.scalable_vit import _IWSA as JaxIWSA

    jd, td = _dtypes(dtype)
    x = np.random.default_rng(side + dv).standard_normal((2, side, side, dim)).astype(np.float32)
    tmod = tsv._IWSA(dim, wsz, heads, dk, dv, dtype=td, device="cpu")
    out, refs, _ = _module_pair(JaxIWSA(dim, wsz, heads, dk, dv, dtype=jd), tmod, x, dtype, 3,
                                modes=("xla", "interpret"))
    assert out.dtype == getattr(torch, dtype)
    for mode, ref in refs.items():
        assert _module_err(out, ref) <= MODULE_TOL[dtype], mode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iwsa_past_the_fused_kernel_runs_the_kv_blocked_twin(dtype, monkeypatch):
    """One 36 x 36 window (1,296 tokens, past ``qkv_kernel_fits``'s 1,024):
    the port takes the kv-blocked twin (online softmax over 512-key chunks,
    the unnormalised p rounded), vit_tpu its kernel 3 in interpret mode (its
    VMEM estimate, 4.9 MB, is under its 10 MB limit: exact softmax, the
    normalised P rounded) and, under xla, the exact softmax in XLA. Bound:
    fp32 1e-5 of the largest output (sum orders; measured ~1e-7), bf16 one
    bf16 ulp of it (the two p roundings; measured within it)."""
    from vit_tpu.models.scalable_vit import _IWSA as JaxIWSA

    calls = []
    kv = ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a, **k: (calls.append(1), kv(*a, **k))[1])
    jd, td = _dtypes(dtype)
    x = np.random.default_rng(36).standard_normal((1, 36, 36, 32)).astype(np.float32)
    tmod = tsv._IWSA(32, None, 2, 16, 16, dtype=td, device="cpu")
    out, refs, _ = _module_pair(JaxIWSA(32, None, 2, 16, 16, dtype=jd), tmod, x, dtype, 4,
                                modes=("xla", "interpret"))
    assert calls == [1] and not tqa.qkv_kernel_fits(36 * 36, 16)
    assert not tfa.core_fits(36 * 36, 16, 16)
    for mode, ref in refs.items():
        assert _module_err(out, ref) <= MODULE_TOL[dtype], mode


@pytest.mark.parametrize("heads,w,prepend", [(4, 7, 1), (3, 2, 0), (2, 1, 1), (4, 5, 2)])
def test_window_rel_pos_bias_matches_flax(heads, w, prepend):
    """The ``(2w - 1)^2`` table gathered at each offset, zero-padded for the
    prepended tokens: bitwise (a gather)."""
    import jax
    from vit_tpu.nn.bias import WindowRelPosBias as JaxBias

    jmod = JaxBias(heads, w, prepend_tokens=prepend)
    tree = _perturbed(jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(w))), w)
    ref = np.asarray(jmod.apply(tree))
    tmod = WindowRelPosBias(heads, w, prepend_tokens=prepend, device="cpu")
    tmod.load_state_dict(from_jax_params(tree, {}), strict=True)
    with torch.no_grad():
        out = tmod()
    n = w * w + prepend
    assert out.dtype == torch.float32 and out.shape == (1, heads, n, n)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("w,grid_h,grid_w", [(7, 28, 28), (7, 14, 14), (7, 7, 7), (2, 3, 5)])
def test_reference_window_rel_pos_bias_matches_flax(w, grid_h, grid_w):
    """The reference's gather over the actual grid (stride ``[1, 2w - 1]``,
    out-of-table indices clipped: most of them at the quirks' 28 x 28 grid),
    one leading zero row and column: bitwise."""
    import jax
    from vit_tpu.nn.bias import ReferenceWindowRelPosBias as JaxBias

    jmod = JaxBias(4, w, grid_h, grid_w)
    tree = _perturbed(jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(w))), w)
    ref = np.asarray(jmod.apply(tree))
    tmod = ReferenceWindowRelPosBias(4, w, device="cpu")
    tmod.load_state_dict(from_jax_params(tree, {}), strict=True)
    with torch.no_grad():
        out = tmod(grid_h, grid_w)
    assert out.shape == (1, 4, grid_h * grid_w + 1, grid_h * grid_w + 1)
    np.testing.assert_array_equal(out.numpy(), ref)


# A biased self-attention layer: (what, Attention's flags).
BIAS_CASES = {"unfused": {}, "fuse_residual": dict(fuse_residual=True),
              "talking heads": dict(talking_heads=True, fuse_residual=True)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_attention_with_a_bias_matches_vit_tpu(case, dtype, monkeypatch):
    """``Attention.forward(x, bias=)`` against vit_tpu's in interpret mode
    (bf16 op by op), a ``[1, H, N, N]`` bias: fp32 within 1e-5 of the
    output's scale, bf16 within one ulp of it. A bias keeps the layer off
    every block kernel, as vit_tpu's ``bias is None`` term does: with
    ``fuse_residual`` it is ``ops.qkv_attention`` and the residual added
    apart; talking heads take the materializing path."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops
    from vit_tpu.nn.attention import Attention as JaxAttention

    for name in ("attention_block", "talking_heads_block", "reattention_block"):
        monkeypatch.setattr(ops, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} called"))
    kw = dict(norm_eps=1e-5, **BIAS_CASES[case])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    bias = rng.standard_normal((1, 4, 17, 17)).astype(np.float32)
    jd, td = _dtypes(dtype)
    mod = JaxAttention(dim=64, heads=4, dim_head=32, dtype=jd, **kw)
    n = lambda *s: 0.1 * rng.standard_normal(s).astype(np.float32)
    params = {"norm_scale": 1.0 + n(64), "norm_bias": n(64), "qkv_kernel": n(64, 384),
              "out_kernel": n(128, 64), "out_bias": n(64)}
    if "talking_heads" in kw:
        params.update(mix_heads_pre=np.eye(4, dtype=np.float32) + n(4, 4),
                      mix_heads_post=np.eye(4, dtype=np.float32) + n(4, 4))
    tree = {"params": params}
    xj, bj = jnp.asarray(x, jd or jnp.float32), jnp.asarray(bias)

    with jops.force_backend("interpret"):
        if dtype == "float32":
            ref = np.asarray(jax.jit(lambda t, v: mod.apply(t, v, bias=bj))(tree, xj))
        else:
            with jax.disable_jit():
                ref = np.asarray(mod.apply(jax.tree.map(jnp.asarray, tree), xj, bias=bj)
                                 .astype(jnp.float32))
    attn = Attention(64, 4, 32, dtype=td, device="cpu", **kw)
    attn.load_state_dict(from_jax_params(tree, {}), strict=True)
    with torch.inference_mode():
        out = attn(torch.from_numpy(x).to(getattr(torch, dtype)), bias=torch.from_numpy(bias))
    assert out.dtype == getattr(torch, dtype)
    assert _module_err(out, ref) <= MODULE_TOL[dtype]


def test_a_bias_on_cross_attention_raises(monkeypatch):
    """A bias on cross-attention raised before the attention variants were
    ported (the name is kept from then). Now it runs the flash route with
    the bias (``ops.attention``, kernel 4 on the card; no low-query path)
    and matches vit_tpu's in both JAX modes within
    tests/test_torch_attention_variants.py's 2e-5 of the largest output; the
    bias with its keys reversed does not."""
    from test_torch_attention_variants import TOL, _err, _outputs

    for mode in ("xla", "interpret"):
        out, ref = _outputs("b: cross, bias", "float32", mode, monkeypatch)
        assert _err(out, ref) <= TOL["float32"], (mode, _err(out, ref))
    out, ref = _outputs("b: cross, bias", "float32", "xla", monkeypatch,
                        fault=lambda m, bias: bias.flip(-1))
    assert _err(out, ref) > 10 * TOL["float32"]


# -- the trees and the models --------------------------------------------------


@pytest.mark.parametrize("variant", ["preset scalable_vit", "preset region_vit", *VARIANTS])
def test_trees_have_the_names_and_shapes_of_init(variant):
    """chip_smoke draws the weights with numpy in vit_tpu's layout; its tree
    has the leaves of vit_tpu's ``init`` (ScalableViT's first blocks
    unscanned, a stage's other blocks stacked when more than one; RegionViT's
    table and its stacked blocks), its conv kernels the spread of
    lecun-normal over their real fan-in."""
    import jax
    import jax.numpy as jnp

    if variant.startswith("preset"):
        fam = variant.split()[1]
        cfg, size = PRESETS[fam]
    else:
        fam, cfg, size = _config(variant)
    want = jax.eval_shape(_jax_model(fam)(**cfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3), jnp.float32))
    tree = _preset_tree(fam) if variant.startswith("preset") else TREES[fam](cfg, seed=0)
    assert _leaves(tree) == _leaves(jax.tree.map(lambda a: a, want))
    if variant == "preset scalable_vit":
        k = tree["params"]["stage_2"]["iwsa"]["lim"]["kernel"]  # [19, 3, 3, 256, 256]
        assert abs(k.std() * (3 * 3 * 256) ** 0.5 - 1.0) < 0.05
    if variant == "preset region_vit":
        k = tree["params"]["local_conv"]["kernel"]  # [8, 8, 3, 64]: fan-in 192
        assert abs(k.std() * (8 * 8 * 3) ** 0.5 - 1.0) < 0.05


def test_converter_unstacks_the_scanned_stacks():
    """``jax_stages`` lists only the scanned stacks: ScalableViT's
    ``stage_{s}`` of more than one block (``{"stage_2": 19}`` at the
    preset), RegionViT's ``stage_{s}/blocks`` deeper than 1; their leaves go
    to ``.{i}``, conv kernels turn to OIHW."""
    preset = ScalableViT(**SCALABLE_VIT, device="meta")
    assert preset.jax_stages == {"stage_2": 19}
    fam, cfg, _ = _config("scalable_vit D40 reference order")
    tree = scalable_vit_tree(cfg, seed=3)
    model = ScalableViT(**cfg, device="cpu")
    assert model.jax_stages == {"stage_1": 2}
    state = from_jax_params(tree, model.jax_stages)
    model.load_state_dict(state, strict=True)
    p = tree["params"]
    np.testing.assert_array_equal(state["stage_1.1.iwsa.lim.kernel"].numpy(),
                                  p["stage_1"]["iwsa"]["lim"]["kernel"][1].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["stage_0.ssa.to_q.kernel"].numpy(),
                                  p["stage_0"]["ssa"]["to_q"]["kernel"])
    _, cfg, _ = _config("region_vit scanned 3-conv")
    model = RegionViT(**cfg, device="cpu")
    assert model.jax_stages == {"stage_0/blocks": 2, "stage_1/blocks": 2}
    model.load_state_dict(from_jax_params(region_vit_tree(cfg, seed=3), model.jax_stages),
                          strict=True)
    assert RegionViT(**_config("region_vit")[1], device="cpu").jax_stages == {}


@pytest.mark.parametrize("dtype,mode", [("float32", "xla"), ("float32", "interpret"),
                                        ("bfloat16", "xla"), ("bfloat16", "interpret")])
def test_family_matches_jax(dtype, mode, tiny):
    fam, cfg, img, tree, jax_logits = tiny
    ref = jax_logits(dtype, mode)
    td = getattr(torch, dtype) if dtype != "float32" else None
    model = _loaded(fam, cfg, tree, td)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = model(torch.from_numpy(img))
    assert sum(ops.launch_counts().values()) == 0
    assert out.dtype == (td or torch.float32) and out.shape == ref.shape  # as JAX's
    err = float(np.abs(out.float().numpy() - ref).max())
    if dtype == "float32":
        assert err <= TOL_FP32, err
    else:
        control = float(np.abs(jax_logits(dtype, "interpret" if mode == "xla" else "xla")
                               - ref).max())
        assert err <= 2 * max(control, 0.02), (err, control)


def _lim_after_to_out(self, x, *_, **__):
    """``_IWSA.forward`` with the LIM added after ``to_out``, not before (its
    training arguments ignored: the test runs inference)."""
    b, h, w, _ = x.shape
    x = self.norm(x)
    wqkv = torch.cat([self.to_q.kernel, self.to_k.kernel, self.to_v.kernel], dim=1).to(x.dtype)
    qkv = tembed._mm(x, wqkv, x.dtype)
    out = ops.qkv_attention(ops.window_partition(qkv, self.window_size or h), self.heads,
                            scale=self.scale)
    return self.to_out(ops.window_unpartition(out, self.window_size or h, h, w)) + \
        self.lim(qkv[..., 2 * self.hk:])


def _region_token_appended(self, local_tokens, region, bias, window, *_):
    """``_R2LBlock.forward`` with each region token behind its window (its
    training arguments ignored: the test runs inference)."""
    b, lh, lw, d = local_tokens.shape
    n_win = region.shape[1]
    region = region + self.attn(region)
    joint = torch.cat([ops.window_partition(local_tokens, window),
                       region.reshape(b * n_win, 1, d)], dim=1)
    joint = joint + self.attn(joint, bias=bias)
    joint = joint + self.ff(joint)
    return (ops.window_unpartition(joint[:, :-1], window, lh, lw),
            joint[:, -1:].reshape(b, n_win, d))


def _unclipped(self, window_h, window_w):
    """``ReferenceWindowRelPosBias`` without the clip: the out-of-table
    indices read NaN, as CPU JAX's gather fills them."""
    w = self.declared_window_size
    span = 2 * w - 1
    gx, gy = np.meshgrid(np.arange(window_h), np.arange(window_w), indexing="ij")
    grid = np.stack([gx.flatten(), gy.flatten()])
    rel = grid[:, :, None] - grid[:, None, :] + (w - 1)
    idx = torch.as_tensor(rel[0] + rel[1] * span)
    inside = (idx >= 0) & (idx < span * span)
    table = self.rel_pos_bias.embedding[idx.clamp(0, span * span - 1)]
    table = torch.where(inside[..., None], table, torch.nan)
    return torch.nn.functional.pad(table.permute(2, 0, 1), (1, 0, 1, 0))[None]


def _ignored_order(model):
    model.reference_block_order = False
    for m in model.modules():
        if isinstance(m, tsv._ScalableBlock):
            m.reference_block_order = False


# (variant, plant(monkeypatch, model)): each fault misses the fp32 bound.
MODEL_FAULTS = {
    "LIM added after to_out": ("scalable_vit", lambda mp, m: mp.setattr(
        tsv._IWSA, "forward", _lim_after_to_out)),
    "PEG splice skipped": ("scalable_vit", lambda mp, m: mp.setattr(
        PEG, "forward", lambda self, x: x)),
    "reference_block_order ignored": ("scalable_vit D40 reference order",
                                      lambda mp, m: _ignored_order(m)),
    "quirks' index clip dropped (NaN)": ("region_vit quirks", lambda mp, m: mp.setattr(
        ReferenceWindowRelPosBias, "forward", _unclipped)),
    "rel-pos bias transposed": ("region_vit", lambda mp, m: mp.setattr(
        WindowRelPosBias, "forward", lambda self: self._gather(self.index,
                                                               self.prepend_tokens).mT)),
    "region token appended, not prepended": ("region_vit", lambda mp, m: mp.setattr(
        trv._R2LBlock, "forward", _region_token_appended)),
}


@pytest.mark.parametrize("fault", list(MODEL_FAULTS))
def test_model_faults_fail_the_bound(fault, monkeypatch):
    """Each planted fault misses the fp32 bound that the port meets (the
    unclipped gather's NaN misses every bound)."""
    variant, plant = MODEL_FAULTS[fault]
    fam, cfg, img, tree = _inputs(variant)
    ref = _jax_logits(fam, cfg, tree, img, "float32", "xla")
    model = _loaded(fam, cfg, tree)
    with torch.inference_mode():
        good = float(np.abs(model(torch.from_numpy(img)).numpy() - ref).max())
        plant(monkeypatch, model)
        bad = float(np.abs(model(torch.from_numpy(img)).numpy() - ref).max())
    assert good <= TOL_FP32 and not bad <= TOL_FP32, (good, bad)


# Each kernel's plain twin, by the kernel it stands for on the CPU.
TWINS = {"reference_attention_kv_blocked": "flash_attention_kv_blocked",
         "reference_attention": "flash_attention", "xla_qkv_attention": "qkv_attention",
         "reference_mlp": "fused_mlp", "xla_attention_block": "attention_block",
         "xla_window_attention_block": "window_attention_block"}


@pytest.mark.parametrize("fam", list(MODELS))
def test_presets_route_as_the_card_would(fam, monkeypatch):
    """A bf16 preset forward at batch 1 on the CPU calls each kernel's twin
    as often as chip_smoke's FAMILY_LAUNCHES wants the kernel launched a
    forward on the card (the dispatch picks the twin of the kernel the card
    would run), and no other."""
    from chip_smoke import FAMILY_LAUNCHES

    calls = {}
    for name, kernel in TWINS.items():
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _k=kernel, _f=fn, **kw: (
            calls.__setitem__(_k, calls.get(_k, 0) + 1), _f(*a, **kw))[1])
    cfg, size = PRESETS[fam]
    model = MODELS[fam](**cfg, dtype=torch.bfloat16, device="cpu").eval()
    model.load_state_dict(from_jax_params(_preset_tree(fam), model.jax_stages), strict=True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, size, size, 3),
                                                                  dtype=np.float32))
    with torch.inference_mode():
        out = model(x.bfloat16())
    assert out.shape == (1, 1000) and torch.isfinite(out.float()).all()
    assert calls == {k: n for k, n in FAMILY_LAUNCHES[fam].items() if n}


@pytest.mark.parametrize("fam", list(MODELS))
def test_default_constructors_ask_for_the_card(fam):
    _, cfg, _ = _config(fam)
    if torch.cuda.is_available():
        assert next(MODELS[fam](**cfg).head.parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            MODELS[fam](**cfg)


@pytest.mark.parametrize("fam", list(MODELS))
def test_server_answers_requests(fam):
    fam, cfg, _, tree = _inputs(fam)
    size = _config(fam)[2]
    pipe = InferencePipeline(_loaded(fam, cfg, tree), image_size=size, batch_size=4,
                             dtype=torch.float32)
    imgs = np.random.default_rng(2).integers(0, 256, (6, size, size, 3), dtype=np.uint8)
    with BatchingServer(pipe, decoder=JpegDecoder(size=size), max_wait_ms=20) as server:
        futures = [server.submit(im) for im in imgs]
        rows = np.stack([f.result(timeout=60) for f in futures])
    direct = np.concatenate([pipe(imgs[i: i + 1]) for i in range(6)])
    assert rows.shape == (6, 10) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, direct, atol=1e-5, rtol=0)


# -- Dense's cuBLAS flag ----------------------------------------------------------


@pytest.mark.parametrize("caller", [True, False, (False, False)])
@pytest.mark.parametrize("raises", [False, True])
def test_mm_rounded_restores_the_callers_flag(caller, raises, monkeypatch):
    """``_mm_rounded``'s cuBLAS branch (a bf16 product on a CUDA tensor,
    entered here with ``is_cuda`` patched) issues its product with
    ``allow_bf16_reduced_precision_reduction`` off, and gives the caller's
    setting back, split-K part included, also when the product raises."""
    flags = torch.backends.cuda.matmul
    state = torch._C._get_cublas_allow_bf16_reduced_precision_reduction
    saved = state()
    seen = []

    def matmul(a, b):
        seen.append(flags.allow_bf16_reduced_precision_reduction)
        if raises:
            raise RuntimeError("planted")
        return a.float().matmul(b.float()).bfloat16()

    try:
        flags.allow_bf16_reduced_precision_reduction = caller
        before = state()
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        monkeypatch.setattr(torch, "matmul", matmul)
        a, b = torch.ones(2, 3, dtype=torch.bfloat16), torch.ones(3, 4, dtype=torch.bfloat16)
        if raises:
            with pytest.raises(RuntimeError, match="planted"):
                tembed._mm_rounded(a, b, torch.bfloat16)
        else:
            assert tembed._mm_rounded(a, b, torch.bfloat16).shape == (2, 4)
        monkeypatch.undo()
        assert seen == [False] and state() == before
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("what,rows,k,n", DENSE_SHAPES,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_dense_at_split_k_shapes_sums_in_fp32_at_the_default_flag(cuda, what, rows, k, n):
    """A bf16 ``Dense`` at batch 1 (few rows, K 11,907 / 3,840 / 2,352: where
    cuBLAS would add split-K partials in bf16) with
    ``allow_bf16_reduced_precision_reduction`` at PyTorch's default, on: each
    value within one bf16 ulp plus the fp32 sum-order slack of its plain
    product (chip_smoke's ``dense_excess``), and the flag as it was after."""
    flags = torch.backends.cuda.matmul
    saved = torch._C._get_cublas_allow_bf16_reduced_precision_reduction()
    flags.allow_bf16_reduced_precision_reduction = True  # PyTorch's default
    try:
        before = torch._C._get_cublas_allow_bf16_reduced_precision_reduction()
        gen = torch.Generator(device=cuda).manual_seed(k)
        dense = Dense(k, n, use_bias=False, dtype=torch.bfloat16, device=cuda)
        with torch.no_grad():
            dense.kernel.copy_(torch.randn(k, n, generator=gen, device=cuda) / k**0.5)
        x = torch.randn(1, rows, k, generator=gen, device=cuda).bfloat16()
        with torch.inference_mode():
            out = dense(x)
            with ops.force_backend("torch"):
                ref = dense(x)
        assert torch._C._get_cublas_allow_bf16_reduced_precision_reduction() == before
        assert dense_excess(out, ref, x, dense.kernel.bfloat16()) <= 0.0
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved


@pytest.mark.cuda
@pytest.mark.parametrize("what,nq,nk,heads,d,dv", ZOO4_KV + (ZOO4_FLASH,),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_attention_kernels_at_scalable_vit_shapes(cuda, what, nq, nk, heads, d, dv):
    """ScalableViT's attention as the model calls it, batch 8: IWSA stage 0's
    fused rows through ``ops.qkv_attention`` and SSA's rows through
    ``mha_tokens`` launch kernel 5 once (its C plan ``kv_blocked_layout``'s
    ZOO4_KV_VARIANT) and hold its twin at the 64-key chunk within
    kernel_tol; SSA stage 3 launches kernel 4 once. At IWSA stage 0 the twin
    with alpha dropped fails the bound."""
    gen = torch.Generator(device=cuda).manual_seed(nq + d)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda).bfloat16()
    resident = tfa.core_fits(nk, d, dv)
    name = "flash_attention" if resident else "flash_attention_kv_blocked"
    if not resident:
        plan = tfa.kv_blocked_layout(nk, d, dv)
        assert kv_plan_c(nk, d, dv) == plan and plan.variant == ZOO4_KV_VARIANT
    before = ops.launch_counts()
    if what.startswith("IWSA"):
        qkv = r(8, nq, 3 * heads * d)
        out = ops.qkv_attention(qkv, heads, scale=d**-0.5)
        q, k, v = (split_heads(t, heads) for t in qkv.chunk(3, dim=-1))
    else:
        rows = r(8, nq, heads * d), r(8, nk, heads * d), r(8, nk, heads * dv)
        out = mha_tokens(*rows, heads, scale=d**-0.5)
        q, k, v = (split_heads(t, heads) for t in rows)
    after = ops.launch_counts()
    assert {k_: c - before[k_] for k_, c in after.items() if c != before[k_]} == {name: 1}
    if resident:
        ref = tfa.reference_attention(q, k, v, scale=d**-0.5)
    else:
        ref = tfa.reference_attention_kv_blocked(q, k, v, scale=d**-0.5, block_k=tfa.KV_CHUNK)
    ref = ref.transpose(1, 2).reshape(out.shape)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err
    if nk > tfa.KV_CHUNK:
        bad = kv_fault_twin(KV_FAULTS[0], q, k, v).transpose(1, 2).reshape(out.shape)
        assert (bad.float() - ref.float()).abs().max().item() > kernel_tol(ref, None, out.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("what,per,n,heads,biased", ZOO4_QKV,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_qkv_attention_kernel_at_the_slice_shapes(cuda, what, per, n, heads, biased):
    """Kernel 3 at IWSA's three maps and RegionViT's eight shapes (heads of
    32; the joint windows with a ``[1, 4, 50, 50]`` bias), batch 8, against
    its twin within kernel_tol: one launch (at 1 and 4 tokens too)."""
    gen = torch.Generator(device=cuda).manual_seed(n + per)
    qkv = torch.randn(8 * per, n, 3 * heads * 32, generator=gen, device=cuda).bfloat16()
    bias = torch.randn(1, heads, n, n, generator=gen, device=cuda) if biased else None
    before = ops.launch_counts()["qkv_attention"]
    out = ops.qkv_attention(qkv, heads, bias, scale=32**-0.5)
    assert ops.launch_counts()["qkv_attention"] == before + 1
    ref = tqa.xla_qkv_attention(qkv, heads, bias, scale=32**-0.5)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("what,n,dim,f,eps", ZOO4_MLP,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_mlp_kernel_at_the_slice_shapes(cuda, what, n, dim, f, eps):
    """Kernel 2 at the slice's eight MLP shapes (batch 8, without the
    residual, as ConvMLP and FeedForward call it) against its twin, within
    kernel_tol."""
    from vit_tpu_torch.ops.fused_mlp import reference_mlp

    gen = torch.Generator(device=cuda).manual_seed(n + dim)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    args = (r(8, n, dim).bfloat16(), (r(dim, f) / dim**0.5).bfloat16(), 0.1 * r(f),
            (r(f, dim) / f**0.5).bfloat16(), 0.1 * r(dim), 1.0 + 0.1 * r(dim), 0.1 * r(dim))
    kw = dict(activation="gelu", residual=False, ln_eps=eps)
    before = ops.launch_counts()["fused_mlp"]
    out = ops.mlp(*args, **kw)
    assert ops.launch_counts()["fused_mlp"] == before + 1
    ref = reference_mlp(*args, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err
