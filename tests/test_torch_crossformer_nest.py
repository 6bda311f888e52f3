"""The port's CrossFormer and NesT against vit_tpu's on the CPU: the block and
dilated partitions bitwise against JAX's, ``Conv`` with explicit padding,
``CrossEmbedLayer``, ``Aggregate`` and ``DynamicPositionBias`` against the
flax modules, the window twin at CrossFormer's window sizes against JAX's
kernel in interpret mode, chip_smoke's weight draws against vit_tpu's init
trees, the tiny models in both of vit_tpu's CPU modes (``xla``, and
``interpret``: the Pallas kernels in interpreter mode), planted faults, and
serving. On the card: kernel 6 at CrossFormer's eight window shapes, kernel
3 at NesT's three, kernel 2 at the slice's seven MLP shapes.

The tiny models are vit_tpu's ``MODEL_REGISTRY`` configs (CrossFormer: two
stages of depth 1, windows of 49, 16 and 4 tokens; NesT: two hierarchies),
a CrossFormer with a scanned stage of depth 2, 1-token dilated windows and
the reference's DPB (``reference_quirks=True``), and a NesT of three
hierarchies (16 blocks, two aggregates). Parameters are drawn by
chip_smoke's ``*_tree`` functions and perturbed, so that no bias or
LayerNorm parameter is a constant.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import (
    CROSSFORMER,
    CROSSFORMER_ROUTE,
    CROSSFORMER_WINDOWS,
    NEST,
    NEST_QKV,
    WINDOW_FAULTS,
    ZOO3_MLP,
    crossformer_tree,
    kernel_tol,
    nest_tree,
    window_fault_twin,
)
from vit_tpu_torch import ops
from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import CrossFormer, NesT
from vit_tpu_torch.nn import Aggregate, Conv, CrossEmbedLayer, DynamicPositionBias
from vit_tpu_torch.nn import conv as tconv
from vit_tpu_torch.pipeline import InferencePipeline
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

# ops/__init__ exports functions of the modules' own names
twa = importlib.import_module("vit_tpu_torch.ops.window_attention")
tqa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")

MODELS = {"crossformer": CrossFormer, "nest": NesT}
TREES = {"crossformer": crossformer_tree, "nest": nest_tree}
PRESETS = {"crossformer": CROSSFORMER, "nest": NEST}
# The tiny models: (family, changes to the registry config).
VARIANTS = {
    "crossformer": ("crossformer", {}),
    "crossformer scanned quirks": ("crossformer", dict(depth=(1, 2), global_window_size=(4, 1),
                                                       reference_quirks=True)),
    "nest": ("nest", {}),
    "nest 3 hierarchies": ("nest", dict(image_size=32, patch_size=2, num_hierarchies=3,
                                        block_repeats=(1, 1, 2))),
}

# Max |logit| difference allowed (|logits| up to 3.0 on these inputs).
# fp32: every op in fp32 on both sides, summed in other orders: 1e-4
#   (measured 4.8e-7 to 1.2e-6, both modes).
# bf16: the port rounds where vit_tpu's kernels and modules round, but sums
#   run in other orders, and under jit XLA keeps some bf16 values in fp32, so
#   a value of the stream can land one bf16 ulp away. The bound is twice the
#   larger of vit_tpu's own xla-vs-interpret gap and 0.02, as in
#   tests/test_torch_small_vits.py. Measured, the port from xla / interpret
#   (vit_tpu's own gap):
#     crossformer                  0.0039 / 0.0078 (0.0078)
#     crossformer scanned quirks   0.0156 / 0.0156 (0.0156)
#     nest                         0.0156 / 0.0156 (0.0)
#     nest 3 hierarchies           0.0195 / 0.0195 (0.0)
#   so every bound is 0.04: the port sits 1-2.5 bf16 ulps of |logit| ~2-3
#   from vit_tpu, as vit_tpu's two modes sit from each other.
TOL_FP32 = 1e-4
# Window twin against JAX's (max |out - ref| as a share of max |ref|): fp32
# sums in other orders, 2e-5; bf16 rounds at the same sites, a sum's order
# can move a rounding by an ulp: 2^-7 (tests/test_torch_flash_window.py).
WIN_TOL = {"float32": 2e-5, "bfloat16": 2.0**-7}


def _config(variant):
    """The tiny model's family, config and image size."""
    from vit_tpu.models import MODEL_REGISTRY

    fam, changes = VARIANTS[variant]
    _, cfg, size = MODEL_REGISTRY[fam]
    cfg = dict(cfg, **changes)
    return fam, cfg, cfg.get("image_size", size)


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

    return {"crossformer": jm.CrossFormer, "nest": jm.NesT}[fam]


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


@pytest.fixture(scope="module", params=list(VARIANTS))
def tiny(request):
    """A tiny model's family, config, images, tree, and its vit_tpu logits by
    (dtype, mode), each computed once."""
    fam, cfg, size = _config(request.param)
    img = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    tree = _perturbed(TREES[fam](cfg, seed=3), seed=4)
    cache = {}

    def logits(dtype, mode):
        if (dtype, mode) not in cache:
            cache[dtype, mode] = _jax_logits(fam, cfg, tree, img, dtype, mode)
        return cache[dtype, mode]

    return fam, cfg, img, tree, logits


def _flax_apply(mod, tree, x, dtype):
    """A flax module's output as fp32 numpy: in bf16 run op by op
    (``jax.disable_jit``, on jax arrays), where jit's excess precision would
    skip vit_tpu's roundings; in fp32 under jit."""
    import jax
    import jax.numpy as jnp

    if dtype == "float32":
        return np.asarray(jax.jit(mod.apply)(tree, x), np.float32)
    with jax.disable_jit():
        return np.asarray(mod.apply(jax.tree.map(jnp.asarray, tree), x).astype(jnp.float32))


def _module_pair(jmod, tmod, x, dtype, seed):
    """flax ``jmod`` initialised on ``x`` and perturbed, the port's ``tmod``
    loaded with the same tree; returns (port output, flax output, tree)."""
    import jax
    import jax.numpy as jnp

    jd = getattr(jnp, dtype)
    xj = jnp.asarray(x).astype(jd)
    tree = _perturbed(jax.tree.map(np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(0), xj)), seed)
    ref = _flax_apply(jmod, tree, xj, dtype)
    tmod.load_state_dict(from_jax_params(tree, {}), strict=True)
    with torch.inference_mode():
        out = tmod(torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype)))
    return out, ref, tree


def _module_err(out, ref):
    """max |out - ref| as a share of max |ref|, or inf where the shapes
    differ."""
    if tuple(out.shape) != ref.shape:
        return float("inf")
    return float(np.abs(out.float().numpy() - ref).max() / np.abs(ref).max())


# fp32: sums in other orders, 1e-5 of the largest output; bf16: one bf16 ulp
# of it (a sum in another order can round to the neighbouring value).
MODULE_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}


# -- the partitions -------------------------------------------------------------


@pytest.mark.parametrize("kind,n,shape", [
    ("block", 2, (2, 8, 8, 5)), ("block", 4, (1, 16, 8, 3)), ("block", 1, (2, 4, 4, 2)),
    ("dilated", 4, (2, 28, 28, 3)), ("dilated", 2, (2, 14, 14, 4)), ("dilated", 1, (1, 7, 7, 8)),
])
def test_partitions_are_bitwise_jax_and_invert(kind, n, shape):
    """NesT's blocks (1, 2 and 4 a side) and CrossFormer's dilated windows
    (8 x 8 down to 1 x 1 tokens) against vit_tpu.ops, bitwise; the inverse
    gives the map back."""
    jw = importlib.import_module("vit_tpu.ops.windows")
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    part, unpart = getattr(ops, f"{kind}_partition"), getattr(ops, f"{kind}_unpartition")
    out = part(torch.from_numpy(x), n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(getattr(jw, f"{kind}_partition")(x, n)))
    b, h, w, _ = shape
    back = unpart(out, n) if kind == "block" else unpart(out, n, h, w)
    jback = getattr(jw, f"{kind}_unpartition")(np.asarray(out), *((n,) if kind == "block"
                                                                  else (n, h, w)))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(np.asarray(jback), x)


# -- the conv modules ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,s,pad", [(8, 4, ((2, 2), (2, 2))), (3, 2, ((0, 1), (1, 0))),
                                     (4, 2, ((1, 1), (1, 1)))])
def test_conv_with_explicit_padding_matches_flax(k, s, pad, dtype):
    """``Conv(padding=[(low, high), (low, high)])`` against flax ``nn.Conv``
    with the same pairs, an odd pair included, on a 15 x 13 map."""
    import flax.linen as fnn
    import jax.numpy as jnp

    x = np.random.default_rng(k + s).standard_normal((2, 15, 13, 6)).astype(np.float32)
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    td = getattr(torch, dtype) if dtype != "float32" else None
    out, ref, _ = _module_pair(fnn.Conv(10, (k, k), strides=s, padding=list(pad), dtype=jd),
                               Conv(6, 10, k, strides=s, padding=list(pad), dtype=td,
                                    device="cpu"), x, dtype, 5)
    assert out.dtype == getattr(torch, dtype)
    assert _module_err(out, ref) <= MODULE_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernels,stride,side", [((4, 8, 16, 32), 4, 32), ((32, 4, 16, 8), 4, 30),
                                                 ((2, 4), 2, 14), ((4, 2), 2, 15)])
def test_cross_embed_layer_matches_flax(kernels, stride, side, dtype):
    """CrossFormer's cross-scale embedding at its stage-0 kernels (stride 4:
    8 + 4 + 2 + 2 channels of 16, kernel sizes sorted) and its later ones
    (stride 2), on maps that divide by the stride and that do not."""
    import jax.numpy as jnp
    from vit_tpu.nn.conv import CrossEmbedLayer as JaxCrossEmbed

    x = np.random.default_rng(side).standard_normal((2, side, side, 3)).astype(np.float32)
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    td = getattr(torch, dtype) if dtype != "float32" else None
    tmod = CrossEmbedLayer(3, 16, kernels, stride, dtype=td, device="cpu")
    out, ref, tree = _module_pair(JaxCrossEmbed(16, kernels, stride, dtype=jd), tmod, x, dtype, 6)
    assert out.shape == (2, side // stride, side // stride, 16)
    widths = [tree["params"][f"conv_{i}"]["kernel"].shape for i in range(len(kernels))]
    assert [w[0] for w in widths] == sorted(kernels)
    assert [w[-1] for w in widths] == ([8, 4, 2, 2] if len(kernels) == 4 else [8, 8])
    assert _module_err(out, ref) <= MODULE_TOL[dtype]


def test_cross_embed_same_padding_fails():
    """A planted fault: SAME padding in place of the explicit ``((k - s) //
    2, (k - s + 1) // 2)``. The two agree wherever the map divides by the
    stride (every shape of the presets), so the fault shows where it does
    not: 30 px at stride 4 gives SAME an 8 x 8 map where the explicit pads
    give 7 x 7, and 15 px at stride 2 gives 8 x 8 against 7 x 7."""
    from vit_tpu.nn.conv import CrossEmbedLayer as JaxCrossEmbed

    for kernels, stride, side in (((4, 8, 16, 32), 4, 30), ((2, 4), 2, 15)):
        x = np.random.default_rng(side).standard_normal((2, side, side, 3)).astype(np.float32)
        tmod = CrossEmbedLayer(3, 16, kernels, stride, device="cpu")
        out, ref, _ = _module_pair(JaxCrossEmbed(16, kernels, stride), tmod, x, "float32", 6)
        assert _module_err(out, ref) <= TOL_FP32
        for i in range(len(kernels)):
            getattr(tmod, f"conv_{i}").padding = "SAME"
        with torch.inference_mode():
            bad = tmod(torch.from_numpy(x))
        assert _module_err(bad, ref) > TOL_FP32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side,scale", [(8, 1.0), (6, 1.0), (7, 1.0), (8, 1e-3)])
def test_aggregate_matches_flax(side, scale, dtype):
    """NesT's aggregation (3x3 SAME conv, flax LayerNorm at eps 1e-6, 3x3
    max pool of stride 2, SAME) on even maps, where SAME's pool pads (0, 1),
    and an odd one (1, 1); at 1e-3 of the scale the conv's output is small
    enough that the eps shows."""
    import jax.numpy as jnp
    from vit_tpu.nn.conv import Aggregate as JaxAggregate

    x = scale * np.random.default_rng(side).standard_normal((2, side, side, 8)).astype(np.float32)
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    td = getattr(torch, dtype) if dtype != "float32" else None
    out, ref, _ = _module_pair(JaxAggregate(16, dtype=jd), Aggregate(8, 16, dtype=td,
                                                                       device="cpu"),
                               x, dtype, 7)
    assert out.shape == (2, (side + 1) // 2, (side + 1) // 2, 16)
    assert out.dtype == getattr(torch, dtype)
    assert _module_err(out, ref) <= MODULE_TOL[dtype]


@pytest.mark.parametrize("fault", ["max_pool2d(padding=1)", "LayerNorm eps 1e-5"])
def test_aggregate_faults_fail(fault, monkeypatch):
    """Planted faults in Aggregate miss the fp32 bound of the module: the
    pool padded on both sides (every window shifted on the 8 x 8 map), and
    the file's other eps, 1e-5, in place of flax's default 1e-6 (on the
    input at 1e-3 of the scale, with no conv bias, where the variance is
    near the eps)."""
    import torch.nn.functional as F
    from vit_tpu.nn.conv import Aggregate as JaxAggregate

    scale = 1.0 if fault.startswith("max_pool") else 1e-3
    x = scale * np.random.default_rng(8).standard_normal((2, 8, 8, 8)).astype(np.float32)
    tmod = Aggregate(8, 16, device="cpu")
    out, ref, tree = _module_pair(JaxAggregate(16), tmod, x, "float32", 7)
    if scale < 1:  # no conv bias, so the conv's output is as small as x
        import jax

        tree["params"]["conv"]["bias"] = np.zeros_like(tree["params"]["conv"]["bias"])
        ref = _flax_apply(JaxAggregate(16), tree, jax.numpy.asarray(x), "float32")
        tmod.load_state_dict(from_jax_params(tree, {}), strict=True)
        with torch.inference_mode():
            out = tmod(torch.from_numpy(x))
    assert _module_err(out, ref) <= TOL_FP32
    if fault.startswith("max_pool"):
        monkeypatch.setattr(tconv, "max_pool_same", lambda t: F.max_pool2d(
            t.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1))
    else:
        tmod.norm.eps = 1e-5
    with torch.inference_mode():
        bad = tmod(torch.from_numpy(x))
    assert _module_err(bad, ref) > 10 * TOL_FP32


# -- the dynamic position bias ----------------------------------------------------


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("w", [1, 2, 4, 7])
def test_dynamic_position_bias_matches_flax(w, quirks):
    """DPB in both modes against flax, fp32, within 1e-6 of the largest bias:
    ``[1, heads, w^2, w^2]`` from the (2w-1)^2 offsets, or with
    ``reference_quirks`` ``[1, 1, w^2, w^2]`` from the (2w+1)^2 ones
    gathered with stride 2w-1."""
    import jax
    from vit_tpu.nn.bias import DynamicPositionBias as JaxDPB

    jmod = JaxDPB(16, 3, reference_quirks=quirks)
    tree = _perturbed(jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(w), w)), w)
    ref = np.asarray(jax.jit(jmod.apply, static_argnums=1)(tree, w))
    tmod = DynamicPositionBias(16, 3, reference_quirks=quirks, device="cpu")
    tmod.load_state_dict(from_jax_params(tree, {}), strict=True)
    with torch.inference_mode():
        out = tmod(w)
    assert out.dtype == torch.float32 and out.shape == (1, 1 if quirks else 3, w * w, w * w)
    assert float(np.abs(out.numpy() - ref).max()) <= 1e-6 * float(np.abs(ref).max())


# -- the window twin at CrossFormer's window sizes --------------------------------

W_ARGS = ("xw", "ln_scale", "ln_bias", "wqkv", "wout", "bout")
# (dtype, windows, S, C, heads, bias heads): heads of 32; 1- and 4-token
# windows (15 and 12 padded rows of the kernel's 16-row tile), 16, 49 and 64.
WINDOW_CASES = [
    ("float32", 6, 1, 64, 2, 2), ("bfloat16", 6, 1, 64, 2, 2), ("bfloat16", 5, 1, 128, 4, 1),
    ("float32", 4, 4, 64, 2, 2), ("bfloat16", 4, 4, 128, 4, 4), ("bfloat16", 4, 4, 64, 2, 1),
    ("bfloat16", 3, 16, 64, 2, 2), ("bfloat16", 2, 49, 128, 4, 4), ("float32", 2, 64, 64, 2, 2),
]


def _window_inputs(seed, nw, s, c, heads, bias_heads):
    rng = np.random.default_rng(seed)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    hd = heads * 32
    return dict(xw=r(nw, s, c), ln_scale=1.0 + 0.1 * r(c), ln_bias=0.1 * r(c),
                wqkv=0.1 * r(c, 3 * hd), wout=0.1 * r(hd, c), bout=0.1 * r(c),
                bias=r(1, bias_heads, s, s))


@pytest.mark.parametrize("dtype,nw,s,c,heads,bias_heads", WINDOW_CASES)
def test_window_twin_matches_jax_at_crossformer_windows(dtype, nw, s, c, heads, bias_heads):
    """The port keeps windows under 32 tokens on kernel 6 (vit_tpu sends them
    to XLA on the TPU): its twin against JAX's XLA twin and JAX's Pallas
    kernel in interpret mode, with a per-head or shared DPB-shaped bias."""
    import jax.numpy as jnp

    jwa = importlib.import_module("vit_tpu.ops.window_attention")
    inp = _window_inputs(s * 10 + c, nw, s, c, heads, bias_heads)
    low = lambda k: dtype if k in ("xw", "wqkv", "wout") else "float32"
    t = [torch.from_numpy(inp[k]).to(getattr(torch, low(k))) for k in W_ARGS]
    j = [jnp.asarray(inp[k]).astype(getattr(jnp, low(k))) for k in W_ARGS]
    tb, jb = torch.from_numpy(inp["bias"]), jnp.asarray(inp["bias"])
    out = ops.window_attention_block(*t, heads, tb, scale=32**-0.5)
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    for what, ref in (("xla", jwa.xla_window_attention_block(*j, heads, jb, scale=32**-0.5)),
                      ("interpret", jwa.fused_window_attention_block(
                          *j, heads, jb, scale=32**-0.5, interpret=True))):
        ref = np.asarray(ref.astype(jnp.float32))
        err = float(np.abs(out.float().numpy() - ref).max())
        assert err <= WIN_TOL[dtype] * float(np.abs(ref).max()), (what, err)


@pytest.mark.parametrize("fault,s", [(WINDOW_FAULTS[1], 1), (WINDOW_FAULTS[1], 4),
                                     (WINDOW_FAULTS[2], 4), (WINDOW_FAULTS[2], 49),
                                     (WINDOW_FAULTS[3], 4), (WINDOW_FAULTS[3], 49),
                                     (WINDOW_FAULTS[0], 49)])
def test_window_faults_fail_the_kernel_bound(fault, s):
    """The faults chip_smoke plants in the window twin at CrossFormer's
    shapes (padded keys unmasked at 1 and 4 tokens, the bias transposed, a
    per-head bias read as head 0's, windows attending across each other)
    move the output far past kernel_tol."""
    inp = _window_inputs(s, 4, s, 64, 2, 2)
    args = [torch.from_numpy(inp[k]).bfloat16() if k in ("xw", "wqkv", "wout")
            else torch.from_numpy(inp[k]) for k in W_ARGS]
    bias = torch.from_numpy(inp["bias"][0])
    ref = twa.xla_window_attention_block(*args, 2, bias)
    bad = window_fault_twin(args, 2, bias, fault)
    assert (bad.float() - ref.float()).abs().max().item() > 3 * kernel_tol(ref, None, ref.dtype)


# (S, C, heads, dim_head) -> (route, windows a block, shared-memory bytes) of
# kernel 6 at CrossFormer's eight window shapes (the issue's plan table).
CROSSFORMER_PLANS = [
    ((49, 64, 2, 32), ("o-tile", 2, 101376)), ((64, 64, 2, 32), ("o-tile", 2, 101376)),
    ((49, 128, 4, 32), ("o-tile", 2, 161792)), ((16, 128, 4, 32), ("o-tile", 8, 161792)),
    ((49, 256, 8, 32), ("o-tile", 2, 227328)), ((4, 256, 8, 32), ("o-tile", 8, 227328)),
    ((49, 512, 16, 32), ("o-tile", 1, 206848)), ((1, 512, 16, 32), ("o-tile", 4, 206848)),
]


@pytest.mark.parametrize("shape,plan", CROSSFORMER_PLANS)
def test_crossformer_window_plans_are_pinned(shape, plan):
    assert tuple(twa.plan_for(*shape)) == plan and plan[0] == CROSSFORMER_ROUTE
    assert any((sw, c) == shape[:2] for _, _, sw, c in CROSSFORMER_WINDOWS)


# -- the trees and the models --------------------------------------------------


@pytest.mark.parametrize("variant", ["preset crossformer", "preset nest", *VARIANTS])
def test_trees_have_the_names_and_shapes_of_init(variant):
    """chip_smoke draws the weights with numpy in vit_tpu's layout; its tree
    has the leaves of vit_tpu's ``init`` (a stage deeper than 1 stacked, the
    quirk mode's one-output DPB), its conv kernels the spread of
    lecun-normal over their real fan-in."""
    import jax
    import jax.numpy as jnp

    if variant.startswith("preset"):
        fam = variant.split()[1]
        cfg, size = PRESETS[fam], 224
    else:
        fam, cfg, size = _config(variant)
    want = jax.eval_shape(_jax_model(fam)(**cfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3), jnp.float32))
    tree = TREES[fam](cfg, seed=0)
    assert _leaves(tree) == _leaves(jax.tree.map(lambda a: a, want))
    if variant == "preset crossformer":
        k = tree["params"]["embed_0"]["conv_3"]["kernel"]  # [32, 32, 3, 8]: fan-in 3072
        assert abs(k.std() * (32 * 32 * 3) ** 0.5 - 1.0) < 0.05
    if variant == "preset nest":
        k = tree["params"]["agg_0"]["conv"]["kernel"]  # [3, 3, 96, 192]: fan-in 864
        assert abs(k.std() * (3 * 3 * 96) ** 0.5 - 1.0) < 0.05


def test_converter_unstacks_the_scanned_stage():
    """``jax_stages`` lists every stage with its depth: the stacked leaves of
    a stage of depth 2 (its DPB's too) go to ``stage_1.{i}``, a stage of
    depth 1 to ``stage_0.0``; conv kernels turn to OIHW."""
    fam, cfg, _ = _config("crossformer scanned quirks")
    tree = crossformer_tree(cfg, seed=3)
    model = CrossFormer(**cfg, device="cpu")
    assert model.jax_stages == {"stage_0": 1, "stage_1": 2}
    state = from_jax_params(tree, model.jax_stages)
    model.load_state_dict(state, strict=True)
    p = tree["params"]
    np.testing.assert_array_equal(state["stage_1.1.lda.dpb.fc3.kernel"].numpy(),
                                  p["stage_1"]["lda"]["dpb"]["fc3"]["kernel"][1])
    np.testing.assert_array_equal(state["stage_0.0.sda.qkv_kernel"].numpy(),
                                  p["stage_0"]["sda"]["qkv_kernel"])
    np.testing.assert_array_equal(state["embed_1.conv_1.kernel"].numpy(),
                                  p["embed_1"]["conv_1"]["kernel"].transpose(3, 2, 0, 1))
    assert NesT(**_config("nest")[1], device="cpu").jax_stages == {}


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
    assert out.dtype == (td or torch.float32) and out.shape == (2, 10)  # as JAX's
    err = float(np.abs(out.float().numpy() - ref).max())
    if dtype == "float32":
        assert err <= TOL_FP32, err
    else:
        control = float(np.abs(jax_logits(dtype, "interpret" if mode == "xla" else "xla")
                               - ref).max())
        assert err <= 2 * max(control, 0.02), (err, control)


def _transposed_dpb(monkeypatch):
    forward = DynamicPositionBias.forward
    monkeypatch.setattr(DynamicPositionBias, "forward", lambda self, w: forward(self, w).mT)


def _window_lda(monkeypatch):
    monkeypatch.setattr(ops, "dilated_partition", ops.window_partition)
    monkeypatch.setattr(ops, "dilated_unpartition", ops.window_unpartition)


def _padded_pool(monkeypatch):
    import torch.nn.functional as F

    monkeypatch.setattr(tconv, "max_pool_same", lambda t: F.max_pool2d(
        t.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1))


MODEL_FAULTS = {
    "DPB bias transposed": ("crossformer", _transposed_dpb),
    "window_partition in place of dilated_partition for LDA": ("crossformer", _window_lda),
    "max_pool2d(padding=1) in Aggregate": ("nest 3 hierarchies", _padded_pool),
}


@pytest.mark.parametrize("fault", list(MODEL_FAULTS))
def test_model_faults_fail_the_bound(fault, monkeypatch):
    """Each planted fault misses the fp32 bound that the port meets (the
    padding and eps faults of the modules are held at the module level
    above, where they can show)."""
    variant, plant = MODEL_FAULTS[fault]
    fam, cfg, size = _config(variant)
    img = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    tree = _perturbed(TREES[fam](cfg, seed=3), seed=4)
    ref = _jax_logits(fam, cfg, tree, img, "float32", "xla")
    model = _loaded(fam, cfg, tree)
    with torch.inference_mode():
        good = float(np.abs(model(torch.from_numpy(img)).numpy() - ref).max())
        plant(monkeypatch)
        bad = float(np.abs(model(torch.from_numpy(img)).numpy() - ref).max())
    assert good <= TOL_FP32 < bad, (good, bad)


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
    _, cfg, size = _config(fam)
    model = _loaded(fam, cfg, _perturbed(TREES[fam](cfg, seed=3), seed=4))
    pipe = InferencePipeline(model, image_size=size, batch_size=4, dtype=torch.float32)
    imgs = np.random.default_rng(2).integers(0, 256, (6, size, size, 3), dtype=np.uint8)
    with BatchingServer(pipe, decoder=JpegDecoder(size=size), max_wait_ms=20) as server:
        futures = [server.submit(im) for im in imgs]
        rows = np.stack([f.result(timeout=60) for f in futures])
    direct = np.concatenate([pipe(imgs[i: i + 1]) for i in range(6)])
    assert rows.shape == (6, 10) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, direct, atol=1e-5, rtol=0)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bias_heads", ["per-head", "shared"])
@pytest.mark.parametrize("what,per,sw,c", CROSSFORMER_WINDOWS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_window_kernel_at_crossformer_shapes(cuda, what, per, sw, c, bias_heads):
    """Kernel 6 at CrossFormer's eight window shapes (heads of 32), batch 8,
    with a per-head ``[H, S, S]`` and a shared ``[1, S, S]`` bias, against
    its twin within kernel_tol: one launch."""
    heads = c // 32
    inp = _window_inputs(sw + c, 8 * per, sw, c, heads, heads if bias_heads == "per-head" else 1)
    args = [torch.from_numpy(inp[k]).to(cuda, torch.bfloat16 if k[0] in "xw" else torch.float32)
            for k in W_ARGS]
    bias = torch.from_numpy(inp["bias"]).to(cuda)
    before = ops.launch_counts()["window_attention_block"]
    out = ops.window_attention_block(*args, heads, bias, scale=32**-0.5)
    assert ops.launch_counts()["window_attention_block"] == before + 1
    ref = twa.xla_window_attention_block(*args, heads, bias, scale=32**-0.5)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape,plan", CROSSFORMER_PLANS)
def test_crossformer_window_plans_mirror_the_kernel(cuda, shape, plan):
    import ctypes

    from vit_tpu_torch.ops import _build

    got = (ctypes.c_int * 3)()
    assert _build.load_library().vt_window_attention_plan(
        *shape, ctypes.cast(got, ctypes.c_void_p)) == 0
    assert (twa.VARIANTS[got[0]], got[1], got[2]) == plan


@pytest.mark.cuda
@pytest.mark.parametrize("what,blocks,n,heads", NEST_QKV,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_qkv_attention_kernel_at_nest_shapes(cuda, what, blocks, n, heads):
    """Kernel 3 at NesT's three levels (196 tokens, heads of 32), batch 8,
    against its twin within kernel_tol."""
    gen = torch.Generator(device=cuda).manual_seed(heads)
    qkv = torch.randn(8 * blocks, n, 3 * heads * 32, generator=gen, device=cuda).bfloat16()
    before = ops.launch_counts()["qkv_attention"]
    out = ops.qkv_attention(qkv, heads, scale=32**-0.5)
    assert ops.launch_counts()["qkv_attention"] == before + 1
    ref = tqa.xla_qkv_attention(qkv, heads, scale=32**-0.5)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("what,n,dim,f,eps", ZOO3_MLP,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_mlp_kernel_at_the_slice_shapes(cuda, what, n, dim, f, eps):
    """Kernel 2 at the slice's seven MLP shapes (batch 8, without the
    residual as ConvMLP calls it) against its twin, within kernel_tol."""
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
