"""The port's CvT and LeViT against vit_tpu's on the CPU: the inference
``BatchNorm``, ``DepthWiseConv2d`` with a BatchNorm (folded and not), both
branches of ``ConvMLP``, a norm-free ``FeedForward`` of another output
width and ``LeViTAttentionBias`` against the flax modules; the numpy
``fold_batch_norm`` bit for bit against vit_tpu's; ``from_jax_params``
loading ``batch_stats``; chip_smoke's tree functions against ``init``; the
tiny models folded and unfolded in both of vit_tpu's CPU modes (``xla``, and
``interpret``: the Pallas kernels in interpreter mode); planted faults;
serving. On the card: kernel 4 at the slice's eight attention shapes and
kernel 2 at its six MLP shapes.

The tiny models are vit_tpu's ``MODEL_REGISTRY`` configs (CvT: three stages
of depth 1; LeViT: three stages of depth 1 at 64 px) and the same at depth
2 (LeViT with a distillation head). Parameters and BatchNorm statistics are
drawn by chip_smoke's ``*_tree`` functions and perturbed, so that no bias
or norm parameter is a constant, and channel 0 of every BatchNorm is made a
dead channel (running variance 1e-5, scale 4e-3), as trained networks have:
there eps carries weight, so a fold or a norm that drops it shows.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import (
    CVT,
    LEVIT,
    ZOO5_FLASH,
    ZOO5_MLP,
    cvt_tree,
    kernel_tol,
    levit_tree,
    zoo5_attention_inputs,
)
from vit_tpu_torch import ops
from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import CvT, LeViT
from vit_tpu_torch.models import cvt as tcvt
from vit_tpu_torch.nn import (
    BatchNorm,
    ConvMLP,
    DepthWiseConv2d,
    FeedForward,
    LeViTAttentionBias,
)
from vit_tpu_torch.nn.attention import mha_tokens
from vit_tpu_torch.pipeline import InferencePipeline
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import fold_batch_norm, from_jax_params

torch.set_num_threads(2)

tfa = importlib.import_module("vit_tpu_torch.ops.flash_attention")

MODELS = {"cvt": CvT, "levit": LeViT}
TREES = {"cvt": cvt_tree, "levit": levit_tree}
PRESETS = {"cvt": (CVT, 224), "levit": (LEVIT, 224)}
# The tiny models: (family, changes to the registry config).
VARIANTS = {
    "cvt": ("cvt", {}),
    "cvt depth 2": ("cvt", dict(s1_depth=2, s2_depth=2, s3_depth=2)),
    "levit": ("levit", {}),
    "levit depth 2 distill": ("levit", dict(depth=2, num_distill_classes=5)),
}

# Max |logit| difference allowed.
# fp32 (fp32_tol): every op in fp32 on both sides, summed in other orders:
#   1e-4, or 2e-5 of max |logit| where that is more. LeViT has no norm in its
#   stack, so its logits grow with depth (max |logit| 5.7 at depth 1, 17.1 at
#   depth 2) and so does the sum-order noise: measured 2.1e-4 / 2.5e-4 (xla /
#   interpret) at depth 2, where vit_tpu's own xla-vs-interpret gap is 6.7e-5
#   and its folded-vs-unfolded gap 1.4e-4; CvT 1e-6 to 2.4e-6 (max |logit|
#   2.4-2.8), LeViT at depth 1 1.5e-5.
# CvT bf16: twice the larger of vit_tpu's own xla-vs-interpret gap and 0.02,
#   as in tests/test_torch_scalable_region.py: 0.04 (measured 0.0078-0.0156,
#   vit_tpu's own gap 0.0: at these shapes its interpret mode runs its
#   kernel 4 where its xla mode runs XLA, to the same bits).
# LeViT bf16: against the port's own fp32 logits, within twice vit_tpu's
#   bf16-vs-fp32 gap (in the mode) on the same tree: LeViT's bf16 loses much
#   against fp32, so the bound is the reference's own loss (measured 0.0120 /
#   0.0135 against 2 x 0.0176 / 2 x 0.0129 at the registry config).
TOL_FP32 = 1e-4


def fp32_tol(ref):
    return max(TOL_FP32, 2e-5 * float(np.abs(ref).max()))


# Modules against flax (max |out - ref| as a share of max |ref|): fp32 sums in
# other orders, 1e-5; bf16 one bf16 ulp of the largest output.
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


def _dead_channels(tree):
    """Channel 0 of every BatchNorm of a ``{params, batch_stats}`` tree made a
    dead channel: running variance 1e-5, scale 4e-3 (in place)."""
    def walk(params, stats):
        if set(stats) == {"mean", "var"}:
            stats["var"][0], params["scale"][0] = 1e-5, 4e-3
            return
        for name, s in stats.items():
            walk(params[name], s)

    walk(tree["params"], tree.get("batch_stats", {}))
    return tree


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

    return {"cvt": jm.CvT, "levit": jm.LeViT}[fam]


def _fp32(out):
    """Logits (or the (out, distill) pair) as one fp32 numpy array."""
    outs = out if isinstance(out, tuple) else (out,)
    return np.concatenate([np.asarray(o, np.float32).reshape(o.shape[0], -1) for o in outs], 1)


def _jax_logits(fam, cfg, tree, img, dtype, mode, fold):
    import jax
    import jax.numpy as jnp

    jd = getattr(jnp, dtype) if dtype != "float32" else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIT_TPU_BACKEND", mode)
        out = jax.jit(_jax_model(fam)(**cfg, fold_bn=fold, dtype=jd).apply)(tree,
                                                                           jnp.asarray(img))
        return _fp32(jax.tree.map(lambda o: o.astype(jnp.float32), out))


def _loaded(fam, cfg, tree, dtype=None, fold=False):
    model = MODELS[fam](**cfg, fold_bn=fold, dtype=dtype, device="cpu")
    model.load_state_dict(from_jax_params(fold_batch_norm(tree) if fold else tree,
                                          model.jax_stages), strict=True)
    return model


def _port_logits(model, img):
    with torch.inference_mode():
        out = model(torch.from_numpy(img))
    return _fp32(tuple(o.float() for o in out) if isinstance(out, tuple) else out.float())


def _inputs(variant):
    fam, cfg, size = _config(variant)
    img = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    return fam, cfg, img, _dead_channels(_perturbed(TREES[fam](cfg, seed=3), seed=4))


@pytest.fixture(scope="module", params=list(VARIANTS))
def tiny(request):
    """A tiny model's family, config, images, unfolded tree, and its vit_tpu
    logits by (dtype, mode, folded), each computed once (the folded tree is
    vit_tpu's own fold)."""
    from vit_tpu.utils import fold_batch_norm as jax_fold

    fam, cfg, img, tree = _inputs(request.param)
    cache = {}

    def logits(dtype, mode, fold):
        if (dtype, mode, fold) not in cache:
            t = jax_fold(_jax_model(fam)(**cfg), tree)[1] if fold else tree
            cache[dtype, mode, fold] = _jax_logits(fam, cfg, t, img, dtype, mode, fold)
        return cache[dtype, mode, fold]

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


def _module_tree(jmod, x, seed):
    """``jmod``'s init variables on ``x``, perturbed; BatchNorm statistics
    drawn as chip_smoke draws them (means normal(0, 0.3), variances
    exp(normal(0, 0.3))), with dead channels."""
    import jax

    tree = jax.tree.map(np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(0), x))
    tree = _perturbed({k: dict(v) for k, v in tree.items()}, seed)
    if "batch_stats" in tree:
        rng = np.random.default_rng(seed)
        draw = lambda k, v: (0.3 * rng.standard_normal(v.shape) if k == "mean" else
                             np.exp(0.3 * rng.standard_normal(v.shape))).astype(np.float32)
        walk = lambda t: {k: walk(v) if isinstance(v, dict) else draw(k, v) for k, v in t.items()}
        tree["batch_stats"] = walk(tree["batch_stats"])
        _dead_channels(tree)
    return tree


def _module_pair(jmod, tmod, x, dtype, seed, modes=("xla",), fold=None):
    """flax ``jmod`` initialised on ``x`` (perturbed, dead channels), the
    port's ``tmod`` loaded with the same tree; with ``fold`` (the folded flax
    module), the flax side is ``fold`` on vit_tpu's folded tree and the
    port's module loads the port's fold. Returns (port output, {mode: flax
    output}, tree)."""
    import jax.numpy as jnp
    from vit_tpu.utils import fold_batch_norm as jax_fold

    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    tree = _module_tree(jmod, xj, seed)
    ref_mod, ref_tree = (jmod, tree) if fold is None else (fold, jax_fold(jmod, tree)[1])
    refs = {mode: _flax_apply(ref_mod, ref_tree, xj, dtype, mode) for mode in modes}
    tmod.load_state_dict(from_jax_params(tree if fold is None else fold_batch_norm(tree), {}),
                         strict=True)
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
def test_batch_norm_matches_flax(dtype):
    """``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32 against
    the fp32 statistics, one rounding to the dtype: within 1e-5 of the
    output's scale in fp32, one bf16 ulp in bf16."""
    import flax.linen as fnn

    jd, td = _dtypes(dtype)
    x = np.random.default_rng(1).standard_normal((2, 5, 5, 24)).astype(np.float32)
    out, refs, tree = _module_pair(fnn.BatchNorm(use_running_average=True, dtype=jd),
                                   BatchNorm(24, dtype=td, device="cpu"), x, dtype, 1)
    assert set(tree) == {"params", "batch_stats"}
    assert out.dtype == getattr(torch, dtype)
    assert _module_err(out, refs["xla"]) <= MODULE_TOL[dtype]


def test_batch_norm_does_not_train():
    """At inference (``train=False``, the serving path) a BatchNorm does not
    train: its running statistics stay as loaded. Only ``train=True`` moves
    them (tests/test_torch_train_bn.py holds that against flax)."""
    bn = BatchNorm(4, device="cpu")
    x = torch.arange(8.0).reshape(2, 4)
    bn(x)
    assert torch.equal(bn.mean, torch.zeros(4)) and torch.equal(bn.var, torch.ones(4))
    bn(x, train=True)
    assert not torch.equal(bn.mean, torch.zeros(4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("folded", [False, True])
def test_depthwise_conv_with_batch_norm_matches_flax(folded, dtype):
    """CvT's projection: depthwise (no bias) -> BatchNorm -> pointwise (no
    bias) at stride 2, on an odd map; folded, the depthwise conv with the
    bias the fold gives it, against flax's folded module on vit_tpu's
    fold."""
    from vit_tpu.nn.conv import DepthWiseConv2d as JaxDW

    jd, td = _dtypes(dtype)
    x = np.random.default_rng(2).standard_normal((2, 7, 7, 16)).astype(np.float32)
    kw = dict(use_bias=False, batch_norm=True)
    tmod = DepthWiseConv2d(16, 32, 3, 2, fold_bn=folded, dtype=td, device="cpu", **kw)
    out, refs, _ = _module_pair(JaxDW(16, 32, 3, 2, dtype=jd, **kw), tmod, x, dtype, 2,
                                fold=JaxDW(16, 32, 3, 2, fold_bn=True, dtype=jd, **kw)
                                if folded else None)
    assert (tmod.bn is None) == folded and (tmod.depthwise.bias is not None) == folded
    assert out.shape == (2, 4, 4, 32) and out.dtype == getattr(torch, dtype)
    assert _module_err(out, refs["xla"]) <= MODULE_TOL[dtype]


# Token ConvMLP cases: (what, dim, mult, dim_out, activation, pre_norm, modes);
# another output width runs only on vit_tpu's XLA path (its kernel's output is
# D wide).
TOKEN_MLP = {
    "CvT's": (16, 4, None, "gelu", True, ("xla", "interpret")),
    "LeViT's": (16, 2, None, "hard_swish", False, ("xla", "interpret")),
    "norm-free, dim_out 24": (16, 2, 24, "hard_swish", False, ("xla",)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(TOKEN_MLP))
def test_conv_mlp_token_branch_matches_flax(case, dtype):
    """``ConvMLP``'s token branch (``ff``: one ``ops.mlp``) against flax in
    each mode: with a LayerNorm of eps 1e-5 and GELU, and without a norm
    (no ``ln_*`` parameters: the kernel's LayerNorm prologue is skipped) with
    hard-swish, at D or another output width."""
    from vit_tpu.nn.conv import ConvMLP as JaxConvMLP

    dim, mult, dim_out, act, pre_norm, modes = TOKEN_MLP[case]
    jd, td = _dtypes(dtype)
    x = np.random.default_rng(3).standard_normal((2, 4, 4, dim)).astype(np.float32)
    jmod = JaxConvMLP(dim, mult, activation=act, pre_norm=pre_norm, dim_out=dim_out, dtype=jd)
    tmod = ConvMLP(dim, mult, activation=act, pre_norm=pre_norm, dim_out=dim_out, dtype=td,
                   device="cpu")
    out, refs, tree = _module_pair(jmod, tmod, x, dtype, 3, modes=modes)
    assert any(k.startswith("ln_") for k in tree["params"]["ff"]) == pre_norm
    assert out.shape == (2, 4, 4, dim_out or dim) and out.dtype == getattr(torch, dtype)
    for mode, ref in refs.items():
        assert _module_err(out, ref) <= MODULE_TOL[dtype], mode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("folded", [False, True])
def test_conv_mlp_batch_norm_branch_matches_flax(folded, dtype):
    """``ConvMLP(batch_norm=True)``: up -> bn1 -> hard-swish -> down -> bn2,
    to another output width; folded, the two convs with the fold's biases
    and no BatchNorm, against flax's folded module on vit_tpu's fold."""
    from vit_tpu.nn.conv import ConvMLP as JaxConvMLP

    jd, td = _dtypes(dtype)
    x = np.random.default_rng(4).standard_normal((2, 3, 3, 16)).astype(np.float32)
    kw = dict(batch_norm=True, dim_out=8)
    tmod = ConvMLP(16, 2, fold_bn=folded, dtype=td, device="cpu", **kw)
    out, refs, _ = _module_pair(JaxConvMLP(16, 2, dtype=jd, **kw), tmod, x, dtype, 4,
                                fold=JaxConvMLP(16, 2, fold_bn=True, dtype=jd, **kw)
                                if folded else None)
    assert (tmod.bn1 is None) == folded and (tmod.up.bias is not None) == folded
    assert out.shape == (2, 3, 3, 8) and out.dtype == getattr(torch, dtype)
    assert _module_err(out, refs["xla"]) <= MODULE_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feed_forward_without_norm_to_another_width_matches_flax(dtype):
    """``FeedForward(pre_norm=False, dim_out=)`` over tokens: no LayerNorm
    parameters, ``w2`` ``[F, dim_out]``."""
    from vit_tpu.nn.blocks import FeedForward as JaxFF

    jd, td = _dtypes(dtype)
    x = np.random.default_rng(5).standard_normal((2, 9, 16)).astype(np.float32)
    tmod = FeedForward(16, 48, activation="hard_swish", pre_norm=False, dim_out=24, dtype=td,
                       device="cpu")
    out, refs, tree = _module_pair(JaxFF(16, 48, activation="hard_swish", pre_norm=False,
                                         dim_out=24, dtype=jd), tmod, x, dtype, 5)
    assert set(tree["params"]) == {"w1", "b1", "w2", "b2"}
    assert tmod.ln_scale is None and tuple(tmod.w2.shape) == (48, 24)
    assert _module_err(out, refs["xla"]) <= MODULE_TOL[dtype]


@pytest.mark.parametrize("heads,fmap,q_stride", [(2, 4, 1), (3, 4, 2), (4, 7, 2), (2, 14, 1)])
def test_levit_attention_bias_matches_flax(heads, fmap, q_stride):
    """The ``[kv_side**2, heads]`` table read at ``|q * q_stride - k|``:
    bitwise (a gather), fp32 ``[1, heads, Nq, Nk]``."""
    import jax
    from vit_tpu.nn.bias import LeViTAttentionBias as JaxBias

    q_side = -(-fmap // q_stride)
    jmod = JaxBias(heads, fmap, q_fmap_size=q_side, q_stride=q_stride)
    tree = _perturbed(jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(fmap))), fmap)
    ref = np.asarray(jmod.apply(tree))
    tmod = LeViTAttentionBias(heads, fmap, q_fmap_size=q_side, q_stride=q_stride, device="cpu")
    tmod.load_state_dict(from_jax_params(tree, {}), strict=True)
    with torch.no_grad():
        out = tmod()
    assert out.dtype == torch.float32 and out.shape == (1, heads, q_side**2, fmap**2)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_mha_tokens_passes_the_bias_through():
    """``mha_tokens(bias=)`` adds the bias to the scaled scores (the twin of
    kernel 4 on the CPU) at Dv != D and Nq != Nk."""
    rng = np.random.default_rng(6)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v, bias = t(2, 4, 2 * 8), t(2, 9, 2 * 8), t(2, 9, 2 * 16), t(1, 2, 4, 9)
    out = mha_tokens(q, k, v, 2, scale=0.3, bias=bias)
    split = lambda x: x.reshape(2, -1, 2, x.shape[-1] // 2).transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", split(q), split(k)) * 0.3 + bias
    ref = torch.einsum("bhqk,bhkd->bhqd", s.softmax(-1), split(v)).transpose(1, 2).reshape(2, 4, 32)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-5)


# -- the fold, the converter, the trees ------------------------------------------


def _module_bn_tree():
    """vit_tpu's BatchNorm branch of ConvMLP, as a tree with ``bn1`` /
    ``bn2``: the pairs no model has."""
    import jax.numpy as jnp
    from vit_tpu.nn.conv import ConvMLP as JaxConvMLP

    return _module_tree(JaxConvMLP(16, 2, batch_norm=True), jnp.zeros((1, 3, 3, 16)), 7)


@pytest.mark.parametrize("what", ["cvt", "levit depth 2 distill", "ConvMLP batch_norm"])
def test_fold_batch_norm_is_bitwise_vit_tpus(what):
    """The port's numpy fold gives vit_tpu's arrays bit for bit (float64,
    cast back), the same tree shape, and no ``batch_stats``; the input tree
    is left as it was."""
    import jax
    from vit_tpu.models.cvt import CvT as JaxCvT
    from vit_tpu.utils import fold_batch_norm as jax_fold

    tree = _module_bn_tree() if what == "ConvMLP batch_norm" else _inputs(what)[3]
    before = jax.tree.map(np.copy, tree)
    got = fold_batch_norm(tree)
    want = jax_fold(JaxCvT(num_classes=1), tree)[1]  # the model is only cloned
    assert set(got) == {"params"} and _leaves(got) == _leaves(jax.tree.map(np.asarray, want))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype == np.float32, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    jax.tree.map(np.testing.assert_array_equal, tree, before)


def test_fold_batch_norm_refuses_what_it_cannot_fold():
    tree = {"params": {"blk": {"norm": {"scale": np.ones(2), "bias": np.zeros(2)}}},
            "batch_stats": {"blk": {"norm": {"mean": np.zeros(2), "var": np.ones(2)}}}}
    with pytest.raises(ValueError, match="no adjacent conv"):
        fold_batch_norm(tree)
    with pytest.raises(ValueError, match="no BatchNorm"):
        fold_batch_norm({"params": {"conv": {"kernel": np.ones((1, 1, 2, 2))}}})


def test_converter_loads_batch_stats_into_the_buffers():
    """``batch_stats/<path>/{mean, var}`` -> the BatchNorm buffers of the same
    path, strictly; the folded tree (no ``batch_stats``) loads the folded
    model; an unfolded model refuses the folded tree."""
    fam, cfg, _, tree = _inputs("cvt")
    state = from_jax_params(tree, {})
    model = CvT(**cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(model.attn_2_0.to_kv.bn.var.numpy(),
                                  tree["batch_stats"]["attn_2_0"]["to_kv"]["bn"]["var"])
    np.testing.assert_array_equal(model.attn_1_0.to_q.depthwise.kernel.detach().numpy(),
                                  tree["params"]["attn_1_0"]["to_q"]["depthwise"]["kernel"]
                                  .transpose(3, 2, 0, 1))
    folded = from_jax_params(fold_batch_norm(tree), {})
    assert not any(k.endswith((".mean", ".var")) for k in folded)
    CvT(**cfg, fold_bn=True, device="cpu").load_state_dict(folded, strict=True)
    with pytest.raises(RuntimeError, match="Missing key"):
        CvT(**cfg, device="cpu").load_state_dict(folded, strict=True)


@pytest.mark.parametrize("variant", ["preset cvt", "preset levit", *VARIANTS])
def test_trees_have_the_names_and_shapes_of_init(variant):
    """chip_smoke draws params and batch_stats with numpy in vit_tpu's layout:
    the leaves of vit_tpu's ``init``, conv kernels with the spread of
    lecun-normal over their real fan-in, positive variances."""
    import jax
    import jax.numpy as jnp

    if variant.startswith("preset"):
        fam = variant.split()[1]
        cfg, size = PRESETS[fam]
    else:
        fam, cfg, size = _config(variant)
    want = jax.eval_shape(_jax_model(fam)(**cfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3), jnp.float32))
    tree = TREES[fam](cfg, seed=0)
    assert set(tree) == {"params", "batch_stats"}
    for col in tree:
        assert _leaves(tree[col]) == _leaves(jax.tree.map(lambda a: a, dict(want[col]))), col
    variances = [v for p, v in jax.tree_util.tree_leaves_with_path(tree["batch_stats"])
                 if p[-1].key == "var"]
    assert all((v > 0).all() for v in variances) and np.std(np.concatenate(variances)) > 0.1
    if variant == "preset cvt":
        k = tree["params"]["embed_1"]["kernel"]  # [7, 7, 3, 64]: fan-in 147
        assert abs(k.std() * (7 * 7 * 3) ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("dtype,mode", [("float32", "xla"), ("float32", "interpret"),
                                        ("bfloat16", "xla"), ("bfloat16", "interpret")])
def test_family_matches_jax(dtype, mode, fold, tiny):
    """The tiny models against vit_tpu's, each side folded by its own
    package's fold or unfolded. LeViT in bf16 is held against the port's fp32
    within twice vit_tpu's bf16-vs-fp32 gap in the mode (the header)."""
    fam, cfg, img, tree, jax_logits = tiny
    td = getattr(torch, dtype) if dtype != "float32" else None
    model = _loaded(fam, cfg, tree, td, fold)
    ops.reset_launch_counts()
    out = _port_logits(model, img)
    assert sum(ops.launch_counts().values()) == 0
    ref = jax_logits(dtype, mode, fold)
    assert out.shape == ref.shape
    if dtype == "float32":
        err = float(np.abs(out - ref).max())
        assert err <= fp32_tol(ref), (err, fp32_tol(ref))
    elif fam == "cvt":
        err = float(np.abs(out - ref).max())
        control = float(np.abs(jax_logits(dtype, "interpret" if mode == "xla" else "xla", fold)
                               - ref).max())
        assert err <= 2 * max(control, 0.02), (err, control)
    else:
        fp32 = _port_logits(_loaded(fam, cfg, tree, None, fold), img)
        err = float(np.abs(out - fp32).max())
        gap = float(np.abs(ref - jax_logits("float32", mode, fold)).max())
        assert err <= 2 * gap, (err, gap)


def _kv_swapped(self, x, train=False, generator=None):
    """``_ConvAttention.forward`` with v taken as the first half of ``to_kv``."""
    b, h, w, _ = x.shape
    x = self.norm(x)
    q, kv = self.to_q(x, train), self.to_kv(x, train)
    v, k = kv.reshape(b, -1, 2 * self.inner).chunk(2, dim=-1)
    out = mha_tokens(q.reshape(b, h * w, self.inner), k, v, self.heads, scale=self.scale)
    return self.to_out(out.reshape(b, h, w, self.inner))


def _bias_without_q_stride(monkeypatch):
    """``LeViTAttentionBias`` indexing the queries at stride 1 whatever
    ``q_stride``: the table's shape, the wrong entries."""
    init = LeViTAttentionBias.__init__
    monkeypatch.setattr(LeViTAttentionBias, "__init__",
                        lambda self, heads, fmap, q_fmap_size=None, q_stride=1, *, device:
                        init(self, heads, fmap, q_fmap_size, 1, device=device))


def _bn_without_eps(self, x, train=False):
    y = (x.float() - self.mean) * (torch.rsqrt(self.var) * self.scale) + self.bias
    return y.to(self.dtype or torch.float32)


def _erf_gelu(monkeypatch):
    gelu = torch.nn.functional.gelu
    monkeypatch.setattr(torch.nn.functional, "gelu", lambda x, approximate="none": gelu(x))


# (variant, folded, plant(monkeypatch)): each fault misses the fp32 bound. The
# fold without eps is planted in the tree the port loads.
MODEL_FAULTS = {
    "the fold without eps": ("cvt", True, None),
    "LeViT's bias without q_stride": ("levit", False, _bias_without_q_stride),
    "k and v swapped in CvT's split": ("cvt", True, lambda mp: mp.setattr(
        tcvt._ConvAttention, "forward", _kv_swapped)),
    "erf GELU on LeViT's attention output": ("levit", True, _erf_gelu),
    "the unfolded BatchNorm with var for var + eps": ("levit", False, lambda mp: mp.setattr(
        BatchNorm, "forward", _bn_without_eps)),
}


@pytest.mark.parametrize("fault", list(MODEL_FAULTS))
def test_model_faults_fail_the_bound(fault, monkeypatch):
    """Each planted fault misses the fp32 bound that the port meets (``-s``
    prints both errors beside the bound)."""
    variant, fold, plant = MODEL_FAULTS[fault]
    fam, cfg, img, tree = _inputs(variant)
    from vit_tpu.utils import fold_batch_norm as jax_fold

    jtree = jax_fold(_jax_model(fam)(**cfg), tree)[1] if fold else tree
    ref = _jax_logits(fam, cfg, jtree, img, "float32", "xla", fold)
    good = float(np.abs(_port_logits(_loaded(fam, cfg, tree, None, fold), img) - ref).max())
    if plant is None:
        model = MODELS[fam](**cfg, fold_bn=True, device="cpu")
        model.load_state_dict(from_jax_params(fold_batch_norm(tree, eps=0.0), {}), strict=True)
    else:
        plant(monkeypatch)
        model = _loaded(fam, cfg, tree, None, fold)
    bad = float(np.abs(_port_logits(model, img) - ref).max())
    tol = fp32_tol(ref)
    print(f"{fault}: port {good:.3g}, with the fault {bad:.3g}, bound {tol:.3g}")
    assert good <= tol and not bad <= tol, (good, bad, tol)


# Each kernel's plain twin, by the kernel it stands for on the CPU.
TWINS = {"reference_attention_kv_blocked": "flash_attention_kv_blocked",
         "reference_attention": "flash_attention", "xla_qkv_attention": "qkv_attention",
         "reference_mlp": "fused_mlp", "xla_attention_block": "attention_block",
         "xla_window_attention_block": "window_attention_block"}


@pytest.mark.parametrize("fam", list(MODELS))
def test_presets_route_as_the_card_would(fam, monkeypatch):
    """A folded bf16 preset forward at batch 1 on the CPU calls each kernel's
    twin as often as chip_smoke's FAMILY_LAUNCHES wants the kernel launched a
    forward on the card (every attention on kernel 4's twin: ``core_fits``
    holds at 784 keys of 64, and at LeViT's 32 / 64 widths), and no other."""
    from chip_smoke import FAMILY_LAUNCHES

    calls = {}
    for name, kernel in TWINS.items():
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _k=kernel, _f=fn, **kw: (
            calls.__setitem__(_k, calls.get(_k, 0) + 1), _f(*a, **kw))[1])
    cfg, size = PRESETS[fam]
    model = _loaded(fam, cfg, TREES[fam](cfg, seed=0), torch.bfloat16, fold=True).eval()
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
    """The folded fp32 model behind ``BatchingServer``: the rows equal direct
    calls."""
    _, cfg, _, tree = _inputs(fam)
    size = _config(fam)[2]
    pipe = InferencePipeline(_loaded(fam, cfg, tree, fold=True), image_size=size, batch_size=4,
                             dtype=torch.float32)
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
@pytest.mark.parametrize("what,heads,nq,nk,d,dv,biased", ZOO5_FLASH,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_flash_kernel_at_the_slice_shapes(cuda, what, heads, nq, nk, d, dv, biased):
    """Kernel 4 as the models call it (``mha_tokens``: CvT's k and v halves
    of one projection; LeViT's D 32 / Dv 64 with an fp32 per-head bias),
    batch 8: one launch, within kernel_tol of its twin."""
    gen = torch.Generator(device=cuda).manual_seed(nq + nk)
    call, q, k, v, bias = zoo5_attention_inputs(gen, 8, heads, nq, nk, d, dv, biased)
    before = ops.launch_counts()["flash_attention"]
    out = call()
    assert ops.launch_counts()["flash_attention"] == before + 1
    ref = tfa.reference_attention(q, k, v, bias, scale=d**-0.5).transpose(1, 2).reshape(out.shape)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("what,n,dim,f,eps,act", ZOO5_MLP,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_mlp_kernel_at_the_slice_shapes(cuda, what, n, dim, f, eps, act):
    """Kernel 2 at the slice's six shapes (batch 8, without the residual;
    LeViT's without the LayerNorm, with hard-swish) against its twin."""
    from vit_tpu_torch.ops.fused_mlp import reference_mlp

    gen = torch.Generator(device=cuda).manual_seed(n + dim)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    args = [r(8, n, dim).bfloat16(), (r(dim, f) / dim**0.5).bfloat16(), 0.1 * r(f),
            (r(f, dim) / f**0.5).bfloat16(), 0.1 * r(dim)]
    if eps is not None:
        args += [1.0 + 0.1 * r(dim), 0.1 * r(dim)]
    kw = dict(activation=act, residual=False, ln_eps=eps or 0.0)
    before = ops.launch_counts()["fused_mlp"]
    out = ops.mlp(*args, **kw)
    assert ops.launch_counts()["fused_mlp"] == before + 1
    ref = reference_mlp(*args, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err
