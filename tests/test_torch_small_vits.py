"""The port's PatchMerger-ViT and ViT for small datasets (SPT + LSA) against
vit_tpu's on the CPU: ``spt_shifts`` bitwise against JAX's, ``SPT``,
``PatchMerger`` and an LSA ``Attention`` against the flax modules,
chip_smoke's weight draws against vit_tpu's init trees, LSA's routing (no
block kernel, at any depth), the tiny models in both of vit_tpu's CPU modes
(``xla``, and ``interpret``: the Pallas kernels in interpreter mode), planted
faults, and serving. On the card: ``Dense``'s cuBLAS bf16 product and the
unfused output projection's wgmma GEMM against their plain products, kernel 2
at the slice's five MLP shapes and kernel 3 at PatchMerger-ViT's two.

The tiny models are the families' ``MODEL_REGISTRY`` configs of vit_tpu
(PatchMerger-ViT: depth 4, merged after layer 2; the small-dataset ViT: depth
2, its stack scanned) and the same at depth 2, merged after layer 1, and at
depth 1 (unscanned). Parameters are drawn by chip_smoke's ``*_tree``
functions and perturbed, so that no bias, LayerNorm parameter or
temperature is a constant.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from chip_smoke import (
    DENSE_SHAPES,
    PATCH_MERGER,
    SMALL_DATASETS,
    ZOO2_MLP,
    ZOO2_QKV,
    kernel_tol,
    patch_merger_tree,
    vit_small_datasets_tree,
)
from vit_tpu_torch import ops
from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import PatchMergerViT, ViTSmallDatasets
from vit_tpu_torch.nn import SPT, Attention, Dense, PatchMerger, Transformer
from vit_tpu_torch.pipeline import InferencePipeline
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

MODELS = {"patch_merger_vit": PatchMergerViT, "vit_small_datasets": ViTSmallDatasets}
TREES = {"patch_merger_vit": patch_merger_tree, "vit_small_datasets": vit_small_datasets_tree}
PRESETS = {"patch_merger_vit": PATCH_MERGER, "vit_small_datasets": SMALL_DATASETS}
# (family, depth) of the tiny models: each at its registry depth, then the other
VARIANTS = [("patch_merger_vit", 4), ("patch_merger_vit", 2), ("vit_small_datasets", 2),
            ("vit_small_datasets", 1)]

# Max |logit| difference allowed (|logits| up to 2.1 on these inputs).
# fp32: every op in fp32 on both sides, summed in other orders: 1e-4
#   (measured 8.9e-7 to 1.5e-6, both modes).
# bf16: the port rounds where vit_tpu's kernels and modules round (the
#   merger and an LSA layer are bitwise vit_tpu run op by op), but the patch
#   embedding's fp32 product and SPT's LayerNorm and product over 3840 values
#   sum in other orders, which can flip one bf16 value of the stream, and
#   under jit XLA keeps some bf16 values in fp32 (excess precision). So
#   vit_tpu's own two modes differ by 0.0077 to 0.0133 here, and the bound is
#   twice the larger of that gap and 0.02, as tests/test_torch_vit_family.py
#   holds its families. Measured, the port from xla / interpret (the gap):
#     patch_merger_vit depth 4     0.0144 / 0.0151 (0.0077)
#     patch_merger_vit depth 2     0.0090 / 0.0139 (0.0105)
#     vit_small_datasets depth 2   0.0243 / 0.0182 (0.0121)
#     vit_small_datasets depth 1   0.0259 / 0.0248 (0.0133)
TOL_FP32 = 1e-4


def _config(fam, depth):
    """vit_tpu's registry config of ``fam`` at ``depth`` and its image size."""
    from vit_tpu.models import MODEL_REGISTRY

    _, cfg, size = MODEL_REGISTRY[fam]
    cfg = dict(cfg, depth=depth)
    if fam == "patch_merger_vit":
        cfg["patch_merge_layer"] = depth // 2
    return cfg, size


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    perturb = lambda a: a + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32)
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else perturb(v) for k, v in t.items()}
    return walk(tree)


def _normal(rng, std, *shape):
    return (std * rng.standard_normal(shape)).astype(np.float32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


def _jax_logits(fam, cfg, tree, img, dtype, mode):
    import jax
    import jax.numpy as jnp
    from vit_tpu import models as jm

    jd = getattr(jnp, dtype) if dtype != "float32" else None
    model = {"patch_merger_vit": jm.PatchMergerViT, "vit_small_datasets": jm.ViTSmallDatasets}[fam]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIT_TPU_BACKEND", mode)
        return np.asarray(jax.jit(model(**cfg, dtype=jd).apply)(tree, jnp.asarray(img)),
                          np.float32)


def _loaded(fam, cfg, tree, dtype=None):
    model = MODELS[fam](**cfg, dtype=dtype, device="cpu")
    model.load_state_dict(from_jax_params(tree, model.jax_stages), strict=True)
    return model


@pytest.fixture(scope="module", params=VARIANTS, ids=[f"{f}-depth{d}" for f, d in VARIANTS])
def tiny(request):
    """A tiny model's config, images, tree, and its vit_tpu logits by (dtype,
    mode), each computed once."""
    fam, depth = request.param
    cfg, size = _config(fam, depth)
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
    (``jax.disable_jit``, on jax arrays: numpy's bf16 arithmetic promotes),
    where jit's excess precision would skip vit_tpu's roundings; in fp32
    under jit, where there are none to skip."""
    import jax
    import jax.numpy as jnp

    if dtype == "float32":
        return np.asarray(jax.jit(mod.apply)(tree, x), np.float32)
    with jax.disable_jit():
        return np.asarray(mod.apply(jax.tree.map(jnp.asarray, tree), x).astype(jnp.float32))


def _ulp_err(out, ref):
    """Largest elementwise |out - ref| in bf16 ulps of |ref| (floored at
    2^-8 of max |ref|, so values near zero count by the largest one's ulp)."""
    ref = np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(ref), 2.0**-8 * np.abs(ref).max())
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(np.asarray(out, np.float64) - ref) / ulp).max())


# -- SPT -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 5, 7, 2), (3, 16, 16, 3)])
def test_spt_shifts_is_bitwise_jax(shape, dtype):
    import jax.numpy as jnp
    from vit_tpu.ops.patch_embed import spt_shifts as jax_spt_shifts

    x = np.random.default_rng(shape[1]).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax_spt_shifts(jnp.asarray(x, getattr(jnp, dtype))).astype(jnp.float32))
    out = ops.spt_shifts(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype) and out.shape == shape[:3] + (5 * shape[3],)
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spt_matches_flax(dtype):
    """SPT (the shifts, patchify, a bias-free LayerNorm and a Dense over 3840
    values a patch) against flax. fp32: the LayerNorm's and the product's
    sums run in other orders (measured 2.9e-6 at |out| ~4). bf16: the same
    rounding sites, so at most one bf16 ulp where a sum lands on a rounding
    boundary (measured: 1 of 2048 values one ulp apart)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.embed import SPT as JaxSPT

    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    mod = JaxSPT(64, 16, dtype=getattr(jnp, dtype) if dtype != "float32" else None)
    tree = {"params": {"norm": {"scale": 1.0 + _normal(rng, 0.1, 3840)},
                       "proj": {"kernel": _normal(rng, 3840**-0.5, 3840, 64),
                                "bias": _normal(rng, 0.1, 64)}}}
    ref = np.asarray(jax.jit(mod.apply)(tree, jnp.asarray(img)).astype(jnp.float32))
    spt = SPT(64, 16, dtype=getattr(torch, dtype) if dtype != "float32" else None,
              device="cpu")
    spt.load_state_dict(from_jax_params(tree, {}), strict=True)
    with torch.inference_mode():
        out = spt(torch.from_numpy(img))
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, 16, 64)
    out = out.float().numpy()
    if dtype == "float32":
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        assert _ulp_err(out, ref) <= 1.0 and (out != ref).mean() <= 0.01


# -- PatchMerger -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [16, 37])
def test_patch_merger_matches_flax(n, dtype):
    """The merger against flax (in bf16 run op by op): fp32 within 1e-5 of the
    output's scale (measured ~1e-7); bf16 within one bf16 ulp,
    with its queries rounded then scaled, both products rounded once and the
    softmax on bf16 scores (measured: bitwise)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.embed import PatchMerger as JaxPatchMerger

    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n, 64)).astype(np.float32)
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    mod = JaxPatchMerger(64, 4, dtype=jd)
    xj = jnp.asarray(x, jd or jnp.float32)
    tree = {"params": {"queries": _normal(rng, 1.0, 4, 64),
                       "norm": {"scale": 1.0 + _normal(rng, 0.1, 64), "bias": _normal(rng, 0.1, 64)}}}
    ref = _flax_apply(mod, tree, xj, dtype)
    merger = PatchMerger(64, 4, dtype=getattr(torch, dtype) if jd else None, device="cpu")
    merger.load_state_dict(from_jax_params(tree, {}), strict=True)
    with torch.inference_mode():
        out = merger(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype) and out.shape == (3, 4, 64)
    out = out.float().numpy()
    if dtype == "float32":
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        assert _ulp_err(out, ref) <= 1.0


# -- LSA -------------------------------------------------------------------------


LSA_CASES = {"delta": {}, "fuse_residual": {"fuse_residual": True},
             "talking heads": {"talking_heads": True}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(LSA_CASES))
def test_lsa_attention_matches_vit_tpu(case, dtype):
    """An LSA layer (``mask_self`` and a learned temperature, moved 0.3 from
    its init) against vit_tpu's ``Attention`` in interpret mode (in bf16 run
    op by op): fp32 within 1e-5 of the output's scale (measured ~1e-6); bf16 within one
    bf16 ulp (measured: bitwise). With ``fuse_residual`` and with talking
    heads too: vit_tpu's fusion gates exclude LSA, so both sides take the
    materializing path."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.attention import Attention as JaxAttention

    kw = dict(mask_self=True, learned_temperature=True, norm_eps=1e-5, **LSA_CASES[case])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    mod = JaxAttention(dim=64, heads=4, dim_head=16, dtype=jd, **kw)
    xj = jnp.asarray(x, jd or jnp.float32)
    params = {"norm_scale": 1.0 + _normal(rng, 0.1, 64), "norm_bias": _normal(rng, 0.1, 64),
              "qkv_kernel": _normal(rng, 0.125, 64, 192), "out_kernel": _normal(rng, 0.125, 64, 64),
              "out_bias": _normal(rng, 0.1, 64),
              "log_temperature": np.float32(math.log(16**-0.5) + 0.3)}  # moved from its init
    if "talking_heads" in kw:
        params.update(mix_heads_pre=np.eye(4, dtype=np.float32) + _normal(rng, 0.1, 4, 4),
                      mix_heads_post=np.eye(4, dtype=np.float32) + _normal(rng, 0.1, 4, 4))
    tree = {"params": params}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIT_TPU_BACKEND", "interpret")
        ref = _flax_apply(mod, tree, xj, dtype)
    attn = Attention(64, 4, 16, dtype=getattr(torch, dtype) if jd else None, device="cpu", **kw)
    attn.load_state_dict(from_jax_params(tree, {}), strict=True)
    with torch.inference_mode():
        out = attn(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    out = out.float().numpy()
    if dtype == "float32":
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        assert _ulp_err(out, ref) <= 1.0


def _spied(monkeypatch):
    """Count the calls of every attention kernel's dispatcher."""
    calls = {}
    for name in ("attention_block", "qkv_attention", "talking_heads_block", "reattention_block",
                 "attention"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=fn, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a, **k))[1])
    return calls


@pytest.mark.parametrize("depth", [1, 2])
def test_lsa_never_reaches_a_block_kernel(depth, monkeypatch):
    """A stack of LSA layers (``fuse_residual`` from depth 2) calls no
    attention kernel's dispatcher: each layer takes the materializing path;
    the same stack without LSA fuses (depth 2) or calls ``qkv_attention``
    (depth 1)."""
    x = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(depth))
    calls = _spied(monkeypatch)
    with torch.inference_mode():
        Transformer(32, depth, 2, 16, 64, mask_self=True, learned_temperature=True,
                    device="cpu")(x)
        assert calls == {}
        Transformer(32, depth, 2, 16, 64, device="cpu")(x)
    assert calls == ({"attention_block": 2} if depth == 2 else {"qkv_attention": 1})


def test_cross_attention_lsa_still_raises(monkeypatch):
    """LSA on the cross-attention branch raised before the attention
    variants were ported (the name is kept from then). Now ``mask_self``
    runs the flash route (``ops.attention(mask_self=True)``), the learned
    temperature the low-query path, and both match vit_tpu's in fp32 within
    tests/test_torch_attention_variants.py's 2e-5 of the largest output."""
    from test_torch_attention_variants import TOL, _err, _outputs

    for name in ("b: cross, mask_self", "b: cross, learned temperature, low-query"):
        out, ref = _outputs(name, "float32", "xla", monkeypatch)
        assert _err(out, ref) <= TOL["float32"], (name, _err(out, ref))


# -- the trees and the models --------------------------------------------------


@pytest.mark.parametrize("fam", list(MODELS))
@pytest.mark.parametrize("cfg", ["preset", "tiny", "tiny other depth"])
def test_trees_have_the_names_and_shapes_of_init(fam, cfg):
    import jax
    import jax.numpy as jnp
    from vit_tpu import models as jm

    if cfg == "preset":
        c, size = PRESETS[fam], 256
    else:
        c, size = _config(fam, [d for f, d in VARIANTS if f == fam][cfg != "tiny"])
    model = {"patch_merger_vit": jm.PatchMergerViT, "vit_small_datasets": jm.ViTSmallDatasets}[fam]
    want = jax.eval_shape(model(**c).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3), jnp.float32))
    tree = TREES[fam](c, seed=0)
    assert _leaves(tree) == _leaves(jax.tree.map(lambda a: a, want))
    if fam == "vit_small_datasets":  # each layer's temperature at vit_tpu's init
        leaf = tree["params"]["encoder"]
        leaf = leaf["blocks"]["attn"] if c["depth"] > 1 else leaf["attn_0"]
        np.testing.assert_allclose(leaf["log_temperature"], math.log(64**-0.5 if cfg == "preset"
                                                                     else 16**-0.5), rtol=1e-6)


@pytest.mark.parametrize("dtype,mode", [("float32", "xla"), ("float32", "interpret"),
                                        ("bfloat16", "xla"), ("bfloat16", "interpret")])
def test_family_matches_jax(dtype, mode, tiny):
    fam, cfg, img, tree, jax_logits = tiny
    ref = jax_logits(dtype, mode)
    model = _loaded(fam, cfg, tree, getattr(torch, dtype) if dtype != "float32" else None)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = model(torch.from_numpy(img))
    assert sum(ops.launch_counts().values()) == 0
    assert out.dtype == torch.float32 and out.shape == (2, 10)  # fp32 heads, as JAX's
    err = float(np.abs(out.numpy() - ref).max())
    if dtype == "float32":
        assert err <= TOL_FP32, err
    else:
        control = float(np.abs(jax_logits(dtype, "interpret" if mode == "xla" else "xla")
                               - ref).max())
        assert err <= 2 * max(control, 0.02), (err, control)


def _swapped_shifts(x):
    """A planted fault: SPT's right and left shifts swapped."""
    good = ops.patch_embed.spt_shifts(x)
    c = x.shape[-1]
    return torch.cat([good[..., :c], good[..., 2 * c: 3 * c], good[..., c: 2 * c],
                      good[..., 3 * c:]], dim=-1)


@pytest.fixture(scope="module")
def lsa_tiny():
    """The tiny small-dataset ViT (registry depth 2) with each layer's
    temperature moved 0.3 from its init, and vit_tpu's fp32 logits."""
    cfg, size = _config("vit_small_datasets", 2)
    img = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    tree = _perturbed(vit_small_datasets_tree(cfg, seed=3), seed=4)
    attn = tree["params"]["encoder"]["blocks"]["attn"]
    attn["log_temperature"] = attn["log_temperature"] + np.float32(0.3)
    return cfg, img, tree, _jax_logits("vit_small_datasets", cfg, tree, img, "float32", "xla")


FAULTS = ("LSA routed to the fused block (no mask, a constant scale)", "diagonal unmasked",
          "constant temperature", "SPT's left and right shifts swapped")


@pytest.mark.parametrize("fault", FAULTS)
def test_small_datasets_faults_fail_the_bound(fault, lsa_tiny, monkeypatch):
    """Each fault must miss the fp32 bound that the port meets. The fused
    route is the one a layer without LSA takes at depth 2; without the fault
    no layer reaches ``ops.attention_block``, and on the card the plain
    control (``force_backend("torch")``) launches no kernel 1."""
    cfg, img, tree, ref = lsa_tiny
    model = _loaded("vit_small_datasets", cfg, tree)
    calls = _spied(monkeypatch)
    with torch.inference_mode():
        good = float(np.abs(model(torch.from_numpy(img)).numpy() - ref).max())
        assert calls == {}
        ops.reset_launch_counts()
        with ops.force_backend("torch"):
            model(torch.from_numpy(img))
        assert ops.launch_counts()["attention_block"] == 0
        for block in model.encoder.blocks:
            if fault in (FAULTS[0], FAULTS[1]):
                block.attn.mask_self = False
            if fault in (FAULTS[0], FAULTS[2]):
                block.attn.learned_temperature = False
        if fault == FAULTS[3]:
            monkeypatch.setattr(ops, "spt_shifts", _swapped_shifts)
        bad = float(np.abs(model(torch.from_numpy(img)).numpy() - ref).max())
    assert calls == ({"attention_block": 2} if fault == FAULTS[0] else {})
    assert good <= TOL_FP32 < bad, (good, bad)


@pytest.mark.parametrize("fam", list(MODELS))
def test_default_constructors_ask_for_the_card(fam):
    cfg, _ = _config(fam, 2)
    if torch.cuda.is_available():
        assert next(MODELS[fam](**cfg).head.parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            MODELS[fam](**cfg)


@pytest.mark.parametrize("fam", list(MODELS))
def test_server_answers_requests(fam):
    cfg, size = _config(fam, 2)
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
@pytest.mark.parametrize("what,rows,k,n", DENSE_SHAPES,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_dense_on_the_card_is_within_an_ulp_of_the_plain_product(cuda, what, rows, k, n):
    """A bf16 ``Dense`` on a CUDA tensor (cuBLAS, fp32 sums, one rounding)
    against its plain product (``force_backend("torch")``: ``_mm``) at T2T's
    proj and SPT's widths, batch 8: each value within one bf16 ulp of the
    plain one, plus the fp32 sum-order slack of K products."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    dense = Dense(k, n, use_bias=False, dtype=torch.bfloat16, device=cuda)
    with torch.no_grad():
        dense.kernel.copy_(torch.randn(k, n, generator=gen, device=cuda) / k**0.5)
    x = torch.randn(8, rows, k, generator=gen, device=cuda).bfloat16()
    with torch.inference_mode():
        out = dense(x)
        with ops.force_backend("torch"):
            ref = dense(x)
    assert out.dtype == ref.dtype == torch.bfloat16
    ref = ref.float()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
    slack = 2 * k * 2.0**-24 * (x.float().abs() @ dense.kernel.bfloat16().float().abs())
    assert ((out.float() - ref).abs() <= ulp + slack).all()


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
def test_unfused_out_projection_on_the_card_matches_its_twin(cuda, residual):
    """``Attention._unfused`` at PatchMerger-ViT's width (256 tokens, dim
    1024, 8 heads of 64), batch 8: on the card the fused-qkv kernel and the
    output projection on the wgmma GEMM (fp32 bias in the epilogue), against
    the plain twin (``force_backend("torch")``), within kernel_tol, with and
    without the residual added after the rounding."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    attn = Attention(1024, 8, 64, fuse_residual=residual, norm_eps=1e-5, device=cuda)
    with torch.no_grad():
        for name, p in attn.named_parameters():
            r = torch.randn(p.shape, generator=gen, device=cuda)
            p.copy_(1.0 + 0.1 * r if name == "norm_scale" else
                    0.1 * r if p.dim() == 1 else r / p.shape[0] ** 0.5)
    x = torch.randn(8, 256, 1024, generator=gen, device=cuda).bfloat16()
    with torch.inference_mode():
        out = attn._unfused(x, torch.bfloat16)
        with ops.force_backend("torch"):
            ref = attn._unfused(x, torch.bfloat16)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("what,n", ZOO2_QKV, ids=lambda v: v if isinstance(v, str) else None)
def test_qkv_attention_kernel_at_patch_merger_shapes(cuda, what, n):
    """Kernel 3 at PatchMerger-ViT's two shapes (256 tokens, and the 8 merged
    ones; 8 heads of 64), batch 8, against its twin within kernel_tol."""
    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    gen = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(8, n, 3 * 512, generator=gen, device=cuda).bfloat16()
    before = ops.launch_counts()["qkv_attention"]
    out = ops.qkv_attention(qkv, 8)
    assert ops.launch_counts()["qkv_attention"] == before + 1
    ref = qa.xla_qkv_attention(qkv, 8)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("what,n,dim,f,eps", ZOO2_MLP,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_mlp_kernel_at_the_slice_shapes(cuda, what, n, dim, f, eps):
    """Kernel 2 at the slice's five MLP shapes (batch 8, without the residual
    as FeedForward calls it) against its twin, within kernel_tol."""
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
