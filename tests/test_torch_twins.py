"""The port's Twins-SVT against vit_tpu's on the CPU: its conv modules against
flax, the converter's conv layout and stages, chip_smoke's weight draw
against vit_tpu's init tree, the tiny model in both of vit_tpu's CPU modes
(``xla``, and ``interpret``: the Pallas kernels in interpreter mode), and
serving.

The tiny model is ``MODEL_REGISTRY["twins_svt"]`` of vit_tpu with
``s3_depth=2``, so that stage 3 is scanned (stacked) in vit_tpu's tree. Its
parameters are drawn once per file by ``chip_smoke.twins_tree`` (checked
against ``jax.eval_shape`` of vit_tpu's ``init``) and perturbed, so that no
bias or LayerNorm parameter is a constant.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import twins_tree
from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import TwinsSVT
from vit_tpu_torch.nn import PEG, Conv, ConvMLP, LayerNorm, PatchEmbedding
from vit_tpu_torch.ops.block_attention import _ln_f32
from vit_tpu_torch.pipeline import InferencePipeline
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

# Max |logit| difference allowed (|logits| up to 8.6 on this input).
# fp32 against xla: every op in fp32 on both sides; measured 5.7e-6: 1e-4.
# bf16: the port rounds where vit_tpu's modules and kernels round, but the
#   sums run in another order, and a value one bf16 ulp apart upstream
#   (0.1% of the values after the first window block) spreads through 18
#   attention and 18 MLP layers of width 16-32, whose LayerNorms divide by
#   small deviations: vit_tpu's own two modes differed by 0.0625 to 0.25
#   over three input draws (init weights, perturbed alike). The port
#   measured 0.078 (xla) and 0.094 (interpret) here: 0.4, 1.6x the largest
#   gap between vit_tpu's own modes.
TOL = {("float32", "xla"): 1e-4, ("bfloat16", "xla"): 0.4, ("bfloat16", "interpret"): 0.4}


def _config():
    from vit_tpu.models import MODEL_REGISTRY

    _, cfg, size = MODEL_REGISTRY["twins_svt"]
    return dict(cfg, s3_depth=2), size


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    perturb = lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else perturb(v) for k, v in t.items()}
    return walk(tree)


@pytest.fixture(scope="module")
def tiny():
    cfg, size = _config()
    img = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    return cfg, img, _perturbed(twins_tree(cfg, 1), 2)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_twins_tree_has_the_names_and_shapes_of_init(tiny):
    """chip_smoke draws the preset's weights with numpy in vit_tpu's layout;
    its tree has the leaves of vit_tpu's ``init``, and its conv kernels the
    spread of lecun-normal over their real fan-in (kh * kw * in/groups)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import TwinsSVT as JaxTwins

    cfg, img, _ = tiny
    shapes = jax.eval_shape(JaxTwins(**cfg).init, jax.random.PRNGKey(0), jnp.asarray(img))
    tree = twins_tree(cfg, 1)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_leaves_with_path(shapes)}
    assert _leaves(tree) == want
    kv = tree["params"]["block_a_1"]["layers"]["global"]["to_kv"]["kernel"]  # [4, 4, 16, 1024]
    assert abs(kv.std() * (4 * 4 * 16) ** 0.5 - 1.0) < 0.05
    peg = tree["params"]["peg_2"]["proj"]["kernel"]  # depthwise [3, 3, 1, 16]: fan-in 9
    assert 0.5 < peg.std() * 3.0 < 1.5


def test_converter_turns_conv_kernels_after_unstacking(tiny):
    """HWIO conv kernels become OIHW, in a scanned stage (5-D leaves) after
    the depth axis is taken off; Dense kernels keep ``[in, out]``; the tree
    loads with ``strict=True``."""
    cfg, _, tree = tiny
    model = TwinsSVT(**cfg, device="cpu")
    assert model.jax_stages["block_a_3/layers"] == 2 and model.jax_stages["block_b_1/layers"] == 1
    state = from_jax_params(tree, model.jax_stages)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)
    p = tree["params"]
    kv3 = p["block_a_3"]["layers"]["global"]["to_kv"]["kernel"]  # [2, 2, 2, 32, 1024]
    np.testing.assert_array_equal(state["block_a_3.layers.1.global.to_kv.kernel"].numpy(),
                                  kv3[1].transpose(3, 2, 0, 1))
    kv1 = p["block_b_1"]["layers"]["global"]["to_kv"]["kernel"]
    np.testing.assert_array_equal(state["block_b_1.layers.0.global.to_kv.kernel"].numpy(),
                                  kv1.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["peg_1.proj.kernel"].numpy(),
                                  p["peg_1"]["proj"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["block_a_3.layers.0.local.qkv_kernel"].numpy(),
                                  p["block_a_3"]["layers"]["local"]["qkv_kernel"][0])
    with pytest.raises(ValueError, match="depth"):
        from_jax_params(tree, {**model.jax_stages, "block_a_3/layers": 3})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("module", ["conv", "depthwise", "peg", "patch_embedding", "conv_mlp"])
def test_conv_modules_match_flax(module, dtype):
    """flax ``nn.Conv(dtype)`` (SAME padding, the odd pixel at the end; the
    bias added after the rounding, in the dtype), PEG, PatchEmbedding (``(c
    p1 p2)`` features) and ConvMLP against vit_tpu's modules. fp32 within
    1e-5 of the largest output; bf16 within one bf16 ulp of it (a sum in
    another order can round to the neighbouring value)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn import conv as jconv

    jd = getattr(jnp, dtype) if dtype != "float32" else None
    td = getattr(torch, dtype) if dtype != "float32" else None
    x = np.random.default_rng(3).standard_normal((2, 9, 7, 8)).astype(np.float32)
    jmod, tmod = {
        "conv": (fnn.Conv(12, (3, 3), strides=2, dtype=jd),
                 Conv(8, 12, 3, strides=2, dtype=td, device="cpu")),
        "depthwise": (fnn.Conv(8, (3, 3), feature_group_count=8, use_bias=False, dtype=jd),
                      Conv(8, 8, 3, feature_group_count=8, use_bias=False, dtype=td,
                           device="cpu")),
        "peg": (jconv.PEG(8, dtype=jd), PEG(8, dtype=td, device="cpu")),
        "patch_embedding": (jconv.PatchEmbedding(16, 2, dtype=jd),
                            PatchEmbedding(8, 16, 2, dtype=td, device="cpu")),
        "conv_mlp": (jconv.ConvMLP(8, dtype=jd), ConvMLP(8, dtype=td, device="cpu")),
    }[module]
    if module == "patch_embedding":
        x = x[:, :8, :6]
    xj = jnp.asarray(x, jd or jnp.float32)
    variables = _perturbed(jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), xj)), 4)
    ref = np.asarray(jmod.apply(variables, xj), np.float32)
    tmod.load_state_dict(from_jax_params(variables, {}), strict=True)
    with torch.inference_mode():
        out = tmod(torch.from_numpy(x).to(td or torch.float32))
    assert out.dtype == (td or torch.float32) and out.shape == ref.shape
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol * np.abs(ref).max(), rtol=0)


def test_conv_mlp_batch_norm_raises():
    """The BatchNorm branch builds (``up``, ``bn1``, ``down``, ``bn2``, no
    biases unfolded) and trains; folded (``fold_bn``) it raises in training
    mode, inference only as ``vit_tpu`` asserts
    (tests/test_torch_cvt_levit.py holds the branch against flax,
    tests/test_torch_train_bn.py its training)."""
    m = ConvMLP(8, batch_norm=True, device="cpu")
    assert m.bn1 is not None and m.bn2 is not None and m.up.bias is None
    assert m(torch.randn(2, 2, 2, 8), train=True).shape == (2, 2, 2, 8)
    folded = ConvMLP(8, batch_norm=True, fold_bn=True, device="cpu")
    with pytest.raises(ValueError, match="inference only"):
        folded(torch.zeros(1, 2, 2, 8), train=True)


def test_layer_norm_dtype_is_flax():
    """``LayerNorm(dtype=bf16)`` is flax's ``nn.LayerNorm(dtype=bf16)``: fp32
    statistics and normalisation, then one rounding; with ``dtype=None`` it
    is the fp32 formula it was, bit for bit."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(5).standard_normal((3, 7, 24)).astype(np.float32)
    mod = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = _perturbed(jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(0), xb)), 6)
    ref = np.asarray(mod.apply(variables, xb).astype(jnp.float32))
    ln = LayerNorm(24, eps=1e-5, dtype=torch.bfloat16, device="cpu")
    ln.load_state_dict(from_jax_params(variables, {}), strict=True)
    with torch.inference_mode():
        out = ln(torch.from_numpy(x).bfloat16())
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.float().numpy(), ref)
        plain = LayerNorm(24, eps=1e-5, device="cpu")
        plain.load_state_dict(ln.state_dict())
        xt = torch.from_numpy(x)
        torch.testing.assert_close(plain(xt), _ln_f32(xt, ln.scale, ln.bias, 1e-5), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,mode", [("float32", "xla"), ("bfloat16", "xla"),
                                        ("bfloat16", "interpret")])
def test_twins_matches_jax(dtype, mode, tiny, monkeypatch):
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import TwinsSVT as JaxTwins

    cfg, img, tree = tiny
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    td = getattr(torch, dtype) if dtype != "float32" else None
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    ref = np.asarray(jax.jit(JaxTwins(**cfg, dtype=jd).apply)(tree, jnp.asarray(img)), np.float32)
    model = TwinsSVT(**cfg, dtype=td, device="cpu")
    model.load_state_dict(from_jax_params(tree, model.jax_stages), strict=True)
    ops = importlib.import_module("vit_tpu_torch.ops")
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = model(torch.from_numpy(img))
    assert sum(ops.launch_counts().values()) == 0
    assert out.dtype == (td or torch.float32) and out.shape == (2, 10)  # bf16 logits, as JAX's
    err = float(np.abs(out.float().numpy() - ref).max())
    assert err <= TOL[(dtype, mode)], err


def test_default_twins_asks_for_the_card(tiny):
    cfg, _, _ = tiny
    if torch.cuda.is_available():
        assert next(TwinsSVT(**cfg).parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            TwinsSVT(**cfg)


def test_server_answers_requests(tiny):
    cfg, img, tree = tiny
    model = TwinsSVT(**cfg, device="cpu")
    model.load_state_dict(from_jax_params(tree, model.jax_stages), strict=True)
    size = img.shape[1]
    pipe = InferencePipeline(model, image_size=size, batch_size=4, dtype=torch.float32)
    imgs = np.random.default_rng(2).integers(0, 256, (6, size, size, 3), dtype=np.uint8)
    with BatchingServer(pipe, decoder=JpegDecoder(size=size), max_wait_ms=20) as server:
        futures = [server.submit(im) for im in imgs]
        rows = np.stack([f.result(timeout=60) for f in futures])
    direct = np.concatenate([pipe(imgs[i: i + 1]) for i in range(6)])
    assert rows.shape == (6, 10) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, direct, atol=1e-5, rtol=0)


def test_exports_loads_and_runs_with_its_global_attention(tiny):
    """The global attention is the attribute ``global_`` (``global`` is a
    Python keyword, and ``ExportedProgram.module()`` writes each parameter's
    path as code), while the state dict keeps vit_tpu's name: the converted
    tree loads strictly, ``state_dict()`` gives its keys back, and the
    program exported, saved and loaded equals the eager model bit for bit."""
    from vit_tpu_torch.utils import export_forward, load_forward

    cfg, img, tree = tiny
    model = TwinsSVT(**cfg, dtype=torch.bfloat16, device="cpu")
    state = from_jax_params(tree, model.jax_stages)
    model.load_state_dict(state, strict=True)
    assert set(model.state_dict()) == set(state)
    assert not any(".global_." in k for k in model.state_dict())
    x = torch.from_numpy(img[:1]).bfloat16()
    program = load_forward(export_forward(model.eval(), x))
    assert any(".global_." in k for k, _ in program.named_parameters())
    with torch.inference_mode():
        assert torch.equal(program(x), model(x))


@pytest.mark.cuda
@pytest.mark.parametrize("c,out,k,stride,groups,n", [
    (64, 1024, 7, 7, 1, 56), (256, 1024, 7, 7, 1, 14), (512, 1024, 7, 7, 1, 7),
    (16, 1024, 4, 4, 1, 16), (64, 64, 3, 1, 64, 56),
])
def test_bf16_conv_on_the_card_matches_the_cpu(c, out, k, stride, groups, n):
    """On the card a bf16 ``Conv`` runs in bf16 through cuDNN; it agrees with
    the CPU's fp32 sums of the same rounded operands within one bf16 ulp of
    the largest output (GSA's strided convs and PEG's depthwise one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(c + k)
    conv = Conv(c, out, k, strides=stride, feature_group_count=groups, dtype=torch.bfloat16,
                device="cpu")
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(rng.standard_normal(conv.kernel.shape)).float()
                          / (k * k * c / groups) ** 0.5)
        conv.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(out)).float())
    x = torch.from_numpy(rng.standard_normal((2, n, n, c))).bfloat16()
    with torch.inference_mode():
        ref = conv(x)
        got = conv.cuda()(x.cuda()).cpu()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2.0**-7 * ref.float().abs().max().item(), err
