"""The port's T2T-ViT against vit_tpu's on the CPU: the soft split
(``extract_patches``) against vit_tpu and TensorFlow, flax's LayerNorm
without a bias, chip_smoke's weight draw against vit_tpu's init tree, the
tiny model in both of vit_tpu's CPU modes (``xla``, and ``interpret``: the
Pallas kernels in interpreter mode), and serving.

The tiny models are ``MODEL_REGISTRY["t2t"]`` of vit_tpu (encoder depth 1,
so that its one layer is unscanned) and the same with encoder depth 2
(scanned). Their tokenizers run the preset's widths, 147 and 1323, so the
kv-blocked twin is on the port's path. Parameters are drawn by
``chip_smoke.t2t_tree`` and perturbed, so that no bias or LayerNorm parameter
is a constant.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import t2t_tree
from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import T2TViT
from vit_tpu_torch.nn import LayerNorm
from vit_tpu_torch.ops import extract_patches
from vit_tpu_torch.pipeline import InferencePipeline
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

T2T_PRESET = dict(image_size=224, num_classes=1000, dim=512, depth=5, heads=8, mlp_dim=512,
                  t2t_layers=((7, 4), (3, 2), (3, 2)))

# Max |logit| difference allowed, per dtype and vit_tpu mode (|logits| ~1-3).
# fp32: every op in fp32 on both sides, summed in other orders; the online
#   softmax of the port's tokenizer equals the exact one to fp32 rounding:
#   1e-4.
# bf16: the port follows vit_tpu's rounding sites op for op, but where vit_tpu
#   runs an exact softmax in its tokenizer (its XLA twin, or its fused-qkv
#   kernel in interpret mode: the tiny stages fit that kernel's VMEM
#   estimate) the port runs the kv-blocked twin, which rounds the
#   unnormalised p to bf16 instead of P; one bf16 value moved upstream then
#   spreads through two tokenizer layers 147 and 1323 wide and the encoder.
#   The control is vit_tpu's own two modes on the same weights and input;
#   the port is held to twice the larger of the control and 0.02. Measured
#   (|logits| up to 2.5): the port 0.0156-0.0215 from vit_tpu, the control
#   0.0117-0.0156; fp32 2.6e-6.
TOL_FP32 = 1e-4


def _config(depth):
    from vit_tpu.models import MODEL_REGISTRY

    _, cfg, size = MODEL_REGISTRY["t2t"]
    return dict(cfg, depth=depth), size


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    perturb = lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else perturb(v) for k, v in t.items()}
    return walk(tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.fixture(scope="module", params=[1, 2], ids=["depth1", "depth2"])
def tiny(request):
    cfg, size = _config(request.param)
    img = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    return cfg, img, _perturbed(t2t_tree(cfg, seed=3), seed=4)


@pytest.mark.parametrize("cfg", ["preset", "tiny depth 1", "tiny depth 2"])
def test_t2t_tree_has_the_names_and_shapes_of_init(cfg):
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import T2TViT as JaxT2T

    c, size = (T2T_PRESET, 224) if cfg == "preset" else _config(int(cfg[-1]))
    want = jax.eval_shape(JaxT2T(**c).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3), jnp.float32))
    assert _leaves(t2t_tree(c, seed=0)) == _leaves(jax.tree.map(lambda a: a, want))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("shape,kernel,stride", [
    ((2, 224, 224, 3), 7, 4), ((2, 56, 56, 147), 3, 2), ((1, 17, 19, 5), 4, 3),
])
def test_extract_patches_is_bitwise_jax_and_tensorflow(padding, shape, kernel, stride):
    import jax.numpy as jnp
    import tensorflow as tf
    from vit_tpu.ops.patch_embed import extract_patches as jax_extract

    x = np.random.default_rng(kernel).standard_normal(shape).astype(np.float32)
    out = extract_patches(torch.from_numpy(x), kernel, stride, padding).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_extract(jnp.asarray(x), kernel, stride,
                                                              padding)))
    ref = tf.image.extract_patches(x, [1, kernel, kernel, 1], [1, stride, stride, 1],
                                   [1, 1, 1, 1], padding).numpy()
    np.testing.assert_array_equal(out, ref)


def test_layer_norm_without_bias_is_flax():
    """``LayerNorm(use_bias=False, dtype=bf16)`` is flax's: no ``bias``
    parameter, fp32 statistics, one rounding (T2T's ``head_norm``)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(5).standard_normal((3, 24)).astype(np.float32)
    mod = fnn.LayerNorm(epsilon=1e-5, use_bias=False, dtype=jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = _perturbed(jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(0), xb)), 6)
    ref = np.asarray(mod.apply(variables, xb).astype(jnp.float32))
    ln = LayerNorm(24, eps=1e-5, use_bias=False, dtype=torch.bfloat16, device="cpu")
    assert set(ln.state_dict()) == {"scale"}
    ln.load_state_dict(from_jax_params(variables, {}), strict=True)
    with torch.inference_mode():
        out = ln(torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(out.float().numpy(), ref)


def _jax_logits(cfg, tree, img, dtype, mode, monkeypatch):
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import T2TViT as JaxT2T

    jd = getattr(jnp, dtype) if dtype != "float32" else None
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    return np.asarray(jax.jit(JaxT2T(**cfg, dtype=jd).apply)(tree, jnp.asarray(img)), np.float32)


@pytest.mark.parametrize("dtype,mode", [("float32", "xla"), ("float32", "interpret"),
                                        ("bfloat16", "xla"), ("bfloat16", "interpret")])
def test_t2t_matches_jax(dtype, mode, tiny, monkeypatch):
    cfg, img, tree = tiny
    ref = _jax_logits(cfg, tree, img, dtype, mode, monkeypatch)
    td = getattr(torch, dtype) if dtype != "float32" else None
    model = T2TViT(**cfg, dtype=td, device="cpu")
    model.load_state_dict(from_jax_params(tree, model.jax_stages), strict=True)
    ops = importlib.import_module("vit_tpu_torch.ops")
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = model(torch.from_numpy(img))
    assert sum(ops.launch_counts().values()) == 0
    assert out.dtype == (td or torch.float32) and out.shape == (2, 10)  # bf16 logits, as JAX's
    err = float(np.abs(out.float().numpy() - ref).max())
    if dtype == "float32":
        assert err <= TOL_FP32, err
    else:
        other = _jax_logits(cfg, tree, img, dtype, "interpret" if mode == "xla" else "xla",
                            monkeypatch)
        control = float(np.abs(other - ref).max())
        assert err <= 2 * max(control, 0.02), (err, control)


def test_default_t2t_asks_for_the_card():
    cfg, _ = _config(1)
    if torch.cuda.is_available():
        assert next(T2TViT(**cfg).parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            T2TViT(**cfg)


def test_server_answers_requests(tiny):
    cfg, img, tree = tiny
    model = T2TViT(**cfg, device="cpu")
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
