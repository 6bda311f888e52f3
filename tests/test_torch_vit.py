"""The port's tiny ViT against vit_tpu's ``ViT.apply`` on the CPU, from the
same converted parameters and the same numpy images.

vit_tpu runs in both of its CPU modes: ``xla`` (the default off-TPU) and
``interpret`` (the Pallas kernels in interpreter mode, as
tests/test_ops.py::TestDispatcherPaths drives them).
"""

import numpy as np
import pytest
import torch

from vit_tpu_torch.models import ViT as TorchViT
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

CFG = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4,
           mlp_dim=128, dim_head=16)

# (dtype, residual_dtype) of each precision config.
CONFIGS = {"fp32": (None, None), "bf16": ("bfloat16", None), "mixed": ("bfloat16", "float32")}

# Max |logit| difference allowed, per config and vit_tpu mode (|logits| ~2).
# fp32: 1e-4; the two vit_tpu modes agree to 7e-7 here, the port to 1.3e-6.
# bf16 / interpret: the port rounds where the Pallas kernels do and measured
#   2.4e-7; 4e-3 leaves room for one bf16 intermediate rounding to its
#   neighbour, far below the 1.8e-2 that separates the two vit_tpu modes.
# bf16 / xla: vit_tpu's XLA attention rounds the attention delta and the
#   residual sum separately (nn/attention.py:348, :354) where the kernel
#   rounds once, so its logits differ from its own kernel path by 1.8e-2 on
#   this model; the port follows the kernel path, so it inherits that gap.
#   4e-2 is about twice it.
# mixed: fp32 stream, bf16 GEMM operands: measured 5.4e-7 against both.
TOL = {
    ("fp32", "xla"): 1e-4, ("fp32", "interpret"): 1e-4,
    ("bf16", "xla"): 4e-2, ("bf16", "interpret"): 4e-3,
    ("mixed", "xla"): 1e-3, ("mixed", "interpret"): 1e-3,
}


def _variables(jax_model, img, seed=1):
    """``ViT.init`` parameters as numpy, perturbed so that biases and LN
    parameters are not all zeros and ones."""
    import jax
    import jax.numpy as jnp

    v = jax_model.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(img))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), v
    )


def _models(config, pool="cls"):
    import jax.numpy as jnp
    from vit_tpu.models import ViT as JaxViT

    dt, rd = CONFIGS[config]
    jm = JaxViT(**CFG, pool=pool, dtype=getattr(jnp, dt) if dt else None,
                residual_dtype=getattr(jnp, rd) if rd else None)
    tm = TorchViT(**CFG, pool=pool, dtype=getattr(torch, dt) if dt else None,
                  residual_dtype=getattr(torch, rd) if rd else None)
    return jm, tm


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_vit_matches_jax(config, mode, monkeypatch):
    import jax.numpy as jnp

    img = _images()
    jm, tm = _models(config)
    variables = _variables(jm, img)
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    ref = np.asarray(jm.apply(variables, jnp.asarray(img)), np.float32)
    tm.load_state_dict(from_jax_params(variables), strict=True)
    with torch.inference_mode():
        out = tm(torch.from_numpy(img))
    assert out.dtype == torch.float32 and out.shape == (2, 10)
    err = np.abs(out.numpy() - ref).max()
    assert err <= TOL[(config, mode)], err


def test_vit_mean_pool_matches_jax():
    import jax.numpy as jnp

    img = _images(3)
    jm, tm = _models("fp32", pool="mean")
    variables = _variables(jm, img)
    ref = np.asarray(jm.apply(variables, jnp.asarray(img)), np.float32)
    tm.load_state_dict(from_jax_params(variables), strict=True)
    with torch.inference_mode():
        out = tm(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_converter_round_trips_shapes_and_values():
    import jax

    img = _images()
    jm, tm = _models("bf16")
    variables = _variables(jm, img)
    state = from_jax_params(variables)
    assert set(state) == set(tm.state_dict())
    missing, unexpected = tm.load_state_dict(state, strict=True)
    assert not missing and not unexpected
    leaves = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    for path, leaf in leaves:
        names = [p.key for p in path]
        if names[:2] == ["encoder", "blocks"]:
            assert leaf.shape[0] == CFG["depth"]
            for i in range(CFG["depth"]):
                key = ".".join(["encoder", "blocks", str(i)] + names[2:])
                np.testing.assert_array_equal(state[key].numpy(), leaf[i])
        else:
            np.testing.assert_array_equal(state[".".join(names)].numpy(), leaf)
    n_leaves = sum(
        CFG["depth"] if [p.key for p in path][:2] == ["encoder", "blocks"] else 1
        for path, _ in leaves
    )
    assert len(state) == n_leaves


def test_converter_rejects_a_wrong_layout():
    img = _images()
    jm, tm = _models("fp32")
    state = from_jax_params(_variables(jm, img))
    state["encoder.blocks.0.attn.qkv_kernel"] = state["encoder.blocks.0.attn.qkv_kernel"].T
    with pytest.raises(RuntimeError):
        tm.load_state_dict(state, strict=True)


@pytest.mark.parametrize("flag", ["qkv_bias", "talking_heads", "reattention", "mask_self"])
def test_unported_attention_branches_raise(flag):
    from vit_tpu_torch.nn import Attention

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Attention(64, 4, 16, **{flag: True})


def test_cross_attention_raises():
    from vit_tpu_torch.nn import Attention

    x = torch.zeros(1, 5, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Attention(64, 4, 16)(x, context=x)
