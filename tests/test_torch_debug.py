"""``vit_tpu_torch.utils.debug`` on the CPU: ``checked`` against
``vit_tpu.utils.checked`` on the same NaN-producing input, and
``debug_nans`` and ``kernel_sanitizer`` giving back the state they found."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from vit_tpu_torch import ops
from vit_tpu_torch.models import ViT
from vit_tpu_torch.utils import checked, debug_nans, from_jax_params, kernel_sanitizer

torch.set_num_threads(2)

CFG = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=1, heads=2, mlp_dim=64,
           dim_head=16)


def _global_hooks() -> int:
    return len(nn.modules.module._global_forward_hooks)


@pytest.fixture(scope="module")
def models():
    from vit_tpu.models import ViT as JaxViT

    jm = JaxViT(**CFG)
    rng = np.random.default_rng(0)  # drawn here: jax.jit of init would cost seconds
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 32, 32, 3))))
    variables = jax.tree.map(lambda s: 0.2 * rng.standard_normal(s.shape, np.float32), shapes)
    tm = ViT(**CFG, device="cpu").eval()
    tm.load_state_dict(from_jax_params(variables, tm.jax_stages), strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_checked_raises_where_vit_tpu_does_and_names_the_module(models, bad):
    """A non-finite pixel: vit_tpu's checkify raises on the NaN it makes;
    the port raises on the non-finite logits and names the patch
    embedding, the first module whose output held one."""
    from vit_tpu.utils import checked as jax_checked

    jm, variables, tm = models
    x = np.zeros((2, 32, 32, 3), np.float32)
    x[1, 3, 3, 0] = bad
    with pytest.raises(Exception, match="nan generated"):
        jax_checked(lambda v, a: jm.apply(v, a))(variables, jnp.asarray(x))
    hooks = _global_hooks()
    with pytest.raises(FloatingPointError, match=r"output: first produced by module "
                                                 r"'patch_embed\.\S*' \(Dense\)"):
        checked(tm)(torch.from_numpy(x))
    assert _global_hooks() == hooks


def test_checked_passes_finite_outputs_through(models):
    jm, variables, tm = models
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        out = checked(tm)(torch.from_numpy(x))
        np.testing.assert_array_equal(out.numpy(), tm(torch.from_numpy(x)).numpy())
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_checked_names_the_leaf_of_a_nest():
    lin = nn.Linear(2, 2)

    def fn(x):
        return {"fine": x, "bad": (x, lin(x) / 0.0)}

    with pytest.raises(FloatingPointError, match=r"output\['bad'\]\[1\]: first produced by "
                                                 r"module Linear|output\['bad'\]\[1\]: no module"):
        checked(fn)(torch.zeros(1, 2))


def test_debug_nans_raises_at_the_module_and_restores_state():
    model = nn.Sequential(nn.Linear(2, 2), nn.ReLU())
    x = torch.tensor([[1.0, float("nan")]])
    anomaly, hooks = torch.is_anomaly_enabled(), _global_hooks()
    with pytest.raises(FloatingPointError, match="of module Linear"):
        with debug_nans():
            assert torch.is_anomaly_enabled()
            model(x)
    assert torch.is_anomaly_enabled() == anomaly and _global_hooks() == hooks
    with debug_nans(False):
        assert not torch.is_anomaly_enabled()
        assert torch.isnan(model(x)).any()
    assert torch.is_anomaly_enabled() == anomaly and _global_hooks() == hooks


def test_kernel_sanitizer_forces_the_twins_and_restores():
    assert not ops._forced()
    with kernel_sanitizer():
        assert ops._forced()
        with kernel_sanitizer():
            assert ops._forced()
        assert ops._forced()
    assert not ops._forced()
    with pytest.raises(RuntimeError):
        with kernel_sanitizer():
            raise RuntimeError
    assert not ops._forced()
