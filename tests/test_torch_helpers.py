"""The port's position-table resamplers, ``nn.ProjectInOut`` and
``ops.unpatchify`` against ``vit_tpu``'s on the CPU.

``interpolate_pos_embedding`` at every ``jax.image.resize`` method
(``nearest``, ``bilinear``, ``cubic``, ``lanczos3``, ``lanczos5``), up and
down (antialiased) and at a non-square grid, on fp32 and bf16 tables.
Bounds, measured over these cases:

- ``nearest``: bit for bit (a gather at the same fp32 offsets).
- the weighted methods, fp32: within 2e-6 of max |table| (measured at most
  7.2e-7: the weights' fp32 kernels and the sums run in another order than
  XLA's fused ones);
- bf16: each value within one bf16 ulp (of the larger of the two) plus the
  fp32 bound of ``vit_tpu``'s: both resize in fp32 and round once, so a
  value near a rounding boundary may round the other way, and a value near
  zero carries the fp32 sums' noise (one was 4 ulps of its tiny magnitude
  apart).

``ProjectInOut`` against flax's module in fp32 (1e-5 of max |out|) and
bf16 (one bf16 ulp of max |out|), the callable's arguments passed through.
``unpatchify`` bit for bit ``vit_tpu``'s and the inverse of ``patchify``.
"""

import numpy as np
import pytest
import torch

from vit_tpu_torch import ops
from vit_tpu_torch.nn import ProjectInOut
from vit_tpu_torch.utils import from_jax_params, interpolate_pos_embedding
from vit_tpu_torch.utils.pos_embed import METHODS, resize_weights

torch.set_num_threads(2)

RESIZE_METHODS = ("nearest", "bilinear", "cubic", "lanczos3", "lanczos5")
GRIDS = {"up 4 to 6": ((4, 4), (6, 6)), "up 14 to 24": ((14, 14), (24, 24)),
         "down 8 to 4": ((8, 8), (4, 4)), "down 24 to 7": ((24, 24), (7, 7)),
         "7x5 to 3x9": ((7, 5), (3, 9))}
FP32_TOL = 2e-6
MODULE_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grids", list(GRIDS))
@pytest.mark.parametrize("method", RESIZE_METHODS)
def test_interpolate_pos_embedding_matches_jax_image_resize(method, grids, dtype):
    import jax.numpy as jnp
    from vit_tpu.utils import interpolate_pos_embedding as jax_interpolate

    old, new = GRIDS[grids]
    rng = np.random.default_rng(len(method) + old[0])
    pos = (0.02 * rng.standard_normal((1, 2 + old[0] * old[1], 32))).astype(np.float32)
    ref = np.asarray(jax_interpolate(jnp.asarray(pos).astype(getattr(jnp, dtype)), new, old,
                                     num_prefix_tokens=2, method=method).astype(jnp.float32))
    out = interpolate_pos_embedding(torch.from_numpy(pos).to(getattr(torch, dtype)), new, old,
                                    num_prefix_tokens=2, method=method)
    assert out.dtype == getattr(torch, dtype) and out.shape == (1, 2 + new[0] * new[1], 32)
    out = out.float().numpy()
    np.testing.assert_array_equal(out[:, :2], ref[:, :2])
    if method == "nearest":
        np.testing.assert_array_equal(out, ref)
    elif dtype == "float32":
        assert np.abs(out - ref).max() <= FP32_TOL * np.abs(ref).max()
    else:  # one bf16 ulp (of the larger of the two) beyond the fp32 bound
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(np.abs(ref), np.abs(out)),
                                                  1e-30))) - 7)
        assert (np.abs(out - ref) <= ulp + FP32_TOL * np.abs(ref).max()).all()


@pytest.mark.parametrize("method", [m for m in METHODS if m != "nearest"])
def test_resize_weights_columns_sum_to_one(method):
    """Every output sample's taps (the out-of-range ones dropped) are
    renormalised to 1, up and down; a kernel of one tap is the identity."""
    for n_in, n_out in ((5, 9), (9, 5), (24, 7), (6, 6)):
        w = resize_weights(n_in, n_out, method)
        assert w.shape == (n_in, n_out)
        torch.testing.assert_close(w.sum(0), torch.ones(n_out), rtol=0, atol=2e-6)
    torch.testing.assert_close(resize_weights(6, 6, method), torch.eye(6), rtol=0, atol=1e-6)


def test_cubic_is_keys_not_pytorchs_bicubic():
    """Upsampling a step, ``cubic`` overshoots as Keys' kernel (a = -0.5)
    does, not as ``F.interpolate``'s bicubic (a = -0.75, edges clamped)."""
    import torch.nn.functional as F

    grid = torch.zeros(1, 4, 4, 1)
    grid[:, :, 2:] = 1.0
    pos = torch.cat([torch.zeros(1, 1, 1), grid.reshape(1, 16, 1)], dim=1)
    ours = interpolate_pos_embedding(pos, (8, 8), method="cubic")[0, 1:, 0].reshape(8, 8)
    torch_bicubic = F.interpolate(grid.permute(0, 3, 1, 2), size=(8, 8), mode="bicubic",
                                  align_corners=False)[0, 0]
    assert ours.min() < 0 and (ours - torch_bicubic).abs().max() > 1e-2


def test_unknown_method_raises():
    pos = torch.zeros(1, 17, 8)
    with pytest.raises(ValueError, match="Unknown resize method"):
        interpolate_pos_embedding(pos, (5, 5), method="area")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_in_out_matches_flax(dtype):
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn import ProjectInOut as JaxProjectInOut

    x = np.random.default_rng(0).standard_normal((2, 5, 24)).astype(np.float32)
    jd = None if dtype == "float32" else jnp.bfloat16
    module = JaxProjectInOut(dim_in=24, dim_out=40, dtype=jd)
    fn_jax = lambda h, scale, shift=0.0: jnp.tanh(h) * scale + shift
    variables = module.init(jax.random.PRNGKey(3), jnp.asarray(x), fn_jax, 2.0, shift=0.5)
    variables = jax.tree.map(lambda a: np.asarray(a) + 0.05, variables)  # biases off zero
    ref = np.asarray(module.apply(variables, jnp.asarray(x), fn_jax, 2.0, shift=0.5),
                     np.float32)

    port = ProjectInOut(24, 40, dtype=None if jd is None else torch.bfloat16, device="cpu")
    assert set(port.state_dict()) == {"project_in.kernel", "project_in.bias",
                                      "project_out.kernel", "project_out.bias"}
    port.load_state_dict(from_jax_params(variables), strict=True)
    with torch.inference_mode():
        out = port(torch.from_numpy(x), lambda h, scale, shift=0.0: torch.tanh(h) * scale + shift,
                   2.0, shift=0.5)
    assert out.dtype == (torch.float32 if jd is None else torch.bfloat16)
    assert np.abs(out.float().numpy() - ref).max() <= MODULE_TOL[dtype] * np.abs(ref).max()


@pytest.mark.parametrize("grid,patch,c", [((4, 4), (8, 8), 3), ((2, 3), (4, 2), 5),
                                          ((14, 14), (16, 16), 3)])
def test_unpatchify_is_vit_tpus_and_inverts_patchify(grid, patch, c):
    import jax.numpy as jnp
    from vit_tpu.ops import unpatchify as jax_unpatchify

    x = np.random.default_rng(1).standard_normal(
        (2, grid[0] * grid[1], patch[0] * patch[1] * c)).astype(np.float32)
    out = ops.unpatchify(torch.from_numpy(x), *grid, *patch, c)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jax_unpatchify(jnp.asarray(x), *grid, *patch, c)))
    img = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, grid[0] * patch[0], grid[1] * patch[1], c)).astype(np.float32))
    torch.testing.assert_close(ops.unpatchify(ops.patchify(img, *patch), *grid, *patch, c), img,
                               rtol=0, atol=0)
