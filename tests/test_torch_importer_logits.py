"""Imported reference checkpoints run: for each of the 17 families, the
port's fp32 model on the CPU, loaded from the port's import of a
``chip_smoke.ref_<family>_tree``, against ``vit_tpu``'s ``apply`` on
``vit_tpu``'s import of the same tree, in vit_tpu's ``xla`` mode (the
families' own test files hold both of its CPU modes). CvT and LeViT run on
their imported running statistics (``train=False`` on both sides).

Bound: the families' fp32 bound, 1e-4 on max |logit difference| (LeViT's
norm-free stack: max(1e-4, 2e-5 x max |logit|)).

Planted faults, each of which must fail the leaf-for-leaf comparison with
``vit_tpu``'s import or the logit bound: a FeedForward's ``Dense_0`` and
``Dense_1`` swapped; the PreNorm index parity off by one (the attention
norm read from ``PreNorm_{2i+1}``, the MLP's from ``PreNorm_{2i}``);
LeViT's position table not multiplied by ``sqrt(dim_key)``; ScalableViT
imported into a model without ``reference_block_order``; PatchMerger's
queries drawn from key 1.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_importer import jax_model, tiny_config, unequal_leaves
from vit_tpu_torch.core.utils import cast_tuple
from vit_tpu_torch.models.presets import REFERENCE_PRESETS
from vit_tpu_torch.utils import from_jax_params
from vit_tpu_torch.utils import importer as port_importer

torch.set_num_threads(2)

TOL_FP32 = 1e-4
CASES = {**{fam: (fam, {}) for fam in cs.REF_FAMILIES},
         "levit distilled": ("levit", {"depth": 2, "num_distill_classes": 5})}


def tol(fam, ref):
    return max(TOL_FP32, 2e-5 * float(np.abs(ref).max())) if fam == "levit" else TOL_FP32


def _logits(out):
    out = out if isinstance(out, tuple) else (out,)
    return np.concatenate([np.asarray(o, np.float32) for o in out], axis=-1)


def port_logits(fam, cfg, imported, img):
    ctor = REFERENCE_PRESETS[cs.REF_FAMILIES[fam][0]][0]
    model = ctor(**cfg, device="cpu").eval()
    model.load_state_dict(from_jax_params(imported, model.jax_stages), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(img))
    return _logits(tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy())


@pytest.fixture(scope="module")
def reference():
    """Each case's config, reference tree, input and ``vit_tpu``'s logits
    on its own import, computed once."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.utils import importer as jax_importer

    cache = {}

    def get(name):
        if name not in cache:
            fam, over = CASES[name]
            cfg, size = tiny_config(fam, **over)
            tree = cs.REF_FAMILIES[fam][1](cfg, 21)
            img = np.random.default_rng(5).standard_normal((2, size, size, 3)).astype(np.float32)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("VIT_TPU_BACKEND", "xla")
                out = jax.jit(jax_model(fam, cfg).apply)(
                    cs.reference_import(jax_importer, fam, tree, cfg), jnp.asarray(img))
            cache[name] = (fam, cfg, tree, img, _logits(out))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_imported_logits_match_vit_tpus(name, reference):
    fam, cfg, tree, img, ref = reference(name)
    out = port_logits(fam, cfg, cs.reference_import(port_importer, fam, tree, cfg), img)
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = float(np.abs(out - ref).max())
    assert err <= tol(fam, ref), err


class _ParityOff(dict):
    """A reference Transformer read with the PreNorm index parity off by
    one: ``PreNorm_{k}`` gives ``PreNorm_{k ^ 1}``."""

    def __getitem__(self, key):
        if key.startswith("PreNorm_"):
            key = f"PreNorm_{int(key[len('PreNorm_'):]) ^ 1}"
        return dict.__getitem__(self, key)


def _dense_swapped(mp):
    ff = port_importer._ff
    mp.setattr(port_importer, "_ff", lambda f, norm, ln_bias=None: ff(
        {"Dense_0": f["Dense_1"], "Dense_1": f["Dense_0"]}, norm, ln_bias))


def _draw_from_key_1(mp):
    draw = port_importer._jax_normal
    mp.setattr(port_importer, "_jax_normal", lambda seed, shape: draw(1, shape))


# fault -> (family, how the port's import is planted, model overrides)
FAULTS = {
    "Dense_0 and Dense_1 swapped": ("vit", _dense_swapped, {}),
    "PreNorm index parity off by one": ("vit", None, {}),
    "LeViT's sqrt(dim_key) left out": ("levit", None, {}),
    "ScalableViT without reference_block_order": ("scalable_vit", None,
                                                  {"reference_block_order": False}),
    "PatchMerger draw from key 1": ("patch_merger", _draw_from_key_1, {}),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_import_faults_fail(fault, reference, monkeypatch):
    from vit_tpu.utils import importer as jax_importer

    fam, plant, model_over = FAULTS[fault]
    _, cfg, tree, img, ref = reference(fam)
    if plant is not None:
        plant(monkeypatch)
    if fault.startswith("PreNorm"):
        tree = {"params": {**tree["params"],
                           "Transformer_0": _ParityOff(tree["params"]["Transformer_0"])}}
    if fault.startswith("LeViT"):
        ours = port_importer.import_reference_levit_params(
            tree, cfg["stages"], cast_tuple(cfg["depth"], cfg["stages"]), dim_key=1)
    else:
        ours = cs.reference_import(port_importer, fam, tree, cfg)
    tree_bad = unequal_leaves(ours, cs.reference_import(jax_importer, fam, reference(fam)[2], cfg))
    try:
        out = port_logits(fam, {**cfg, **model_over}, ours, img)
        err = float(np.abs(out - ref).max())
    except (RuntimeError, ValueError):  # a wrong shape does not load
        err = float("inf")
    assert tree_bad or err > tol(fam, ref), (tree_bad, err)
