"""chip_smoke's reference-layout trees (``ref_<family>_tree``) against
``vit_tpu``'s models on the CPU: each tree, through ``vit_tpu``'s importer,
has the names, shapes and dtypes of ``jax.eval_shape`` of the ``vit_tpu``
model's ``init``, no leaf missing and none extra. At the tiny configs
(``vit_tpu``'s ``MODEL_REGISTRY``'s, with the flags each importer needs)
the arrays go through; at ``REFERENCE_PRESETS``' widths only shapes do (the
builder draws zero-stride arrays and ``vit_tpu``'s importer runs under
``jax.eval_shape``), so nothing of preset size is allocated. The port's
importer against ``vit_tpu``'s is in ``tests/test_torch_importer.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_importer import FAMILIES, flat, jax_model, tiny_trees  # noqa: F401
from vit_tpu_torch.models.presets import REFERENCE_PRESETS

torch.set_num_threads(2)


def shapes(tree):
    return {k: (tuple(np.shape(v)), np.dtype(v.dtype)) for k, v in flat(tree).items()}


def init_shapes(fam, cfg, size):
    import jax
    import jax.numpy as jnp

    return shapes(jax.eval_shape(jax_model(fam, cfg).init, jax.random.PRNGKey(0),
                                 jnp.zeros((1, size, size, 3), jnp.float32)))



@pytest.mark.parametrize("fam", FAMILIES)
def test_tiny_imports_have_the_leaves_of_init(fam, tiny_trees):
    """In shapes only (``tests/test_torch_importer.py`` holds the values)."""
    import jax
    from vit_tpu.utils import importer as jax_importer

    _, cfg, size, tree = tiny_trees(fam)
    imported = jax.eval_shape(lambda t: cs.reference_import(jax_importer, fam, t, cfg), tree)
    assert shapes(imported) == init_shapes(fam, cfg, size)


class _ShapesOnly(cs._RefInit):
    """``_RefInit`` drawing zero-stride arrays: a preset's tree in shapes."""

    def uniform(self, shape, std):
        return np.broadcast_to(np.float32(0), shape)


@pytest.mark.parametrize("fam", FAMILIES)
def test_preset_imports_have_the_leaves_of_init(fam, monkeypatch):
    import jax
    from vit_tpu.utils import importer as jax_importer

    preset = cs.REF_FAMILIES[fam][0]
    cfg, size = cs.ref_config(fam, REFERENCE_PRESETS[preset][1]), REFERENCE_PRESETS[preset][2]
    monkeypatch.setattr(cs, "_RefInit", _ShapesOnly)
    tree = cs.REF_FAMILIES[fam][1](cfg, 0)
    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), a.dtype), tree)
    imported = jax.eval_shape(lambda t: cs.reference_import(jax_importer, fam, t, cfg), abstract)
    assert shapes(imported) == init_shapes(fam, cfg, size)
