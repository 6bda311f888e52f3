"""The port's reference-checkpoint importer (``vit_tpu_torch.utils.importer``)
against ``vit_tpu``'s on the CPU, tree against tree.

Reference trees in the ``vit-flax`` layout are drawn by chip_smoke's
``ref_<family>_tree`` builders (no bias or norm parameter a constant).

- The port's importer equals ``vit_tpu``'s leaf for leaf (``np.array_equal``
  and the dtype) for all 17 families, at both ``scan`` values where the
  function takes one, and at deeper variants that reach the stacked and the
  unstacked branches of each layout.
- PatchMerger's queries: ``_jax_normal`` is ``jax.random.normal`` bit for
  bit (0 ulp over the shapes and keys below), and so are the imported
  queries. LSA's temperature: bit for bit ``vit_tpu``'s at every head width
  up to 1,024.

The builders' trees against ``init``'s leaves are in
``tests/test_torch_importer_shapes.py``; the logits and the planted faults
in ``tests/test_torch_importer_logits.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from vit_tpu_torch.models.presets import REFERENCE_PRESETS
from vit_tpu_torch.utils import importer as port_importer

torch.set_num_threads(2)

FAMILIES = list(cs.REF_FAMILIES)

# Deeper tiny variants: (family, overrides of the registry config); each
# reaches a branch of its layout that the registry config does not.
VARIANTS = {
    **{fam: (fam, {}) for fam in FAMILIES},
    "vit depth 1": ("vit", {"depth": 1}),
    "cait cls_depth 2": ("cait", {"cls_depth": 2, "depth": 1}),
    "parallel_vit 3 branches": ("parallel_vit", {"num_parallel_branches": 3}),
    "pit depth 2": ("pit", {"depth": (2, 1)}),
    "t2t depth 2": ("t2t", {"depth": 2}),
    "twins depth 2": ("twins", {"s3_depth": 2, "s4_depth": 2}),
    "nest repeats 2": ("nest", {"block_repeats": (2, 1)}),
    "scalable_vit depth 3": ("scalable_vit", {"depth": (3, 2)}),
    "cvt depth 2": ("cvt", {"s2_depth": 2}),
    "levit distilled": ("levit", {"depth": 2, "num_distill_classes": 5}),
    "crossformer depth 2": ("crossformer", {"depth": (2, 1)}),
    "region_vit depth 2": ("region_vit", {"depth": (2, 1)}),
}


def tiny_config(fam, **overrides):
    """``vit_tpu``'s registry config of ``fam`` with the importer's flags
    (``cs.ref_config``; RegionViT without the PEG, which the reference
    lacks) and ``overrides``, and its image size."""
    from vit_tpu.models import MODEL_REGISTRY

    _, cfg, size = MODEL_REGISTRY[cs.REF_FAMILIES[fam][0]]
    cfg = {**cfg, **overrides}
    if fam == "region_vit":
        cfg["use_peg"] = False
    return cs.ref_config(fam, cfg), size


def jax_model(fam, cfg, dtype=None):
    from vit_tpu import models as jm

    ctor = REFERENCE_PRESETS[cs.REF_FAMILIES[fam][0]][0]
    return getattr(jm, ctor.__name__)(**cfg, dtype=dtype)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unequal_leaves(tree, ref):
    """The paths at which ``tree`` (the port's import) and ``ref``
    (``vit_tpu``'s) differ: a leaf missing or extra, another dtype, shape or
    value."""
    a, b = flat(tree), flat(ref)
    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], np.asarray(b[k])
        if not isinstance(x, np.ndarray) or x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(k)
    return bad


@pytest.fixture(scope="module")
def tiny_trees():
    """Each variant's config, image size and reference tree, drawn once."""
    cache = {}

    def get(name):
        if name not in cache:
            fam, over = VARIANTS[name]
            cfg, size = tiny_config(fam, **over)
            cache[name] = (fam, cfg, size, cs.REF_FAMILIES[fam][1](cfg, 11))
        return cache[name]

    return get


# every variant with scan=True (the default), and unscanned where the function takes scan
IMPORT_CASES = [(name, True) for name in VARIANTS] + [
    (name, False) for name, (fam, _) in VARIANTS.items() if fam in cs.REF_SCAN]


@pytest.mark.parametrize("name,scan", IMPORT_CASES,
                         ids=[f"{n}-{'scan' if s else 'unscanned'}" for n, s in IMPORT_CASES])
def test_port_import_equals_vit_tpus_leaf_for_leaf(name, scan, tiny_trees):
    from vit_tpu.utils import importer as jax_importer

    fam, cfg, _, tree = tiny_trees(name)
    ours = cs.reference_import(port_importer, fam, tree, cfg, scan=scan)
    assert unequal_leaves(ours, cs.reference_import(jax_importer, fam, tree, cfg, scan=scan)) == []


@pytest.mark.parametrize("name", sorted(n for n in dir(port_importer)
                                         if n.startswith("import_reference_")))
def test_signatures_and_defaults_are_vit_tpus(name):
    """Each importer takes vit_tpu's parameters: names, kinds (keyword-only
    ``scan``) and defaults. The two modules hold the same 17, and the
    port's ``utils`` exports each (a superset of ``vit_tpu.utils``'s four)."""
    import inspect

    from vit_tpu.utils import importer as jax_importer

    import vit_tpu_torch.utils as port_utils

    def params(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    assert params(getattr(port_importer, name)) == params(getattr(jax_importer, name))
    assert getattr(port_utils, name) is getattr(port_importer, name)
    ours = {n for n in dir(port_importer) if n.startswith("import_reference_")}
    assert ours == {n for n in dir(jax_importer) if n.startswith("import_reference_")}
    assert len(ours) == 17


def test_imports_keep_each_leafs_dtype(tiny_trees):
    """A bf16 tree (as JAX would hand one over) imports as bf16 where the
    leaf passes through, equal to ``vit_tpu``'s; the zeros beside a leaf
    take its dtype (``zeros_like``)."""
    import jax.numpy as jnp
    from vit_tpu.utils import importer as jax_importer

    fam, cfg, _, tree = tiny_trees("simple_vit")
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else np.asarray(jnp.asarray(v, jnp.bfloat16))
                      for k, v in t.items()}
    bf16 = walk(tree)
    ours = cs.reference_import(port_importer, fam, bf16, cfg)
    assert unequal_leaves(ours, cs.reference_import(jax_importer, fam, bf16, cfg)) == []
    assert ours["params"]["encoder"]["blocks"]["attn"]["out_bias"].dtype == jnp.bfloat16


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
@pytest.mark.parametrize("shape", [(4, 64), (8, 1024), (3,), (257, 333)])
def test_jax_normal_is_bitwise_jax_random_normal(shape, seed):
    import jax

    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    out = port_importer._jax_normal(seed, shape)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_jax_normal_tails_are_bitwise():
    """A million draws reach both branches of XLA's erf_inv (w >= 5 beyond
    |u| > 0.9966) and both of its log1p."""
    import jax

    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1000, 1000)))
    out = port_importer._jax_normal(3, (1000, 1000))
    assert np.abs(ref).max() > 4
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_lsa_temperature_is_vit_tpus_at_every_width():
    """The one value LSA's temperature takes in the port, on import and at
    init, equals vit_tpu's importer and its unjitted init at every width."""
    import jax.numpy as jnp

    from vit_tpu_torch.core.xla_math import lsa_log_temperature
    from vit_tpu_torch.nn.attention import log_temperature_init

    widths = np.arange(1, 1025)
    ours = np.stack([lsa_log_temperature(d) for d in widths])
    init = np.stack([log_temperature_init(d).numpy() for d in widths])
    ref = np.stack([np.asarray(jnp.log(jnp.asarray(d, jnp.float32) ** -0.5)) for d in widths])
    eager_init = np.stack([np.asarray(jnp.log(d**-0.5)) for d in widths])
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(init.view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(eager_init.view(np.int32), ref.view(np.int32))
