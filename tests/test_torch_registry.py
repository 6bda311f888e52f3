"""The port's front door against vit_tpu's on the CPU: ``MODEL_REGISTRY``,
``REFERENCE_PRESETS`` and ``create``; chip_smoke's preset constants held to
the port's presets; the ``python -m vit_tpu_torch`` CLI (``list``, ``smoke``
of every family on the CPU twins, ``version``, and no carrying on on the CPU
without ``--device cpu``); ``utils.pos_embed`` and ``nn.Identity``.
"""

import inspect
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from vit_tpu_torch.__main__ import main
from vit_tpu_torch.models import (
    MODEL_REGISTRY,
    REFERENCE_PRESETS,
    TRAINING_ONLY_DROPPED,
    ViT,
    create,
)
from vit_tpu_torch.nn import Identity
from vit_tpu_torch.utils import adapt_vit_resolution, from_jax_params, interpolate_pos_embedding

torch.set_num_threads(2)

FAMILIES = sorted(MODEL_REGISTRY)
# the training-only keys of vit_tpu's configs (dropout, stochastic depth)
TRAINING_ONLY = {"dropout", "emb_dropout", "layer_dropout"}


def _jax_tables():
    from vit_tpu.models import MODEL_REGISTRY as jax_registry
    from vit_tpu.models import REFERENCE_PRESETS as jax_presets

    return {"registry": (jax_registry, MODEL_REGISTRY), "presets": (jax_presets, REFERENCE_PRESETS)}


def _as_kwargs(v):
    """A config value as plain data: an injected flax ``Transformer`` as the
    fields it was given (every field without a default, and those set)."""
    if hasattr(v, "__dataclass_fields__") and hasattr(v, "parent"):
        import dataclasses

        return {f.name: getattr(v, f.name) for f in dataclasses.fields(v)
                if f.name not in ("parent", "name") and (
                    f.default is dataclasses.MISSING or getattr(v, f.name) != f.default)}
    return v


@pytest.mark.parametrize("table", ["registry", "presets"])
def test_tables_are_vit_tpus_less_the_dropped_keys(table):
    jax_table, port_table = _jax_tables()[table]
    assert sorted(port_table) == sorted(jax_table) and len(port_table) == 18
    for name, (jax_cls, jax_cfg, jax_size) in jax_table.items():
        cls, cfg, size = port_table[name]
        dropped = TRAINING_ONLY_DROPPED.get(name, ())
        assert cls.__name__ == jax_cls.__name__ and size == jax_size, name
        assert cfg == {k: _as_kwargs(v) for k, v in jax_cfg.items() if k not in dropped}, name
        params = inspect.signature(cls).parameters
        assert all(k in TRAINING_ONLY and k not in params for k in dropped), name
        assert all(k in params for k in cfg), name


def test_efficient_encoder_is_the_flax_transformers_fields():
    import dataclasses

    from vit_tpu.models import MODEL_REGISTRY as jax_registry
    from vit_tpu.models import REFERENCE_PRESETS as jax_presets

    for jax_table, port_table in ((jax_registry, MODEL_REGISTRY), (jax_presets, REFERENCE_PRESETS)):
        enc = jax_table["efficient"][1]["transformer"]
        fields = {f.name: getattr(enc, f.name) for f in dataclasses.fields(enc)}
        port = port_table["efficient"][1]["transformer"]
        assert type(enc).__name__ == "Transformer"
        assert all(fields[k] == v for k, v in port.items())
        # the rest of the flax encoder's fields are the port Transformer's defaults
        rest = {k: v for k, v in fields.items() if k not in port and k not in ("parent", "name")}
        from vit_tpu_torch.nn import Transformer

        defaults = {k: p.default for k, p in inspect.signature(Transformer).parameters.items()}
        assert all(defaults.get(k, v) == v for k, v in rest.items()
                   if k not in ("dropout", "dtype", "scan_unroll")), rest
    model = MODEL_REGISTRY["efficient"][0](**MODEL_REGISTRY["efficient"][1], device="cpu")
    assert model.transformer.jax_stages == {"blocks": 2}


def test_create_applies_overrides():
    model, size = create("vit", dim=64, depth=1, heads=2, dim_head=32, mlp_dim=128,
                         num_classes=10, dtype=torch.bfloat16, device="cpu")
    assert size == 256 and isinstance(model, ViT)
    assert model.config["patch_size"] == 32 and model.config["dim"] == 64
    assert model.config["dtype"] == torch.bfloat16 and tuple(model.head.kernel.shape) == (64, 10)
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(KeyError, match="unknown preset"):
        create("vit_moe")


def test_create_builds_on_the_card_by_default():
    small = dict(dim=64, depth=1, heads=2, dim_head=32, mlp_dim=128, num_classes=10)
    if torch.cuda.is_available():
        assert next(create("vit", **small)[0].parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            create("vit", **small)


# chip_smoke's constant -> the preset it serves; each equals the port's preset
# once the constructors' defaults fill both, less the training-only keys
# (chip_smoke leaves them out: the port ignores or does not take them).
CHIP_SMOKE_PRESETS = {"CAIT": "cait", "DEEPVIT": "deepvit", "TWINS": "twins_svt", "T2T": "t2t",
                      "PIT": "pit", "SIMPLE_VIT": "simple_vit", "PARALLEL_VIT": "parallel_vit",
                      "EFFICIENT": "efficient", "CROSS_VIT": "cross_vit",
                      "PATCH_MERGER": "patch_merger_vit", "SMALL_DATASETS": "vit_small_datasets",
                      "CROSSFORMER": "crossformer", "NEST": "nest",
                      "SCALABLE_VIT": "scalable_vit", "REGION_VIT": "region_vit", "CVT": "cvt",
                      "LEVIT": "levit"}
# chip_smoke's family names where they are not the preset's
SMOKE_NAME = {"twins_svt": "twins"}


def _resolved(ctor, kwargs):
    defaults = {k: p.default for k, p in inspect.signature(ctor).parameters.items()
                if p.default is not inspect.Parameter.empty}
    return {k: v for k, v in {**defaults, **kwargs}.items() if k not in TRAINING_ONLY}


@pytest.mark.parametrize("const", list(CHIP_SMOKE_PRESETS))
def test_chip_smoke_constants_are_the_presets(const):
    name = CHIP_SMOKE_PRESETS[const]
    ctor, cfg, size = REFERENCE_PRESETS[name]
    assert _resolved(ctor, getattr(chip_smoke, const)) == _resolved(ctor, cfg)
    assert chip_smoke.IMAGE_SIZE[SMOKE_NAME.get(name, name)] == size


@pytest.mark.parametrize("presets", [False, True])
def test_list_names_every_family(presets, capsys):
    assert main(["list", "--presets"] if presets else ["list"]) == 0
    names = [line.split()[0] for line in capsys.readouterr().out.splitlines()[:18]]
    assert names == FAMILIES


@pytest.mark.parametrize("family", FAMILIES)
def test_smoke_runs_each_family_on_the_cpu(family, capsys):
    assert main(["smoke", family, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(family) and out.rstrip().endswith("ok") and "(1, 10)" in out


def test_smoke_rejects_an_unknown_family(capsys):
    assert main(["smoke", "vit_moe", "--device", "cpu"]) == 2
    assert "unknown family" in capsys.readouterr().err


def test_smoke_without_a_card_stops_and_names_it(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert main(["smoke", "vit"]) == 1
    captured = capsys.readouterr()
    assert "NVIDIA card" in captured.err and "--device cpu" in captured.err
    assert captured.out == ""  # nothing ran


def test_version_prints(capsys):
    assert main(["version"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out and "device" in out


def test_module_runs_as_a_program():
    out = subprocess.run([sys.executable, "-m", "vit_tpu_torch", "list"], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert [line.split()[0] for line in out.splitlines()[:18]] == FAMILIES


@pytest.mark.parametrize("grids", [((4, 4), (6, 6)), ((8, 8), (4, 4)), ((4, 4), (4, 4))],
                         ids=["up 4 to 6", "down 8 to 4", "same grid"])
def test_interpolate_pos_embedding_matches_jax(grids):
    import jax.numpy as jnp
    from vit_tpu.utils import interpolate_pos_embedding as jax_interpolate

    old, new = grids
    pos = np.random.default_rng(3).standard_normal((1, 1 + old[0] * old[1], 24)).astype(np.float32)
    for method in ("bilinear", "cubic"):  # cubic: Keys' kernel, a = -0.5, as jax.image's
        ref = np.asarray(jax_interpolate(jnp.asarray(pos), new, method=method))
        out = interpolate_pos_embedding(torch.from_numpy(pos), new, method=method).numpy()
        assert out.shape == ref.shape == (1, 1 + new[0] * new[1], 24)
        if old == new:
            np.testing.assert_array_equal(out, ref)
            np.testing.assert_array_equal(out, pos)
        else:
            np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="Unknown resize method"):
        interpolate_pos_embedding(torch.from_numpy(pos), new, method="bicubic_torch")


def test_adapt_vit_resolution_matches_jax():
    """tests/test_model_behaviors.py's transfer (a ViT at 64 px run at 96 px)
    on the port's state dict, against vit_tpu's adapted model."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import ViT as JaxViT
    from vit_tpu.utils import adapt_vit_resolution as jax_adapt

    cfg = dict(patch_size=16, num_classes=10, dim=32, depth=1, heads=2, mlp_dim=64, dim_head=16)
    img64 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v64 = jax.tree.map(np.asarray, jax.jit(JaxViT(image_size=64, **cfg).init)(
        jax.random.PRNGKey(1), img64))
    p96 = jax_adapt(v64["params"], image_size=96, patch_size=16)
    img96 = np.random.default_rng(2).standard_normal((2, 96, 96, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JaxViT(image_size=96, **cfg).apply)({"params": p96},
                                                                  jnp.asarray(img96)))

    state = from_jax_params(v64, ViT(image_size=64, **cfg, device="cpu").jax_stages)
    state96 = adapt_vit_resolution(state, image_size=96, patch_size=16)
    assert tuple(state96["pos_embedding"].shape) == (1, 1 + 36, 32)
    model = ViT(image_size=96, **cfg, device="cpu")
    model.load_state_dict(state96, strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(img96)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_identity_passes_its_input_through():
    x = torch.randn(2, 3)
    assert Identity()(x, 1, key="ignored") is x
