"""The muon optimizer (``vit_tpu_torch.train.Muon``) against optax 0.2.6's
``contrib.muon`` as ``vit_tpu.train.make_optimizer`` builds it: the
Newton-Schulz orthogonalization, the leaf labels of ``vit_tpu``'s tree (a
scanned stack's leaves one rank up), one and three updates of the tiny CaiT
and DeepViT against ``vit_tpu.train``'s step, a planted mislabelling, and a
checkpoint's save and resume of its state.
"""

import numpy as np
import pytest
import torch

from test_torch_train_heads import MODELS, check_steps
from vit_tpu_torch import train as tt
from vit_tpu_torch.models import ViT
from vit_tpu_torch.utils import from_jax_params, init_params
from vit_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)


def test_constants_are_optax_defaults():
    """``NS_COEFFS``, ``NS_STEPS``, ``MUON_BETA`` and ``MUON_EPS`` are the
    defaults of optax's ``contrib.muon``, which ``vit_tpu`` leaves as they
    are."""
    import inspect

    from optax import contrib

    want = {k: v.default for k, v in inspect.signature(contrib.muon).parameters.items()}
    assert tt.NS_COEFFS == want["ns_coeffs"] and tt.NS_STEPS == want["ns_steps"]
    assert tt.MUON_BETA == want["beta"] and tt.MUON_EPS == want["eps"]


@pytest.mark.parametrize("shape", [(24, 40), (40, 24), (32, 32)])
def test_orthogonalize_matches_optax(shape):
    """``orthogonalize`` against optax's ``orthogonalize_via_newton_schulz``
    (its coefficients, 5 steps, eps 1e-8) on a wide, a tall and a square
    fp32 matrix: within 1e-5 of the largest value."""
    import jax.numpy as jnp
    from optax.contrib import _muon

    x = np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32)
    ref = np.asarray(_muon.orthogonalize_via_newton_schulz(
        jnp.asarray(x), jnp.asarray((3.4445, -4.7750, 2.0315)), 5, 1e-8))
    out = tt.orthogonalize(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def _optax_labels(model_cls, cfg):
    """Port parameter name -> optax's label of its ``vit_tpu`` leaf
    (``muon`` where the leaf has rank 2), through ``from_jax_params`` of a
    tree of label-valued leaves (1 muon, 0 adam)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import models as jm

    jmodel = getattr(jm, model_cls.__name__)(**cfg)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    tm = model_cls(**cfg, device="cpu")
    tree = jax.tree.map(lambda a: np.full(a.shape, float(len(a.shape) == 2), np.float32), shapes)
    return tm, {k: "muon" if bool(v.flatten()[0]) else "adam"
                for k, v in from_jax_params(tree, tm.jax_stages).items()}


def _port_labels(model):
    opt, _ = tt.make_optimizer(1e-3, name="muon").build(model)
    names = {id(p): k for k, p in model.named_parameters()}
    return {names[id(p)]: "muon" if g["muon"] else "adam" for g in opt.param_groups
            for p in g["params"]}


def _own_ranks(model):
    """The planted fault: each parameter a leaf of its own rank, as a port
    that ignored ``vit_tpu``'s stacking would label it (a stacked layer's
    kernel given muon, its stacked biases Adam)."""
    return [(p.dim(), [p]) for p in model.parameters()]


LABEL_MODELS = {"cait (stack of 2, class layer of 1)": MODELS["cait"],
                "deepvit (stack of 2)": MODELS["deepvit"],
                "vit (depth 1)": (ViT, dict(image_size=32, patch_size=8, num_classes=10, dim=64,
                                            depth=1, heads=4, mlp_dim=128, dim_head=16))}


@pytest.mark.parametrize("case", list(LABEL_MODELS))
def test_leaf_labels_are_optax_partition(case, monkeypatch):
    """Every port parameter takes the label optax gives its ``vit_tpu``
    leaf: a stacked ``[L, D]`` bias, LayerNorm or LayerScale muon, a stacked
    ``[L, D, F]`` kernel Adam, a depth-1 stack's kernels and ``[H, H]`` head
    mixes muon, the patch embedding's and head's kernels muon. A planted
    fault, each parameter labelled by its own rank (``_own_ranks``), labels
    some leaf of a stacked model differently."""
    tm, ref = _optax_labels(*LABEL_MODELS[case])
    ours = _port_labels(tm)
    assert ours == ref
    assert "muon" in ours.values() and "adam" in ours.values()
    monkeypatch.setattr(tt, "leaf_groups", _own_ranks)
    bad = _port_labels(tm)
    stacked = not case.startswith("vit ")
    assert (bad != ref) == stacked


@pytest.mark.parametrize("model", ["cait", "deepvit"])
def test_muon_steps_match_jax(model):
    """1 and 3 muon updates of the tiny CaiT (its patch stage scanned, its
    class stage not) and DeepViT against ``vit_tpu.train`` (optax's muon,
    clip 0.5, weight decay 0.05 on both partitions), within
    tests/test_torch_train_heads.py's step rule (``check_steps``)."""
    check_steps(model, "muon")


def test_a_stacked_leaf_given_muon_fails_the_bound(monkeypatch):
    """The planted mislabelling moves DeepViT's parameters past the step
    rule within three updates."""
    monkeypatch.setattr(tt, "leaf_groups", _own_ranks)
    with pytest.raises(AssertionError):
        check_steps("deepvit", "muon")


def test_muon_resumes_from_a_checkpoint_as_the_uninterrupted_run(tmp_path):
    """Four muon updates of the tiny CaiT (stochastic depth on, a schedule)
    equal two, a ``CheckpointManager`` save and restore into a fresh state,
    and two more, bit for bit, with the momenta and counts restored."""
    cls, cfg = MODELS["cait"]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 32, 32, 3)).astype(
        np.float32))
    y = torch.arange(4)
    opt = tt.make_optimizer(tt.warmup_cosine_schedule(1e-3, 6, 0), name="muon",
                            grad_clip_norm=1.0)

    def fresh(seed):
        model = init_params(cls(**cfg, device="cpu"), torch.Generator().manual_seed(seed))
        return tt.create_train_state(model, opt, torch.Generator().manual_seed(seed), init=False)

    full = fresh(1)
    step = tt.make_train_step(full.model, opt)
    mgr = CheckpointManager(tmp_path / "run", max_to_keep=2)
    for _ in range(4):
        step(full, x, y)
        if full.step == 2:
            mgr.save(full.step, full)
    mgr.wait()
    resumed = fresh(2)
    CheckpointManager(tmp_path / "run").restore(resumed)
    assert resumed.step == 2
    muon_states = [s for s in resumed.optimizer.state.values() if "nu" not in s]
    assert muon_states and all(s["step"] == 2 for s in resumed.optimizer.state.values())
    rstep = tt.make_train_step(resumed.model, opt)
    for _ in range(2):
        rstep(resumed, x, y)
    for k, v in full.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k


@pytest.mark.cuda
def test_muon_on_the_card_matches_the_cpu():
    """Three muon updates on the card, with TF32 off as chip_smoke runs
    them, equal the CPU's within 4e-6 on every value: the tiny CaiT's
    parameters (both labels, a stacked leaf among them), the same gradients
    drawn from a seed on both sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cls, cfg = MODELS["cait"]
    models = [init_params(cls(**cfg, device="cpu"), torch.Generator().manual_seed(0))
              for _ in range(2)]
    models[1].to("cuda")
    opts = [tt.make_optimizer(1e-3, name="muon").build(m)[0] for m in models]
    pairs = list(zip(models[0].parameters(), models[1].parameters()))
    rng = np.random.default_rng(0)
    for _ in range(3):
        for p, q in pairs:
            p.grad = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            q.grad = p.grad.cuda()
        for opt in opts:
            opt.step()
    for (name, p), q in zip(models[0].named_parameters(), models[1].parameters()):
        assert (p.detach() - q.detach().cpu()).abs().max() <= 4e-6, name
