"""The port's trainer against vit_tpu's on the CPU: parameters after AdamW
and LAMB steps against ``vit_tpu.train``, ``accum_steps``, remat and the
Functions' launch and recompute counts under it, schedules, clipping and
optimizers against optax, ``evaluate``, ``init_params`` against flax's init,
checkpoints and resume, dropout, the trainer's CLI, and the import rule (no
JAX under ``vit_tpu_torch``). The ops' and the tiny ViT's gradients are in
``tests/test_torch_train.py``, whose helpers these tests share.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_train import CFG, _images, _jax_vit, _nonzero, _np, _port_vit
from vit_tpu_torch import ops
from vit_tpu_torch import train as tt
from vit_tpu_torch.models import ViT
from vit_tpu_torch.ops import block_attention as tba
from vit_tpu_torch.utils import from_jax_params, init_params
from vit_tpu_torch.utils.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint

tfm = importlib.import_module("vit_tpu_torch.ops.fused_mlp")

torch.set_num_threads(2)


# -- train steps against vit_tpu.train ---------------------------------------------

# Parameters after 1 and 3 updates, max |difference| over all parameters:
# measured 2.05e-6 (AdamW, update 3) and 1.1e-6 (LAMB). Adam-type updates
# divide each gradient value by its own magnitude, so the gradients' fp32
# sum-order noise (relative 1e-6) reaches the parameters at the scale of one
# update (lr = 1e-3), not of the parameters; 4e-6 is twice the largest
# measured. LAMB with norms over each layer's tensor instead of vit_tpu's
# stacked leaves is 8.8e-6 off after one update
# (test_lamb_trust_ratio_pools_the_stacked_layers). fp32 only: in bf16 the
# same normalisation turns bf16 rounding into whole lr's.
STEP_TOL = 4e-6

OPTIMIZERS = {
    "adamw clip warmup-cosine": lambda total: dict(
        learning_rate=tt.warmup_cosine_schedule(1e-3, total, warmup_steps=2),
        name="adamw", grad_clip_norm=0.5),
    "lamb": lambda total: dict(learning_rate=1e-3, name="lamb", grad_clip_norm=None),
}


def _jax_optimizer(spec, total):
    from vit_tpu import train as jtrain

    kw = OPTIMIZERS[spec](total)
    lr = kw.pop("learning_rate")
    if callable(lr):
        lr = jtrain.warmup_cosine_schedule(1e-3, total, warmup_steps=2)
    return jtrain.make_optimizer(lr, **kw)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("spec", list(OPTIMIZERS))
def test_train_steps_match_jax(spec, mode):
    import jax
    import jax.numpy as jnp
    from vit_tpu import train as jtrain

    img, labels = _images(1, b=8)
    total = 4
    jm, v = _jax_vit("fp32", 2, img)
    jopt = _jax_optimizer(spec, total)
    jstate = jtrain.TrainState(v["params"], jopt.init(v["params"]), jnp.zeros((), jnp.int32))
    jstep = jtrain.make_train_step(jm, jopt, remat=True, backend=mode)

    tm = _port_vit("fp32", 2, v)
    opt = tt.make_optimizer(**OPTIMIZERS[spec](total))
    state = tt.create_train_state(tm, opt, init=False)
    step = tt.make_train_step(tm, opt, remat=True)
    x, y = torch.from_numpy(img), torch.from_numpy(labels)
    for n in range(1, 4):
        jstate, jloss = jstep(jstate, jnp.asarray(img), jnp.asarray(labels))
        loss = step(state, x, y)
        assert abs(float(loss) - float(jloss)) <= 1e-5
        if n in (1, 3):
            ref = from_jax_params({"params": jax.device_get(jstate.params)}, tm.jax_stages)
            errs = sorted((float(np.abs(_np(p) - ref[k].numpy()).max()), k)
                          for k, p in tm.named_parameters())
            assert errs[-1][0] <= STEP_TOL, (n, errs[-3:])
    assert state.step == 3 and int(jstate.step) == 3


def test_lamb_trust_ratio_pools_the_stacked_layers(monkeypatch):
    """vit_tpu's LAMB takes its norms over each leaf, and a scanned stack's
    leaf holds every layer: with per-layer norms the first update is off by
    more than STEP_TOL."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import train as jtrain

    img, labels = _images(1, b=8)
    jm, v = _jax_vit("fp32", 2, img)
    jopt = jtrain.make_optimizer(1e-3, name="lamb")
    jstate = jtrain.TrainState(v["params"], jopt.init(v["params"]), jnp.zeros((), jnp.int32))
    jstate, _ = jtrain.make_train_step(jm, jopt)(jstate, jnp.asarray(img), jnp.asarray(labels))
    tm = _port_vit("fp32", 2, v)
    groups = tt.trust_groups(tm)
    assert len(groups) == 4 + 5 + 6 + 2 + 2 and max(len(g) for g in groups) == 2
    monkeypatch.setattr(tt, "trust_groups", lambda m: [[p] for p in m.parameters()])
    opt = tt.make_optimizer(1e-3, name="lamb")
    state = tt.create_train_state(tm, opt, init=False)
    tt.make_train_step(tm, opt)(state, torch.from_numpy(img), torch.from_numpy(labels))
    ref = from_jax_params({"params": jax.device_get(jstate.params)}, tm.jax_stages)
    err = max(float(np.abs(_np(p) - ref[k].numpy()).max()) for k, p in tm.named_parameters())
    assert err > STEP_TOL, err


def test_moe_aux_weight_step_matches_jax():
    """ViT-MoE's load-balance loss in the step (``moe_aux_weight``): the loss
    and the parameters after one AdamW update against vit_tpu's, fp32."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import train as jtrain
    from vit_tpu.models.vit_moe import ViTMoE as JaxViTMoE

    from vit_tpu_torch.models import ViTMoE

    cfg = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2, heads=4,
               mlp_dim=64, dim_head=8, num_experts=4, num_selected=2, moe_every=2)
    img, labels = _images(12, b=4)
    rng = np.random.default_rng(5)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
                        cs.vit_moe_tree(cfg, seed=3))
    jm = JaxViTMoE(**cfg)
    jopt = jtrain.make_optimizer(1e-3)
    jstate = jtrain.TrainState(tree["params"], jopt.init(tree["params"]),
                               jnp.zeros((), jnp.int32))
    jstep = jtrain.make_train_step(jm, jopt, moe_aux_weight=0.5)
    jstate, jloss = jstep(jstate, jnp.asarray(img), jnp.asarray(labels))
    tm = ViTMoE(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(tree, tm.jax_stages), strict=True)
    opt = tt.make_optimizer(1e-3)
    state = tt.create_train_state(tm, opt, init=False)
    loss = tt.make_train_step(tm, opt, moe_aux_weight=0.5)(state, torch.from_numpy(img),
                                                            torch.from_numpy(labels))
    plain = tt.cross_entropy_loss(tm(torch.from_numpy(img)), torch.from_numpy(labels))
    assert abs(float(loss) - float(jloss)) <= 1e-5 and float(loss) != plain.item()
    ref = from_jax_params({"params": jax.device_get(jstate.params)}, tm.jax_stages)
    err = max(float(np.abs(_np(p) - ref[k].numpy()).max()) for k, p in tm.named_parameters())
    assert err <= STEP_TOL, err
    with pytest.raises(ValueError, match="MoE"):
        tt.make_train_step(_tiny_state().model, moe_aux_weight=0.5)


def _tiny_state(seed=0, depth=2, optimizer=None, **extra):
    model = ViT(**CFG, depth=depth, device="cpu", **extra)
    gen = torch.Generator().manual_seed(seed)
    return tt.create_train_state(model, optimizer or tt.make_optimizer(1e-2), gen)


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_accumulated_steps_match_the_full_batch():
    img, labels = (torch.from_numpy(a) for a in _images(2, b=8))
    params = {}
    for accum in (1, 2):
        state = _tiny_state()
        loss = tt.make_train_step(state.model, remat=False, accum_steps=accum)(state, img, labels)
        params[accum] = (float(loss), _params(state.model))
    assert abs(params[1][0] - params[2][0]) <= 1e-6
    for k, a in params[1][1].items():
        # AdamW's first update is ~lr * sign(g): allow a flip at a gradient
        # within rounding of 0 (1e-2 * 1e-8 / 1e-8-scale eps)
        assert (a - params[2][1][k]).abs().max().item() <= 1e-5, k


def test_remat_on_equals_remat_off():
    img, labels = (torch.from_numpy(a) for a in _images(3, b=4))
    out = []
    for remat in (False, True):
        state = _tiny_state(dropout=0.1, emb_dropout=0.1)
        step = tt.make_train_step(state.model, remat=remat)
        losses = [float(step(state, img, labels)) for _ in range(2)]
        out.append((losses, _params(state.model)))
    assert out[0][0] == out[1][0]
    for k, a in out[0][1].items():
        assert torch.equal(a, out[1][1][k]), k


def test_function_launch_counts_under_remat(monkeypatch):
    """The counts chip_smoke's phase 17 requires, rehearsed with the twins in
    the kernels' places: a step at depth D launches each kernel 2 D times
    (the forward and remat's recompute) and recomputes each Function D
    times."""
    calls = {"attention_block": 0, "fused_mlp": 0}

    def counting(name, twin):
        def run(*a, **kw):
            calls[name] += 1
            return twin(*a, **kw)
        return run

    def attn_twin(x, s, b, wq, wo, bo, heads, scale=None, ln_eps=1e-6, true_n=None,
                  block_tokens=None):
        return tba.xla_attention_block(x, s, b, wq, wo, bo, heads, scale, ln_eps, true_n,
                                       block_tokens)

    monkeypatch.setattr(ops, "_use_kernel", lambda x: True)
    monkeypatch.setattr(ops, "fused_attention_block", counting("attention_block", attn_twin))
    monkeypatch.setattr(ops, "fused_mlp", counting("fused_mlp", tfm.reference_mlp))
    state = _tiny_state(depth=3, optimizer=tt.make_optimizer(1e-3, weight_decay=0.0))
    img, labels = (torch.from_numpy(a) for a in _images(4, b=2))
    ops.reset_launch_counts()
    tt.make_train_step(state.model, remat=True)(state, img, labels)
    assert calls == {"attention_block": 6, "fused_mlp": 6}
    assert _nonzero(ops.recompute_counts()) == {"attention_block": 3, "fused_mlp": 3}
    calls.update(attention_block=0, fused_mlp=0)
    ops.reset_launch_counts()
    tt.make_train_step(state.model, remat=False)(state, img, labels)
    assert calls == {"attention_block": 3, "fused_mlp": 3}
    assert _nonzero(ops.recompute_counts()) == {"attention_block": 3, "fused_mlp": 3}
    with torch.inference_mode():
        state.model(img)
    assert _nonzero(ops.recompute_counts()) == {"attention_block": 3, "fused_mlp": 3}


# -- schedules, clipping, optimizers against optax ---------------------------------


@pytest.mark.parametrize("warmup,end", [(0, 0.0), (3, 0.0), (5, 0.1)])
def test_warmup_cosine_matches_optax(warmup, end):
    from vit_tpu import train as jtrain

    ref = jtrain.warmup_cosine_schedule(2e-3, 20, warmup, end)
    ours = tt.warmup_cosine_schedule(2e-3, 20, warmup, end)
    for count in (0, 1, 2, 3, 4, 5, 7, 10, 19, 20, 25):
        assert abs(ours(count) - float(ref(count))) <= 2e-3 * 1e-6, count


def test_lr_schedule_is_read_at_the_update_count():
    """optax evaluates the schedule at the update count: update k uses
    schedule(k), the first schedule(0)."""
    seen = []
    opt = tt.make_optimizer(lambda c: seen.append(c) or 0.0)
    state = _tiny_state(optimizer=opt)
    img, labels = (torch.from_numpy(a) for a in _images(5, b=2))
    step = tt.make_train_step(state.model, opt, remat=False)
    lrs = []
    for _ in range(3):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        step(state, img, labels)
    assert seen[:4] == [0, 1, 2, 3] and lrs == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 1e6])
def test_clip_by_global_norm_matches_optax(max_norm):
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(6)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 5), (7,), (2, 3, 2))]
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = tt.clip_by_global_norm(ours, max_norm)
    assert abs(float(norm) - float(np.sqrt(sum((g**2).sum() for g in grads)))) <= 1e-5
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_named_optimizers_refuse_muon_and_unknown_names():
    """muon is ported (tests/test_torch_muon.py): it builds, one group a
    leaf of vit_tpu's tree; an unknown name still raises."""
    opt, _ = tt.make_optimizer(name="muon").build(_tiny_state().model)
    assert isinstance(opt, tt.Muon)
    with pytest.raises(ValueError):
        tt.make_optimizer(name="sgd")


def test_training_refuses_what_is_not_ported():
    """The small-dataset ViT, the last family whose training was not ported,
    now trains, with or without ``qat`` (QAT itself is ported:
    tests/test_torch_quant_weights.py); a module outside the zoo still
    raises, with or without it."""
    from vit_tpu_torch.models import ViTSmallDatasets

    for qat in (False, True):
        assert callable(tt.make_train_step(ViTSmallDatasets(**CFG, depth=1, device="cpu"),
                                           qat=qat))
        with pytest.raises(NotImplementedError, match="Linear is not ported"):
            tt.make_train_step(torch.nn.Linear(4, 4), qat=qat)


# -- eval --------------------------------------------------------------------------


def test_evaluate_matches_jax():
    import jax.numpy as jnp
    from vit_tpu import train as jtrain

    img, labels = _images(7, b=8)
    jm, v = _jax_vit("fp32", 2, img)
    batches = [(img[:4], labels[:4]), (img[4:], labels[4:])]
    ref = jtrain.evaluate(jm, v, [(jnp.asarray(a), jnp.asarray(b)) for a, b in batches])
    tm = _port_vit("fp32", 2, v)
    out = tt.evaluate(tm, [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in batches])
    assert out["samples"] == ref["samples"] == 8
    assert abs(out["loss"] - ref["loss"]) <= 1e-5 and out["top1"] == ref["top1"]


# -- init_params against flax's init -------------------------------------------------


def test_init_params_matches_flax_init_in_shape_and_distribution():
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import ViT as JaxViT

    cfg = dict(CFG, dim=256, heads=4, dim_head=64, mlp_dim=512, depth=2)
    img = np.zeros((1, 32, 32, 3), np.float32)
    jv = jax.device_get(jax.jit(JaxViT(**cfg).init)({"params": jax.random.PRNGKey(0)},
                                                      jnp.asarray(img)))
    ref = from_jax_params(jv)
    tm = init_params(ViT(**cfg, device="cpu"), torch.Generator().manual_seed(0))
    ours = dict(tm.named_parameters())
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        p = ours[k].detach()
        assert p.shape == r.shape, k
        if r.std() == 0:
            assert torch.equal(p, r), k
            continue
        lim = float(r.abs().max())
        fan_std = (p.shape[0] ** -0.5) if p.dim() == 2 else 0.02 * 0.87962566
        # truncated at 2 std of the untruncated normal; std within sampling error
        assert float(p.abs().max()) <= 2 * fan_std / 0.87962566 * (1 + 1e-6), k
        assert abs(float(p.std()) - float(r.std())) <= 0.1 * float(r.std()), k
        assert abs(float(p.std()) - fan_std) <= 0.1 * fan_std, k
        assert abs(float(p.mean())) <= 0.1 * fan_std, k
        assert float(p.abs().max()) >= 0.8 * lim, k


def test_init_params_refuses_unknown_parameters():
    """The small-dataset ViT initializes now (its LSA ``log_temperature``
    the constant of its init); a parameter of another name (``nn.Linear``'s
    ``weight``) still raises."""
    from vit_tpu_torch.models import ViTSmallDatasets
    from vit_tpu_torch.nn.attention import log_temperature_init

    tm = init_params(ViTSmallDatasets(**CFG, depth=1, device="cpu"), torch.Generator())
    assert torch.equal(tm.encoder.blocks[0].attn.log_temperature.detach(),
                       log_temperature_init(CFG["dim_head"]))
    with pytest.raises(NotImplementedError, match="weight .* no vit_tpu initializer"):
        init_params(torch.nn.Linear(4, 4), torch.Generator())


# -- checkpoints ---------------------------------------------------------------------


def test_checkpoint_round_trip(tmp_path):
    state = _tiny_state(seed=1, optimizer=tt.make_optimizer(1e-3, name="lamb"))
    img, labels = (torch.from_numpy(a) for a in _images(8, b=4))
    tt.make_train_step(state.model)(state, img, labels)
    save_checkpoint(tmp_path / "c.pt", state)
    other = _tiny_state(seed=2, optimizer=tt.make_optimizer(1e-3, name="lamb"))
    restore_checkpoint(tmp_path / "c.pt", other)
    assert other.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, other.model.state_dict()[k]), k
    assert torch.equal(state.generator.get_state(), other.generator.get_state())
    for a, b in zip(state.optimizer.state.values(), other.optimizer.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


@pytest.mark.parametrize("name", ["adamw", "lamb"])
def test_resumed_run_equals_the_uninterrupted_one(tmp_path, name):
    img, labels = (torch.from_numpy(a) for a in _images(9, b=4))
    opt = tt.make_optimizer(tt.warmup_cosine_schedule(1e-3, 6, 2), name=name, grad_clip_norm=1.0)
    full = _tiny_state(seed=3, optimizer=opt, dropout=0.1, emb_dropout=0.1)
    step = tt.make_train_step(full.model, opt)
    mgr = CheckpointManager(tmp_path / "run", max_to_keep=2)
    for _ in range(4):
        step(full, img, labels)
        if full.step == 2:
            mgr.save(full.step, full)
    mgr.wait()  # the save is asynchronous: on disk once wait() returns
    resumed = _tiny_state(seed=4, optimizer=opt, dropout=0.1, emb_dropout=0.1)
    CheckpointManager(tmp_path / "run").restore(resumed)
    assert resumed.step == 2
    rstep = tt.make_train_step(resumed.model, opt)
    for _ in range(2):
        rstep(resumed, img, labels)
    for k, v in full.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    assert resumed.scheduler.get_last_lr() == full.scheduler.get_last_lr()


def test_checkpoint_manager_keeps_the_newest_and_the_best(tmp_path):
    state = _tiny_state()
    mgr = CheckpointManager(tmp_path / "a", max_to_keep=2, save_interval_steps=2)
    assert [mgr.save(s, state, metrics={"loss": 1.0 / s}) for s in range(1, 8)] == [
        False, True, False, True, False, True, False]
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    assert not mgr.save(6, state, force=True) and mgr.save(7, state, force=True)
    assert mgr.all_steps() == [6, 7] and mgr.best_step() is None
    best = CheckpointManager(tmp_path / "b", max_to_keep=2, best_fn=lambda m: m["acc"])
    for s, acc in ((1, 0.5), (2, 0.9), (3, 0.1), (4, 0.7)):
        best.save(s, state, metrics={"acc": acc})
    assert best.all_steps() == [2, 4] and best.best_step() == 2
    with CheckpointManager(tmp_path / "c") as empty:
        empty.wait()
        with pytest.raises(FileNotFoundError):
            empty.restore(state)


# -- dropout ---------------------------------------------------------------------------


def test_train_without_dropout_equals_eval():
    img, _ = _images(10)
    state = _tiny_state(seed=5)
    x = torch.from_numpy(img)
    with torch.no_grad():
        assert torch.equal(state.model(x), state.model(x, train=True, generator=state.generator))


def test_dropout_takes_vit_tpus_routes_and_rate(monkeypatch):
    """With dropout, training materializes attention and runs the MLP on its
    plain path (no fused op is called), as vit_tpu does; the drop rate
    holds; eval is untouched by the rate."""
    from vit_tpu_torch.nn import attention as tattn

    calls = []
    for name in ("attention_block", "mlp", "qkv_attention"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n)
                            or _o(*a, **k))
    rates = []
    orig_dropout = tattn.dropout

    def probe(x, rate, generator):
        y = orig_dropout(x, rate, generator)
        if rate:
            rates.append(float((y == 0).float().mean()))
        return y

    import vit_tpu_torch.models.vit as tvit
    import vit_tpu_torch.nn.blocks as tblocks

    for mod in (tattn, tblocks, tvit):
        monkeypatch.setattr(mod, "dropout", probe)
    img, _ = _images(11, b=8)
    x = torch.from_numpy(img)
    for depth in (1, 2):
        state = _tiny_state(depth=depth, dropout=0.25, emb_dropout=0.25)
        state.model(x, train=True, generator=state.generator)
        assert calls == [], calls
        assert len(rates) == 1 + 4 * depth and all(abs(r - 0.25) <= 0.03 for r in rates), rates
        rates.clear()
        with torch.no_grad():
            state.model(x)
        assert calls and not rates
        calls.clear()


# -- the trainer's CLI ---------------------------------------------------------------------


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    run = str(tmp_path / "run")
    base = ["--device", "cpu", "--batch", "4", "--classes", "10", "--image-size", "32"]
    assert tt.main(base + ["--steps", "3", "--checkpoint-dir", run, "--save-every", "2"]) == 0
    assert CheckpointManager(run).all_steps() == [2, 3]
    assert tt.main(base + ["--steps", "2", "--resume", run, "--checkpoint-dir", run,
                           "--optimizer", "adamw", "--augment", "--ema", "0.99",
                           "--accum", "2"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 3" in out and "step 5: loss" in out
    assert CheckpointManager(run).all_steps() == [2, 3, 5]
    with pytest.raises(NotImplementedError, match="item 8"):
        tt.main(base + ["--steps", "1", "--dp", "2"])
    assert tt.main(base + ["--steps", "1", "--optimizer", "muon"]) == 0
    with pytest.raises(ValueError, match="0 samples"):  # --data reads a folder of JPEGs
        tt.main(base + ["--steps", "1", "--data", str(tmp_path / "no_jpegs")])


def test_cli_without_a_card_exits_1(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tt.main(["--steps", "1"]) == 1


# -- imports ---------------------------------------------------------------------------

JAX_PACKAGES = ("jax", "jaxlib", "flax", "optax", "orbax", "vit_tpu")


def test_training_imports_nothing_of_jax():
    """The port's sources and chip_smoke.py import neither JAX, its
    libraries, nor the JAX package, not even inside a function; importing the
    training modules loads none of them."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(cs.__file__).resolve().parent
    sources = [p for p in (repo / "vit_tpu_torch").rglob("*.py")
               if "_build" not in p.relative_to(repo).parts] + [repo / "chip_smoke.py"]
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in JAX_PACKAGES, (path, line)
    code = ("import sys; import vit_tpu_torch.train, vit_tpu_torch.augment, "
            "vit_tpu_torch.utils.checkpoint, vit_tpu_torch.utils.init, chip_smoke; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {JAX_PACKAGES!r}]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120)
