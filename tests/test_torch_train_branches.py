"""Training EfficientViT, CrossViT, ParallelViT and PatchMerger-ViT: the tiny
models' loss and gradients against ``jax.value_and_grad`` of vit_tpu's, AdamW
steps against ``vit_tpu.train.make_train_step``, dropout with planted keep
masks (the parallel branches among them, and a branch's masks swapped, which
must fail), ``init_params`` against flax's ``init``, EfficientViT's encoder
keywords, and the trainer and its CLI.

The tiny models run on the port's two routes: the CPU's (autograd through
the twins) and the card's (``_KernelsAsTwins``: the twins in the kernels'
places, so that ``AttentionBlockFn``, ``MlpFn`` and ``QkvAttentionFn`` run,
with the launches and recomputes a step that
``chip_smoke.branch_train_counts`` gives).

The helpers here serve ``tests/test_torch_train_blocks.py`` (NesT and
RegionViT), ``tests/test_torch_train_windows.py`` (ScalableViT, CrossFormer)
and ``tests/test_torch_train_lsa_moe.py`` (the small-dataset ViT, ViT-MoE)
too: ``SPECS`` holds the ten families' tiny configs.

CPU tests feed the same numpy inputs (``default_rng(seed)``) through both
packages. The card tests carry the ``cuda`` marker: ``python -m pytest
--noconftest -m cuda tests/test_torch_train_branches.py``.
"""

import contextlib
import functools
import inspect

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_train_heads import _MaskQueue, _plant_jax, _plant_port
from test_torch_train_zoo import _KernelsAsTwins
from vit_tpu_torch import ops
from vit_tpu_torch import train as tt
from vit_tpu_torch.models import (
    MODEL_REGISTRY, CrossFormer, CrossViT, EfficientViT, NesT, ParallelViT, PatchMergerViT,
    RegionViT, ScalableViT, ViTMoE, ViTSmallDatasets,
)
from vit_tpu_torch.utils import from_jax_params, init_params

torch.set_num_threads(2)


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _rel(a, b):
    """Relative L2 distance of ``a`` from the reference ``b``."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    perturb = lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else perturb(v) for k, v in t.items()}
    return walk(tree)


def _reg(name, **over):
    return dict(MODEL_REGISTRY[name][1], **over)


# name -> (port class, config, image size, tree builder): vit_tpu's registry
# tiny configs. CrossViT with its small encoder at depth 2 (scanned: kernel 1
# with remat) and its large one at 1 (unfused: kernel 3); RegionViT with its
# first stage at depth 2 (scanned in vit_tpu) and, apart, with
# ``reference_quirks`` (the clipped bias gather; one 28 x 28 window of 785
# joint tokens at stage 0, 14 x 14 at stage 1). ScalableViT with a single
# block (stage 0's rest unscanned) and two scanned ones (stage 1), and, apart,
# ("scalable_vit split") with SSA keys of 24 and values of 16 (kernel 5 on the
# card) and IWSA keys of 24 and values of 16 (``mha_tokens`` on split views of
# the fused rows, kernel 5) in ``reference_block_order``. CrossFormer with two
# heads of 32 in each stage, stage 0 scanned (49- and 16-token windows) and
# stage 1's LDA on 1-token windows, in both ``reference_quirks`` modes. The
# small-dataset ViT at the registry's config; ViT-MoE at tests/test_moe.py's
# (4 experts, top-2, its MoE in layer 1) with heads of 16.
_SCALABLE = _reg("scalable_vit", depth=(2, 3))
_CROSSFORMER = _reg("crossformer", dim=(64, 64), depth=(2, 1), global_window_size=(4, 1))
_VIT_MOE = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2, heads=2,
                mlp_dim=64, dim_head=16, num_experts=4, num_selected=2, moe_every=2)
SPECS = {
    "efficient": (EfficientViT, _reg("efficient"), 64, cs.efficient_tree),
    "cross_vit": (CrossViT, _reg("cross_vit", sm_enc_depth=2), 64, cs.cross_vit_tree),
    "parallel_vit": (ParallelViT, _reg("parallel_vit"), 64, cs.parallel_vit_tree),
    "patch_merger_vit": (PatchMergerViT, _reg("patch_merger_vit"), 64, cs.patch_merger_tree),
    "nest": (NesT, _reg("nest"), 32, cs.nest_tree),
    "region_vit": (RegionViT, _reg("region_vit", depth=(2, 1)), 112, cs.region_vit_tree),
    "region_vit quirks": (RegionViT, _reg("region_vit", reference_quirks=True, use_peg=False),
                          112, cs.region_vit_tree),
    "scalable_vit": (ScalableViT, _SCALABLE, 64, cs.scalable_vit_tree),
    "scalable_vit split": (ScalableViT, dict(_SCALABLE, depth=(1, 2), ssa_dim_key=24,
                                             ssa_dim_value=16, iwsa_dim_key=24,
                                             iwsa_dim_value=16, reference_block_order=True),
                           64, cs.scalable_vit_tree),
    "crossformer": (CrossFormer, _CROSSFORMER, 112, cs.crossformer_tree),
    "crossformer quirks": (CrossFormer, dict(_CROSSFORMER, reference_quirks=True), 112,
                           cs.crossformer_tree),
    "vit_small_datasets": (ViTSmallDatasets, _reg("vit_small_datasets"), 64,
                           cs.vit_small_datasets_tree),
    "vit_moe": (ViTMoE, _VIT_MOE, 32, cs.vit_moe_tree),
}
FAMILIES = ("efficient", "cross_vit", "parallel_vit", "patch_merger_vit")


@functools.cache
def tree(model):
    """chip_smoke's tree of the tiny model, perturbed; cached, read by every
    test of the model and written by none."""
    _, cfg, _, build = SPECS[model]
    return _perturbed(build(cfg, 7), 8)


def images(seed, b, size):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, size, size, 3)).astype(np.float32), rng.integers(0, 10, b)


def port(model, precision="fp32", **over):
    cls, cfg, _, _ = SPECS[model]
    cfg = _with(cfg, over)
    tm = cls(**cfg, dtype=None if precision == "fp32" else torch.bfloat16, device="cpu")
    tm.load_state_dict(from_jax_params(tree(model), tm.jax_stages), strict=True)
    return tm


def _with(cfg, over):
    """``cfg`` with ``over``; EfficientViT's ``dropout`` goes to its
    encoder's keyword arguments."""
    over = dict(over)
    if "transformer" in cfg and "dropout" in over:
        cfg = dict(cfg, transformer=dict(cfg["transformer"], dropout=over.pop("dropout")))
    return dict(cfg, **over)


def jax_model(model, precision="fp32", **over):
    import jax.numpy as jnp
    from vit_tpu import models as jm
    from vit_tpu.nn.blocks import Transformer as JaxTransformer

    cls, cfg, _, _ = SPECS[model]
    cfg = _with(cfg, over)
    if "transformer" in cfg:
        cfg = dict(cfg, transformer=JaxTransformer(**cfg["transformer"]))
    from vit_tpu.models.vit_moe import ViTMoE as JaxViTMoE

    jcls = JaxViTMoE if cls is ViTMoE else getattr(jm, cls.__name__)  # not in vit_tpu.models
    return jcls(**cfg, dtype=None if precision == "fp32" else jnp.bfloat16)


def train_logits(tm, img, remat=False):
    """The port's training forward: ViT-MoE's takes no ``remat`` (nothing of
    it is scanned in vit_tpu)."""
    if isinstance(tm, ViTMoE):
        return tm(img, train=True)
    return tm(img, train=True, remat=remat)


def logits_2d(logits):
    """The logits as ``[B, classes]``: RegionViT's quirks give ``[B, 1, 1,
    classes]`` at the tiny config (one region)."""
    return logits.reshape(logits.shape[0], -1)


BATCH = 2
_JAX_GRADS = {}


def jax_loss_and_grads(model, precision, mode):
    """``jax.value_and_grad`` of vit_tpu's tiny model's cross-entropy in
    training mode under ``mode`` (jitted), computed once a test run."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops
    from vit_tpu import train as jtrain

    key = (model, precision, mode)
    if key not in _JAX_GRADS:
        img, labels = images(0, BATCH, SPECS[model][2])
        jm = jax_model(model, precision)

        def loss_fn(params):
            with jops.force_backend(mode):
                logits = jm.apply({"params": params}, jnp.asarray(img), True)
            return jtrain.cross_entropy_loss(logits_2d(logits), jnp.asarray(labels))

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tree(model)["params"])
        _JAX_GRADS[key] = float(loss), jax.device_get(grads)
    return _JAX_GRADS[key]


# fp32 in vit_tpu's xla mode, bf16 in both its CPU modes, each on both
# routes. fp32: 1e-5 on the loss and each gradient (relative L2), as
# tests/test_torch_train_bn.py; each gradient's error norm is at least
# allowed GRAD_FLOOR of the largest gradient's norm (fp32 sum-order noise of
# the large terms; a gradient that is exactly zero, RegionViT's last
# layer's bias table, which only discarded outputs read, is held by size).
# bf16: BF16_FLOOR's rule (tests/test_torch_train_zoo.py), twice the larger
# of vit_tpu's own xla-vs-interpret distance and 0.04 a gradient, 0.02 the
# loss. Measured on the six families' tiny configs: fp32 at most 1.7e-6
# (ParallelViT's cls; the loss within 9.6e-7); bf16 at most 0.76 of its
# bound (NesT's first ConvMLP's LayerNorm scale), 0.31 elsewhere
# (RegionViT's local downsample bias), the loss within 0.0104, the two
# routes alike to every digit printed (the Functions' recompute is autograd
# through the twin).
FP32_TOL = 1e-5
GRAD_FLOOR = 1e-7
BF16_FLOOR = (4e-2, 2e-2)


def model_cases(families):
    """fp32 in xla mode and bf16 in both modes, each on both routes."""
    return [(m, "fp32", "xla", route) for m in families for route in ("twins", "functions")] + [
        (m, "bf16", mode, route) for m in families for mode in ("xla", "interpret")
        for route in ("twins", "functions")]


def assert_grads(tm, ref, gtol):
    """Every parameter's fp32 gradient against ``ref``: its error norm
    within ``gtol`` (a float, or by name) of the reference's norm, or
    GRAD_FLOOR of the largest reference norm."""
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(ref)
    norm = lambda t: float(np.linalg.norm(_np(t).astype(np.float64)))
    floor = GRAD_FLOOR * max(norm(r) for r in ref.values())
    for name, p in params.items():
        tol = gtol if isinstance(gtol, float) else gtol[name]
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        err = norm(p.grad.double() - ref[name].double())
        assert err <= max(tol * norm(ref[name]), floor), (name, _rel(p.grad, ref[name]))


def check_loss_and_grads(model, precision, mode, route, monkeypatch, against_fp32=()):
    """The tiny model's loss and every gradient against vit_tpu's
    (``jax_loss_and_grads``) within the bounds above; on the card's route
    with ``branch_train_counts``' launches and recomputes, with remat.

    ``against_fp32``: the bf16 gradients (names) that vit_tpu's CPU modes
    both round far from its fp32 ones, so that their gap says nothing of the
    port's. Each is held to vit_tpu's fp32 gradient instead: its relative L2
    from it at most that of vit_tpu's bf16 gradient in ``mode``."""
    img, labels = images(0, BATCH, SPECS[model][2])
    jloss, jgrads = jax_loss_and_grads(model, precision, mode)
    tm = port(model, precision)
    if route == "functions":
        kernels = _KernelsAsTwins(monkeypatch)
    ops.reset_launch_counts()
    loss = tt.cross_entropy_loss(logits_2d(train_logits(tm, torch.from_numpy(img), remat=True)),
                                 torch.from_numpy(labels))
    loss.backward()
    if route == "functions":
        launches, recomputes = cs.branch_train_counts(tm, image_size=SPECS[model][2])
        assert launches and kernels.launched() == launches
        assert {k: v for k, v in ops.recompute_counts().items() if v} == recomputes
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    if precision == "fp32":
        gtol, ltol = FP32_TOL, FP32_TOL
    else:
        oloss, ograds = jax_loss_and_grads(model, precision,
                                           "interpret" if mode == "xla" else "xla")
        other = from_jax_params({"params": ograds}, tm.jax_stages)
        gtol = {k: 2 * max(_rel(other[k], ref[k]), BF16_FLOOR[0]) for k in ref}
        ltol = 2 * max(abs(oloss - jloss), BF16_FLOOR[1])
        if against_fp32:
            f32 = from_jax_params({"params": jax_loss_and_grads(model, "fp32", "xla")[1]},
                                  tm.jax_stages)
            for k in against_fp32:
                ref[k], gtol[k] = f32[k], _rel(ref[k], f32[k])
    assert abs(loss.item() - jloss) <= ltol, (loss.item(), jloss)
    assert_grads(tm, ref, gtol)


@pytest.mark.parametrize("model,precision,mode,route", model_cases(FAMILIES))
def test_loss_and_grads_match_jax(model, precision, mode, route, monkeypatch):
    """EfficientViT (its encoder scanned: kernel 1), CrossViT (kernel 1 in
    the small encoder, kernel 3 in the large one, the cross-attention in
    plain PyTorch), ParallelViT (kernel 3 in each branch) and
    PatchMerger-ViT (kernel 3 in each layer, the merger in plain PyTorch):
    loss and every gradient against ``jax.value_and_grad`` of vit_tpu's."""
    check_loss_and_grads(model, precision, mode, route, monkeypatch)


# -- AdamW steps against vit_tpu.train --------------------------------------------------

# As tests/test_torch_train_bn.py: STEP_TOL on every value whose clipped
# gradient stayed at or above ADAM_TAU in each update, at least KEPT_SHARE of
# the values so held. The rest, whose gradient is near Adam's eps (1e-8),
# are held to ADAM_OVER, a step either way, as that file holds LeViT's:
# Adam's first update moves a value by lr * g / (|g| + eps), so fp32
# sum-order noise of 1e-9 on a gradient of 5e-9 moves it by a tenth of an
# update or more. Measured after each of two updates on the six families:
# at most 1.7e-6 off above ADAM_TAU (ParallelViT's ff_0_0 w1); below it
# 1.6e-4 (RegionViT's region_proj, its gradient 4.9e-9), 5.9e-5
# (ParallelViT's patch embedding), 1.7e-5 (NesT's to_qkv), 1.2e-5 elsewhere;
# at most 0.87% of a model's values below ADAM_TAU.
STEP_TOL = 4e-6
ADAM_LR = 1e-3
ADAM_TAU = 1e-6
ADAM_OVER = 2 * ADAM_LR
KEPT_SHARE = 0.98
# RegionViT's flipped first steps move its parameters apart by up to 1.6e-4,
# and its second gradients with them (4.1e-6 off above ADAM_TAU measured, past
# STEP_TOL), as LeViT's in tests/test_torch_train_bn.py: its second update
# starts from vit_tpu's parameters and moments before it (``resync``).
RESYNC = ("region_vit",)


@functools.cache
def jax_steps(model):
    """``vit_tpu.train.make_train_step`` in xla mode, fp32, with remat: two
    AdamW updates (lr ADAM_LR, weight decay 0.05, clip 0.5) on ``images(1,
    4)``; each update's (loss, parameters after it, (parameters, Adam state)
    before it)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import train as jtrain

    params = tree(model)["params"]
    jopt = jtrain.make_optimizer(ADAM_LR, name="adamw", grad_clip_norm=0.5)
    jstate = jtrain.TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32), {})
    jstep = jtrain.make_train_step(jax_model(model), jopt, remat=True, backend="xla")
    img, labels = (jnp.asarray(a) for a in images(1, 4, SPECS[model][2]))
    steps = []
    for _ in range(2):
        before = jax.device_get((jstate.params, jstate.opt_state[1][0]))
        jstate, jloss = jstep(jstate, img, labels)
        steps.append((float(jloss), jax.device_get(jstate.params), before))
    return steps


def resync(tm, state, before):
    """The port's parameters and AdamW moments set to vit_tpu's before an
    update (``before``: params, optax's ``ScaleByAdamState``)."""
    params, adam = before
    tm.load_state_dict(from_jax_params({"params": params}, tm.jax_stages))
    mu = from_jax_params({"params": adam.mu}, tm.jax_stages)
    nu = from_jax_params({"params": adam.nu}, tm.jax_stages)
    for k, p in tm.named_parameters():
        state.optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                    "exp_avg": mu[k].clone(), "exp_avg_sq": nu[k].clone()}


def check_adamw_steps(model, zeros=None):
    """Two AdamW updates of the port's trainer against vit_tpu's within the
    rule above (RESYNC's second from vit_tpu's state), the first loss within
    1e-5. ``zeros(tm)``: the number of values whose gradient is zero by
    construction in the update just made; the most of any update so far is
    left out of the count KEPT_SHARE takes its share of."""
    tm = port(model)
    opt = tt.make_optimizer(ADAM_LR, name="adamw", grad_clip_norm=0.5)
    state = tt.create_train_state(tm, opt, init=False)
    step = tt.make_train_step(tm, opt, remat=True)
    params = dict(tm.named_parameters())
    x, y = (torch.from_numpy(a) for a in images(1, 4, SPECS[model][2]))
    gmin, exempt = {}, 0
    for n, (jloss, jparams, before) in enumerate(jax_steps(model), start=1):
        if model in RESYNC and n > 1:
            resync(tm, state, before)
        own = step(state, x, y)
        if n == 1:
            assert abs(float(own) - jloss) <= 1e-5, (float(own), jloss)
        for k, p in params.items():
            fresh = n == 1 or model in RESYNC
            gmin[k] = p.grad.abs() if fresh else torch.minimum(gmin[k], p.grad.abs())
        ref = from_jax_params({"params": jparams}, tm.jax_stages)
        held, over, kept = [], [], 0
        for k, p in params.items():
            err, big = (p.detach() - ref[k]).abs(), gmin[k] >= ADAM_TAU
            kept += int(big.sum())
            held.append((float(err.masked_fill(~big, 0).max()), k))
            over.append((float(err.masked_fill(big, 0).max()), k))
        assert max(held)[0] <= STEP_TOL, (n, sorted(held)[-3:])
        assert max(over)[0] <= ADAM_OVER, (n, sorted(over)[-3:])
        exempt = max(exempt, zeros(tm) if zeros else 0)
        total = sum(p.numel() for p in params.values()) - exempt
        assert kept >= KEPT_SHARE * total, (n, kept, total)


@pytest.mark.parametrize("model", FAMILIES)
def test_adamw_steps_match_jax(model):
    check_adamw_steps(model)


# -- dropout with planted keep masks ------------------------------------------------------

RATE = 0.25
MASK_SEED = 13
# the dropout keys of each family's constructor (EfficientViT's ``dropout``
# reaches its encoder); NesT and RegionViT's are in test_torch_train_blocks
DROP = {"efficient": dict(emb_dropout=RATE, dropout=RATE),
        "cross_vit": dict(emb_dropout=RATE, dropout=RATE),
        "parallel_vit": dict(emb_dropout=RATE, dropout=RATE),
        "patch_merger_vit": dict(emb_dropout=RATE, dropout=RATE),
        "nest": dict(dropout=RATE),
        "region_vit": dict(attn_dropout=RATE, ff_dropout=RATE),
        "scalable_vit": dict(dropout=RATE),
        "crossformer": dict(attn_dropout=RATE, ff_dropout=RATE),
        "vit_small_datasets": dict(emb_dropout=RATE, dropout=RATE),
        "vit_moe": dict(dropout=RATE)}
# vit_tpu pads a ``Transformer``'s stream to 8-row tiles (fp32) around its
# layers (blocks.py:300-340, auto_pad): its feed-forward draws its masks on
# the padded rows, its attention on the real ones. The families whose
# dropout runs inside such a stack.
PADDED_STACKS = ("efficient", "cross_vit", "parallel_vit")


@functools.cache
def jax_drop(model):
    """vit_tpu's loss and gradients at DROP's rates with every keep mask read
    from ``_MaskQueue(MASK_SEED)`` (``_plant_jax``), in xla mode, fp32:
    (loss, grads, the draws)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops
    from vit_tpu import train as jtrain

    mp = pytest.MonkeyPatch()
    queue = _MaskQueue(MASK_SEED)
    try:
        _plant_jax(mp, queue)
        jm = jax_model(model, **DROP[model.split()[0]])
        img, labels = images(0, BATCH, SPECS[model][2])

        def loss_fn(params):
            with jops.force_backend("xla"):
                logits = jm.apply({"params": params}, jnp.asarray(img), True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
            return jtrain.cross_entropy_loss(logits_2d(logits), jnp.asarray(labels))

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tree(model)["params"])
        grads = jax.device_get(grads)
    finally:
        mp.undo()
    return float(loss), grads, queue.drawn


class ReplayQueue:
    """The masks ``_MaskQueue(seed)`` drew for ``drawn``, handed out in
    ``order`` (default: as drawn), each checked against the shape asked."""

    def __init__(self, seed, drawn, order=None):
        rng = np.random.default_rng(seed)
        self.masks = [rng.random(shape) < keep for keep, shape in drawn]
        self.order = list(order if order is not None else range(len(drawn)))
        self.drawn = []

    def draw(self, keep, shape):
        self.drawn.append((round(float(keep), 6), tuple(int(s) for s in shape)))
        mask = self.masks[self.order[len(self.drawn) - 1]]
        assert mask.shape == self.drawn[-1][1], (mask.shape, shape)
        return mask


def plant_padded_mlp_draws(monkeypatch, queue):
    """Each ``FeedForward``'s dropout masks drawn with the token axis padded
    to a multiple of 8 and cut back, as vit_tpu's padded stack draws them
    (a padded row's values never reach a real row)."""
    import importlib

    blocks = importlib.import_module("vit_tpu_torch.nn.blocks")

    def planted(x, rate, generator):
        b, n = x.shape[:2]
        keep = queue.draw(1.0 - rate, (b, -(-n // 8) * 8, *x.shape[2:]))[:, :n]
        keep = torch.from_numpy(keep).to(x.device)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    monkeypatch.setattr(blocks, "dropout", planted)


def port_drop_grads(model, monkeypatch, queue, scope=None):
    """The port's loss at DROP's rates with ``queue``'s masks planted (no
    remat: a recompute would read the queue again), inside ``scope(tm)``
    where given (a planted fault); the model after its backward."""
    tm = port(model, **DROP[model.split()[0]])
    _plant_port(monkeypatch, queue)
    if model in PADDED_STACKS:
        plant_padded_mlp_draws(monkeypatch, queue)
    img, labels = images(0, BATCH, SPECS[model][2])
    with scope(tm) if scope else contextlib.nullcontext():
        loss = tt.cross_entropy_loss(logits_2d(train_logits(tm, torch.from_numpy(img))),
                                     torch.from_numpy(labels))
        loss.backward()
    return loss, tm


# the draws of each tiny model at DROP's rates, in vit_tpu's order
N_DRAWS = {"efficient": 9, "cross_vit": 18, "parallel_vit": 17, "patch_merger_vit": 17,
           "nest": 6, "region_vit": 18, "scalable_vit": 30, "scalable_vit split": 18,
           "crossformer": 18, "vit_small_datasets": 9, "vit_moe": 7}


def check_dropout(model, monkeypatch):
    """Both packages read one queue of planted keep masks, drawn in the same
    order at the same shapes; the loss and every gradient within 1e-5."""
    jloss, jgrads, drawn = jax_drop(model)
    queue = _MaskQueue(MASK_SEED)
    loss, tm = port_drop_grads(model, monkeypatch, queue)
    assert queue.drawn == drawn
    assert len(drawn) == N_DRAWS[model]
    assert abs(loss.item() - jloss) <= 1e-5
    assert_grads(tm, from_jax_params({"params": jgrads}, tm.jax_stages), FP32_TOL)


@pytest.mark.parametrize("model", FAMILIES)
def test_dropout_with_planted_masks_matches_jax(model, monkeypatch):
    """Each family at dropout and emb_dropout 0.25: the embedders' drops,
    every encoder layer materialized with ``attn_drop`` and ``out_drop`` and
    every MLP on its plain path with ``drop1`` and ``drop2`` (ParallelViT's
    branch after branch), CrossViT's cross-attention with ``attn_drop`` on
    the low-query path and ``out_drop``, EfficientViT's encoder dropout
    reaching its injected ``Transformer``."""
    check_dropout(model, monkeypatch)


def test_swapped_branch_masks_fail_the_bound(monkeypatch):
    """ParallelViT with the masks of its two attention branches handed to
    each other (each branch's ``attn_drop`` and ``out_drop`` drawn for the
    other), and apart those of its two feed-forward branches: the
    gradients leave the 1e-5 bound, so the bound sees the branches' order
    of draws."""
    jloss, jgrads, drawn = jax_drop("parallel_vit")
    # draws: emb_drop, then a layer: attn 0 (attn_drop, out_drop), attn 1,
    # ff 0 (drop1, drop2), ff 1
    assert len(drawn) == 1 + 2 * 8
    for first in (1, 5):  # layer 0's attention branches, then its feed-forward ones
        order = list(range(len(drawn)))
        order[first:first + 4] = order[first + 2:first + 4] + order[first:first + 2]
        with monkeypatch.context() as mp:
            loss, tm = port_drop_grads("parallel_vit", mp, ReplayQueue(MASK_SEED, drawn, order))
            ref = from_jax_params({"params": jgrads}, tm.jax_stages)
            worst = max(_rel(p.grad, ref[k]) for k, p in tm.named_parameters())
        assert worst > 100 * FP32_TOL, (first, worst)
    with monkeypatch.context() as mp:  # the replay in vit_tpu's order passes
        loss, tm = port_drop_grads("parallel_vit", mp, ReplayQueue(MASK_SEED, drawn))
        assert_grads(tm, from_jax_params({"params": jgrads}, tm.jax_stages), FP32_TOL)


# -- init_params against flax's init -------------------------------------------------------


def check_init_params(model):
    """``init_params`` against vit_tpu's flax ``init`` (``jax.eval_shape``
    for the names and shapes, the drawn tree for the values): constants
    equal; ``queries`` (PatchMerger) flax's untruncated normal(1) and
    ``embedding`` tables (RegionViT's ``rel_pos_bias``) nn.Embed's
    untruncated normal of std ``1 / sqrt(heads)``, each pooled over the
    model; the rest truncated at two standard deviations of lecun_normal
    (fan-in the kernel's first axis, a conv's ``I * kh * kw``, ViT-MoE's
    ``[E, in, out]`` expert kernels' ``E * in``) or of 0.02
    (``cls``, ``pos_embedding``, NesT's ``pos_emb_{li}``), within 10% of
    their std where they hold 1,000 values."""
    import jax
    import jax.numpy as jnp

    cls, cfg, size, _ = SPECS[model]
    img = jnp.zeros((1, size, size, 3), jnp.float32)
    init = jax.jit(jax_model(model).init)
    shapes = jax.eval_shape(init, {"params": jax.random.PRNGKey(0)}, img)
    jv = jax.device_get(init({"params": jax.random.PRNGKey(0)}, img))
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(np.shape, jv)
    tm = init_params(cls(**cfg, device="cpu"), torch.Generator().manual_seed(0))
    ref = from_jax_params(jv, tm.jax_stages)
    ours = {k: v.detach() for k, v in tm.state_dict().items()}
    assert sorted(ours) == sorted(ref)
    pooled = {"queries": ([], [], 1.0), "embedding": ([], [], None)}
    for k, r in ref.items():
        p = ours[k]
        assert p.shape == r.shape, k
        if r.dim() == 0 or r.numel() == 1 or r.std() == 0:  # a constant: bit for bit
            assert torch.equal(p, r), k
            continue
        leaf = k.split(".")[-1]
        if leaf in pooled:  # untruncated normals, unit once scaled
            scale = pooled[leaf][2] or p.shape[1] ** -0.5
            pooled[leaf][0].append(p.flatten() / scale)
            pooled[leaf][1].append(r.flatten() / scale)
            continue
        fan_std = 0.02 * 0.87962566 if (leaf in ("cls", "pos_embedding")
                                        or leaf.startswith("pos_emb_")) else (
            p[0].numel() if p.dim() == 4 else p.shape[0] * p.shape[1] if p.dim() == 3
            else p.shape[0]) ** -0.5
        assert float(p.abs().max()) <= 2 * fan_std / 0.87962566 * (1 + 1e-6), k
        assert float(r.abs().max()) <= 2 * fan_std / 0.87962566 * (1 + 1e-6), k
        if p.numel() >= 1000:
            assert abs(float(p.std()) - fan_std) <= 0.1 * fan_std, k
    for leaf, (ps, rs, _) in pooled.items():
        for t in (ps, rs):
            if t:  # unit normal once scaled, not truncated
                t = torch.cat(t)
                assert t.numel() >= 16 and abs(float(t.std()) - 1.0) <= 0.3, leaf
                assert float(t.abs().max()) > 1.5, leaf


@pytest.mark.parametrize("model", FAMILIES)
def test_init_params_matches_flax_init(model):
    check_init_params(model)


# -- EfficientViT's encoder keywords ---------------------------------------------------------


class _NoKeywords(torch.nn.Module):
    """An encoder whose ``forward`` takes the tokens alone."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))

    def forward(self, x):
        return x * self.scale


class _Raising(_NoKeywords):
    """An encoder that takes ``train`` and raises a TypeError inside."""

    def forward(self, x, train=False):
        raise TypeError("raised inside the encoder")


class _AnyKeywords(_NoKeywords):
    def forward(self, x, **kw):
        self.seen = sorted(kw)
        return x * self.scale


def test_efficient_hands_the_encoder_the_keywords_it_takes():
    """EfficientViT passes ``train``, ``generator`` and ``remat`` to an
    encoder whose ``forward`` takes them (the port ``Transformer``; all three
    to one that takes ``**kwargs``) and none to one that does not; a
    ``TypeError`` raised inside an encoder reaches the caller, where
    vit_tpu's ``except TypeError`` (efficient.py:55-58) would have called
    the encoder again without ``deterministic``."""
    base = dict(image_size=32, patch_size=16, num_classes=4, dim=8)
    x = torch.randn(1, 32, 32, 3)
    plain = EfficientViT(**base, transformer=_NoKeywords(), device="cpu")
    assert plain._encoder_takes == ()
    assert plain(x, train=True, remat=True).shape == (1, 4)
    anyk = EfficientViT(**base, transformer=_AnyKeywords(), device="cpu")
    anyk(x, train=True)
    assert anyk.transformer.seen == ["generator", "remat", "train"]
    stack = EfficientViT(**base, transformer=dict(dim=8, depth=1, heads=2, dim_head=4,
                                                   mlp_dim=16), device="cpu")
    assert stack._encoder_takes == ("train", "generator", "remat")
    with pytest.raises(TypeError, match="raised inside the encoder"):
        EfficientViT(**base, transformer=_Raising(), device="cpu")(x, train=True)


# -- the trainer and its CLI ---------------------------------------------------------------


def check_trainer_and_cli(name, tmp_path, capsys):
    """``_trainable`` takes the family at its registry config and its
    preset's keys (dropout among them, at a tiny width); ``python -m
    vit_tpu_torch.train --model name`` trains the registry's tiny config on
    the CPU, checkpoints it and resumes from the checkpoint."""
    ctor, cfg, size = MODEL_REGISTRY[name]
    assert callable(tt._trainable(ctor(**cfg, device="cpu"), 0.0, True))
    base = ["--device", "cpu", "--model", name, "--batch", "2", "--classes", "10",
            "--image-size", str(size)]
    assert tt.main(base + ["--steps", "2", "--checkpoint-dir", str(tmp_path)]) == 0
    assert tt.main(base + ["--steps", "1", "--resume", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step 2: loss" in out and "resumed from" in out and "step 3: loss" in out


@pytest.mark.parametrize("name", ["efficient", "cross_vit", "parallel_vit", "patch_merger_vit"])
def test_trainer_and_cli_take_the_family(name, tmp_path, capsys):
    check_trainer_and_cli(name, tmp_path, capsys)


def test_presets_take_their_dropout_back():
    """CrossViT's, ParallelViT's, PatchMerger-ViT's and (since the
    small-dataset ViT trains) the small-dataset ViT's presets carry
    vit_tpu's ``dropout`` and ``emb_dropout`` of 0.1 again (no family's keys
    stay dropped) and build models that keep them; CrossViT's constructor
    defaults to vit_tpu's 0.1."""
    from vit_tpu_torch.models import REFERENCE_PRESETS, TRAINING_ONLY_DROPPED

    assert TRAINING_ONLY_DROPPED == {}
    for name in ("cross_vit", "parallel_vit", "patch_merger_vit", "vit_small_datasets"):
        cfg = REFERENCE_PRESETS[name][1]
        assert cfg["dropout"] == cfg["emb_dropout"] == 0.1, name
    defaults = inspect.signature(CrossViT).parameters
    assert defaults["dropout"].default == defaults["emb_dropout"].default == 0.1
    tm = port("cross_vit", dropout=0.1, emb_dropout=0.1)
    assert tm.sm_embedder.dropout == 0.1 and tm.cross_0_0.sm_attends_lg.dropout == 0.1
    assert tm.sm_enc_0.dropout == 0.1


# -- on the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def card_step_fills_every_gradient(model, dev):
    """The tiny model in bf16 on the card under grad (``init_params``): every
    gradient finite and not all zero, the launches and recomputes of
    ``branch_train_counts``."""
    cls, cfg, size, _ = SPECS[model]
    tm = init_params(cls(**cfg, dtype=torch.bfloat16, device=dev),
                     torch.Generator(dev).manual_seed(0))
    x = torch.randn(2, size, size, 3, device=dev)
    ops.reset_launch_counts()
    tt.cross_entropy_loss(logits_2d(train_logits(tm, x, remat=True)),
                          torch.arange(2, device=dev)).backward()
    want, recomputes = cs.branch_train_counts(tm, image_size=size)
    assert {k: v for k, v in ops.launch_counts().items() if v} == want, model
    assert {k: v for k, v in ops.recompute_counts().items() if v} == recomputes, model
    for name, p in tm.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), (model, name)
    assert any(p.grad.abs().max() > 0 for p in tm.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("model", FAMILIES)
def test_a_card_step_fills_every_gradient(cuda, model):
    card_step_fills_every_gradient(model, cuda)
