"""Training CvT, LeViT, PiT and SimpleViT: ``BatchNorm`` with batch
statistics against flax's ``nn.BatchNorm(use_running_average=False)`` (with
chip_smoke's planted faults), the four tiny models' loss, gradients and new
``batch_stats`` against ``jax.value_and_grad`` with ``mutable=["batch_stats"]``,
AdamW steps (and ``accum_steps=2``) against ``vit_tpu.train.make_train_step``
with ``TrainState.model_state``, LeViT's two-head distillation loss, dropout
with planted keep masks, ``init_params`` against flax's ``init``, a save and
restore of the running statistics, train -> fold -> serve, and the trainer's
refusals.

The tiny models run on the port's two routes: the CPU's (autograd through
the twins) and the card's (``_KernelsAsTwins``: the twins in the kernels'
places, so that ``FlashAttentionFn``, ``MlpFn``, ``AttentionBlockFn`` and
``QkvAttentionFn`` run, with the launches and recomputes a step that
``chip_smoke.bn_train_counts`` gives).

CPU tests feed the same numpy inputs (``default_rng(seed)``) through both
packages. The card tests carry the ``cuda`` marker: ``python -m pytest
--noconftest -m cuda tests/test_torch_train_bn.py``.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_train_heads import _MaskQueue, _plant_jax, _plant_port
from test_torch_train_zoo import _KernelsAsTwins
from vit_tpu_torch import ops
from vit_tpu_torch import train as tt
from vit_tpu_torch.models import MODEL_REGISTRY, CvT, LeViT, PiT, SimpleViT
from vit_tpu_torch.nn.embed import BatchNorm
from vit_tpu_torch.utils import fold_batch_norm_state, from_jax_params, init_params

torch.set_num_threads(2)


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _rel(a, b):
    """Relative L2 distance of ``a`` from the reference ``b``."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bf16_ulp(ref):
    """One bf16 ulp of each value of ``ref`` (8 significant bits)."""
    mag = np.maximum(np.abs(_np(ref)), np.float32(2.0**-126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# -- (a) BatchNorm alone against flax ---------------------------------------------------

# (dtype, momentum, input): "dead" is [4, 2, 4, 8] with channel 3 constant
# (its batch variance exactly 0: 32 values a channel, so that XLA's mean,
# a sum times 1 / 32, is exact too); "clamp" is [2, 1, 1, 8] with channel 5 two
# nearby fp32 values whose fast variance E[x^2] - E[x]^2 comes out below -eps
# in fp32 (with two values a channel every sum is one addition, so both
# packages round it alike).
BN_CASES = [(dt, m, "dead") for dt in ("float32", "bfloat16") for m in (0.9, 0.99)] + [
    ("float32", 0.99, "clamp")]
BN_FAULTS = list(cs.BN_FAULTS)


def _bn_case(dtype, momentum, kind, seed=5):
    """(x, scale, bias, running mean, running var, cotangent) as numpy fp32
    (x already at ``dtype``'s values)."""
    rng = np.random.default_rng(seed)
    shape = (4, 2, 4, 8) if kind == "dead" else (2, 1, 1, 8)
    x = (rng.standard_normal(shape) * 1.5 + rng.standard_normal(8)).astype(np.float32)
    if kind == "dead":
        x[..., 3] = 0.75
    else:
        x[..., 5] = np.array([64.59722, 64.59725], np.float32).reshape(2, 1, 1)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    scale = (1.0 + 0.2 * rng.standard_normal(8)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(8)).astype(np.float32)
    mean = (0.3 * rng.standard_normal(8)).astype(np.float32)
    var = np.exp(0.3 * rng.standard_normal(8)).astype(np.float32)
    return x, scale, bias, mean, var, rng.standard_normal(shape).astype(np.float32)


@functools.cache
def _flax_bn(dtype, momentum, kind):
    """flax ``nn.BatchNorm(use_running_average=False, momentum, epsilon
    1e-5, dtype)`` on ``_bn_case``: (y, new mean, new var, dx, dscale,
    dbias), eager (op by op, as the port computes)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    x, scale, bias, mean, var, g = _bn_case(dtype, momentum, kind)
    jdt = getattr(jnp, dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-5,
                       dtype=None if dtype == "float32" else jdt)

    def f(params, xj):
        return bn.apply({"params": params, "batch_stats": {"mean": jnp.asarray(mean),
                                                          "var": jnp.asarray(var)}},
                        xj, mutable=["batch_stats"])

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    y, vjp, stats = jax.vjp(f, params, jnp.asarray(x).astype(jdt), has_aux=True)
    dparams, dx = vjp(jnp.asarray(g).astype(y.dtype))
    st = stats["batch_stats"]
    return tuple(np.asarray(a, np.float32) for a in (
        y, st["mean"], st["var"], dx, dparams["scale"], dparams["bias"]))


def _port_bn(dtype, momentum, kind, fault=None):
    x, scale, bias, mean, var, g = _bn_case(dtype, momentum, kind)
    bn = BatchNorm(8, momentum=momentum, dtype=None if dtype == "float32" else torch.bfloat16,
                   device="cpu")
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        dict(scale=scale, bias=bias, mean=mean, var=var).items()})
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    y = bn(xt, train=True) if fault is None else cs.bn_faulty(bn, xt, fault)
    y.backward(torch.from_numpy(g).to(y.dtype))
    return y, bn, xt


def _bn_over(y, bn, ref, dtype):
    """The (name, error, bound) rows over their bound: the output within
    1e-6 in fp32 and one bf16 ulp of each value in bf16, the new statistics
    within 1e-6."""
    ry, rmean, rvar = ref[:3]
    if dtype == "float32":
        out = float(np.abs(_np(y) - ry).max()), 1e-6
    else:
        out = float((np.abs(_np(y) - ry) / _bf16_ulp(ry)).max()), 1.0
    rows = [("out", *out), ("mean", float(np.abs(_np(bn.mean) - rmean).max()), 1e-6),
            ("var", float(np.abs(_np(bn.var) - rvar).max()), 1e-6)]
    return [r for r in rows if not r[1] <= r[2]]


@pytest.mark.parametrize("dtype,momentum,kind", BN_CASES)
def test_batchnorm_trains_as_flax(dtype, momentum, kind):
    """``BatchNorm(train=True)`` against flax's: the output (fp32 within
    1e-6, bf16 within one bf16 ulp), the new running statistics within 1e-6
    (``momentum * ra + (1 - momentum) * batch``, the biased variance), and
    the gradients of x, scale and bias within 1e-5 relative L2 (a bf16 dx
    within one bf16 ulp of each value, plus 1e-6 of the largest). The clamp
    case's channel has a fast variance below -eps before the clamp (without
    it the output would be NaN)."""
    ref = _flax_bn(dtype, momentum, kind)
    y, bn, xt = _port_bn(dtype, momentum, kind)
    assert y.dtype == getattr(torch, dtype)
    assert not _bn_over(y, bn, ref, dtype)
    for got, want in ((xt.grad, ref[3]), (bn.scale.grad, ref[4]), (bn.bias.grad, ref[5])):
        if got.dtype == torch.bfloat16:  # dx, rounded once from fp32 sums in either order
            assert (np.abs(_np(got) - want) <= _bf16_ulp(want) + 1e-6 * np.abs(want).max()).all()
        else:
            assert _rel(got, want) <= 1e-5, _rel(got, want)
    if kind == "clamp":
        xf = xt.detach().float()
        pre = (xf * xf).mean(dim=(0, 1, 2)) - xf.mean(dim=(0, 1, 2)) ** 2
        assert pre[5] < -1e-5 and torch.isfinite(y).all()
    else:
        assert float(bn.var[3]) == pytest.approx(momentum * _bn_case(dtype, momentum, kind)[4][3])


@pytest.mark.parametrize("fault", BN_FAULTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_faults_fail_the_bound(fault, dtype):
    """Each of chip_smoke's planted BatchNorm faults (``bn_faulty``: the
    unbiased running variance, torch's momentum convention, the running
    statistics in the training forward, the statistics over the batch axis
    alone, one update done twice) moves the output or the new statistics
    past the bound against flax's; ``bn_faulty`` without a fault is the
    module."""
    ref = _flax_bn(dtype, 0.99, "dead")
    y, bn, _ = _port_bn(dtype, 0.99, "dead", fault)
    assert _bn_over(y, bn, ref, dtype), fault


def test_batchnorm_without_the_clamp_fails():
    """The fast variance without its clamp at zero gives NaN on the clamp
    case's channel."""
    x, scale, bias, mean, var, _ = _bn_case("float32", 0.99, "clamp")
    xf = torch.from_numpy(x)
    m, m2 = xf.mean(dim=(0, 1, 2)), (xf * xf).mean(dim=(0, 1, 2))
    y = (xf - m) * (torch.rsqrt(m2 - m * m + 1e-5) * torch.from_numpy(scale))
    assert torch.isnan(y[..., 5]).all()


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_conv_mlp_batch_norm_branch_trains_as_flax(rate, monkeypatch):
    """``ConvMLP``'s BatchNorm flavour (run by no model) in training against
    ``vit_tpu``'s: 1x1 conv, BatchNorm of the batch, hard-swish, dropout
    (planted masks on both sides at 0.25), 1x1 conv, BatchNorm; the output,
    every gradient and the new ``batch_stats`` within 1e-5 (statistics
    1e-6)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.conv import ConvMLP as JaxConvMLP

    from vit_tpu_torch.nn import ConvMLP

    rng = np.random.default_rng(17)
    x = (rng.standard_normal((2, 4, 4, 8)) + rng.standard_normal(8)).astype(np.float32)
    g = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    jm = JaxConvMLP(8, 2, rate, batch_norm=True)
    v = jax.device_get(jm.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x)))
    v = {"params": _perturbed(v["params"], 18), "batch_stats": _perturbed(v["batch_stats"], 19)}
    jq = _MaskQueue(MASK_SEED)
    with monkeypatch.context() as mp:
        _plant_jax(mp, jq)

        def f(params, xj):
            return jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xj,
                            deterministic=rate == 0.0, train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})

        ref, vjp, stats = jax.vjp(f, v["params"], jnp.asarray(x), has_aux=True)
        dparams, dx = vjp(jnp.asarray(g))
    tm = ConvMLP(8, 2, batch_norm=True, dropout=rate, device="cpu")
    tm.load_state_dict(from_jax_params(v, {}), strict=True)
    tq = _MaskQueue(MASK_SEED)
    _plant_port(monkeypatch, tq)
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, train=True)
    out.backward(torch.from_numpy(g))
    assert tq.drawn == jq.drawn and len(jq.drawn) == (rate > 0)
    assert _rel(out, ref) <= 1e-5 and _rel(xt.grad, dx) <= 1e-5
    ref_grads = from_jax_params({"params": jax.device_get(dparams)}, {})
    for name, p in tm.named_parameters():
        assert _rel(p.grad, ref_grads[name]) <= 1e-5, name
    new = from_jax_params({"params": {}, **jax.device_get(stats)}, {})
    assert max(_stat_err(v_, new[k]) for k, v_ in _stats(tm).items()) <= 1e-6


# -- the tiny models -----------------------------------------------------------------


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    perturb = lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else perturb(v) for k, v in t.items()}
    return walk(tree)


# name -> (port class, config, image size, tree builder): the registry's tiny
# configs; CvT at 64 px and LeViT at 128 (so that the last stage's
# BatchNorms see 16 values a channel at batch 4, not 2 or 4), LeViT also
# with a distillation head, PiT at depth (2, 1) (a scanned stage on kernel 1
# with remat, and an unscanned one).
MODELS = {"cvt": (CvT, dict(MODEL_REGISTRY["cvt"][1]), 64, cs.cvt_tree),
          "levit": (LeViT, dict(MODEL_REGISTRY["levit"][1], image_size=128), 128, cs.levit_tree),
          "levit distill": (LeViT, dict(MODEL_REGISTRY["levit"][1], image_size=128,
                                        num_distill_classes=6), 128, cs.levit_tree),
          "pit": (PiT, dict(MODEL_REGISTRY["pit"][1], depth=(2, 1)), 64, cs.pit_tree),
          "simple_vit": (SimpleViT, dict(MODEL_REGISTRY["simple_vit"][1]), 64,
                         cs.simple_vit_tree)}


@functools.cache
def _tree(model):
    """chip_smoke's tree of the tiny model (BatchNorm statistics drawn
    away from 0 and 1), perturbed; cached, read by every test of the model."""
    _, cfg, _, build = MODELS[model]
    tree = build(cfg, 7)
    return {k: _perturbed(v, 8) for k, v in tree.items()}


def _images(seed, b, size):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, size, size, 3)).astype(np.float32), rng.integers(0, 10, b)


def _port(model, precision="fp32", tree=None, **over):
    cls, cfg, _, _ = MODELS[model]
    tm = cls(**cfg, **over, dtype=None if precision == "fp32" else torch.bfloat16, device="cpu")
    tm.load_state_dict(from_jax_params(tree or _tree(model), tm.jax_stages), strict=True)
    return tm


def _jax_model(model, precision="fp32", **over):
    import jax.numpy as jnp
    from vit_tpu import models as jm

    cls, cfg, _, _ = MODELS[model]
    return getattr(jm, cls.__name__)(**cfg, **over,
                                     dtype=None if precision == "fp32" else jnp.bfloat16)


def _head(logits):
    return logits[0] if isinstance(logits, tuple) else logits


_JAX_GRADS = {}
# The batch of the gradient cases: a BatchNorm's statistics over 4 images
# (CvT's stage-3 keys over 16 values a channel at 64 px; at 2 images and 32
# px they would be over 2, where fp32 sum order moves every gradient by 6e-5).
BATCH = 4


def _jax_loss_and_grads(model, precision, mode):
    """``jax.value_and_grad`` of vit_tpu's tiny model's cross-entropy (the
    class head) in training mode under ``mode`` (jitted), with the new
    ``batch_stats`` (``mutable``); kept for the file."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops
    from vit_tpu import train as jtrain

    key = (model, precision, mode)
    if key not in _JAX_GRADS:
        tree = _tree(model)
        img, labels = _images(0, BATCH, MODELS[model][2])
        jm = _jax_model(model, precision)
        stats = {k: v for k, v in tree.items() if k != "params"}

        def loss_fn(params):
            with jops.force_backend(mode):
                out = jm.apply({"params": params, **stats}, jnp.asarray(img), True,
                               mutable=list(stats) or False)
            logits, new = out if stats else (out, {})
            return jtrain.cross_entropy_loss(_head(logits), jnp.asarray(labels)), new

        (loss, new), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree["params"])
        _JAX_GRADS[key] = float(loss), jax.device_get(grads), jax.device_get(new)
    return _JAX_GRADS[key]


def _stat_err(a, b):
    """A running statistic's error relative to its largest value (at least
    1): the running variances of LeViT's projections reach the 100s."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _stat_tol(model):
    return STAT_TOL.get(model.split()[0], 1e-6)


def _stats(model):
    return {k: v for k, v in model.state_dict().items() if k.rsplit(".", 1)[-1] in ("mean",
                                                                                   "var")}


# fp32 in vit_tpu's xla mode on both routes; bf16 in both modes on the card's
# route, within tests/test_torch_train_zoo.py's BF16_FLOOR rule (twice the
# larger of vit_tpu's own xla-vs-interpret distance and 0.04 a gradient, 0.02
# the loss), as ROADMAP's bf16 bound.
BF16_FLOOR = (4e-2, 2e-2)
# A BatchNorm after a linear map makes the loss blind to a per-channel scale
# of that map's input: the gradient of the LayerNorm scale before CvT's
# depthwise projections is what SAME padding leaves of it, 1e-4 of the
# largest gradient, and its relative error is the sum-order noise of the
# large terms that cancel (2.9e-4 measured). Each gradient's error norm is
# held to the larger of its bound and GRAD_FLOOR times the largest
# gradient's norm: fp32 sum-order noise of the large terms.
GRAD_FLOOR = 1e-7
# The tiny LeViT's gradients are ill-conditioned in fp32 in both packages:
# moving its input by 1e-7 (relative, random) moves its stem's gradients by
# 5.4e-5 in the port and 2.3e-5 in vit_tpu (its batch statistics over few
# values and its norm-free stack), so the two sum orders put them 3.2e-5
# apart. LeViT's fp32 gradients are held to LEVIT_FP32 (relative L2).
LEVIT_FP32 = 1e-4
# The running statistics: within STAT_TOL of each one's largest value
# (``_stat_err``). LeViT's: 1e-5 (measured 2.2e-6). Its projections' outputs
# carry means several times their spread, so the fast variance E[x^2] -
# E[x]^2 cancels and the batch variance moves 4e-5 between sum orders.
STAT_TOL = {"levit": 1e-5}
FAMILIES = ("cvt", "levit", "pit", "simple_vit")
MODEL_CASES = ([(m, "fp32", "xla", route) for m in FAMILIES for route in ("twins", "functions")]
               + [(m, "bf16", mode, "functions") for m in FAMILIES if m != "levit"
                  for mode in ("xla", "interpret")])


def _assert_grads(tm, ref, gtol):
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


@pytest.mark.parametrize("model,precision,mode,route", MODEL_CASES)
def test_loss_grads_and_batch_stats_match_jax(model, precision, mode, route, monkeypatch):
    """The tiny model's loss and every parameter's gradient against
    ``jax.value_and_grad`` of vit_tpu's with ``mutable=["batch_stats"]``,
    and the port's running statistics after the forward against the
    returned ``batch_stats``, leaf by leaf; on the CPU's route or the
    card's (``_KernelsAsTwins``, with ``bn_train_counts``' launches and
    recomputes; PiT and SimpleViT with remat). fp32 within 1e-5 (LeViT's
    gradients within LEVIT_FP32; the statistics within STAT_TOL of their
    largest value); bf16 within BF16_FLOOR's rule, the statistics within
    BF16_FLOOR's gradient floor. LeViT in bf16 is badly conditioned (ROADMAP
    "LeViT bf16"): its stem's gradients sit 0.12 from vit_tpu's, past the
    rule, and its bf16 loss 0.055 from the port's fp32 where vit_tpu's
    jitted bf16 sits under 0.03 from its fp32, so its card route is held in
    fp32 here (the "functions" case) and no bf16 case is listed for it.
    Each gradient's error norm is at least allowed GRAD_FLOOR of the
    largest gradient's norm."""
    img, labels = _images(0, BATCH, MODELS[model][2])
    jloss, jgrads, jstats = _jax_loss_and_grads(model, precision, mode)
    tm = _port(model, precision)
    if route == "functions":
        kernels = _KernelsAsTwins(monkeypatch)
    ops.reset_launch_counts()
    loss = tt.cross_entropy_loss(tm(torch.from_numpy(img), train=True, remat=True),
                                 torch.from_numpy(labels))
    loss.backward()
    if route == "functions":
        launches, recomputes = cs.bn_train_counts(tm)
        assert kernels.launched() == launches
        assert {k: v for k, v in ops.recompute_counts().items() if v} == recomputes
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    new = from_jax_params({"params": {}, **jstats}, tm.jax_stages) if jstats else {}
    if precision == "fp32":
        gtol = {k: LEVIT_FP32 if model.startswith("levit") else 1e-5 for k in ref}
        ltol = 1e-5
    else:
        oloss, ograds, _ = _jax_loss_and_grads(model, precision,
                                               "interpret" if mode == "xla" else "xla")
        other = from_jax_params({"params": ograds}, tm.jax_stages)
        gtol = {k: 2 * max(_rel(other[k], ref[k]), BF16_FLOOR[0]) for k in ref}
        ltol = 2 * max(abs(oloss - jloss), BF16_FLOOR[1])
    assert abs(loss.item() - jloss) <= ltol, (loss.item(), jloss)
    _assert_grads(tm, ref, gtol)
    stats = _stats(tm)
    assert sorted(stats) == sorted(new) and bool(new) == (model in ("cvt", "levit"))
    for name, v in stats.items():
        if precision == "fp32":
            assert _stat_err(v, new[name]) <= _stat_tol(model), name
        else:
            assert _rel(v, new[name]) <= BF16_FLOOR[0], (name, _rel(v, new[name]))


@pytest.mark.parametrize("model", ["cvt", "levit"])
def test_training_forward_moves_the_statistics_once_and_eval_reads_them(model):
    """A training forward moves every running statistic once (two forwards
    twice: no recompute runs a BatchNorm again), an eval forward moves none
    and reads them; ``evaluate`` runs in eval mode."""
    tm = _port(model)
    img, labels = (torch.from_numpy(a) for a in _images(0, 2, MODELS[model][2]))
    before = {k: v.clone() for k, v in _stats(tm).items()}
    with torch.no_grad():
        tm(img)
    assert all(torch.equal(v, before[k]) for k, v in _stats(tm).items())
    loss = tt.cross_entropy_loss(_head(tm(img, train=True, remat=True)), labels)
    once = {k: v.clone() for k, v in _stats(tm).items()}
    assert all(not torch.equal(v, before[k]) for k, v in once.items())
    loss.backward()
    assert all(torch.equal(v, once[k]) for k, v in _stats(tm).items())
    tt.evaluate(tm, [(img, labels)])
    assert all(torch.equal(v, once[k]) for k, v in _stats(tm).items())


# -- (c) AdamW steps against vit_tpu.train, the statistics after each ---------------------

# As tests/test_torch_train_zoo.py: STEP_TOL on every value whose clipped
# gradient stayed at or above ADAM_TAU in each update, a tenth of one update
# on the rest, at least KEPT_SHARE of the values held to STEP_TOL; the
# running statistics within 1e-6 after each update (they do not go through
# Adam).
STEP_TOL = 4e-6
ADAM_LR = 1e-3
ADAM_TAU = 1e-6
KEPT_SHARE = 0.8
# LeViT's fp32 gradients carry 3e-5 of relative sum-order noise (LEVIT_FP32's
# comment), up to 3e-8 on a value: Adam's first update flips the sign of
# such a near-zero gradient's step (4.7e-4 measured on a value whose
# clipped gradient is 2.5e-9), and from there the two sides' parameters
# drift apart at every later gradient (8.6e-4 after three updates where the
# gradient is above 1e-3). So each of LeViT's updates starts from
# vit_tpu's parameters, moments and statistics before it (``_resync``); a
# value is held to STEP_TOL where its gradient is at least LEVIT_TAU (Adam's
# first step moves lr * eps * dg / (|g| + eps)^2: at |g| 1e-5 and dg 3e-8,
# 3e-9), at least LEVIT_KEPT of the values so (96.9% measured), and the
# rest, whose step's sign the noise may flip, to LEVIT_OVER (an update
# either way).
RESYNC = ("levit",)
LEVIT_TAU, LEVIT_KEPT, LEVIT_OVER = 1e-5, 0.8, 2 * ADAM_LR


@functools.cache
def _jax_steps(model, accum):
    """``vit_tpu.train.make_train_step`` in xla mode, fp32, with remat and
    ``model_state``: three AdamW updates (lr ADAM_LR, weight decay 0.05,
    clip 0.5, ``accum_steps`` ``accum``) on ``_images(1, 4)``; each
    update's (loss, parameters after it, model_state after it)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import train as jtrain

    tree = _tree(model)
    params, state = tree["params"], {k: v for k, v in tree.items() if k != "params"}
    jopt = jtrain.make_optimizer(ADAM_LR, name="adamw", grad_clip_norm=0.5)
    jstate = jtrain.TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32), state)
    jstep = jtrain.make_train_step(_jax_model(model), jopt, remat=True, backend="xla",
                                   accum_steps=accum)
    img, labels = (jnp.asarray(a) for a in _images(1, 4, MODELS[model][2]))
    steps = []
    for _ in range(3):
        before = jax.device_get((jstate.params, jstate.opt_state[1][0], jstate.model_state))
        jstate, jloss = jstep(jstate, img, labels)
        steps.append((float(jloss), jax.device_get(jstate.params),
                      jax.device_get(jstate.model_state), before))
    return steps


def _resync(tm, state, before):
    """The port's parameters, AdamW moments and running statistics set to
    vit_tpu's before an update (``before``: params, optax's
    ``ScaleByAdamState``, model_state)."""
    params, adam, model_state = before
    tm.load_state_dict(from_jax_params({"params": params, **model_state}, tm.jax_stages))
    mu = from_jax_params({"params": adam.mu}, tm.jax_stages)
    nu = from_jax_params({"params": adam.nu}, tm.jax_stages)
    for k, p in tm.named_parameters():
        state.optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                    "exp_avg": mu[k].clone(), "exp_avg_sq": nu[k].clone()}


@pytest.mark.parametrize("model,accum", [("cvt", 1), ("cvt", 2), ("levit", 1), ("levit", 2)])
def test_adamw_steps_and_statistics_match_jax(model, accum):
    """1 and 3 AdamW updates against vit_tpu's (``_jax_steps``) within the
    rule above (LeViT's each from vit_tpu's state before it), the running
    statistics after every update within STAT_TOL (with ``accum_steps=2``
    moved twice an update, in microbatch order), the first loss within
    1e-5."""
    tm = _port(model)
    opt = tt.make_optimizer(ADAM_LR, name="adamw", grad_clip_norm=0.5)
    state = tt.create_train_state(tm, opt, init=False)
    step = tt.make_train_step(tm, opt, remat=True, accum_steps=accum)
    params = dict(tm.named_parameters())
    x, y = (torch.from_numpy(a) for a in _images(1, 4, MODELS[model][2]))
    tau, share, rest = ((LEVIT_TAU, LEVIT_KEPT, LEVIT_OVER) if model == "levit" else
                        (ADAM_TAU, KEPT_SHARE, ADAM_LR / 10))
    gmin = {}
    for n, (jloss, jparams, jstate, before) in enumerate(_jax_steps(model, accum), start=1):
        if model in RESYNC and n > 1:
            _resync(tm, state, before)
        own = step(state, x, y)
        if n == 1:
            assert abs(float(own) - jloss) <= 1e-5
        new = from_jax_params({"params": {}, **jstate}, tm.jax_stages)
        stats = _stats(tm)
        assert sorted(stats) == sorted(new)
        assert max(_stat_err(v, new[k]) for k, v in stats.items()) <= _stat_tol(model), n
        for k, p in params.items():
            fresh = n == 1 or model in RESYNC
            gmin[k] = p.grad.abs() if fresh else torch.minimum(gmin[k], p.grad.abs())
        if n in (1, 3):
            ref = from_jax_params({"params": jparams}, tm.jax_stages)
            held, over, kept = [], [], 0
            for k, p in params.items():
                err, big = (p.detach() - ref[k]).abs(), gmin[k] >= tau
                kept += int(big.sum())
                held.append((float(err.masked_fill(~big, 0).max()), k))
                over.append((float(err.masked_fill(big, 0).max()), k))
            assert max(held)[0] <= STEP_TOL, (n, sorted(held)[-3:])
            assert max(over)[0] <= rest, (n, sorted(over)[-3:])
            assert kept >= share * sum(p.numel() for p in params.values()), (n, kept)


# -- (d) LeViT's two heads -------------------------------------------------------------


def _teacher(images):
    """A fixed teacher of 6 logits: the images' channel means through a
    fixed [3, 6] map (numpy or torch)."""
    w = np.random.default_rng(12).standard_normal((3, 6)).astype(np.float32)
    if isinstance(images, torch.Tensor):
        return images.float().mean(dim=(1, 2)) @ torch.from_numpy(w)
    import jax.numpy as jnp

    return jnp.mean(images.astype(jnp.float32), axis=(1, 2)) @ jnp.asarray(w)


@functools.cache
def _jax_distill_step(hard, teacher):
    """One AdamW update of vit_tpu's two-head tiny LeViT (lr ADAM_LR, no
    clip), with ``_teacher`` and ``distill_hard=hard`` or without a teacher:
    (loss, parameters after, model_state after)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import train as jtrain

    tree = _tree("levit distill")
    params, state = tree["params"], {k: v for k, v in tree.items() if k != "params"}
    jopt = jtrain.make_optimizer(ADAM_LR, name="adamw")
    jstate = jtrain.TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32), state)
    kw = dict(teacher_apply=_teacher, distill_hard=hard, distill_alpha=0.4,
              distill_tau=2.0) if teacher else {}
    jstep = jtrain.make_train_step(_jax_model("levit distill"), jopt, remat=True, backend="xla",
                                   **kw)
    img, labels = (jnp.asarray(a) for a in _images(1, 4, 128))
    jstate, jloss = jstep(jstate, img, labels % 6)
    return float(jloss), jax.device_get(jstate.params), jax.device_get(jstate.model_state)


@pytest.mark.parametrize("hard,teacher", [(True, True), (False, True), (True, False)])
def test_two_head_levit_distills_as_vit_tpu(hard, teacher):
    """A LeViT with ``num_distill_classes`` trains its ``distill_head`` on
    the teacher (``distillation_loss``'s second argument, hard and soft) and
    its class head on the labels, as ``vit_tpu``'s step: the loss within
    1e-5 and every parameter after one AdamW update (no clip) within
    LeViT's rule (STEP_TOL where the gradient is at least LEVIT_TAU,
    LEVIT_OVER elsewhere). Without a teacher the class head alone trains on
    the labels; the distillation head gets a zero gradient and only Adam's
    weight decay, as optax gives it."""
    jloss, jparams, jstate = _jax_distill_step(hard, teacher)
    tm = _port("levit distill")
    opt = tt.make_optimizer(ADAM_LR, name="adamw")
    state = tt.create_train_state(tm, opt, init=False)
    kw = dict(teacher_apply=_teacher, distill_hard=hard, distill_alpha=0.4,
              distill_tau=2.0) if teacher else {}
    step = tt.make_train_step(tm, opt, remat=True, **kw)
    x, y = (torch.from_numpy(a) for a in _images(1, 4, 128))
    loss = step(state, x, y % 6)
    assert abs(float(loss) - jloss) <= 1e-5, (float(loss), jloss)
    dgrad = float(tm.distill_head.kernel.grad.abs().max())
    assert (dgrad > 0) == teacher, dgrad
    ref = from_jax_params({"params": jparams}, tm.jax_stages)
    for k, p in tm.named_parameters():
        err, big = (p.detach() - ref[k]).abs(), p.grad.abs() >= LEVIT_TAU
        assert float(err.masked_fill(~big, 0).max()) <= STEP_TOL, k
        assert float(err.masked_fill(big, 0).max()) <= LEVIT_OVER, k
    new = from_jax_params({"params": {}, **jstate}, tm.jax_stages)
    assert max(_stat_err(v, new[k]) for k, v in _stats(tm).items()) <= _stat_tol("levit")


def test_eval_reads_the_class_head():
    """``evaluate`` of a two-head LeViT scores its class head on the
    running statistics, as ``vit_tpu``'s eval step (``:360``)."""
    tm = _port("levit distill")
    x, y = (torch.from_numpy(a) for a in _images(2, 4, 128))
    with torch.no_grad():
        head = tm(x)[0]
    got = tt.evaluate(tm, [(x, y % 6)])
    assert got["loss"] == pytest.approx(float(tt.cross_entropy_loss(head, y % 6)), rel=1e-6)


# -- (e) dropout with planted keep masks ----------------------------------------------------

DROP = {"levit": dict(dropout=0.25), "pit": dict(dropout=0.25, emb_dropout=0.25)}
MASK_SEED = 13


@functools.cache
def _jax_drop(model):
    """vit_tpu's gradients with every keep mask read from
    ``_MaskQueue(MASK_SEED)`` (``_plant_jax``): (loss, grads, new stats,
    the draws)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops
    from vit_tpu import train as jtrain

    mp = pytest.MonkeyPatch()
    queue = _MaskQueue(MASK_SEED)
    try:
        _plant_jax(mp, queue)
        tree = _tree(model)
        stats = {k: v for k, v in tree.items() if k != "params"}
        jm = _jax_model(model, **DROP[model])
        img, labels = _images(0, 2, MODELS[model][2])

        def loss_fn(params):
            with jops.force_backend("xla"):
                out = jm.apply({"params": params, **stats}, jnp.asarray(img), True,
                               mutable=list(stats) or False,
                               rngs={"dropout": jax.random.PRNGKey(0)})
            logits, new = out if stats else (out, {})
            return jtrain.cross_entropy_loss(logits, jnp.asarray(labels)), new

        (loss, new), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree["params"])
        grads, new = jax.device_get(grads), jax.device_get(new)
    finally:
        mp.undo()
    return float(loss), grads, new, queue.drawn


def _pad_mlp_draws(monkeypatch, queue):
    """Each MLP's dropout masks drawn with the token axis padded to a
    multiple of 8 and cut back: vit_tpu pads PiT's stream to 8-row tiles
    around a stage's layers (226 -> 232 and 65 -> 72 at the tiny PiT) and
    its feed-forward draws its masks on the padded rows (its attention on
    the real ones); a padded row's values never reach a real row."""
    import importlib

    blocks = importlib.import_module("vit_tpu_torch.nn.blocks")

    def planted(x, rate, generator):
        b, n = x.shape[:2]
        keep = queue.draw(1.0 - rate, (b, -(-n // 8) * 8, *x.shape[2:]))[:, :n]
        keep = torch.from_numpy(keep).to(x.device)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    monkeypatch.setattr(blocks, "dropout", planted)


@pytest.mark.parametrize("model", list(DROP))
def test_dropout_with_planted_masks_matches_jax(model, monkeypatch):
    """LeViT at dropout 0.25 (each attention's ``drop`` after ``to_out_bn``,
    each MLP's two on its plain path) and PiT at dropout and emb_dropout
    0.25 (``emb_drop``, every attention materialized and every MLP plain):
    both packages read one queue of planted keep masks, drawn in the same
    order at the same shapes; the loss within 1e-5, every gradient within
    1e-5 (LeViT's within LEVIT_FP32), the new running statistics within
    STAT_TOL. Without remat: a recompute would
    read the queue again."""
    jloss, jgrads, jstats, drawn = _jax_drop(model)
    tm = _port(model, **DROP[model])
    queue = _MaskQueue(MASK_SEED)
    _plant_port(monkeypatch, queue)
    if model == "pit":
        _pad_mlp_draws(monkeypatch, queue)
    img, labels = _images(0, 2, MODELS[model][2])
    loss = tt.cross_entropy_loss(tm(torch.from_numpy(img), train=True),
                                 torch.from_numpy(labels))
    loss.backward()
    assert queue.drawn == drawn
    assert len(drawn) == {"levit": 15, "pit": 13}[model]
    assert abs(loss.item() - jloss) <= 1e-5
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    _assert_grads(tm, ref, LEVIT_FP32 if model == "levit" else 1e-5)
    if jstats:
        new = from_jax_params({"params": {}, **jstats}, tm.jax_stages)
        assert max(_stat_err(v, new[k]) for k, v in _stats(tm).items()) <= _stat_tol(model)


# -- (f) init_params against flax's init -------------------------------------------------


@pytest.mark.parametrize("model", FAMILIES)
def test_init_params_matches_flax_init(model):
    """``init_params`` against vit_tpu's flax ``init`` (``jax.eval_shape``
    for the names and shapes, the drawn tree for the values): constants
    equal (LayerNorm and BatchNorm scales and biases, the running
    statistics at 0 and 1), LeViT's ``pos_bias`` tables flax ``nn.Embed``'s
    untruncated normal of std ``1 / sqrt(heads)`` (some value past two
    standard deviations, pooled over the model), the rest truncated at two
    standard deviations of lecun_normal (conv kernels over ``I * kh * kw``,
    a depthwise kernel's ``kh * kw``) or of 0.02 (``cls``,
    ``pos_embedding``), within 10% of their std where they hold 1,000
    values."""
    import jax
    import jax.numpy as jnp

    cls, cfg, size, _ = MODELS[model]
    img = jnp.zeros((1, size, size, 3), jnp.float32)
    init = jax.jit(_jax_model(model).init)
    shapes = jax.eval_shape(init, {"params": jax.random.PRNGKey(0)}, img)
    jv = jax.device_get(init({"params": jax.random.PRNGKey(0)}, img))
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(np.shape, jv)
    tm = cls(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(_tree(model), tm.jax_stages))  # stats away from 0, 1
    init_params(tm, torch.Generator().manual_seed(0))
    ref = from_jax_params(jv, tm.jax_stages)
    ours = {k: v.detach() for k, v in tm.state_dict().items()}
    assert sorted(ours) == sorted(ref)
    tables, rtables = [], []
    for k, r in ref.items():
        p = ours[k]
        assert p.shape == r.shape, k
        if r.std() == 0:
            assert torch.equal(p, r), k
            continue
        if k.endswith("embedding") and "pos_bias" in k:
            tables.append(p.flatten() * p.shape[1] ** 0.5)
            rtables.append(r.flatten() * r.shape[1] ** 0.5)
            continue
        fan_std = 0.02 * 0.87962566 if k.split(".")[-1] in ("cls", "pos_embedding") else (
            p[0].numel() if p.dim() == 4 else p.shape[0]) ** -0.5
        assert float(p.abs().max()) <= 2 * fan_std / 0.87962566 * (1 + 1e-6), k
        assert float(r.abs().max()) <= 2 * fan_std / 0.87962566 * (1 + 1e-6), k
        if p.numel() >= 1000:
            assert abs(float(p.std()) - fan_std) <= 0.1 * fan_std, k
    if model == "levit":
        for t in (torch.cat(tables), torch.cat(rtables)):  # unit normal once scaled
            assert t.numel() >= 40 and abs(float(t.std()) - 1.0) <= 0.3
            assert float(t.abs().max()) > 2.0  # not truncated


# -- (g) checkpoints keep the running statistics --------------------------------------------


def test_async_save_restores_the_running_statistics_bitwise(tmp_path):
    """``CheckpointManager``'s async save of a trained CvT's state restores
    its running statistics (buffers of the ``state_dict``) and parameters
    bit for bit; ``Ema`` averages the parameters only."""
    from vit_tpu_torch.augment import Ema
    from vit_tpu_torch.utils.checkpoint import CheckpointManager

    tm = _port("cvt")
    opt = tt.make_optimizer(ADAM_LR)
    state = tt.create_train_state(tm, opt, init=False)
    step = tt.make_train_step(tm, opt)
    x, y = (torch.from_numpy(a) for a in _images(1, 4, 32))
    step(state, x, y)
    ema = Ema.init(tm, decay=0.9)
    assert not any(k.endswith((".mean", ".var")) for k in ema.params)
    want = {k: v.clone() for k, v in tm.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(state.step, state, force=True)
    step(state, x, y)  # moves the statistics after save() returned
    mgr.wait()
    mgr.close()
    fresh = _port("cvt")
    restored = tt.create_train_state(fresh, opt, init=False)
    CheckpointManager(str(tmp_path)).restore(restored)
    got = fresh.state_dict()
    assert sorted(got) == sorted(want) and any(k.endswith(".var") for k in got)
    assert all(torch.equal(got[k], want[k]) for k in want)


# -- (h) train, fold and serve ------------------------------------------------------------


@pytest.mark.parametrize("model", ["cvt", "levit"])
def test_trained_model_folds_and_serves_as_it_evaluates(model):
    """Two AdamW steps, then ``fold_batch_norm_state`` of the port's own
    state into a ``fold_bn=True`` model: its logits, served through
    ``InferencePipeline`` on the CPU, within 1e-5 of max |logit| of the
    unfolded model's eval logits (``make_eval_step``'s forward) on the same
    preprocessed images; the fold equals ``fold_batch_norm`` of the state as
    a ``vit_tpu`` tree bit for bit."""
    from vit_tpu_torch.pipeline import InferencePipeline

    cls, cfg, size, _ = MODELS[model]
    tm = _port(model)
    opt = tt.make_optimizer(ADAM_LR)
    state = tt.create_train_state(tm, opt, init=False)
    step = tt.make_train_step(tm, opt)
    x, y = (torch.from_numpy(a) for a in _images(1, 4, size))
    for _ in range(2):
        step(state, x, y)
    folded = cls(**cfg, fold_bn=True, device="cpu").eval()
    folded.load_state_dict(fold_batch_norm_state(tm.state_dict()), strict=True)
    assert not any(isinstance(m, BatchNorm) for m in folded.modules())
    raw = np.random.default_rng(3).integers(0, 256, (3, size + 8, size + 8, 3), dtype=np.uint8)
    served = InferencePipeline(folded, image_size=size, batch_size=4)(raw)
    pipe = InferencePipeline(tm.eval(), image_size=size, batch_size=4)
    ref = pipe(raw)
    assert np.abs(served - ref).max() <= 1e-5 * np.abs(ref).max()


# -- (i) what the trainer refuses -------------------------------------------------------------


def test_trainer_takes_the_four_families_and_refuses_a_folded_model():
    """``_trainable`` takes CvT, LeViT (one head and two), PiT and
    SimpleViT; a ``fold_bn=True`` CvT or LeViT is inference only (and so is
    its training forward); ScalableViT and CrossFormer, which raised here
    before their training was ported, are taken too, and a module outside
    the zoo still raises."""
    from vit_tpu_torch.models import CrossFormer, ScalableViT

    for model in MODELS:
        assert callable(tt._trainable(_port(model), 0.0, True)), model
    for cls in (CvT, LeViT):
        name = "cvt" if cls is CvT else "levit"
        folded = cls(**MODELS[name][1], fold_bn=True, device="cpu")
        with pytest.raises(ValueError, match="inference only"):
            tt.make_train_step(folded)
        with pytest.raises(ValueError, match="inference only"):
            folded(torch.zeros(1, MODELS[name][2], MODELS[name][2], 3), train=True)
    for name, cls in (("scalable_vit", ScalableViT), ("crossformer", CrossFormer)):
        assert callable(tt.make_train_step(cls(**MODEL_REGISTRY[name][1], device="cpu")))
    with pytest.raises(NotImplementedError, match="Sequential is not ported"):
        tt.make_train_step(torch.nn.Sequential(torch.nn.Linear(4, 4)))


@pytest.mark.parametrize("name", ["cvt", "levit", "pit", "simple_vit"])
def test_cli_trains_checkpoints_and_resumes(name, tmp_path, capsys):
    """``python -m vit_tpu_torch.train --model cvt|levit|pit|simple_vit``
    trains the registry's tiny config on the CPU, checkpoints it and
    resumes from the checkpoint."""
    base = ["--device", "cpu", "--model", name, "--batch", "2", "--classes", "10",
            "--image-size", "64"]
    assert tt.main(base + ["--steps", "2", "--checkpoint-dir", str(tmp_path)]) == 0
    assert tt.main(base + ["--steps", "1", "--resume", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step 2: loss" in out and "resumed from" in out and "step 3: loss" in out


# -- on the card ----------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batchnorm_on_the_card_matches_the_host(cuda, dtype):
    """``BatchNorm(train=True)`` on the card against the same module on the
    host in fp32 at LeViT's stage-0 shape, batch 8, within chip_smoke's
    ``bn_errors`` bounds, the planted faults failing them."""
    what, hw, c, m = cs.BN_SHAPES[1]
    gen = torch.Generator(device=cuda).manual_seed(3)
    dead, _ = cs.bn_dead_value(gen, 8, hw, c, torch.bfloat16)
    x, scale, bias, _ = cs.bn_inputs(gen, 8, hw, c, dtype, dead)
    bn = cs.bn_module(c, m, scale, bias, dtype, cuda)
    ref = cs.bn_module(c, m, scale.cpu(), bias.cpu(), None, "cpu")
    with torch.no_grad():
        rows = cs.bn_errors(bn(x, train=True), bn.mean, bn.var, ref(x.float().cpu(), train=True),
                            ref.mean, ref.var, dtype)
    assert all(e <= t for _, e, t in rows), rows
    for fault in cs.BN_FAULTS:
        fbn = cs.bn_module(c, m, scale, bias, dtype, cuda)
        with torch.no_grad():
            fy = cs.bn_faulty(fbn, x, fault)
        assert any(e > t for _, e, t in cs.bn_errors(fy, fbn.mean, fbn.var, *(
            lambda r2: (r2(x.float().cpu(), train=True), r2.mean, r2.var))(
            cs.bn_module(c, m, scale.cpu(), bias.cpu(), None, "cpu")), dtype)), fault


@pytest.mark.cuda
def test_a_card_step_of_each_family_fills_every_gradient(cuda):
    """The four tiny models in bf16 on the card under grad: every gradient
    finite, the launches and recomputes of ``bn_train_counts``, the
    running statistics moved and finite."""
    for model in ("cvt", "levit", "pit", "simple_vit"):
        cls, cfg, size, _ = MODELS[model]
        tm = init_params(cls(**cfg, dtype=torch.bfloat16, device=cuda),
                         torch.Generator(cuda).manual_seed(0))
        x = torch.randn(2, size, size, 3, device=cuda)
        ops.reset_launch_counts()
        tt.cross_entropy_loss(tm(x, train=True, remat=True),
                              torch.arange(2, device=cuda)).backward()
        want, recomputes = cs.bn_train_counts(tm)
        assert {k: v for k, v in ops.launch_counts().items() if v} == want, model
        assert {k: v for k, v in ops.recompute_counts().items() if v} == recomputes, model
        for name, p in tm.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), (model, name)
        stats = _stats(tm)
        assert all(torch.isfinite(v).all() for v in stats.values()), model
        assert all(not torch.equal(v, torch.zeros_like(v)) for k, v in stats.items()
                   if k.endswith(".mean")), model
