"""Training CaiT and DeepViT: the autograd Functions of kernels 7 and 8
against vit_tpu's custom VJPs on the CPU, the two models' gradients (with
planted stochastic-depth and dropout masks) and AdamW steps against
``jax.value_and_grad`` and ``vit_tpu.train``, the attention's training
routes against ``th_fusable`` / ``reattn_fusable``, cross-attention dropout,
``init_params``, the trainer, and the Functions on the card.

The tiny models run on the port's two routes: the CPU's (autograd through
the twins) and the card's (``_KernelsAsTwins``: the twins in the kernels'
places, so that ``TalkingHeadsBlockFn``, ``ReattentionBlockFn`` and
``MlpFn`` run, with the launches and recomputes a step that
``chip_smoke.head_mix_train_counts`` gives).

CPU tests feed the same numpy inputs (``default_rng(seed)``) through both
packages. The card tests carry the ``cuda`` marker: ``python -m pytest
--noconftest -m cuda tests/test_torch_train_heads.py``.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from vit_tpu_torch import ops
from vit_tpu_torch import train as tt
from vit_tpu_torch.models import CaiT, DeepViT
from vit_tpu_torch.nn import Attention
from vit_tpu_torch.utils import from_jax_params, init_params

nn_attention = importlib.import_module("vit_tpu_torch.nn.attention")
tcait = importlib.import_module("vit_tpu_torch.models.cait")

torch.set_num_threads(2)

# tests/test_torch_train_zoo.py's bounds (relative L2 of each gradient
# against vit_tpu's): fp32 1e-5, bf16 2e-2.
OP_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TINY = dict(image_size=32, patch_size=8, num_classes=10, dim=64, heads=4, mlp_dim=128,
            dim_head=16)


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _rel(a, b):
    """Relative L2 distance of ``a`` from the reference ``b``."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _torch(arrays, dtypes):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dt))
            for a, dt in zip(arrays, dtypes)]


def _jax(arrays, dtypes):
    import jax.numpy as jnp

    return [jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dt))
            for a, dt in zip(arrays, dtypes)]


# -- kernels 7 and 8: TalkingHeadsBlockFn and ReattentionBlockFn ------------------

# (kind, tokens, residual, dtype): 17 tokens are padded inside vit_tpu's
# kernels (to 24 in fp32, 32 in bf16), and kernel 8 pads them to 32 on the
# card; 16 are not.
FN_CASES = [("talking_heads_block", 16, False, "float32"),
            ("talking_heads_block", 17, True, "float32"),
            ("talking_heads_block", 17, False, "bfloat16"),
            ("reattention_block", 17, True, "float32"),
            ("reattention_block", 17, True, "bfloat16")]


def _fn_case(kind, n, residual, seed=3):
    """(arrays in ``ALL_FN_ARGS`` order, the cotangent, the options): batch
    2, width 64, 4 heads of 16, head mixes at vit_tpu's test scale (0.3), a
    head-LN bias large enough that padded key columns would count."""
    b, dim, heads, d = 2, 64, 4, 16
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, n, dim)), 1.0 + 0.1 * rng.standard_normal(dim),
              0.1 * rng.standard_normal(dim), rng.standard_normal((dim, 3 * heads * d)) / dim**0.5,
              rng.standard_normal((heads * d, dim)) / (heads * d) ** 0.5,
              0.1 * rng.standard_normal(dim), 0.3 * rng.standard_normal((heads, heads))]
    if kind == "talking_heads_block":
        arrays.append(0.3 * rng.standard_normal((heads, heads)))
        kw = dict(heads=heads, scale=d**-0.5, ln_eps=1e-5, residual=residual)
    else:
        arrays += [1.0 + 0.1 * rng.standard_normal(heads), 0.5 * rng.standard_normal(heads)]
        kw = dict(heads=heads, scale=d**-0.5, ln_eps=1e-6, reattn_eps=1e-6)
    return arrays, rng.standard_normal((b, n, dim)).astype(np.float32), kw


def _fn_dtypes(kind, dtype):
    dt = ["float32"] * len(cs.ALL_FN_ARGS[kind])
    for i in (0, 3, 4):  # x, wqkv, wout
        dt[i] = dtype
    return dt


@functools.cache
def _jax_fn_grads(kind, n, residual, dtype):
    """``jax.vjp`` of vit_tpu's kernel in interpret mode, whose custom VJP
    (``_th_bwd`` / ``_reattn_bwd``) recomputes its XLA twin."""
    import jax

    jrb = importlib.import_module("vit_tpu.ops.reattention_block")

    arrays, g, kw = _fn_case(kind, n, residual)
    if kind == "talking_heads_block":
        f = lambda *a: jrb.fused_talking_heads_block(
            *a, kw["heads"], scale=kw["scale"], ln_eps=kw["ln_eps"], residual=residual,
            interpret=True)
    else:
        f = lambda *a: jrb.fused_reattention_block(
            *a, kw["heads"], scale=kw["scale"], ln_eps=kw["ln_eps"],
            reattn_eps=kw["reattn_eps"], interpret=True)
    dtypes = _fn_dtypes(kind, dtype)
    _, vjp = jax.vjp(f, *_jax(arrays, dtypes))
    return [np.asarray(r, np.float32) for r in vjp(_jax([g], [dtypes[0]])[0])]


def _assert_grads(kind, grads, ref, dtype):
    for name, a, b in zip(cs.ALL_FN_ARGS[kind], grads, ref):
        assert _rel(a, b) <= OP_TOL[dtype], (name, _rel(a, b))


@pytest.mark.parametrize("kind,n,residual,dtype", FN_CASES)
def test_function_grads_match_jax(kind, n, residual, dtype):
    """The Function with its twin as the forward: every operand's gradient
    (x, the LayerNorm, the weights, the head mixes and kernel 8's head-LN
    parameters) in its operand's dtype, within OP_TOL of ``jax.vjp`` of
    vit_tpu's kernel in interpret mode."""
    arrays, g, kw = _fn_case(kind, n, residual)
    dtypes = _fn_dtypes(kind, dtype)
    args = _torch(arrays, dtypes)
    grads = cs.function_grads(kind, args, kw, torch.from_numpy(g).to(args[0].dtype),
                              forward=cs.twin_forward(kind))
    assert [a.dtype for a in grads] == [a.dtype for a in args]
    _assert_grads(kind, grads, _jax_fn_grads(kind, n, residual, dtype), dtype)


@pytest.mark.parametrize("kind,n,residual", [c[:3] for c in FN_CASES if c[3] == "float32"])
def test_recompute_is_the_twins_function(kind, n, residual):
    """What each Function's backward differentiates (``ops.reattention_block``'s
    ``recompute_*``: einsum head mixes, flax's LayerNorm across the heads)
    computes its forward twin's function in fp32, within 1e-6 relative L2:
    only the sum order differs."""
    arrays, _, kw = _fn_case(kind, n, residual)
    args = _torch(arrays, _fn_dtypes(kind, "float32"))
    rb = importlib.import_module("vit_tpu_torch.ops.reattention_block")
    recompute = getattr(rb, f"recompute_{kind}")
    opts = list(kw.values())
    assert _rel(recompute(*args, *opts), cs.twin_forward(kind)(*args, *opts)) <= 1e-6


@pytest.mark.parametrize("kind,n,residual", [c[:3] for c in FN_CASES if c[3] == "float32"])
def test_function_faults_fail_the_bound(kind, n, residual):
    """Each fault ``check_function`` plants (``function_faults``: a head mix
    transposed in the recompute, the residual's gradient dropped, the
    LayerNorm gradients swapped, kernel 8 recomputed on tokens padded to 32
    with the padded keys in) moves a gradient past the fp32 bound against
    vit_tpu's."""
    arrays, g, kw = _fn_case(kind, n, residual)
    args = _torch(arrays, _fn_dtypes(kind, "float32"))
    faults = cs.function_faults(kind, args, kw)
    mixes = 2 if kind == "talking_heads_block" else 1
    assert len(faults) == 1 + residual + mixes + (kind == "reattention_block")
    ref = _jax_fn_grads(kind, n, residual, "float32")
    for fault in faults:
        bad = cs.faulty_grads(kind, args, kw, torch.from_numpy(g), fault)
        assert any(_rel(a, b) > OP_TOL["float32"] for a, b in zip(bad, ref)), fault


@pytest.mark.parametrize("kind", list(cs.HEAD_MIX_FN_ARGS))
def test_function_saves_only_its_inputs_and_counts_a_recompute(kind):
    """As ``_th_fwd`` / ``_reattn_fwd``: the operands as given (kernel 8's
    unpadded x) and nothing of the forward's inside; a backward counts one
    recompute of its kernel."""
    arrays, g, kw = _fn_case(kind, 17, True)
    leaves = [a.requires_grad_() for a in _torch(arrays, _fn_dtypes(kind, "float32"))]
    out = cs.apply_function(kind, cs.twin_forward(kind), leaves, kw)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == len(leaves) and all(s is l for s, l in zip(saved, leaves))
    ops.reset_launch_counts()
    out.backward(torch.from_numpy(g))
    assert {k: v for k, v in ops.recompute_counts().items() if v} == {kind: 1}


def test_ops_entries_take_the_functions_and_export_reaches_the_operators(monkeypatch):
    """On the card's route (``_use_kernel`` true, the twins in the kernels'
    places) the two ops entries go through their Functions under grad and
    call the kernel directly without it; while ``torch.export`` traces
    (``torch.compiler.is_compiling``) and nothing needs grad, ``_route``
    still gives the operators."""
    kernels = _KernelsAsTwins(monkeypatch)
    for kind, entry, fn in (("talking_heads_block", ops.talking_heads_block,
                             ops.TalkingHeadsBlockFn),
                            ("reattention_block", ops.reattention_block,
                             ops.ReattentionBlockFn)):
        arrays, _, kw = _fn_case(kind, 16, True)
        args = _torch(arrays, _fn_dtypes(kind, "float32"))
        extra = dict(residual=True) if kind == "talking_heads_block" else {}
        with torch.no_grad():
            out = entry(*args, kw["heads"], scale=kw["scale"], ln_eps=kw["ln_eps"], **extra)
        assert out.grad_fn is None
        leaves = [a.requires_grad_() for a in args]
        out = entry(*leaves, kw["heads"], scale=kw["scale"], ln_eps=kw["ln_eps"], **extra)
        assert type(out.grad_fn).__name__ == f"{fn.__name__}Backward"
        op = getattr(torch.ops.vit_tpu_torch, kind).default
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        with torch.no_grad():
            assert ops._route(op, None, None, *args) is op
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: False)
    assert kernels.launched() == {"talking_heads_block": 2, "reattention_block": 2}


# -- the attention's training routes ---------------------------------------------------


def _jax_route(kind, rate, deterministic):
    """Whether vit_tpu's ``Attention`` (raw-parameter self-attention with
    the head mix, ``fuse_residual`` for re-attention) reaches its kernel in
    interpret mode: ``th_fusable`` / ``reattn_fusable``."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops
    from vit_tpu.nn.attention import Attention as JaxAttention

    entry = kind
    calls = []
    orig = getattr(jops, entry)

    def spy(*a, **k):
        calls.append(entry)
        return orig(*a, **k)

    m = JaxAttention(dim=32, heads=2, dim_head=16, dropout=rate,
                     talking_heads=kind == "talking_heads_block",
                     reattention=kind == "reattention_block",
                     fuse_residual=kind == "reattention_block")
    x = jnp.ones((1, 8, 32), jnp.float32)
    setattr(jops, entry, spy)
    try:
        with jops.force_backend("interpret"):
            v = m.init({"params": jax.random.PRNGKey(0)}, x)
            calls.clear()
            m.apply(v, x, deterministic=deterministic, rngs={"dropout": jax.random.PRNGKey(1)})
    finally:
        setattr(jops, entry, orig)
    return bool(calls)


@pytest.mark.parametrize("kind", list(cs.HEAD_MIX_FN_ARGS))
def test_training_routes_are_vit_tpus(kind, monkeypatch):
    """At dropout 0 and 0.1, in training and not: the port reaches kernel 7
    or 8 exactly where vit_tpu's ``th_fusable`` / ``reattn_fusable`` send
    its layer to the kernel (dropout in training materializes the scores)."""
    calls = []
    orig = getattr(ops, kind)
    monkeypatch.setattr(ops, kind, lambda *a, **k: calls.append(kind) or orig(*a, **k))
    x = torch.ones(1, 8, 32)
    for rate in (0.0, 0.1):
        a = Attention(32, 2, 16, dropout=rate, talking_heads=kind == "talking_heads_block",
                      reattention=kind == "reattention_block",
                      fuse_residual=kind == "reattention_block", device="cpu")
        for train in (False, True):
            calls.clear()
            with torch.no_grad():
                a(x, train=train, generator=torch.Generator().manual_seed(0))
            assert bool(calls) == _jax_route(kind, rate, not train), (rate, train)
            assert bool(calls) == (rate == 0.0 or not train), (rate, train)


# -- cross-attention dropout ---------------------------------------------------------


class _MaskQueue:
    """One queue of numpy keep masks (``default_rng(seed)``), drawn in call
    order at each call's keep probability and shape; ``drawn`` records
    (keep probability, shape) of each draw."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.drawn = []

    def draw(self, keep, shape):
        self.drawn.append((round(float(keep), 6), tuple(int(s) for s in shape)))
        return self.rng.random(self.drawn[-1][1]) < keep


def _plant_jax(monkeypatch, queue):
    """``jax.random.bernoulli``, which flax's ``Dropout`` and vit_tpu's CaiT
    gate call, reading ``queue`` at run time (an ordered ``io_callback``,
    so that every layer of a scanned stage reads its own mask). The callback
    takes the draw's key as an operand it ignores: without one it depends
    on nothing in the scan, and a jitted forward ran it once too often."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import io_callback

    def planted(key, p=0.5, shape=None, *a, **k):
        shape = tuple(shape)
        if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
            key = jax.random.key_data(key)
        return io_callback(lambda _: queue.draw(p, shape), jax.ShapeDtypeStruct(shape, jnp.bool_),
                           key, ordered=True)

    monkeypatch.setattr(jax.random, "bernoulli", planted)


def _plant_port(monkeypatch, queue):
    """The port's draw (``nn.attention.bernoulli``, the module's and CaiT's
    names of it) reading ``queue``."""
    planted = lambda keep, shape, generator, device: torch.from_numpy(
        queue.draw(keep, shape)).to(device)
    monkeypatch.setattr(nn_attention, "bernoulli", planted)
    monkeypatch.setattr(tcait, "bernoulli", planted)


@pytest.mark.parametrize("lowq", [True, False])
def test_cross_attention_dropout_matches_jax(lowq, monkeypatch):
    """CaiT's class-attention (talking heads, cross, ``kv_include_self``) in
    training at dropout 0.25 with planted masks: ``attn_drop`` on the
    probabilities after the post-softmax mix (the low-query path, :462; the
    materializing path, :503), ``out_drop`` after ``to_out`` (:409). Output
    and every gradient within 1e-5 of vit_tpu's, the masks drawn in the same
    order at the same shapes."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.attention import Attention as JaxAttention

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 64)).astype(np.float32)
    g = rng.standard_normal((2, 1, 64)).astype(np.float32)
    kw = dict(dim=64, heads=4, dim_head=16, talking_heads=True, lowq_cross=lowq, norm_eps=1e-5,
              dropout=0.25)
    jm = JaxAttention(**kw)
    variables = jax.device_get(jm.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x),
                                       jnp.asarray(ctx), True))
    variables = {"params": jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])}
    jq = _MaskQueue(4)
    _plant_jax(monkeypatch, jq)

    def f(params, a, c):
        return jm.apply({"params": params}, a, c, True, deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(0)})

    ref, vjp = jax.vjp(jax.jit(f), variables["params"], jnp.asarray(x), jnp.asarray(ctx))
    dparams, dx, dctx = vjp(jnp.asarray(g))
    tq = _MaskQueue(4)
    _plant_port(monkeypatch, tq)
    ta = Attention(64, 4, 16, talking_heads=True, cross=True, lowq_cross=lowq, norm_eps=1e-5,
                   dropout=0.25, device="cpu")
    ta.load_state_dict(from_jax_params(variables, {}), strict=True)
    xt, ct = (torch.from_numpy(a).requires_grad_() for a in (x, ctx))
    out = ta(xt, ct, kv_include_self=True, train=True)
    assert tq.drawn == jq.drawn == [(0.75, (2, 4, 1, 17)), (0.75, (2, 1, 64))]
    assert _rel(out, ref) <= 1e-5
    out.backward(torch.from_numpy(g))
    refs = from_jax_params({"params": jax.device_get(dparams)}, {})
    assert _rel(xt.grad, dx) <= 1e-5 and _rel(ct.grad, dctx) <= 1e-5
    for name, p in ta.named_parameters():
        assert _rel(p.grad, refs[name]) <= 1e-5, name


# -- the tiny models: loss and gradients against jax.value_and_grad --------------------

# CaiT: two talking-heads layers (scanned), one class layer (not), stochastic
# depth 0.25; DeepViT: a scanned stack of two re-attention layers. "drop" adds
# vit_tpu's dropout routes: dropout and emb_dropout 0.1.
MODELS = {"cait": (CaiT, dict(TINY, depth=2, cls_depth=1, layer_dropout=0.25)),
          "deepvit": (DeepViT, dict(TINY, depth=2)),
          "cait drop": (CaiT, dict(TINY, depth=2, cls_depth=1, layer_dropout=0.25, dropout=0.1,
                                   emb_dropout=0.1)),
          "deepvit drop": (DeepViT, dict(TINY, depth=2, dropout=0.1, emb_dropout=0.1))}
MASK_SEED = 11


def _images(seed, b):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 32, 32, 3)).astype(np.float32), rng.integers(0, 10, b)


@functools.cache
def _tree(model):
    """vit_tpu's ``init`` of the tiny model, perturbed so that LayerNorms,
    biases and LayerScales are not constants (every model of one family
    reads the same tree; none writes to it)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import models as jm

    cls, cfg = MODELS[model]
    jmodel = getattr(jm, cls.__name__)(**cfg)
    v = jax.device_get(jax.jit(jmodel.init)({"params": jax.random.PRNGKey(1)},
                                            jnp.zeros((1, 32, 32, 3), jnp.float32)))
    rng = np.random.default_rng(2)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.standard_normal(a.shape).astype(
            np.float32), v)


def _jax_model(model, precision):
    import jax.numpy as jnp
    from vit_tpu import models as jm

    cls, cfg = MODELS[model]
    return getattr(jm, cls.__name__)(**cfg, dtype=None if precision == "fp32" else jnp.bfloat16)


def _port(model, precision, tree=None):
    cls, cfg = MODELS[model]
    tm = cls(**cfg, dtype=None if precision == "fp32" else torch.bfloat16, device="cpu")
    tm.load_state_dict(from_jax_params(tree or _tree(model.split()[0]), tm.jax_stages),
                       strict=True)
    return tm


_JAX_GRADS = {}


def _jax_loss_and_grads(model, precision, mode, monkeypatch):
    """``jax.value_and_grad`` of vit_tpu's tiny model's cross-entropy in
    training mode under ``mode`` (jitted), every keep mask and gate read
    from ``_MaskQueue(MASK_SEED)``; with the draws (kept for the file)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops
    from vit_tpu import train as jtrain

    key = (model, precision, mode)
    if key not in _JAX_GRADS:
        img, labels = _images(0, 2)
        jm = _jax_model(model, precision)
        queue = _MaskQueue(MASK_SEED)
        with monkeypatch.context() as mp:
            _plant_jax(mp, queue)

            def loss_fn(params):
                with jops.force_backend(mode):
                    logits = jm.apply({"params": params}, jnp.asarray(img), True,
                                      rngs={"dropout": jax.random.PRNGKey(0)})
                return jtrain.cross_entropy_loss(logits, jnp.asarray(labels))

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
                _tree(model.split()[0])["params"])
            grads = jax.device_get(grads)
        _JAX_GRADS[key] = float(loss), grads, queue.drawn
    return _JAX_GRADS[key]


class _KernelsAsTwins:
    """Runs the card's route on the CPU: ``ops._use_kernel`` true, each
    kernel wrapper replaced by its twin, so the ops entries go through the
    autograd Functions; ``calls`` counts each kernel's would-be launches."""

    NAMES = {"fused_talking_heads_block": "talking_heads_block",
             "fused_reattention_block": "reattention_block", "fused_mlp": "fused_mlp"}

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.NAMES.values(), 0)
        monkeypatch.setattr(ops, "_use_kernel", lambda x: True)
        for wrapper, kind in self.NAMES.items():
            monkeypatch.setattr(ops, wrapper, self._counting(kind, cs.twin_forward(kind)))

    def _counting(self, kind, twin):
        def run(*a, **kw):
            self.calls[kind] += 1
            return twin(*a, **kw)
        return run

    def launched(self):
        return {k: v for k, v in self.calls.items() if v}


# bf16 as tests/test_torch_train_zoo.py's BF16_FLOOR: a gradient within twice
# the larger of vit_tpu's own xla-vs-interpret distance and 0.04, the loss
# within twice the larger of their gap and 0.02.
BF16_FLOOR = (4e-2, 2e-2)
# fp32 in vit_tpu's xla mode on both routes (its interpret mode's fp32
# gradients equal it within sum order); bf16 in both modes on the card's
# route; the dropout routes (no kernel 7 or 8) in fp32 on the CPU's route.
MODEL_CASES = ([(m, "fp32", "xla", route) for m in ("cait", "deepvit")
                for route in ("twins", "functions")]
               + [(m, "bf16", mode, "functions") for m in ("cait", "deepvit")
                  for mode in ("xla", "interpret")]
               + [(m, "fp32", "xla", "twins") for m in ("cait drop", "deepvit drop")])


@pytest.mark.parametrize("model,precision,mode,route", MODEL_CASES)
def test_loss_and_grads_match_jax(model, precision, mode, route, monkeypatch):
    """The tiny model's loss and every parameter's gradient against
    ``jax.value_and_grad`` of vit_tpu's (``MODEL_CASES``), both sides reading
    one queue of planted keep masks (CaiT's stochastic-depth gates, and the
    dropout masks of the "drop" models), drawn in the same order at the same
    shapes; the port on the CPU's route or the card's (``_KernelsAsTwins``,
    with the launches and recomputes ``chip_smoke.head_mix_train_counts``
    gives, DeepViT with remat). fp32 within 1e-5 (loss and each gradient's
    relative L2); bf16 within BF16_FLOOR's rule."""
    img, labels = _images(0, 2)
    jloss, jgrads, drawn = _jax_loss_and_grads(model, precision, mode, monkeypatch)
    tm = _port(model, precision)
    queue = _MaskQueue(MASK_SEED)
    _plant_port(monkeypatch, queue)
    if route == "functions":
        kernels = _KernelsAsTwins(monkeypatch)
    ops.reset_launch_counts()
    # with masks planted, a recompute would read the queue again: remat only
    # where nothing is drawn (DeepViT at dropout 0), as the card's step runs it
    remat = route == "functions" and not drawn
    loss = tt.cross_entropy_loss(tm(torch.from_numpy(img), train=True, remat=remat),
                                 torch.from_numpy(labels))
    loss.backward()
    assert queue.drawn == drawn
    assert len(drawn) == {"cait": 6, "deepvit": 0, "cait drop": 19, "deepvit drop": 9}[model]
    if route == "functions":
        launches, recomputes = cs.head_mix_train_counts(tm, remat)
        assert kernels.launched() == launches
        assert {k: v for k, v in ops.recompute_counts().items() if v} == recomputes
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    if precision == "fp32":
        gtol = {k: 1e-5 for k in ref}
        ltol = 1e-5
    else:
        oloss, ograds, _ = _jax_loss_and_grads(model, precision,
                                               "interpret" if mode == "xla" else "xla",
                                               monkeypatch)
        other = from_jax_params({"params": ograds}, tm.jax_stages)
        gtol = {k: 2 * max(_rel(other[k], ref[k]), BF16_FLOOR[0]) for k in ref}
        ltol = 2 * max(abs(oloss - jloss), BF16_FLOOR[1])
    assert abs(loss.item() - jloss) <= ltol, (loss.item(), jloss)
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(ref)
    for name, p in params.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert _rel(p.grad, ref[name]) <= gtol[name], (name, _rel(p.grad, ref[name]))


def test_unscaled_keep_gate_fails_the_bound(monkeypatch):
    """A planted fault, the stochastic-depth gate without its ``1 / (1 - p)``
    scale, moves the tiny CaiT's gradients past the fp32 bound."""
    img, labels = _images(0, 2)
    jloss, jgrads, _ = _jax_loss_and_grads("cait", "fp32", "xla", monkeypatch)
    tm = _port("cait", "fp32")
    _plant_port(monkeypatch, _MaskQueue(MASK_SEED))

    def unscaled(self, x, delta, scale, train, generator):
        keep = tcait.bernoulli(1.0 - self.layer_dropout, (x.shape[0], 1, 1), generator,
                               x.device)
        return x + delta * scale.to(delta.dtype) * keep.to(delta.dtype)

    monkeypatch.setattr(tcait._CaiTBlock, "gated_residual", unscaled)
    loss = tt.cross_entropy_loss(tm(torch.from_numpy(img), train=True), torch.from_numpy(labels))
    loss.backward()
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    assert max(_rel(p.grad, ref[k]) for k, p in tm.named_parameters()) > 1e-5


def test_stochastic_depth_and_dropout_rates(monkeypatch):
    """CaiT at layer_dropout 0.25 and dropout 0.25: each gate is one draw of
    shape (B, 1, 1) a delta (two a layer, both stages), each dropout site of
    vit_tpu's (the embedding; a patch layer's probabilities, output and
    MLP's two; a class layer's cross-attention probabilities and output and
    MLP's two) keeps 75% of its values, a dropped sample's delta is zero and
    a kept one's is scaled by 1 / 0.75 in the delta's dtype, and a
    generator seeded alike repeats the loss bit for bit."""
    cfg = dict(TINY, depth=2, cls_depth=1, layer_dropout=0.25, dropout=0.25, emb_dropout=0.25)
    tm = CaiT(**cfg, dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(from_jax_params(_tree("cait"), tm.jax_stages), strict=True)
    seen = []
    orig = nn_attention.bernoulli

    def probe(keep, shape, generator, device):
        seen.append(orig(keep, shape, generator, device))
        return seen[-1]

    monkeypatch.setattr(nn_attention, "bernoulli", probe)
    monkeypatch.setattr(tcait, "bernoulli", probe)
    gates = []
    gated = tcait._CaiTBlock.gated_residual

    def spy(self, x, delta, scale, train, generator):
        out = gated(self, x, delta, scale, train, generator)
        keep = seen[-1]  # the gate's own draw
        assert keep.shape == (x.shape[0], 1, 1) and out.dtype == delta.dtype == torch.bfloat16
        # bf16 throughout: (delta * LayerScale) * keep / 0.75, then the add
        assert torch.equal(out, x + delta * scale.to(delta.dtype) * keep.to(delta.dtype) / 0.75)
        gates.append(keep)
        return out

    monkeypatch.setattr(tcait._CaiTBlock, "gated_residual", spy)
    x = torch.from_numpy(_images(3, 64)[0])
    with torch.no_grad():
        a = tm(x, train=True, generator=torch.Generator().manual_seed(5))
        draws = len(seen)
        b = tm(x, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and len(seen) == 2 * draws
    sites = [m for m in seen[:draws] if m.shape != (64, 1, 1)]
    assert len(gates) == 2 * 2 * 3 and len(sites) == 1 + 4 * 2 + 4 * 1
    kept = torch.cat([m.flatten() for m in gates[:6]]).float().mean().item()
    assert abs(kept - 0.75) <= 0.07, kept  # 384 draws: 4 standard deviations
    assert all(0 < int(m.sum()) < 64 for m in gates)
    kept, total = sum(int(m.sum()) for m in sites), sum(m.numel() for m in sites)
    assert abs(kept / total - 0.75) <= 0.01, kept / total


# -- AdamW steps against vit_tpu.train ------------------------------------------------

# tests/test_torch_train_zoo.py's rule: STEP_TOL on every value whose clipped
# gradient stayed at or above ADAM_TAU in each update, a tenth of one update
# on the rest; lr from warmup_cosine_schedule(ADAM_LR, 6, 0), whose first
# update is at ADAM_LR (no warmup: an update at lr 0 checks nothing). The
# exemption is Adam's: it divides each value by its own second moment, which
# magnifies sum-order noise in a near-zero gradient. muon divides a leaf by
# its whole norm before Newton-Schulz, so every value of a muon leaf is held
# to STEP_TOL. CaiT's patch-stage gradients pass its LayerScale (0.1) and
# the clip: 37-41% of its values fall under ADAM_TAU in some update, so
# KEPT_SHARE asks for half. Measured after three updates: at most 3.8e-7 off
# above ADAM_TAU, 1.2e-5 below it; every muon leaf at most 1.2e-7 off (CaiT
# and DeepViT); kept 58.6% (CaiT AdamW) to 97.2% (DeepViT).
STEP_TOL = 4e-6
ADAM_LR = 1e-3
ADAM_TAU = 1e-6
KEPT_SHARE = 0.5


def _no_layer_dropout(model):
    cls, cfg = MODELS[model]
    return cls, {k: v for k, v in cfg.items() if k != "layer_dropout"}


@functools.cache
def _jax_steps(model, name):
    """``vit_tpu.train.make_train_step`` in xla mode, fp32, with remat:
    three updates of optimizer ``name`` (lr ``warmup_cosine_schedule(ADAM_LR,
    6, 0)``, weight decay 0.05, clip 0.5) of the tiny ``model`` without
    dropout, on ``_images(1, 4)``. Each update's (parameters before it, its
    loss, parameters after it), kept for the file."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import models as jm
    from vit_tpu import train as jtrain

    cls, cfg = _no_layer_dropout(model)
    params = _tree(model)["params"]
    jopt = jtrain.make_optimizer(jtrain.warmup_cosine_schedule(ADAM_LR, 6, 0), name=name,
                                 grad_clip_norm=0.5)
    jstate = jtrain.TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
    jstep = jtrain.make_train_step(getattr(jm, cls.__name__)(**cfg), jopt, remat=True,
                                   backend="xla")
    img, labels = (jnp.asarray(a) for a in _images(1, 4))
    steps = []
    for _ in range(3):
        before = jax.device_get(jstate.params)
        jstate, jloss = jstep(jstate, img, labels)
        steps.append((before, float(jloss), jax.device_get(jstate.params)))
    return steps


def check_steps(model, name):
    """The port's parameters after 1 and 3 updates of optimizer ``name``
    against vit_tpu's (``_jax_steps``), within the rule above, at least
    KEPT_SHARE of the values held to STEP_TOL, every value of a muon leaf
    (``leaf_groups``' matrices) among them. The losses within 1e-5: the
    first on the same parameters; before the later updates the two sides'
    parameters differ at the near-zero gradients (moving the loss by up to
    1.1e-5), so there the port's forward runs on vit_tpu's parameters."""
    cls, cfg = _no_layer_dropout(model)
    tm = cls(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(_tree(model), tm.jax_stages), strict=True)
    opt = tt.make_optimizer(tt.warmup_cosine_schedule(ADAM_LR, 6, 0), name=name,
                            grad_clip_norm=0.5)
    state = tt.create_train_state(tm, opt, init=False)
    step = tt.make_train_step(tm, opt, remat=True)
    params = dict(tm.named_parameters())
    muon = {id(p) for rank, g in tt.leaf_groups(tm) if name == "muon" and rank == 2 for p in g}
    x, y = (torch.from_numpy(a) for a in _images(1, 4))
    gmin = {}
    for n, (jbefore, jloss, jafter) in enumerate(_jax_steps(model, name), start=1):
        if n > 1:
            before = cls(**cfg, device="cpu")
            before.load_state_dict(from_jax_params({"params": jbefore}, before.jax_stages))
            with torch.no_grad():
                loss = tt.cross_entropy_loss(before(x, train=True), y)
        own = step(state, x, y)
        assert abs(float(own if n == 1 else loss) - jloss) <= 1e-5, n
        for k, p in params.items():
            gmin[k] = p.grad.abs() if n == 1 else torch.minimum(gmin[k], p.grad.abs())
        if n in (1, 3):
            ref = from_jax_params({"params": jafter}, tm.jax_stages)
            held, over, kept = [], [], 0
            for k, p in params.items():
                err = (p.detach() - ref[k]).abs()
                big = torch.ones_like(err, dtype=torch.bool) if id(p) in muon else (
                    gmin[k] >= ADAM_TAU)
                kept += int(big.sum())
                held.append((float(err.masked_fill(~big, 0).max()), k))
                over.append((float(err.masked_fill(big, 0).max()), k))
            assert max(held)[0] <= STEP_TOL, (n, sorted(held)[-3:])
            assert max(over)[0] <= ADAM_LR / 10, (n, sorted(over)[-3:])
            assert kept >= KEPT_SHARE * sum(p.numel() for p in params.values()), n


@pytest.mark.parametrize("model", ["cait", "deepvit"])
def test_adamw_steps_match_jax(model):
    """1 and 3 AdamW updates against vit_tpu's (``check_steps``)."""
    check_steps(model, "adamw")


# -- init_params and the trainer --------------------------------------------------------


@pytest.mark.parametrize("model", ["cait", "deepvit"])
def test_init_params_matches_flax_init(model):
    """``init_params`` against vit_tpu's flax ``init`` at a CaiT of depth 2
    (LayerScale 0.1) and a DeepViT: the same names and shapes, the constants
    equal (LayerScales, reattn_scale / reattn_bias, LN, biases), the head
    mixes flax's untruncated ``normal(0.02)`` (pooled over the model: std
    within 10%, some value past two standard deviations), the rest as
    tests/test_torch_train_zoo.py holds them."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import models as jm

    cls, cfg = MODELS[model]
    cfg = dict(cfg, heads=16, dim=128, dim_head=8)
    jv = jax.device_get(jax.jit(getattr(jm, cls.__name__)(**cfg).init)(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3), jnp.float32)))
    tm = init_params(cls(**cfg, device="cpu"), torch.Generator().manual_seed(0))
    ref = from_jax_params(jv, tm.jax_stages)
    ours = {k: v.detach() for k, v in tm.state_dict().items()}
    assert sorted(ours) == sorted(ref)
    mixes, rmixes = [], []
    for k, r in ref.items():
        p = ours[k]
        assert p.shape == r.shape, k
        if r.min() == r.max():
            assert torch.equal(p, r), k
            continue
        if k.rsplit(".", 1)[-1] in ("mix_heads_pre", "mix_heads_post", "reattn_weights"):
            mixes.append(p.flatten())
            rmixes.append(r.flatten())
            continue
        fan_std = 0.02 * 0.87962566 if k in ("cls", "pos_embedding") else p.shape[0] ** -0.5
        assert float(p.abs().max()) <= 2 * fan_std / 0.87962566 * (1 + 1e-6), k
        assert abs(float(p.std()) - fan_std) <= 0.15 * fan_std, k
    mixes, rmixes = torch.cat(mixes), torch.cat(rmixes)
    assert mixes.numel() >= 512
    for t in (mixes, rmixes):
        assert abs(float(t.std()) - 0.02) <= 0.1 * 0.02
        assert float(t.abs().max()) > 2 * 0.02  # not truncated
    if model == "cait":
        assert torch.equal(ours["patch_stage.blocks.1.ls_ff"], torch.full((128,), 0.1))


@pytest.mark.parametrize("name", ["cait", "deepvit"])
def test_trainer_takes_both_families_and_its_cli_trains_them(name, capsys):
    """``_trainable`` takes CaiT and DeepViT; ``python -m vit_tpu_torch.train
    --model cait|deepvit`` trains the registry's tiny config on the CPU, at
    the registry's dropout and at ``dropout`` 0 with muon."""
    from vit_tpu_torch.models import MODEL_REGISTRY

    ctor, cfg, _ = MODEL_REGISTRY[name]
    assert callable(tt._trainable(ctor(**cfg, device="cpu"), 0.0, True))
    base = ["--device", "cpu", "--model", name, "--batch", "2", "--steps", "2", "--classes",
            "10", "--image-size", "32"]
    assert tt.main(base) == 0
    assert tt.main(base + ["--config", '{"dropout": 0.0}', "--optimizer", "muon"]) == 0
    assert capsys.readouterr().out.count("step 2: loss") == 2


def test_refuse_grad_points_at_the_new_functions():
    """Kernels 7 and 8 called raw under grad name the entry that
    differentiates them; kernels 9 and 10 say they have no Function."""
    leaf = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match=r"ops\.talking_heads_block "
                                                  r"\(TalkingHeadsBlockFn\)"):
        ops.fused_talking_heads_block(*[leaf] * 8, 1)
    with pytest.raises(NotImplementedError, match=r"ops\.reattention_block "
                                                  r"\(ReattentionBlockFn\)"):
        ops.fused_reattention_block(*[leaf] * 9, 1)
    i8 = torch.zeros(2, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="no autograd Function .*inference only"):
        ops.fused_quant_mlp(leaf, leaf, leaf, i8, leaf, leaf, i8, leaf, leaf)
    with pytest.raises(NotImplementedError, match="no autograd Function .*inference only"):
        ops.fused_quant_attention_block(leaf, leaf, leaf, i8, leaf, i8, leaf, leaf, 1)


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,residual", [("talking_heads_block", 64, False),
                                             ("talking_heads_block", 50, True),
                                             ("reattention_block", 65, True)])
def test_function_on_the_card_fills_every_gradient_and_matches_its_twin(cuda, kind, n,
                                                                         residual):
    """Each Function on the card in bf16: one launch of its kernel forward, a
    backward counted as one recompute, every gradient finite and within
    kernel_tol's form of autograd through the twin, the planted faults
    failing (``check_function``; kernel 8 at 65 tokens, padded to 80 on the
    card, with the padded recompute among them); the raw wrapper still
    raises under grad."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    args = cs.hm_inputs(gen, "th" if kind == "talking_heads_block" else "ra", 2, n, 256, 4, 64,
                        torch.bfloat16, cuda, rln_bias=0.5)
    kw = (dict(heads=4, scale=0.125, ln_eps=1e-5, residual=residual)
          if kind == "talking_heads_block" else
          dict(heads=4, scale=0.125, ln_eps=1e-6, reattn_eps=1e-6))
    g = torch.randn(args[0].shape, generator=gen, device=cuda).bfloat16()
    ops.reset_launch_counts()
    cs.check_function("card", kind, args, kw, g)
    assert ops.launch_counts()[kind] == 1 and ops.recompute_counts()[kind] == 1
    leaves = [a.detach().requires_grad_() for a in args]
    with pytest.raises(NotImplementedError, match=kind):
        getattr(ops, f"fused_{kind}")(*leaves, kw["heads"])


@pytest.mark.cuda
def test_a_card_step_fills_every_gradient(cuda):
    """The tiny CaiT (no dropout) and DeepViT in bf16 on the card under grad:
    every parameter's gradient finite, the launches and recomputes
    ``head_mix_train_counts`` gives; a CaiT at dropout 0.1 launches no
    kernel 7."""
    for model in ("cait", "deepvit", "cait drop"):
        cls, cfg = MODELS[model]
        tm = init_params(cls(**cfg, dtype=torch.bfloat16, device=cuda),
                         torch.Generator(cuda).manual_seed(0))
        x = torch.randn(2, 32, 32, 3, device=cuda)
        ops.reset_launch_counts()
        tt.cross_entropy_loss(tm(x, train=True, generator=torch.Generator(cuda).manual_seed(1),
                                 remat=True), torch.arange(2, device=cuda)).backward()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        if model == "cait drop":
            assert "talking_heads_block" not in launches, launches
        else:
            want, recomputes = cs.head_mix_train_counts(tm, True)
            assert launches == want, model
            assert {k: v for k, v in ops.recompute_counts().items() if v} == recomputes, model
        for name, p in tm.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), (model, name)


@pytest.mark.cuda
def test_kernels_nine_and_ten_still_raise_under_grad_on_the_card(cuda):
    qb = importlib.import_module("vit_tpu_torch.ops.quant_block")
    d, hd = 64, 64
    t = lambda *s: torch.randn(*s, device=cuda, requires_grad=True)
    i8 = lambda *s: torch.zeros(*s, dtype=torch.int8, device=cuda)
    x = torch.randn(2, 8, d, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="inference only"):
        qb.fused_quant_attention_block(x, t(d), t(d), i8(3 * hd, d), t(3 * hd), i8(d, hd), t(d),
                                       t(d), 4)
    with pytest.raises(NotImplementedError, match="inference only"):
        qb.fused_quant_mlp(x, t(d), t(d), i8(128, d), t(128), t(128), i8(d, 128), t(d), t(d))
