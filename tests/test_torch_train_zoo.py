"""Training Twins-SVT and T2T-ViT: the autograd Functions of kernels 3-6 and
the bf16 ``Dense`` backward against vit_tpu's on the CPU, the two models'
gradients and AdamW steps against ``jax.value_and_grad`` and
``vit_tpu.train``, and the Functions on the card.

The tiny models run on the port's two routes: the CPU's (autograd through
the twins) and the card's (``_KernelsAsTwins``: the twins in the kernels'
places, so that the autograd Functions of kernels 1-6 and ``MmRoundedFn``
run, with the launches and recomputes a step that
``chip_smoke.zoo_train_counts`` gives).

CPU tests feed the same numpy inputs (``default_rng(seed)``) through both
packages. Each Function runs with its twin as the forward (the kernels run
only on the card) against ``jax.vjp`` of vit_tpu's op in interpret mode,
whose custom VJP runs the backward the Function ports: the recompute of the
XLA twin for kernels 3 and 6, the Q-chunked ``_flash_bwd`` for kernels 4
and 5. The card tests carry the ``cuda`` marker: ``python -m pytest
--noconftest -m cuda tests/test_torch_train_zoo.py``.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from vit_tpu_torch import ops
from vit_tpu_torch import train as tt
from vit_tpu_torch.models import T2TViT, TwinsSVT
from vit_tpu_torch.nn import Dense
from vit_tpu_torch.utils import from_jax_params, init_params

tfa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
tqa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
twa = importlib.import_module("vit_tpu_torch.ops.window_attention")
tembed = importlib.import_module("vit_tpu_torch.nn.embed")

torch.set_num_threads(2)

# Relative L2 of each gradient against vit_tpu's: tests/test_torch_train.py's
# OP_TOL for kernels 1 and 2. fp32: the same formulas on the same inputs,
# summed in other orders: 1e-5 (measured <= 5.4e-7). bf16: both sides run the
# same backward on inputs rounded alike, but their forwards (the port's twin,
# vit_tpu's interpret-mode kernel) and the gradients' casts to bf16 round
# apart by an ulp here and there, and flash's dS = p (dP - delta) subtracts
# nearly equal rows, which turns one ulp of out into more of dS: 2e-2, about
# three bf16 ulps (2^-8 each) of relative error; measured <= 1.3e-4 (flash),
# 3.5e-5 (kernel 3), 3.8e-7 (kernel 6), 4.5e-3 (a Dense bias's bf16 sum).
OP_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _rel(a, b):
    """Relative L2 distance of ``a`` from the reference ``b``."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _torch(arrays, dtypes):
    return [None if a is None else torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dt)) for a, dt in zip(arrays, dtypes)]


def _jax(arrays, dtypes):
    import jax.numpy as jnp

    return [None if a is None else jnp.asarray(np.asarray(a, np.float32)).astype(
        getattr(jnp, dt)) for a, dt in zip(arrays, dtypes)]


def _jax_vjp(f, arrays, dtypes, g):
    """``jax.vjp`` of ``f`` over the arrays present, at cotangent ``g`` (in
    the first array's dtype); None in the absent arrays' places."""
    import jax

    jargs = _jax(arrays, dtypes)
    idx = [i for i, a in enumerate(jargs) if a is not None]

    def fn(*present):
        full = list(jargs)
        for i, a in zip(idx, present):
            full[i] = a
        return f(*full)

    _, vjp = jax.vjp(fn, *[jargs[i] for i in idx])
    ref = iter(vjp(_jax([g], [dtypes[0]])[0]))
    return [next(ref) if i in idx else None for i in range(len(arrays))]


def _function_grads(kind, arrays, dtypes, kw, g):
    """The Function of ``kind`` with its twin forward: gradients at ``g``."""
    args = _torch(arrays, dtypes)
    return cs.function_grads(kind, args, kw, torch.from_numpy(g).to(args[0].dtype),
                             forward=cs.twin_forward(kind))


def _assert_grads(kind, grads, ref, dtype):
    for name, a, b in zip(cs.ALL_FN_ARGS[kind], grads, ref):
        if b is None:
            assert a is None, name
            continue
        assert _rel(a, b) <= OP_TOL[dtype], (name, _rel(a, b))


# -- kernels 4 and 5: FlashAttentionFn ----------------------------------------------

# (b, h, nq, nk, d, dv, bias shape or None, mask_self): no bias, [1, H, N, N]
# and [B, 1, N, N]; mask_self; Nq != Nk with Dv != D; Nq 300, past BLOCK_Q
# (256) and not a multiple of it, so that the last chunk is padded.
FLASH_CASES = {
    "no bias": (2, 3, 40, 40, 16, 16, None, False),
    "bias [1,H,N,N]": (2, 3, 40, 40, 16, 16, (1, 3), False),
    "bias [B,1,N,N], mask_self": (2, 3, 40, 40, 16, 16, (2, 1), True),
    "Nq != Nk, Dv != D": (2, 2, 33, 49, 16, 32, (2, 2), False),
    "Nq 300 padded, bias [1,1,Nq,Nk], mask_self": (1, 2, 300, 40, 16, 16, (1, 1), True),
}
KV_CASES = {
    "bias [B,1,Nq,Nk], mask_self, D 24": (2, 2, 40, 70, 24, 24, (2, 1), True),
    "Nq 300 padded, Dv != D": (1, 1, 300, 150, 16, 24, None, False),
}


def _flash_arrays(seed, case):
    b, h, nq, nk, d, dv, bshape, mask = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, h, nq, d)), rng.standard_normal((b, h, nk, d)),
              rng.standard_normal((b, h, nk, dv)),
              None if bshape is None else rng.standard_normal((*bshape, nq, nk))]
    return arrays, rng.standard_normal((b, h, nq, dv)).astype(np.float32), dict(
        scale=0.3, mask_self=mask)


def _jax_flash(kind, kw):
    jfa = importlib.import_module("vit_tpu.ops.flash_attention")

    fn = jfa.flash_attention if kind == "flash_attention" else jfa.flash_attention_kv_blocked
    return lambda q, k, v, bias: fn(q, k, v, bias, scale=kw["scale"],
                                    mask_self=kw["mask_self"], interpret=True)


FLASH_JAX_CASES = (
    [("flash_attention", c, "float32") for c in FLASH_CASES]
    + [("flash_attention_kv_blocked", c, "float32") for c in KV_CASES]
    + [("flash_attention", "bias [1,H,N,N]", "bfloat16"),
       ("flash_attention", "Nq 300 padded, bias [1,1,Nq,Nk], mask_self", "bfloat16"),
       ("flash_attention_kv_blocked", "bias [B,1,Nq,Nk], mask_self, D 24", "bfloat16")])


@pytest.mark.parametrize("kind,case,dtype", FLASH_JAX_CASES)
def test_flash_function_grads_match_jax(kind, case, dtype):
    """``FlashAttentionFn`` (``flash_backward``) against ``jax.vjp`` of
    vit_tpu's kernel 4 or 5 in interpret mode, whose custom VJP is
    ``_flash_bwd``; the bias in fp32, q, k, v in ``dtype``."""
    arrays, g, kw = _flash_arrays(1, {**FLASH_CASES, **KV_CASES}[case])
    dtypes = [dtype] * 3 + ["float32"]
    ref = _jax_vjp(_jax_flash(kind, kw), arrays, dtypes, g)
    grads = _function_grads(kind, arrays, dtypes, kw, g)
    assert [None if a is None else a.dtype for a in grads] == [
        None if a is None else getattr(torch, dt) for a, dt in zip(arrays, dtypes)]
    _assert_grads(kind, grads, ref, dtype)


@pytest.mark.parametrize("kind,case", [("flash_attention", c) for c in FLASH_CASES]
                         + [("flash_attention_kv_blocked", c) for c in KV_CASES])
def test_flash_backward_equals_autograd_through_the_twin(kind, case):
    """In fp32 ``flash_backward`` and autograd through ``reference_attention``
    / ``reference_attention_kv_blocked`` compute one function in two sum
    orders: within 1e-5 relative L2 (measured <= 3e-7)."""
    arrays, g, kw = _flash_arrays(2, {**FLASH_CASES, **KV_CASES}[case])
    args = _torch(arrays, ["float32"] * 4)
    gt = torch.from_numpy(g)
    grads = cs.function_grads(kind, args, kw, gt, forward=cs.twin_forward(kind))
    ref = cs.twin_grads(kind, args, kw, gt)
    _assert_grads(kind, grads, ref, "float32")


def test_flash_backward_chunks_by_block_q_and_counts_its_kernel():
    """The backward holds one chunk of BLOCK_Q queries at a time (``s`` of
    ``[B, H, BLOCK_Q, Nk]``); its Function counts a recompute of the kernel
    the shape dispatches to."""
    seen = []
    orig = tfa._bmm_f32

    def spy(a, b):
        seen.append(tuple(a.shape))
        return orig(a, b)

    arrays, g, kw = _flash_arrays(3, FLASH_CASES["Nq 300 padded, bias [1,1,Nq,Nk], mask_self"])
    args = _torch(arrays, ["float32"] * 4)
    ops.reset_launch_counts()
    try:
        tfa._bmm_f32 = spy
        cs.function_grads("flash_attention", args, kw, torch.from_numpy(g),
                          forward=cs.twin_forward("flash_attention"))
    finally:
        tfa._bmm_f32 = orig
    assert seen == [(2, tfa.BLOCK_Q, 16)] * 2
    assert {k: v for k, v in ops.recompute_counts().items() if v} == {"flash_attention": 1}
    assert tfa.kernel_name(1300, 200, 300) == "flash_attention_kv_blocked"


@pytest.mark.parametrize("fault", cs.FLASH_BWD_FAULTS)
def test_flash_backward_faults_fail_the_bound(fault):
    """Each planted fault of the flash backward moves a gradient past the
    fp32 bound against vit_tpu's (the case has all that they need: a bias
    broadcast over 2 heads, mask_self, a padded last chunk)."""
    arrays, g, kw = _flash_arrays(4, FLASH_CASES["Nq 300 padded, bias [1,1,Nq,Nk], mask_self"])
    args = _torch(arrays, ["float32"] * 4)
    assert cs.flash_faults(args, kw) == list(cs.FLASH_BWD_FAULTS)
    ref = _jax_vjp(_jax_flash("flash_attention", kw), arrays, ["float32"] * 4, g)
    good = cs.function_grads("flash_attention", args, kw, torch.from_numpy(g),
                             forward=cs.twin_forward("flash_attention"))
    _assert_grads("flash_attention", good, ref, "float32")
    bad = cs.faulty_grads("flash_attention", args, kw, torch.from_numpy(g), fault)
    assert any(_rel(a, b) > OP_TOL["float32"] for a, b in zip(bad, ref) if b is not None)


# -- kernel 3: QkvAttentionFn --------------------------------------------------------

QKV_BIAS = {"no bias": None, "bias [1,H,N,N]": (1, 4), "bias [B,1,N,N]": (2, 1)}


@pytest.mark.parametrize("bias,dtype", [(b, "float32") for b in QKV_BIAS]
                         + [("bias [B,1,N,N]", "bfloat16")])
def test_qkv_function_grads_match_jax(bias, dtype):
    """``QkvAttentionFn`` (the twin recomputed) against ``jax.vjp`` of
    vit_tpu's ``fused_qkv_attention`` in interpret mode (``_qkv_attention_bwd``),
    with ``dbias`` summed over the bias's broadcast axes; the planted fault
    (dq and dk swapped) fails the bound."""
    jqa = importlib.import_module("vit_tpu.ops.qkv_attention")

    rng = np.random.default_rng(5)
    b, n, heads, d = 2, 24, 4, 16
    bshape = QKV_BIAS[bias]
    arrays = [rng.standard_normal((b, n, 3 * heads * d)),
              None if bshape is None else rng.standard_normal((*bshape, n, n))]
    g = rng.standard_normal((b, n, heads * d)).astype(np.float32)
    kw = dict(heads=heads, scale=d**-0.5)
    dtypes = [dtype, "float32"]
    ref = _jax_vjp(lambda qkv, bb: jqa.fused_qkv_attention(qkv, heads, bb, scale=kw["scale"],
                                                           interpret=True), arrays, dtypes, g)
    grads = _function_grads("qkv_attention", arrays, dtypes, kw, g)
    _assert_grads("qkv_attention", grads, ref, dtype)
    args = _torch(arrays, dtypes)
    bad = cs.faulty_grads("qkv_attention", args, kw, torch.from_numpy(g).to(args[0].dtype),
                          cs.QKV_BWD_FAULTS[0])
    assert _rel(bad[0], ref[0]) > OP_TOL[dtype]


# -- kernel 6: WindowAttentionBlockFn -------------------------------------------------

WINDOW_CASES = {"no bias": (16, None), "bias [H,S,S]": (16, (2,)), "bias [1,S,S], S 49": (49, (1,))}


@pytest.mark.parametrize("case,dtype", [("no bias", "float32"), ("bias [1,S,S], S 49", "float32"),
                                        ("bias [H,S,S]", "bfloat16")])
def test_window_function_grads_match_jax(case, dtype):
    """``WindowAttentionBlockFn`` (the twin recomputed) against ``jax.vjp``
    of vit_tpu's kernel in interpret mode (``_wab_bwd``): xw and the weights
    in ``dtype``, the LayerNorm parameters, biases and window bias fp32; the
    bias's gradient where it has one (CrossFormer's reaches its DPB MLPs)."""
    jwa = importlib.import_module("vit_tpu.ops.window_attention")

    s, bshape = WINDOW_CASES[case]
    nw, c, heads, d = 3, 32, 2, 16
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal((nw, s, c)), 1.0 + 0.1 * rng.standard_normal(c),
              0.1 * rng.standard_normal(c), rng.standard_normal((c, 3 * heads * d)) / c**0.5,
              rng.standard_normal((heads * d, c)) / (heads * d) ** 0.5,
              0.1 * rng.standard_normal(c),
              None if bshape is None else rng.standard_normal((*bshape, s, s))]
    g = rng.standard_normal((nw, s, c)).astype(np.float32)
    kw = dict(heads=heads, scale=d**-0.5, ln_eps=1e-5)
    dtypes = [dtype, "float32", "float32", dtype, dtype, "float32", "float32"]
    ref = _jax_vjp(lambda *a: jwa.fused_window_attention_block(
        *a[:6], heads, a[6], scale=kw["scale"], ln_eps=1e-5, interpret=True), arrays, dtypes, g)
    grads = _function_grads("window_attention_block", arrays, dtypes, kw, g)
    _assert_grads("window_attention_block", grads, ref, dtype)


# -- the bf16 Dense backward ---------------------------------------------------------


@pytest.mark.parametrize("route", ["autograd", "MmRoundedFn"])
def test_bf16_dense_backward_matches_flax(route):
    """A bf16 ``Dense`` against ``jax.vjp`` of flax's ``Dense(dtype=
    bfloat16)``: flax rounds the product and its two transposes (bf16 dots of
    the bf16 cotangent) once each, and so do the CPU's autograd of ``_mm``
    and ``MmRoundedFn`` (the card's route: its bf16 products here on the
    CPU's bf16 matmul). Every gradient within OP_TOL's bf16 bound
    (measured 0 for x and the kernel; 4.5e-3 for the bias, whose bf16 sum
    over the 18 rows rounds in another order)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    g = rng.standard_normal((2, 9, 24)).astype(np.float32)
    fdense = fnn.Dense(24, dtype=jnp.bfloat16)
    variables = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(fdense.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    out, vjp = jax.vjp(lambda v, a: fdense.apply(v, a), variables, jnp.asarray(x).astype(
        jnp.bfloat16))
    dvars, dx = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    dense = Dense(48, 24, dtype=torch.bfloat16, device="cpu")
    dense.load_state_dict(from_jax_params(variables, {}), strict=True)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    if route == "MmRoundedFn":
        y = tembed.MmRoundedFn.apply(xt, dense.kernel.bfloat16()) + dense.bias.bfloat16()
    else:
        y = dense(xt)
    assert y.dtype == torch.bfloat16 and torch.equal(y.float(), torch.from_numpy(
        np.asarray(out, np.float32)))
    y.backward(torch.from_numpy(g).bfloat16())
    assert dense.kernel.grad.dtype == torch.float32
    assert _rel(xt.grad, dx) <= OP_TOL["bfloat16"], _rel(xt.grad, dx)
    for name, p in dense.named_parameters():
        ref = dvars["params"][name]
        assert _rel(p.grad, ref) <= OP_TOL["bfloat16"], (name, _rel(p.grad, ref))


# -- the tiny models: loss and gradients against jax.value_and_grad --------------------


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    perturb = lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else perturb(v) for k, v in t.items()}
    return walk(tree)


MODELS = {"twins": "twins_svt", "t2t depth 1": "t2t", "t2t depth 2": "t2t"}


@functools.cache
def _tiny(model):
    """(port class, vit_tpu class, config, image size, variables tree) of a
    tiny config of vit_tpu's registry (Twins: every stage at depth 1; T2T at
    encoder depth 1, unscanned, and 2, scanned), weights drawn by
    chip_smoke's tree builders and perturbed. Cached: every test of a
    model reads the same tree and none writes to it."""
    from vit_tpu.models import MODEL_REGISTRY

    jcls, cfg, size = MODEL_REGISTRY[MODELS[model]]
    if model == "twins":
        return TwinsSVT, jcls, dict(cfg), size, _perturbed(cs.twins_tree(cfg, 1), 2)
    cfg = dict(cfg, depth=int(model[-1]))
    return T2TViT, jcls, cfg, size, _perturbed(cs.t2t_tree(cfg, seed=3), 4)


def _images(seed, b, size):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, size, size, 3)).astype(np.float32), rng.integers(0, 10, b)


def _port(model, precision, tree):
    cls, _, cfg, _, _ = _tiny(model)
    tm = cls(**cfg, dtype=None if precision == "fp32" else torch.bfloat16, device="cpu")
    tm.load_state_dict(from_jax_params(tree, tm.jax_stages), strict=True)
    return tm


_JAX_GRADS = {}


def _jax_loss_and_grads(model, precision, mode):
    """``jax.value_and_grad`` of vit_tpu's tiny model's cross-entropy in
    training mode under ``mode`` (jitted; kept for the file's tests)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops
    from vit_tpu import train as jtrain

    key = (model, precision, mode)
    if key not in _JAX_GRADS:
        _, jcls, cfg, size, tree = _tiny(model)
        img, labels = _images(0, 2, size)
        jm = jcls(**cfg, dtype=None if precision == "fp32" else jnp.bfloat16)

        def loss_fn(params):
            with jops.force_backend(mode):
                logits = jm.apply({"params": params}, jnp.asarray(img), True)
            return jtrain.cross_entropy_loss(logits, jnp.asarray(labels))

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tree["params"])
        _JAX_GRADS[key] = float(loss), jax.device_get(grads)
    return _JAX_GRADS[key]


class _KernelsAsTwins:
    """Runs the card's route on the CPU: ``ops._use_kernel`` true, each
    kernel wrapper replaced by its twin, so the ops entries go through the
    autograd Functions (and a bf16 ``Dense`` through ``MmRoundedFn``);
    ``calls`` counts each kernel's would-be launches."""

    NAMES = {"fused_attention_block": "attention_block", "fused_mlp": "fused_mlp",
             "fused_qkv_attention": "qkv_attention", "flash_attention": "flash_attention",
             "flash_attention_kv_blocked": "flash_attention_kv_blocked",
             "fused_window_attention_block": "window_attention_block"}

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.NAMES.values(), 0)
        monkeypatch.setattr(ops, "_use_kernel", lambda x: True)
        for wrapper, kind in self.NAMES.items():
            monkeypatch.setattr(ops, wrapper, self._counting(kind, cs.twin_forward(kind)))

    def _counting(self, kind, twin):
        if kind == "attention_block":
            plain = twin

            def twin(x, s, b, wq, wo, bo, heads, scale=None, ln_eps=1e-6, true_n=None,
                     block_tokens=None):
                return plain(x, s, b, wq, wo, bo, heads, scale, ln_eps, true_n, block_tokens)

        def run(*a, **kw):
            self.calls[kind] += 1
            return twin(*a, **kw)
        return run

    def launched(self):
        return {k: v for k, v in self.calls.items() if v}


# Loss and gradients against vit_tpu's. fp32 (tests/test_torch_train.py's
# MODEL_TOL): 1e-5 relative L2 a parameter and 1e-5 on the loss (measured
# <= 5.2e-6 and 3.6e-6). The query projection of Twins' stage-4 GSA, whose
# softmax runs over one key, has a gradient of exactly zero, and each side
# gives rounding noise there (vit_tpu's 0 in xla mode, 6e-7 in interpret
# mode; the largest gradient norm is 52): a gradient whose norm in vit_tpu is
# at most 1e-6 of the largest is held to that size. bf16: the bound of
# tests/test_torch_t2t.py and tests/test_torch_twins.py, held to vit_tpu's
# own two CPU modes: a parameter's gradient within twice the larger of the
# distance between vit_tpu's xla and interpret gradients and 0.04
# (test_torch_train.py's bf16 gradient bound), the loss within twice the
# larger of their loss gap and 0.02 (test_torch_t2t.py's logit floor: the
# loss moves with the logits). vit_tpu's two modes round apart (XLA's fused
# bf16 chains against the kernels' rounding sites) and the port follows
# each mode's sites only in part, so one bf16 value moved upstream reaches
# every gradient below it. Measured: Twins' worst gradient 0.126 off
# (vit_tpu's own modes up to 0.087 apart), its loss 0.080 (0.050); T2T's
# 0.018 (0.014) and 0.014 (0.0064). test_torch_train.py's 4e-3 on the loss
# held for ViT, not here.
BF16_FLOOR = (4e-2, 2e-2)


# fp32 in vit_tpu's xla mode, on both routes: its interpret mode's fp32
# gradients are the same within sum order, so a second mode adds no check at
# 1e-5. bf16 in both modes (the bound needs their gap) on the card's route,
# the one that trains on the card; the CPU's route is held in fp32, and its
# bf16 Dense backward by test_bf16_dense_backward_matches_flax.
MODEL_CASES = ([(m, "fp32", "xla", route) for m in MODELS for route in ("twins", "functions")]
               + [(m, "bf16", mode, "functions") for m in MODELS
                  for mode in ("xla", "interpret")])


@pytest.mark.parametrize("model,precision,mode,route", MODEL_CASES)
def test_loss_and_grads_match_jax(model, precision, mode, route, monkeypatch):
    """The tiny model's loss and every parameter's gradient against
    ``jax.value_and_grad`` of vit_tpu's in its CPU modes (``MODEL_CASES``);
    the port on the CPU's route (autograd through the twins) and on the
    card's (``_KernelsAsTwins``: the Functions, with the launches and
    recomputes a step that ``chip_smoke.zoo_train_counts`` gives)."""
    *_, size, tree = _tiny(model)
    img, labels = _images(0, 2, size)
    jloss, jgrads = _jax_loss_and_grads(model, precision, mode)
    tm = _port(model, precision, tree)
    if route == "functions":
        kernels = _KernelsAsTwins(monkeypatch)
    ops.reset_launch_counts()
    loss = tt.cross_entropy_loss(tm(torch.from_numpy(img), train=True, remat=True),
                                 torch.from_numpy(labels))
    loss.backward()
    if route == "functions":
        launches, recomputes = cs.zoo_train_counts(tm)
        assert kernels.launched() == launches
        assert {k: v for k, v in ops.recompute_counts().items() if v} == recomputes
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    if precision == "fp32":
        gtol = {k: 1e-5 for k in ref}
        ltol = 1e-5
    else:
        oloss, ograds = _jax_loss_and_grads(model, precision,
                                            "interpret" if mode == "xla" else "xla")
        other = from_jax_params({"params": ograds}, tm.jax_stages)
        gtol = {k: 2 * max(_rel(other[k], ref[k]), BF16_FLOOR[0]) for k in ref}
        ltol = 2 * max(abs(oloss - jloss), BF16_FLOOR[1])
    assert abs(loss.item() - jloss) <= ltol, (loss.item(), jloss)
    params = tm.state_dict(keep_vars=True)  # Twins' state dict names its `global_` `global`
    assert sorted(params) == sorted(ref)
    zero = 1e-6 * max(float(np.linalg.norm(_np(r))) for r in ref.values())
    for name, p in params.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        if float(np.linalg.norm(_np(ref[name]))) <= zero:
            assert float(np.linalg.norm(_np(p.grad))) <= zero, name
            continue
        assert _rel(p.grad, ref[name]) <= gtol[name], (name, _rel(p.grad, ref[name]))


# -- AdamW steps against vit_tpu.train -------------------------------------------------


# AdamW against vit_tpu.train: tests/test_torch_train.py's STEP_TOL on every
# value whose clipped gradient stayed at or above ADAM_TAU in each update so
# far, and a tenth of one update (ADAM_LR / 10) on the rest. Adam's first
# update moves a value by lr * g / (|g| + eps), eps 1e-8, so a gradient off
# by dg moves it by lr * eps * dg / (|g| + eps)^2: with fp32 sum-order noise
# dg ~ 1e-9, under 1e-8 lr where |g| >= ADAM_TAU = 100 eps, but dg / (4 eps)
# of an update where |g| is near eps, a tenth of one at dg = 4e-9. The tiny
# models hold such near-zero gradients (Twins' GSA projections, T2T's proj
# and tokenizer): 10% of Twins' values, 4% of T2T's. Measured after three
# updates: at most 3.6e-7 off above ADAM_TAU; below it 7.5e-6 (Twins'
# stage-1 GSA to_kv, its gradient 1.8e-9) and 4.4e-6 (T2T's proj, 3e-9).
# lr 1e-4, not test_torch_train's 1e-3: at 1e-3 the tiny Twins fits its
# four images in two updates (loss 9.03, 2.14, 5e-7), after which its
# gradients are rounding noise and a third update compares nothing.
STEP_TOL = 4e-6
ADAM_LR = 1e-4
ADAM_TAU = 1e-6


@pytest.mark.parametrize("model", ["twins", "t2t depth 2"])
def test_adamw_steps_match_jax(model):
    """Parameters after 1 and 3 AdamW updates (constant lr ADAM_LR, weight
    decay 0.05, clip 0.5: every update here is clipped) against
    ``vit_tpu.train.make_train_step`` in xla mode, fp32, with remat, within
    the bounds above, at least 80% of the values held to STEP_TOL. The
    losses within 1e-5: the first on the same parameters; before the later
    updates the two sides' parameters differ at the near-zero gradients,
    which moves the loss by up to 2.9e-5 (Twins), so there the port's
    forward runs on vit_tpu's parameters (measured <= 2.2e-6 off)."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import train as jtrain

    _, jcls, cfg, size, tree = _tiny(model)
    img, labels = _images(1, 4, size)
    jopt = jtrain.make_optimizer(ADAM_LR, name="adamw", grad_clip_norm=0.5)
    jstate = jtrain.TrainState(tree["params"], jopt.init(tree["params"]),
                               jnp.zeros((), jnp.int32))
    jstep = jtrain.make_train_step(jcls(**cfg), jopt, remat=True, backend="xla")
    tm = _port(model, "fp32", tree)
    opt = tt.make_optimizer(ADAM_LR, name="adamw", grad_clip_norm=0.5)
    state = tt.create_train_state(tm, opt, init=False)
    step = tt.make_train_step(tm, opt, remat=True)
    x, y = torch.from_numpy(img), torch.from_numpy(labels)
    params = tm.state_dict(keep_vars=True)
    gmin = {}
    for n in range(1, 4):
        if n > 1:
            before = _port(model, "fp32", {"params": jax.device_get(jstate.params)})
            with torch.no_grad():
                loss = tt.cross_entropy_loss(before(x, train=True), y)
        jstate, jloss = jstep(jstate, jnp.asarray(img), jnp.asarray(labels))
        own = step(state, x, y)
        assert abs(float(own if n == 1 else loss) - float(jloss)) <= 1e-5, n
        for k, p in params.items():  # the clipped gradient that this update used
            gmin[k] = p.grad.abs() if n == 1 else torch.minimum(gmin[k], p.grad.abs())
        if n in (1, 3):
            ref = from_jax_params({"params": jax.device_get(jstate.params)}, tm.jax_stages)
            held, over, kept = [], [], 0
            for k, p in params.items():
                err, big = (p.detach() - ref[k]).abs(), gmin[k] >= ADAM_TAU
                kept += int(big.sum())
                held.append((float(err.masked_fill(~big, 0).max()), k))
                over.append((float(err.masked_fill(big, 0).max()), k))
            assert max(held)[0] <= STEP_TOL, (n, sorted(held)[-3:])
            assert max(over)[0] <= ADAM_LR / 10, (n, sorted(over)[-3:])
            assert kept >= 0.8 * sum(p.numel() for p in params.values()), n


# -- dropout -------------------------------------------------------------------------


def _dropout_model(model, rate):
    cls, _, cfg, _, tree = _tiny(model)
    extra = dict(dropout=rate) if model == "twins" else dict(dropout=rate, emb_dropout=rate)
    tm = cls(**cfg, **extra, device="cpu")
    tm.load_state_dict(from_jax_params(tree, tm.jax_stages), strict=True)
    return tm


@pytest.mark.parametrize("model", ["twins", "t2t depth 2"])
def test_dropout_zero_trains_as_eval_and_a_rate_drops_and_scales(model, monkeypatch):
    """Train mode with dropout 0 is eval bit for bit. With a rate of 0.25,
    every site that vit_tpu drops at (Twins: each attention's output and
    each ConvMLP's two; T2T: the embedding and every layer's attention
    probabilities, output and MLP) keeps 75% of its values, each scaled by
    1 / 0.75, and a generator seeded alike repeats the loss bit for bit."""
    nn_attention = importlib.import_module("vit_tpu_torch.nn.attention")

    size = _tiny(model)[3]
    x = torch.from_numpy(_images(2, 2, size)[0])
    tm = _dropout_model(model, 0.0)
    with torch.no_grad():
        assert torch.equal(tm(x), tm(x, train=True, generator=torch.Generator().manual_seed(0)))
    seen = []
    orig = nn_attention.dropout

    def probe(t, rate, generator):
        y = orig(t, rate, generator)
        if rate:
            kept = y != 0
            seen.append((int(kept.sum()), kept.numel()))
            assert torch.equal(y[kept], (t / (1 - rate))[kept])
        return y

    for mod in ("vit_tpu_torch.nn.attention", "vit_tpu_torch.nn.blocks",
                "vit_tpu_torch.models.twins_svt", "vit_tpu_torch.models.t2t"):
        m = importlib.import_module(mod)
        for attr in ("dropout", "apply_dropout"):
            if getattr(m, attr, None) is orig:
                monkeypatch.setattr(m, attr, probe)
    tm = _dropout_model(model, 0.25)
    gen = lambda: torch.Generator().manual_seed(3)
    with torch.no_grad():
        a = tm(x, train=True, generator=gen())
        sites = len(seen)
        b = tm(x, train=True, generator=gen())
        assert not torch.equal(a, tm(x))
    assert torch.equal(a, b)
    cfg = _tiny(model)[2]
    if model == "twins":  # each attention's output, each ConvMLP's drop1 and drop2
        local = 2 * sum(cfg[f"s{s}_depth"] for s in (1, 2, 3))
        layers = local + 2 * cfg["s4_depth"]
        assert sites == local + layers + 2 * (local + layers)
    else:  # the embedding; a tokenizer layer's probabilities (it has no output
        # projection) and MLP; an encoder layer's probabilities, output and MLP
        assert sites == 1 + 3 * (len(cfg["t2t_layers"]) - 1) + 4 * cfg["depth"]
    kept, total = (sum(c) for c in zip(*seen[:sites]))
    assert abs(kept / total - 0.75) <= 0.01, kept / total
    assert all(abs(k / n - 0.75) <= 0.15 for k, n in seen[:sites]), seen


# -- init_params against flax's init ------------------------------------------------


@pytest.mark.parametrize("model", ["twins", "t2t depth 2"])
def test_init_params_matches_flax_init_in_shape_and_distribution(model):
    """``init_params`` against vit_tpu's flax ``init``: the same names and
    shapes (``jax.eval_shape``), and each tensor's distribution as
    tests/test_torch_train.py holds ViT's: constants equal, the rest within
    sampling error of the initializer's standard deviation, mean near 0,
    truncated at 2 standard deviations, conv kernels at lecun_normal over
    ``I * kh * kw`` (flax's ``kh * kw * in / groups``). Tensors of fewer
    than 1,000 values (PEG's depthwise kernels here) are held to the
    truncation bound only: the spread of so few samples' deviation exceeds
    the 10% the others are held to."""
    import jax
    import jax.numpy as jnp

    cls, jcls, cfg, size, _ = _tiny(model)
    img = jnp.zeros((1, size, size, 3), jnp.float32)
    init = jax.jit(jcls(**cfg).init)
    shapes = jax.eval_shape(init, {"params": jax.random.PRNGKey(0)}, img)
    jv = jax.device_get(init({"params": jax.random.PRNGKey(0)}, img))
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(np.shape, jv)
    tm = init_params(cls(**cfg, device="cpu"), torch.Generator().manual_seed(0))
    ref = from_jax_params(jv, tm.jax_stages)
    ours = {k: v.detach() for k, v in tm.state_dict().items()}
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        p = ours[k]
        assert p.shape == r.shape, k
        if r.std() == 0:
            assert torch.equal(p, r), k
            continue
        fan_std = 0.02 * 0.87962566 if k.split(".")[-1] in ("cls", "pos_embedding") else (
            p[0].numel() if p.dim() == 4 else p.shape[0]) ** -0.5
        assert float(p.abs().max()) <= 2 * fan_std / 0.87962566 * (1 + 1e-6), k
        assert float(r.abs().max()) <= 2 * fan_std / 0.87962566 * (1 + 1e-6), k
        if p.numel() < 1000:
            continue
        assert abs(float(p.std()) - float(r.std())) <= 0.1 * float(r.std()), k
        assert abs(float(p.std()) - fan_std) <= 0.1 * fan_std, k
        assert abs(float(p.mean())) <= 0.1 * fan_std, k


def test_init_params_refuses_unknown_parameters_with_the_roadmap_item():
    """The small-dataset ViT, whose ``log_temperature`` raised here before,
    initializes now; a parameter of no family's name still raises, saying
    what ``init_params`` covers."""
    from vit_tpu_torch.models import MODEL_REGISTRY, ViTSmallDatasets

    init_params(ViTSmallDatasets(**MODEL_REGISTRY["vit_small_datasets"][1], device="cpu"),
                torch.Generator())
    with pytest.raises(NotImplementedError, match="the 18 families of vit_tpu_torch.models and "
                                                  "of ViTMoE"):
        init_params(torch.nn.Conv2d(3, 4, 3), torch.Generator())


# -- the trainer ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["twins_svt", "t2t"])
def test_trainer_accepts_both_families_and_its_cli_trains_them(name, capsys):
    """``_trainable`` takes Twins-SVT and T2T-ViT, and ScalableViT and
    CrossFormer, which raised here before their training was ported; a
    module outside the zoo still raises, saying what trains;
    ``python -m vit_tpu_torch.train --model twins_svt|t2t`` trains the
    registry's tiny config on the CPU."""
    from vit_tpu_torch.models import MODEL_REGISTRY, CrossFormer, ScalableViT

    ctor, cfg, _ = MODEL_REGISTRY[name]
    assert callable(tt._trainable(ctor(**cfg, device="cpu"), 0.0, True))
    assert callable(tt.make_train_step(ScalableViT(**MODEL_REGISTRY["scalable_vit"][1],
                                                   device="cpu")))
    assert callable(tt.make_train_step(CrossFormer(**MODEL_REGISTRY["crossformer"][1],
                                                   device="cpu")))
    with pytest.raises(NotImplementedError, match="trains the 18 families of "
                                                  "vit_tpu_torch.models and ViTMoE"):
        tt.make_train_step(torch.nn.Linear(4, 4))
    assert tt.main(["--device", "cpu", "--model", name, "--batch", "2", "--steps", "2",
                    "--classes", "10", "--image-size", "64"]) == 0
    assert "step 2: loss" in capsys.readouterr().out


def test_refuse_grad_points_at_the_functions():
    """Kernels 3-6 called raw under grad name the entry that differentiates
    them; the int8 kernels say they have no Function (kernels 7 and 8 name
    theirs: tests/test_torch_train_heads.py)."""
    leaf = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match=r"ops\.attention \(FlashAttentionFn\)"):
        ops.flash_attention(leaf, leaf, leaf)
    with pytest.raises(NotImplementedError, match=r"ops\.qkv_attention \(QkvAttentionFn\)"):
        tqa.fused_qkv_attention(leaf, 1)
    with pytest.raises(NotImplementedError, match="WindowAttentionBlockFn"):
        twa.fused_window_attention_block(leaf, leaf, leaf, leaf, leaf, leaf, 1)
    with pytest.raises(NotImplementedError, match="no autograd Function .*item 7"):
        ops.fused_quant_mlp(leaf, leaf, leaf, torch.zeros(2, dtype=torch.int8), leaf, leaf,
                            torch.zeros(2, dtype=torch.int8), leaf, leaf)


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(kind, dev):
    """A small bf16 case of ``kind`` on the card: (args, kw) in
    ``chip_smoke.ALL_FN_ARGS`` order, with a bias needing a gradient where
    the kernel takes one."""
    gen = torch.Generator(device=dev).manual_seed(21)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    if kind == "qkv_attention":
        return [r(2, 50, 3 * 4 * 32).bfloat16(), r(1, 4, 50, 50)], dict(heads=4, scale=32**-0.5)
    if kind == "window_attention_block":
        a = cs.attn_inputs(gen, 16, 49, 64, 2, 32, torch.bfloat16, dev)
        return [a[k] for k in cs.FN_ARGS["attention_block"]] + [r(2, 49, 49)], dict(
            heads=2, scale=32**-0.5, ln_eps=1e-5)
    d = 64 if kind == "flash_attention" else 147
    return [r(2, 2, 300, d).bfloat16(), r(2, 2, 77, d).bfloat16(), r(2, 2, 77, d).bfloat16(),
            r(2, 1, 300, 77)], dict(scale=d**-0.5, mask_self=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(cs.ZOO_FN_ARGS))
def test_function_on_the_card_fills_every_gradient_and_matches_its_twin(cuda, kind):
    """Each new Function on the card: one launch of its kernel forward, a
    backward counted as one recompute, every gradient finite and within
    kernel_tol's form of autograd through the twin, the planted faults
    failing (``check_function``); the raw wrapper still raises under grad."""
    args, kw = _card_case(kind, cuda)
    with torch.no_grad():
        out = cs.apply_function(kind, None, args, kw)
    g = torch.randn(out.shape, device=cuda).to(out.dtype)
    ops.reset_launch_counts()
    cs.check_function("card", kind, args, kw, g)
    assert ops.launch_counts()[kind] == 1 and ops.recompute_counts()[kind] >= 1
    leaves = [a.detach().requires_grad_() for a in args]
    with pytest.raises(NotImplementedError, match="item 7"):
        if kind == "qkv_attention":
            tqa.fused_qkv_attention(leaves[0], kw["heads"], leaves[1], kw["scale"])
        elif kind == "window_attention_block":
            twa.fused_window_attention_block(*leaves[:6], kw["heads"], leaves[6], kw["scale"],
                                             kw["ln_eps"])
        else:
            getattr(tfa, kind)(*leaves, kw["scale"], kw["mask_self"])


@pytest.mark.cuda
def test_a_card_step_fills_every_gradient(cuda):
    """The tiny Twins-SVT and T2T-ViT in bf16 on the card under grad: every
    parameter's gradient finite, the launches and recomputes
    ``zoo_train_counts`` gives."""
    from vit_tpu_torch.models import MODEL_REGISTRY

    for name, extra in (("twins_svt", {}), ("t2t", {}), ("t2t", dict(depth=2))):
        cls, cfg, size = MODEL_REGISTRY[name]
        cfg = dict(cfg, **extra)
        model = f"{name} {extra}"
        tm = init_params(cls(**cfg, dtype=torch.bfloat16, device=cuda),
                         torch.Generator(cuda).manual_seed(0))
        x = torch.randn(2, size, size, 3, device=cuda)
        ops.reset_launch_counts()
        tt.cross_entropy_loss(tm(x, train=True, remat=True),
                              torch.arange(2, device=cuda)).backward()
        launches, recomputes = cs.zoo_train_counts(tm)
        assert {k: v for k, v in ops.launch_counts().items() if v} == launches, model
        assert {k: v for k, v in ops.recompute_counts().items() if v} == recomputes, model
        for name, p in tm.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), (model, name)


@pytest.mark.cuda
@pytest.mark.parametrize("what,rows,k,n", cs.DENSE_SHAPES,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_dense_backward_sums_in_fp32_at_the_default_flag(cuda, what, rows, k, n):
    """A bf16 ``Dense`` differentiated on the card at the split-K shapes of
    tests/test_torch_scalable_region.py (few rows, long K), with
    ``allow_bf16_reduced_precision_reduction`` at PyTorch's default, on:
    its backward products run in ``MmRoundedFn`` under ``fp32_bf16_sums``,
    each gradient within one bf16 ulp plus the fp32 sum-order slack of its
    plain product (``dense_excess``), and the flag as it was after."""
    flags = torch.backends.cuda.matmul
    state = torch._C._get_cublas_allow_bf16_reduced_precision_reduction
    saved = state()
    flags.allow_bf16_reduced_precision_reduction = True  # PyTorch's default
    before = state()
    seen = []
    orig = torch.matmul

    def spy(a, b):  # the flag, without its split-K part where PyTorch has one
        flag = state()
        seen.append(flag[0] if isinstance(flag, tuple) else flag)
        return orig(a, b)

    try:
        gen = torch.Generator(device=cuda).manual_seed(k)
        dense = Dense(k, n, use_bias=False, dtype=torch.bfloat16, device=cuda)
        with torch.no_grad():
            dense.kernel.copy_(torch.randn(k, n, generator=gen, device=cuda) / k**0.5)
        x = torch.randn(1, rows, k, generator=gen, device=cuda).bfloat16().requires_grad_()
        g = torch.randn(1, rows, n, generator=gen, device=cuda).bfloat16()
        torch.matmul = spy
        try:
            dense(x).backward(g)
        finally:
            torch.matmul = orig
        assert seen == [False, False, False]  # the forward and both backward products
        assert state() == before
        w = dense.kernel.detach().bfloat16()
        dx_ref = torch.matmul(g.float(), w.float().t())
        dw_ref = torch.matmul(x.detach().float().reshape(-1, k).t(), g.float().reshape(-1, n))
        assert cs.dense_excess(x.grad, dx_ref.bfloat16(), g, w.t()) <= 0.0
        assert cs.dense_excess(dense.kernel.grad.bfloat16(), dw_ref.bfloat16(),
                               x.detach().reshape(-1, k).t(), g.reshape(-1, n)) <= 0.0
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved
