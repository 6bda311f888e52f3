"""The port's training path against vit_tpu's on the CPU, and its autograd
Functions of kernels 1 and 2 on the card.

CPU tests feed the same numpy inputs (``default_rng(seed)``) through both
packages: the ops' gradients against ``jax.vjp`` of vit_tpu's kernels (in
interpret mode, through their custom VJPs); the tiny ViT's
loss and gradients against ``jax.value_and_grad`` in both vit_tpu CPU modes;
parameters after AdamW and LAMB steps against ``vit_tpu.train``; schedules
and clipping against optax; ``evaluate``, ``init_params``, checkpoints,
dropout and the trainer's CLI. JAX is imported inside the tests: the card
runs this file's ``cuda`` tests with ``python -m pytest --noconftest -m cuda
tests/test_torch_train.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from vit_tpu_torch import ops
from vit_tpu_torch import train as tt
from vit_tpu_torch.models import ViT
from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops import block_attention as tba
from vit_tpu_torch.utils import from_jax_params, init_params
from vit_tpu_torch.utils.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint

tfm = importlib.import_module("vit_tpu_torch.ops.fused_mlp")

torch.set_num_threads(2)

CFG = dict(image_size=32, patch_size=8, num_classes=10, dim=64, heads=4, mlp_dim=128,
           dim_head=16)
DTYPES = {"fp32": None, "bf16": "bfloat16"}


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _nonzero(counts):
    """The entries of a ``launch_counts`` / ``recompute_counts`` dict that
    are not 0 (both name every kernel they count)."""
    return {k: v for k, v in counts.items() if v}


def _rel(a, b):
    """Relative L2 distance of ``a`` from the reference ``b``."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -- ops: gradients against jax.vjp -----------------------------------------------

ATTN_CASES = {
    "plain": dict(n=17, true_n=None, block_tokens=None),
    "padded": dict(n=24, true_n=17, block_tokens=None),
    "packed": dict(n=40, true_n=17, block_tokens=20),
}
# Relative L2 of each gradient against vit_tpu's. fp32: sum orders only
# (measured <= 3e-7). bf16 (x and weights bf16; LN parameters and biases
# fp32): both sides differentiate the same rounded forward, but round the
# cotangents of the bf16 casts at different places (JAX's dot transposes
# keep the operand dtype), measured <= 6e-3 here; 2e-2 is about three bf16
# ulps (2^-8 each) of relative error.
OP_TOL = {"fp32": 1e-5, "bf16": 2e-2}


def _attn_inputs(seed, b, n, dim, heads, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, dim)), 1.0 + 0.1 * rng.standard_normal(dim),
            0.1 * rng.standard_normal(dim), rng.standard_normal((dim, 3 * heads * d)) / dim**0.5,
            rng.standard_normal((heads * d, dim)) / (heads * d) ** 0.5,
            0.1 * rng.standard_normal(dim)]


def _as(arrays, dtypes, conv):
    return [None if a is None else conv(np.asarray(a, np.float32), dt)
            for a, dt in zip(arrays, dtypes)]


def _torch_leaf(a, dt):
    return torch.from_numpy(a).to(getattr(torch, dt)).requires_grad_()


def _jnp(a, dt):
    import jax.numpy as jnp

    return jnp.asarray(a).astype(getattr(jnp, dt))


@pytest.mark.parametrize("precision", list(DTYPES))
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_block_grads_match_jax(case, precision):
    """Against ``jax.vjp`` of vit_tpu's kernel in interpret mode, whose
    custom VJP differentiates its XLA twin (``_ab_bwd``): the XLA path's
    own gradients are the same function's."""
    import jax
    from vit_tpu.ops import block_attention as jba

    c = ATTN_CASES[case]
    heads, d = 4, 16
    arrays = _attn_inputs(3, 2, c["n"], 64, heads, d)
    wdt = "float32" if precision == "fp32" else "bfloat16"
    dts = [wdt, "float32", "float32", wdt, wdt, "float32"]
    g = np.random.default_rng(4).standard_normal((2, c["n"], 64)).astype(np.float32)
    masks = dict(true_n=c["true_n"], block_tokens=c["block_tokens"])
    scale = d**-0.5

    f = lambda *a: jba.fused_attention_block(*a, heads, scale=scale, interpret=True, **masks)
    jargs = _as(arrays, dts, _jnp)
    _, vjp = jax.vjp(f, *jargs)
    ref = vjp(_jnp(g, wdt))

    targs = _as(arrays, dts, _torch_leaf)
    out = ops.attention_block(*targs, heads, scale=scale, **masks)
    grads = torch.autograd.grad(out, targs, torch.from_numpy(g).to(out.dtype))
    for name, a, b in zip(cs.FN_ARGS["attention_block"], grads, ref):
        assert a.dtype == targs[cs.FN_ARGS["attention_block"].index(name)].dtype
        assert _rel(a, b) <= OP_TOL[precision], (name, _rel(a, b))


MLP_PRESENT = {
    "all": ("b1", "b2", "ln_scale", "ln_bias"),
    "no biases": ("ln_scale", "ln_bias"),
    "no ln_bias": ("b1", "b2", "ln_scale"),
    "no LayerNorm": ("b1", "b2"),
}


def _mlp_arrays(seed, t, dim, f, present):
    rng = np.random.default_rng(seed)
    full = dict(x=rng.standard_normal((2, t, dim)), w1=rng.standard_normal((dim, f)) / dim**0.5,
                b1=0.1 * rng.standard_normal(f), w2=rng.standard_normal((f, dim)) / f**0.5,
                b2=0.1 * rng.standard_normal(dim), ln_scale=1.0 + 0.1 * rng.standard_normal(dim),
                ln_bias=0.1 * rng.standard_normal(dim))
    return [full[k] if k in ("x", "w1", "w2") or k in present else None
            for k in cs.FN_ARGS["fused_mlp"]]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("precision", list(DTYPES))
@pytest.mark.parametrize("present", list(MLP_PRESENT))
def test_mlp_grads_match_jax(present, precision, residual):
    import jax

    jfm = importlib.import_module("vit_tpu.ops.fused_mlp")
    arrays = _mlp_arrays(5, 17, 64, 128, MLP_PRESENT[present])
    wdt = "float32" if precision == "fp32" else "bfloat16"
    dts = [wdt, wdt, "float32", wdt, "float32", "float32", "float32"]
    g = np.random.default_rng(6).standard_normal((2, 17, 64)).astype(np.float32)
    kw = dict(activation="gelu", residual=residual, ln_eps=1e-6)
    idx = [i for i, a in enumerate(arrays) if a is not None]
    jargs = _as(arrays, dts, _jnp)

    def f(*present_args):
        full = list(jargs)
        for i, a in zip(idx, present_args):
            full[i] = a
        return jfm.fused_mlp(*full, **kw, interpret=True)

    _, vjp = jax.vjp(f, *[jargs[i] for i in idx])
    ref = vjp(_jnp(g, wdt))
    targs = _as(arrays, dts, _torch_leaf)
    out = ops.mlp(*targs, **kw)
    grads = torch.autograd.grad(out, [targs[i] for i in idx], torch.from_numpy(g).to(out.dtype))
    for i, a, b in zip(idx, grads, ref):
        assert _rel(a, b) <= OP_TOL[precision], (cs.FN_ARGS["fused_mlp"][i], _rel(a, b))


# -- the Functions on the CPU, with the twin in the kernel's place ------------------


def _function_case(kind, precision, seed=7):
    wdt = torch.float32 if precision == "fp32" else torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    if kind == "attention_block":
        arrays = _attn_inputs(seed, 2, 24, 64, 4, 16)
        dts = [wdt, torch.float32, torch.float32, wdt, wdt, torch.float32]
        kw = dict(heads=4, scale=0.25, ln_eps=1e-6, true_n=17, block_tokens=None)
    else:
        arrays = _mlp_arrays(seed, 17, 64, 128, MLP_PRESENT["all"])
        dts = [wdt, wdt, torch.float32, wdt, torch.float32, torch.float32, torch.float32]
        kw = dict(activation="gelu", residual=True, ln_eps=1e-6)
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(dt) for a, dt in zip(arrays, dts)]
    g = torch.randn(args[0].shape, generator=gen).to(wdt)
    return args, kw, g


@pytest.mark.parametrize("precision", list(DTYPES))
@pytest.mark.parametrize("kind", list(cs.FN_ARGS))
def test_function_with_twin_forward_equals_autograd_and_sees_faults(kind, precision):
    """The Function's gradients equal autograd through the twin bit for bit
    (the same ops on the same inputs); each of FUNCTION_FAULTS fails
    chip_smoke's bound, and skipping the cotangent cast changes nothing."""
    args, kw, g = _function_case(kind, precision)
    grads = cs.function_grads(kind, args, kw, g, forward=cs.twin_forward(kind))
    ref = cs.twin_grads(kind, args, kw, g)
    for name, a, b in zip(cs.FN_ARGS[kind], grads, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert cs.check_function("cpu", kind, args, kw, g, forward=cs.twin_forward(kind)) == 0.0
    for fault in cs.FUNCTION_FAULTS:
        bad = cs.faulty_grads(kind, args, kw, g, fault)
        assert any(e > t for _, e, t in cs.grad_errors(kind, bad, ref)), fault


def test_function_gets_its_cotangent_in_the_outputs_dtype():
    """Why skipping the cast is no fault: a bf16 output consumed in fp32
    still hands the Function's backward a bf16 cotangent."""
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a * 2

        @staticmethod
        def backward(ctx, g):
            seen.append(g.dtype)
            return g * 2

    a = torch.randn(4, 8).bfloat16().requires_grad_()
    (Probe.apply(a).float() * torch.randn(4, 8)).sum().backward()
    assert seen == [torch.bfloat16]


def test_function_saves_only_its_inputs():
    """As _ab_fwd: the six inputs and nothing of the forward's inside."""
    args, kw, g = _function_case("attention_block", "bf16")
    leaves = [a.requires_grad_() for a in args]
    out = ops.AttentionBlockFn.apply(cs.twin_forward("attention_block"), *leaves, kw["heads"], kw["scale"], kw["ln_eps"],
                                     kw["true_n"], kw["block_tokens"])
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6 and all(s is l for s, l in zip(saved, leaves))


# -- the grad guard of kernels 3-10 -------------------------------------------------


def _guarded_calls(t):
    """Each guarded kernel wrapper called on CPU tensors ``t(*shape)``."""
    fa, qa, qb, rb, wa = (importlib.import_module(f"vit_tpu_torch.ops.{m}") for m in (
        "flash_attention", "qkv_attention", "quant_block", "reattention_block",
        "window_attention"))

    d, hd = 64, 64
    block = lambda: (t(2, 8, d), t(d), t(d), t(d, 3 * hd), t(hd, d), t(d))
    i8 = lambda *s: torch.zeros(*s, dtype=torch.int8)
    return {
        "qkv_attention": lambda: qa.fused_qkv_attention(t(2, 8, 3 * hd), 4),
        "flash_attention": lambda: fa.flash_attention(t(2, 4, 8, 16), t(2, 4, 8, 16),
                                                      t(2, 4, 8, 16)),
        "flash_attention_kv_blocked": lambda: fa.flash_attention_kv_blocked(
            t(2, 4, 8, 16), t(2, 4, 8, 16), t(2, 4, 8, 16)),
        "window_attention_block": lambda: wa.fused_window_attention_block(*block(), 4),
        "talking_heads_block": lambda: rb.fused_talking_heads_block(*block(), t(4, 4), t(4, 4),
                                                                    4),
        "reattention_block": lambda: rb.fused_reattention_block(*block(), t(4, 4), t(4), t(4), 4),
        "quant_attention_block": lambda: qb.fused_quant_attention_block(
            t(2, 8, d), t(d), t(d), i8(3 * hd, d), t(3 * hd), i8(d, hd), t(d), t(d), 4),
        "quant_mlp": lambda: qb.fused_quant_mlp(t(2, 8, d), t(d), t(d), i8(128, d), t(128),
                                                t(128), i8(d, 128), t(d), t(d)),
        "gemm_sm90": lambda: tba.gemm_sm90(t(8, 16).bfloat16(), t(16, 8).bfloat16()),
    }


@pytest.mark.parametrize("kernel", list(_guarded_calls(torch.randn)))
def test_kernels_without_a_function_raise_under_grad(kernel):
    leaf = lambda *s: torch.randn(*s, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        _guarded_calls(leaf)[kernel]()
    # silent without grad: the wrapper goes on to refuse the CPU tensor itself
    for scope in (torch.inference_mode, torch.no_grad):
        with scope(), pytest.raises(ValueError, match="CUDA tensors"):
            _guarded_calls(leaf)[kernel]()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _guarded_calls(torch.randn)[kernel]()


def test_refuse_grad_needs_grad_mode_and_an_operand_that_requires_it():
    leaf = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        _build.refuse_grad("k", None, torch.zeros(2), leaf)
    _build.refuse_grad("k", torch.zeros(2), None, 3)
    with torch.no_grad():
        _build.refuse_grad("k", leaf)
    with torch.inference_mode():
        _build.refuse_grad("k", leaf)


# -- the tiny ViT: loss and gradients against jax.value_and_grad --------------------

# Relative L2 of each parameter's gradient and |loss| difference. fp32:
# measured <= 1.2e-6 and 2.4e-7 in both modes. bf16: the losses agree bit for
# bit in interpret mode and by 1.1e-3 in xla mode at depth 2 (vit_tpu's XLA
# attention rounds its delta and the residual sum apart), the gradients by
# <= 1.4e-2 (cls and pos_embedding, which sum every token's cotangent):
# the cotangents of the bf16 casts round at different places (see OP_TOL).
MODEL_TOL = {"fp32": (1e-5, 1e-5), "bf16": (4e-2, 4e-3)}


def _images(seed, b=4, size=32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, size, size, 3)).astype(np.float32), rng.integers(0, 10, b)


def _jax_vit(precision, depth, img, seed=1, **extra):
    """vit_tpu's tiny ViT and its ``init`` variables (numpy), perturbed so
    that biases and LayerNorm parameters are not zeros and ones."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import ViT as JaxViT

    dt = DTYPES[precision]
    jm = JaxViT(**CFG, depth=depth, dtype=getattr(jnp, dt) if dt else None, **extra)
    v = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(img))
    rng = np.random.default_rng(seed)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32)
                     + 0.02 * rng.standard_normal(a.shape).astype(np.float32), v)
    return jm, v


def _port_vit(precision, depth, variables, **extra):
    dt = DTYPES[precision]
    tm = ViT(**CFG, depth=depth, dtype=getattr(torch, dt) if dt else None, device="cpu", **extra)
    tm.load_state_dict(from_jax_params(variables, tm.jax_stages), strict=True)
    return tm


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("precision", list(DTYPES))
@pytest.mark.parametrize("depth", [1, 2])
def test_vit_loss_and_grads_match_jax(depth, precision, mode):
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops
    from vit_tpu import train as jtrain

    img, labels = _images(0)
    jm, v = _jax_vit(precision, depth, img)

    def loss_fn(params):
        with jops.force_backend(mode):
            logits = jm.apply({"params": params}, jnp.asarray(img), True)
        return jtrain.cross_entropy_loss(logits, jnp.asarray(labels))

    jloss, jgrads = jax.value_and_grad(loss_fn)(v["params"])
    tm = _port_vit(precision, depth, v)
    loss = tt.cross_entropy_loss(tm(torch.from_numpy(img), train=True, remat=True),
                                 torch.from_numpy(labels))
    loss.backward()
    gtol, ltol = MODEL_TOL[precision]
    assert abs(loss.item() - float(jloss)) <= ltol
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    for name, p in tm.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert _rel(p.grad, ref[name]) <= gtol, (name, _rel(p.grad, ref[name]))


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
    jv = jax.device_get(JaxViT(**cfg).init({"params": jax.random.PRNGKey(0)}, jnp.asarray(img)))
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


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "mixed"])
@pytest.mark.parametrize("kind", list(cs.FN_ARGS))
def test_function_on_the_card_matches_its_twin(cuda, kind, precision):
    gen = torch.Generator(device=cuda).manual_seed(11)
    x_dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    if kind == "attention_block":
        a = cs.attn_inputs(gen, 2, 80, 256, 4, 64, x_dtype, cuda)
        kw = dict(heads=4, scale=0.125, ln_eps=1e-6, true_n=77, block_tokens=None)
    else:
        a = cs.mlp_inputs(gen, 80, 256, 1024, x_dtype, cuda, b=2)
        kw = dict(activation="gelu", residual=True, ln_eps=1e-6)
    args = [a.get(k) for k in cs.FN_ARGS[kind]]
    g = torch.randn(args[0].shape, generator=gen, device=cuda).to(x_dtype)
    before = ops.launch_counts()[kind]
    cs.check_function(f"card {precision}", kind, args, kw, g)
    assert ops.launch_counts()[kind] == before + 1


@pytest.mark.cuda
def test_a_card_forward_under_grad_fills_every_gradient(cuda):
    torch.manual_seed(0)
    state = tt.create_train_state(ViT(**CFG, depth=2, dtype=torch.bfloat16, device=cuda),
                                  generator=torch.Generator(cuda).manual_seed(0))
    img = torch.randn(4, 32, 32, 3, device=cuda)
    ops.reset_launch_counts()
    tt.cross_entropy_loss(state.model(img, train=True),
                          torch.arange(4, device=cuda)).backward()
    assert ops.launch_counts()["attention_block"] == 2
    assert _nonzero(ops.recompute_counts()) == {"attention_block": 2, "fused_mlp": 2}
    for name, p in state.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.cuda
def test_kernels_three_to_ten_raise_under_grad_on_the_card(cuda):
    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    qkv = torch.randn(2, 8, 3 * 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        qa.fused_qkv_attention(qkv, 4)
    with torch.inference_mode():
        qa.fused_qkv_attention(qkv.detach(), 4)


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
