"""The port's gradients against vit_tpu's on the CPU, and its autograd
Functions of kernels 1 and 2 on the card.

CPU tests feed the same numpy inputs (``default_rng(seed)``) through both
packages: the ops' gradients against ``jax.vjp`` of vit_tpu's kernels (in
interpret mode, through their custom VJPs); the Functions with the twin in
the kernel's place; the grad guard of kernels 3-10; the tiny ViT's loss and
gradients against ``jax.value_and_grad`` in both vit_tpu CPU modes. The
trainer (steps, optimizers, schedules, ``evaluate``, ``init_params``,
checkpoints, dropout, the CLI) is in ``tests/test_torch_train_steps.py``.
JAX is imported inside the tests: the card runs this file's ``cuda`` tests
with ``python -m pytest --noconftest -m cuda tests/test_torch_train.py``.
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
from vit_tpu_torch.utils import from_jax_params

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
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(seed)}, jnp.asarray(img))
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
