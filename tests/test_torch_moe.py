"""The port's MoE layer and ViT-MoE against vit_tpu's on the CPU.

``MoEFeedForward`` against vit_tpu's module in fp32 and bf16 at capacity
factors 1.25, 0.5 (choices dropped) and 1e-9 (one slot an expert): its
output, its routes and gates (the smallest top-k margin printed, so that a
flip shows as one), its load-balance loss; five planted faults that must
fail the bounds. The tiny ViT-MoE of ``tests/test_moe.py`` (32 px, patch 8,
17 tokens, dim 32, depth 2, 4 experts, top-2) with an MoE layer every layer
and every second layer, in both of vit_tpu's CPU modes (``xla``, and
``interpret``: the Pallas kernels in interpreter mode); its launches on the
CPU twins; ``chip_smoke.vit_moe_tree`` against ``init``; serving.

Parameters are vit_tpu's ``init`` (the module tests) or drawn by
``chip_smoke.vit_moe_tree`` (the models), then perturbed, so that no bias or
norm parameter is a constant and the router's bias moves the routes.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import FAMILY_LAUNCHES, vit_moe_tree
from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import ViTMoE
from vit_tpu_torch.nn import MoEFeedForward
from vit_tpu_torch.pipeline import InferencePipeline
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

ops = importlib.import_module("vit_tpu_torch.ops")
tmoe = importlib.import_module("vit_tpu_torch.nn.moe")

# tests/test_moe.py:70's model, with an MoE layer every (1) or every second (2) layer
TINY = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2, heads=4, mlp_dim=64,
            dim_head=8, num_experts=4, num_selected=2)
# The module: [B, S, D] = [3, 17, 32], F 64; (experts, k, capacity factor).
B, S, D, F = 3, 17, 32, 64
ROUTINGS = {"cf 1.25": (4, 2, 1.25), "cf 0.5": (4, 2, 0.5), "cf 1e-9": (4, 2, 1e-9),
            "one expert cf 1e-9": (1, 1, 1e-9)}

# Bounds of the MoE layer against vit_tpu's.
# fp32: every op in fp32 on both sides, the router and expert products summed
#   in other orders: 1e-5 (measured up to 2.4e-7 at max |y| ~0.7).
# bf16: both sides round at the same sites (the expert operands and the
#   hidden, then the output once), so they differ only where an fp32 value a
#   few ulps apart lands on the other side of a bf16 rounding: at most
#   BF16_DIFFER of the values unequal and each within one bf16 ulp of max |y|
#   (measured: 1 value of 1,632, by 1.9e-6). A rounding the port adds moves
#   a large share of the values by an ulp.
TOL_FP32 = 1e-5
BF16_DIFFER = 0.01
# The tiny ViT-MoE's logits: fp32 1e-4 (sum orders through depth 2); bf16
# twice the larger of vit_tpu's own xla-vs-interpret gap and 0.02, as
# tests/test_torch_t2t.py holds T2T-ViT.
TOL_MODEL_FP32 = 1e-4


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    perturb = lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else perturb(v) for k, v in t.items()}
    return walk(tree)


def _jax_moe(routing, dtype):
    """vit_tpu's module, its perturbed variables and the input, at ``routing``."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.moe import MoEFeedForward as JaxMoE

    e, k, cf = routing
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    mod = JaxMoE(dim=D, hidden_dim=F, num_experts=e, num_selected=k, capacity_factor=cf,
                 dtype=jd)
    x = np.random.default_rng(7).standard_normal((B, S, D)).astype(np.float32)
    xj = jnp.asarray(x, jd or jnp.float32)
    variables = _perturbed(jax.tree.map(np.asarray, jax.jit(mod.init)(jax.random.PRNGKey(1), xj)), 8)
    return mod, variables, x


def _jax_run(mod, variables, x, dtype):
    """vit_tpu's output, router logits and sown aux loss, run op by op."""
    import jax.numpy as jnp

    jd = getattr(jnp, dtype)
    y, state = mod.apply(variables, jnp.asarray(x, jd), capture_intermediates=True,
                         mutable=["intermediates"])
    inter = state["intermediates"]
    return (np.asarray(y.astype(jnp.float32)), np.asarray(inter["router"]["__call__"][0]),
            float(inter["moe_aux_loss"][0]))


def _jax_routes(logits, k):
    """vit_tpu/nn/moe.py:82-96 on vit_tpu's router logits, in JAX: the
    chosen experts and the renormalised gates."""
    import jax
    import jax.numpy as jnp

    remaining = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    e = remaining.shape[-1]
    idx, gates = [], []
    for _ in range(k):
        i = jnp.argmax(remaining, axis=-1)
        mask = jax.nn.one_hot(i, e, dtype=jnp.float32)
        gates.append(jnp.sum(remaining * mask, axis=-1))
        idx.append(i)
        remaining = remaining * (1.0 - mask)
    denom = sum(gates) + 1e-9
    return np.stack(idx, -1), np.stack([np.asarray(g / denom) for g in gates], -1)


def _port(routing, dtype, variables, x):
    e, k, cf = routing
    td = getattr(torch, dtype) if dtype != "float32" else None
    mod = MoEFeedForward(D, F, num_experts=e, num_selected=k, capacity_factor=cf, dtype=td,
                         device="cpu")
    mod.load_state_dict(from_jax_params(variables, {}), strict=True)
    with torch.inference_mode():
        xt = torch.from_numpy(x).to(td or torch.float32)
        y, aux = mod(xt, return_aux=True)
        _, probs, idx, gates = mod.route(xt)
    return mod, y, aux, probs, idx, gates


def _within(y, ref, dtype):
    """(max |y - ref|, the share of values unequal, whether both hold the
    bound of ``dtype``)."""
    y = y.float().numpy()
    err = float(np.abs(y - ref).max())
    differ = float((y != ref).mean())
    if dtype == "float32":
        return err, differ, err <= TOL_FP32
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    return err, differ, err <= ulp and differ <= BF16_DIFFER


def _margin(probs, k):
    """The smallest gap between neighbouring probabilities among a token's
    top k + 1: where it is ~1e-7, fp32 sum order alone can flip a route."""
    top = torch.sort(probs.float(), dim=-1, descending=True).values[..., : k + 1]
    return float((top[..., :-1] - top[..., 1:]).min()) if top.shape[-1] > 1 else float("inf")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_moe_layer_matches_jax(routing, dtype):
    e, k, cf = ROUTINGS[routing]
    mod, variables, x = _jax_moe(ROUTINGS[routing], dtype)
    ref, logits, aux_ref = _jax_run(mod, variables, x, dtype)
    tm, y, aux, probs, idx, gates = _port(ROUTINGS[routing], dtype, variables, x)
    want_idx, want_gates = _jax_routes(logits, k)
    cap = tmoe.expert_capacity(S, k, e, cf)
    pos, keep = tmoe.positions(idx, e, cap)
    print(f"{routing} {dtype}: capacity {cap}, {int((~keep).sum())} of {keep.numel()} choices "
          f"dropped; smallest top-{k} margin {_margin(probs, k):.3g}")
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(gates.numpy(), want_gates, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux), aux_ref, rtol=1e-6)
    err, differ, ok = _within(y, ref, dtype)
    assert y.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert ok, (err, differ)
    if routing == "cf 0.5":
        assert not keep.all()  # the drop path runs
    if cf == 1e-9:
        assert cap == 1
        assert (keep.sum(dim=(1, 2)) == e).all()  # each expert keeps one choice a sample
        touched = y.float().abs().amax(-1) > 0
        assert touched[:, 0].all()  # the first token keeps its first choice
        if e == 1:  # one slot in all: only the first token gets a delta
            assert not touched[:, 1:].any()


# the port's own steps, which the planted faults wrap
POSITIONS, TOP_K, COMBINE = tmoe.positions, tmoe.top_k, tmoe.combine


def _pooled_capacity(idx, e, cap):
    """Capacity counted over the whole batch (B * C slots an expert)."""
    b, s, k = idx.shape
    pos, keep = POSITIONS(idx.reshape(1, b * s, k), e, b * cap)
    sample = torch.arange(b).view(b, 1, 1) * cap
    return pos.view(b, s, k) - sample, keep.view(b, s, k)


def _clamped(idx, e, cap):
    """Overflowing choices written into the last slot, and kept."""
    pos, _ = POSITIONS(idx, e, cap)
    return pos.clamp(max=cap - 1), torch.ones_like(pos, dtype=torch.bool)


def _token_order(idx, e, cap):
    """Second choices placed in token order, beside the first choices."""
    b, s, k = idx.shape
    pos, keep = POSITIONS(idx.reshape(b, s * k, 1), e, cap)
    return pos.view(b, s, k), keep.view(b, s, k)


def _raw_gates(probs, k):
    """The chosen probabilities, not renormalised over their sum."""
    idx, _ = TOP_K(probs, k)
    return idx, probs.gather(-1, idx)


def _rounded_outputs(out, *args):
    """The expert outputs rounded to bf16 before the gated sum."""
    return COMBINE(out.bfloat16().float(), *args)


# fault -> (routing, dtype, the step of nn/moe.py it replaces, the replacement)
FAULTS = {
    "capacity pooled across the batch": ("cf 0.5", "float32", "positions", _pooled_capacity),
    "overflow clamped into the last slot": ("cf 0.5", "float32", "positions", _clamped),
    "second choices in token order": ("cf 0.5", "float32", "positions", _token_order),
    "gates not renormalised": ("cf 1.25", "float32", "top_k", _raw_gates),
    "expert outputs rounded to bf16 before the combine's sum": (
        "cf 1.25", "bfloat16", "combine", _rounded_outputs),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_bound(fault, monkeypatch):
    routing, dtype, step, bad = FAULTS[fault]
    mod, variables, x = _jax_moe(ROUTINGS[routing], dtype)
    ref, _, _ = _jax_run(mod, variables, x, dtype)
    good = _within(_port(ROUTINGS[routing], dtype, variables, x)[1], ref, dtype)
    monkeypatch.setattr(tmoe, step, bad)
    faulty = _within(_port(ROUTINGS[routing], dtype, variables, x)[1], ref, dtype)
    print(f"{fault}: port {good[:2]}, with the fault {faulty[:2]} (max |dy|, share unequal)")
    assert good[2] and not faulty[2], (good, faulty)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.fixture(scope="module", params=[1, 2], ids=["moe every layer", "moe every 2nd layer"])
def tiny(request):
    cfg = dict(TINY, moe_every=request.param)
    img = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    return cfg, img, _perturbed(vit_moe_tree(cfg, seed=3), seed=4)


def test_vit_moe_tree_has_the_names_and_shapes_of_init(tiny):
    import jax
    import jax.numpy as jnp
    from vit_tpu.models.vit_moe import ViTMoE as JaxViTMoE

    cfg, _, tree = tiny
    want = jax.eval_shape(JaxViTMoE(**cfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3), jnp.float32))
    assert _leaves(tree) == _leaves(jax.tree.map(lambda a: a, want))


def _loaded(cfg, tree, dtype=None):
    model = ViTMoE(**cfg, dtype=dtype, device="cpu")
    assert model.jax_stages == {}
    model.load_state_dict(from_jax_params(tree, model.jax_stages), strict=True)
    return model.eval()


def _jax_logits(cfg, tree, img, dtype, mode, monkeypatch):
    import jax
    import jax.numpy as jnp
    from vit_tpu.models.vit_moe import ViTMoE as JaxViTMoE

    jd = getattr(jnp, dtype) if dtype != "float32" else None
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    return np.asarray(jax.jit(JaxViTMoE(**cfg, dtype=jd).apply)(tree, jnp.asarray(img)),
                      np.float32)


@pytest.mark.parametrize("dtype,mode", [("float32", "xla"), ("float32", "interpret"),
                                        ("bfloat16", "xla"), ("bfloat16", "interpret")])
def test_vit_moe_matches_jax(dtype, mode, tiny, monkeypatch):
    cfg, img, tree = tiny
    ref = _jax_logits(cfg, tree, img, dtype, mode, monkeypatch)
    td = getattr(torch, dtype) if dtype != "float32" else None
    model = _loaded(cfg, tree, td)
    with torch.inference_mode():
        out = model(torch.from_numpy(img).to(td or torch.float32))
    assert out.dtype == torch.float32 and out.shape == (2, 10)
    err = float(np.abs(out.numpy() - ref).max())
    if dtype == "float32":
        print(f"{mode} fp32: max |dlogit| {err:.3g}")
        assert err <= TOL_MODEL_FP32, err
    else:
        other = _jax_logits(cfg, tree, img, dtype, "interpret" if mode == "xla" else "xla",
                            monkeypatch)
        control = float(np.abs(other - ref).max())
        print(f"{mode} bf16: max |dlogit| {err:.3g}, vit_tpu's own gap {control:.3g}")
        assert err <= 2 * max(control, 0.02), (err, control)


def test_aux_losses_are_the_sown_values(tiny):
    import jax
    import jax.numpy as jnp
    from vit_tpu.models.vit_moe import ViTMoE as JaxViTMoE

    cfg, img, tree = tiny
    _, state = jax.jit(lambda v, x: JaxViTMoE(**cfg).apply(v, x, mutable=["intermediates"]))(
        tree, jnp.asarray(img))
    want = [float(v["moe_aux_loss"][0]) for k, v in sorted(state["intermediates"].items())]
    with torch.inference_mode():
        logits, aux = _loaded(cfg, tree)(torch.from_numpy(img), return_aux=True)
    assert len(aux) == cfg["depth"] // cfg["moe_every"] == len(want)
    np.testing.assert_allclose([float(a) for a in aux], want, rtol=1e-6)


# Each kernel's plain twin, by the kernel it stands for on the CPU.
TWINS = {"reference_attention_kv_blocked": "flash_attention_kv_blocked",
         "reference_attention": "flash_attention", "xla_qkv_attention": "qkv_attention",
         "reference_mlp": "fused_mlp", "xla_attention_block": "attention_block",
         "xla_window_attention_block": "window_attention_block"}


def test_launches_on_the_cpu_twins(tiny, monkeypatch):
    """A bf16 forward calls the attention block's twin once a layer, the MLP
    kernel's twin once a dense layer, and no other twin: the MoE layers run
    no kernel. chip_smoke wants the same of the full model a forward."""
    cfg, img, tree = tiny
    calls = {}
    for name, kernel in TWINS.items():
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _k=kernel, _f=fn, **kw: (
            calls.__setitem__(_k, calls.get(_k, 0) + 1), _f(*a, **kw))[1])
    model = _loaded(cfg, tree, torch.bfloat16)
    with torch.inference_mode():
        model(torch.from_numpy(img[:1]).bfloat16())
    depth, dense = cfg["depth"], cfg["depth"] - cfg["depth"] // cfg["moe_every"]
    assert calls == {k: n for k, n in (("attention_block", depth), ("fused_mlp", dense)) if n}
    full = FAMILY_LAUNCHES["vit_moe"]
    assert {k: n for k, n in full.items() if n} == {"attention_block": 8, "fused_mlp": 4}


def test_default_vit_moe_asks_for_the_card():
    if torch.cuda.is_available():
        assert next(ViTMoE(**TINY).parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            ViTMoE(**TINY)


def test_server_answers_requests(tiny):
    """The fp32 model behind ``BatchingServer``, 6 requests in buckets of 4:
    the rows equal direct calls (capacity is counted a sample, so a padded
    batch routes each row as alone)."""
    cfg, _, tree = tiny
    pipe = InferencePipeline(_loaded(cfg, tree), image_size=32, batch_size=4,
                             dtype=torch.float32)
    imgs = np.random.default_rng(2).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    with BatchingServer(pipe, decoder=JpegDecoder(size=32), max_wait_ms=20) as server:
        futures = [server.submit(im) for im in imgs]
        rows = np.stack([f.result(timeout=60) for f in futures])
    direct = np.concatenate([pipe(imgs[i: i + 1]) for i in range(6)])
    assert rows.shape == (6, 10) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, direct, atol=1e-5, rtol=0)
