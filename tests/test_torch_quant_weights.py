"""The port's int8 paths beyond the plain ViT on the CPU, against vit_tpu's
``utils/quantize.py`` from the same parameters and numpy images:
``quantize_vit`` of a ViT with a qkv bias (``vit_apply_w8a8`` in ``w8`` and
``w8a8``, ``w8a8_kernel`` refused, ``auto`` falling back); the weight-only
transforms ``quantize_weights`` (codes and scales for ViT's stacked layers,
LeViT's convs and BatchNorms, CrossFormer's convs and windows),
``dequantize_weights``, ``quantized_apply``, ``tree_nbytes`` and
``fake_quantize_weights``; ``simple_vit_apply_w8a8`` in every mode; one
``make_train_step(qat=True)`` step.

vit_tpu's ``w8`` and ``w8a8`` modes reach ``ops.qkv_attention``, which runs
under both of its CPU backends; its ``w8a8_kernel`` mode runs the Pallas
kernels in interpret mode on the CPU.
"""

import numpy as np
import pytest
import torch

from vit_tpu_torch import train as tt
from vit_tpu_torch.models import CrossFormer, LeViT, SimpleViT, ViT
from vit_tpu_torch.utils import (
    QuantSimpleViT,
    QuantViT,
    dequantize_weights,
    fake_quantize_weights,
    from_jax_params,
    from_jax_quant,
    quantize_vit,
    quantize_weights,
    quantized_apply,
    resolve_quant_mode,
    simple_vit_apply_w8a8,
    tree_nbytes,
)
from vit_tpu_torch.utils import quantize as tq

torch.set_num_threads(2)

CFG = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4,
           mlp_dim=128, dim_head=16)
HF_KNOBS = dict(qkv_bias=True, activation="gelu_exact", norm_eps=1e-12)


def _images(b, seed=0, size=32):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _perturbed(variables, seed=1):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.02 * rng.standard_normal(a.shape).astype(np.float32), variables)


def _pair(jax_cls, torch_cls, cfg, img, dtype=None, seed=1):
    """vit_tpu's model with perturbed ``init`` variables, and the port's
    loaded with them."""
    import jax
    import jax.numpy as jnp

    jm = jax_cls(**cfg, dtype=getattr(jnp, dtype) if dtype else None)
    v = _perturbed(jax.jit(jm.init)({"params": jax.random.PRNGKey(seed)}, jnp.asarray(img)),
                   seed)
    tm = torch_cls(**cfg, dtype=getattr(torch, dtype) if dtype else None, device="cpu")
    tm.load_state_dict(from_jax_params(v, tm.jax_stages), strict=True)
    return jm, v, tm.eval()


def _vit_pair(dtype=None, **extra):
    from vit_tpu.models import ViT as JaxViT

    return _pair(JaxViT, ViT, dict(CFG, **extra), _images(1), dtype)


def _run(model, img, dtype=None, **kw):
    with torch.inference_mode():
        return model(torch.from_numpy(img).to(getattr(torch, dtype) if dtype else torch.float32),
                     **kw)


# -- quantize_vit of a ViT with a qkv bias --------------------------------------------


def test_quantize_vit_keeps_the_qkv_bias_as_vit_tpu_does():
    """``quantize_vit`` of the port's qkv-bias ViT equals ``from_jax_quant`` of
    vit_tpu's ``quantize_vit`` (whose refusal of such trees is gone): the
    codes, the scales and the fp32 ``qkv_bias`` under the raw names."""
    from vit_tpu.utils.quantize import quantize_vit as jax_quantize_vit

    _, v, tm = _vit_pair("bfloat16", **HF_KNOBS)
    qm = quantize_vit(tm)
    assert isinstance(qm, QuantViT) and qm.qkv_bias
    state = from_jax_quant(jax_quantize_vit(v))
    ours = qm.state_dict()
    assert set(state) == set(ours)
    for key, value in state.items():
        assert value.dtype == ours[key].dtype and torch.equal(ours[key], value), key
    assert ours["encoder.blocks.1.attn.qkv_bias"].shape == (3 * 64,)
    fresh = QuantViT(**dict(CFG, **HF_KNOBS), device="cpu")
    fresh.load_state_dict(state, strict=True)


# Max |logit| difference from vit_apply_w8a8 on the qkv-bias tree (|logits| ~2),
# about 2.5-3x the measured gaps, as tests/test_torch_quant_vit.py sets them.
# These models take the erf GELU, and PyTorch's erf and XLA's erfc-based
# GELU differ in the last fp32 bit of ~60% of values (F.gelu; ~40% with an
# erfc of the same form), so w8a8, which quantizes the hidden per row, moves
# a row's codes wherever its maximum lands on the other side: measured in
# fp32 < 1e-5 at batch 2 and 1.01e-2 at batch 8 (auto); in bf16 (the hidden
# rounded to bf16 first) 4.3e-2 at batch 2 and 5.2e-2 at batch 8. w8
# quantizes no activation: < 1e-5 in fp32, 3.7e-3 in bf16.
QTOL = {(None, "w8"): 1e-5, (None, "w8a8"): 3e-2, ("bfloat16", "w8"): 1e-2,
        ("bfloat16", "w8a8"): 0.15}


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("mode,batch,backend", [("w8", 2, "xla"), ("w8a8", 2, "interpret"),
                                                ("auto", 1, "xla"), ("auto", 8, "xla")])
def test_qkv_bias_quant_vit_matches_jax(mode, batch, backend, dtype, monkeypatch):
    import jax.numpy as jnp
    from vit_tpu.utils.quantize import quantize_vit as jax_quantize_vit
    from vit_tpu.utils.quantize import vit_apply_w8a8

    jm, v, tm = _vit_pair(dtype, **HF_KNOBS)
    qm = quantize_vit(tm, mode=mode)
    img = _images(batch, seed=2)
    monkeypatch.setenv("VIT_TPU_BACKEND", backend)
    jdt = getattr(jnp, dtype) if dtype else jnp.float32
    ref = np.asarray(vit_apply_w8a8(jm, jax_quantize_vit(v), jnp.asarray(img).astype(jdt),
                                    mode=mode), np.float32)
    out = _run(qm, img, dtype).numpy()
    resolved = "w8a8" if mode == "auto" and batch > 1 else resolve_quant_mode(batch)
    resolved = mode if mode != "auto" else resolved
    assert np.abs(out - ref).max() <= QTOL[(dtype, resolved)], np.abs(out - ref).max()


def test_qkv_bias_kernel_mode_raises_and_auto_falls_back(monkeypatch):
    """``w8a8_kernel`` on a qkv-bias model raises vit_tpu's error; ``auto``
    at a kernel-mode batch runs ``w8a8`` (kernel 3's twin, never the W8A8
    block twins), as vit_tpu's ``auto`` does."""
    from vit_tpu.utils import quantize as jq

    _, _, tm = _vit_pair(None, **HF_KNOBS)
    qm = quantize_vit(tm)
    img = _images(8, seed=3)
    with pytest.raises(ValueError) as err:
        _run(qm, img, mode="w8a8_kernel")
    assert str(err.value) == tq.QKV_BIAS_KERNEL_ERROR
    assert "w8a8_kernel" in str(err.value) and "qkv" in str(err.value)
    calls = []
    monkeypatch.setattr(tq.ops, "quant_attention_block",
                        lambda *a, **k: calls.append("block") or pytest.fail("block twin"))
    torch.testing.assert_close(_run(qm, img), _run(qm, img, mode="w8a8"), rtol=0, atol=0)
    assert resolve_quant_mode(8) == "w8a8_kernel" == jq.resolve_quant_mode(8) and not calls


# -- the weight-only transforms -------------------------------------------------------


def _pick(node, which):
    if isinstance(node, dict):
        if "__w8__" in node:
            return node[which]
        return {k: _pick(v, which) for k, v in node.items()}
    return node


def _marks(node):
    """1 where vit_tpu compressed a leaf, 0 elsewhere, in its shapes."""
    if isinstance(node, dict):
        if "__w8__" in node:
            return np.ones(node["__w8__"].shape, np.float32)
        return {k: _marks(v) for k, v in node.items()}
    return np.zeros(np.shape(node), np.float32)


def _check_codes_equal_vit_tpus(qstate, jq_vars, stages):
    """The port's compressed state against vit_tpu's ``quantize_weights``
    tree, unstacked and turned as ``from_jax_params`` turns the weights: the
    same leaves compressed, the codes and the scales bit for bit, every
    other leaf unchanged. Returns the number of compressed tensors."""
    codes = from_jax_params(_pick(jq_vars, "__w8__"), stages)
    scales = from_jax_params(_pick(jq_vars, "__scale__"), stages)
    marks = from_jax_params(_marks(jq_vars), stages)
    assert set(qstate) == set(codes)
    n = 0
    for key, value in qstate.items():
        if isinstance(value, dict):
            n += 1
            assert marks[key].all(), key
            assert value["__w8__"].dtype == torch.int8, key
            assert tuple(value["__scale__"].shape) == tuple(scales[key].shape), key
            assert torch.equal(value["__w8__"].float(), codes[key]), key
            assert torch.equal(value["__scale__"], scales[key]), key
        else:
            assert not marks[key].any(), key
            assert torch.equal(value.float(), codes[key]), key
    return n


def _tiny_levit():
    from vit_tpu.models.levit import LeViT as JaxLeViT

    cfg = dict(image_size=64, num_classes=10, stages=2, dim=(64, 64), depth=1, heads=(1, 2),
               mlp_mult=2, dim_key=16, dim_value=16)
    return _pair(JaxLeViT, LeViT, cfg, _images(1, size=64), seed=1) + (_images(2, 4, 64),)


def _tiny_crossformer():
    from vit_tpu.models.crossformer import CrossFormer as JaxCrossFormer

    cfg = dict(num_classes=10, dim=(32, 64), depth=(1, 1), global_window_size=(4, 2),
               local_window_size=7, cross_embed_kernel_sizes=((4, 8), (2, 4)),
               cross_embed_strides=(4, 2))
    return _pair(JaxCrossFormer, CrossFormer, cfg, _images(1, size=112), seed=3) + (
        _images(1, 5, 112),)


def _tiny_vit():
    jm, v, tm = _vit_pair()
    return jm, v, tm, _images(2, 6)


FAMILIES = {"vit": _tiny_vit, "levit": _tiny_levit, "crossformer": _tiny_crossformer}


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_quantize_weights_equals_vit_tpus_and_applies(fam):
    """Codes and scales of every compressed leaf equal vit_tpu's (ViT: per
    layer of its stacked kernels; LeViT: convs and BatchNorm statistics
    passed through; CrossFormer: HWIO conv kernels, whose scales run per
    (H, O) in vit_tpu's unstacked layout); ``dequantize_weights`` is vit_tpu's
    tree converted; ``quantized_apply`` runs the model on it as vit_tpu's
    does (the port's fp32 parity bound for each family: 2e-5 of max |logit|,
    measured 6.7e-7, 1.3e-6 and 2.2e-7 of it); ``tree_nbytes`` counts
    vit_tpu's bytes."""
    import jax.numpy as jnp
    from vit_tpu.utils import quantize as jq

    jm, v, tm, img = FAMILIES[fam]()
    for min_size in (1024, 16384):
        jq_vars = jq.quantize_weights(v, min_size=min_size)
        qstate = quantize_weights(tm, min_size=min_size)
        n = _check_codes_equal_vit_tpus(qstate, jq_vars, tm.jax_stages)
        assert n > 0 or min_size == 16384
        assert tree_nbytes(qstate) == jq.tree_nbytes(jq_vars)
    qstate = quantize_weights(tm, min_size=1024)
    jq_vars = jq.quantize_weights(v, min_size=1024)
    back = dequantize_weights(qstate)
    ref_back = from_jax_params(jq.dequantize_weights(jq_vars), tm.jax_stages)
    assert all(torch.equal(back[k], ref_back[k]) for k in ref_back)
    assert tree_nbytes(qstate) < 0.75 * tree_nbytes(tm)
    ref = np.asarray(jq.quantized_apply(jm, jq_vars, jnp.asarray(img)), np.float32)
    with torch.inference_mode():
        out = quantized_apply(tm, qstate, torch.from_numpy(img))
        plain = tm(torch.from_numpy(img))
    out = (out[0] if isinstance(out, tuple) else out).numpy()
    assert np.abs(out - ref).max() <= 2e-5 * np.abs(ref).max(), np.abs(out - ref).max()
    # the model's own (float) weights were not touched
    assert not torch.equal(plain, torch.from_numpy(out))


def test_stacked_layers_get_per_layer_scales_and_depth_decides_min_size():
    """A ViT layer of 64 x 128 (8,192 values) is compressed at min_size 16,384
    because vit_tpu's stacked leaf holds both layers (16,384); at depth 1
    vit_tpu's leaf is the layer itself and stays float."""
    _, _, tm = _vit_pair()
    q = quantize_weights(tm)
    assert isinstance(q["encoder.blocks.0.ff.w1"], dict)
    assert not isinstance(q["encoder.blocks.0.attn.out_kernel"], dict)  # 2 x 64 x 64
    one = ViT(**dict(CFG, depth=1), device="cpu")
    assert not isinstance(quantize_weights(one)["encoder.blocks.0.ff.w1"], dict)
    scales = [q[f"encoder.blocks.{i}.ff.w1"]["__scale__"] for i in (0, 1)]
    assert tuple(scales[0].shape) == (1, 128) and not torch.equal(*scales)


def test_conv_scale_on_the_ports_axis_zero_is_a_fault(monkeypatch):
    """A planted fault: the scales of CrossFormer's conv kernels taken on the
    port's OIHW layout as if it were vit_tpu's (axis 0, O, read as H) no
    longer equal vit_tpu's."""
    from vit_tpu.utils import quantize as jq

    _, v, tm, _ = _tiny_crossformer()
    monkeypatch.setattr(tq, "_CONV_TO_HWIO", (0, 1, 2, 3))
    with pytest.raises(AssertionError):
        _check_codes_equal_vit_tpus(quantize_weights(tm, min_size=1024),
                                    jq.quantize_weights(v, min_size=1024), tm.jax_stages)


def test_fake_quantized_forward_is_the_deployed_one_and_its_gradient_the_identity():
    _, _, tm = _vit_pair()
    img = torch.from_numpy(_images(2, 7))
    views = fake_quantize_weights(tm, min_size=1024)
    with torch.inference_mode():
        deployed = quantized_apply(tm, quantize_weights(tm, min_size=1024), img)
        ste = torch.func.functional_call(tm, views, (img,))
    assert torch.equal(ste, deployed)
    w = tm.encoder.blocks[0].attn.qkv_kernel
    assert not isinstance(views["encoder.blocks.0.attn.qkv_kernel"], torch.nn.Parameter)
    assert views["head.kernel"] is tm.head.kernel  # 64 x 10: too small
    g = torch.randn(w.shape)
    (views["encoder.blocks.0.attn.qkv_kernel"] * g).sum().backward()
    assert torch.equal(w.grad, g)
    tm.zero_grad()
    with tq.fake_quantized(tm, min_size=1024):
        assert not isinstance(tm.encoder.blocks[0].attn.qkv_kernel, torch.nn.Parameter)
        loss = (tm(img) ** 2).sum()
        loss.backward()
    assert tm.encoder.blocks[0].attn.qkv_kernel is w and torch.isfinite(w.grad).all()
    assert w.grad.abs().max() > 0


@pytest.mark.parametrize("mode", ["xla", "interpret"])
def test_qat_train_step_matches_jax(mode):
    """One ``make_train_step(qat=True)`` AdamW step against vit_tpu's, as
    tests/test_torch_train.py holds the float steps: Adam divides each
    gradient by its own magnitude, so the gradients' fp32 sum-order noise
    reaches the parameters at the scale of the update (lr 1e-3). Measured
    3.3e-6 (xla) and 2.9e-6 (interpret) after the step; 8e-6 is ~2.5x."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import train as jtrain

    rng = np.random.default_rng(1)
    img, labels = _images(8, 1), rng.integers(0, 10, 8)
    jm, v, tm = _vit_pair()
    jopt = jtrain.make_optimizer(1e-3, name="adamw", grad_clip_norm=0.5)
    jstate = jtrain.TrainState(v["params"], jopt.init(v["params"]), jnp.zeros((), jnp.int32))
    jstep = jtrain.make_train_step(jm, jopt, remat=True, qat=True, backend=mode)
    opt = tt.make_optimizer(1e-3, name="adamw", grad_clip_norm=0.5)
    state = tt.create_train_state(tm, opt, init=False)
    step = tt.make_train_step(tm, opt, remat=True, qat=True)
    jstate, jloss = jstep(jstate, jnp.asarray(img), jnp.asarray(labels))
    loss = step(state, torch.from_numpy(img), torch.from_numpy(labels))
    assert abs(float(loss) - float(jloss)) <= 1e-5
    ref = from_jax_params({"params": jax.device_get(jstate.params)}, tm.jax_stages)
    for k, p in tm.named_parameters():
        assert isinstance(p, torch.nn.Parameter), k
        assert np.abs(p.detach().numpy() - ref[k].numpy()).max() <= 8e-6, k


def test_qat_step_differs_from_the_float_step_and_keeps_remat_exact():
    img = torch.from_numpy(_images(4, 8))
    labels = torch.arange(4) % 10
    out = {}
    for qat, remat in ((False, True), (True, True), (True, False)):
        _, _, tm = _vit_pair()
        state = tt.create_train_state(tm, tt.make_optimizer(1e-3), init=False)
        loss = tt.make_train_step(tm, remat=remat, qat=qat)(state, img, labels)
        out[(qat, remat)] = (float(loss), {k: p.detach().clone() for k, p in tm.named_parameters()})
    assert out[(True, True)][0] != out[(False, True)][0]
    assert out[(True, True)][0] == out[(True, False)][0]
    for k, p in out[(True, True)][1].items():
        assert torch.equal(p, out[(True, False)][1][k]), k


# -- SimpleViT ------------------------------------------------------------------------

# Max |logit| difference from vit_tpu's simple_vit_apply_w8a8 (|logits| ~1):
# fp32 measured <= 1e-6 in every mode; bf16 w8 / w8a8 round the tanh-GELU
# hidden to bf16 (see QTOL), w8a8_kernel quantizes it from fp32.
STOL = {(None, m): 1e-5 for m in ("w8", "w8a8", "w8a8_kernel")}
STOL.update({("bfloat16", "w8"): 1e-2, ("bfloat16", "w8a8"): 3e-2,
             ("bfloat16", "w8a8_kernel"): 1e-5})


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("mode,batch", [("w8", 2), ("w8a8", 2), ("w8a8_kernel", 2), ("auto", 8)])
def test_simple_vit_apply_w8a8_matches_jax(mode, batch, dtype, monkeypatch):
    import jax.numpy as jnp
    from vit_tpu.models import SimpleViT as JaxSimpleViT
    from vit_tpu.utils import quantize as jq

    cfg = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4,
               mlp_dim=128, dim_head=16)
    jm, v, tm = _pair(JaxSimpleViT, SimpleViT, cfg, _images(1), dtype)
    qm = quantize_vit(tm)
    assert isinstance(qm, QuantSimpleViT) and qm.mode == "auto"
    img = _images(batch, 9)
    monkeypatch.setenv("VIT_TPU_BACKEND", "xla")
    jdt = getattr(jnp, dtype) if dtype else jnp.float32
    ref = np.asarray(jq.simple_vit_apply_w8a8(jm, jq.quantize_vit(v), jnp.asarray(img, jdt),
                                              mode=mode), np.float32)
    with torch.inference_mode():
        out = simple_vit_apply_w8a8(qm, torch.from_numpy(img).to(
            getattr(torch, dtype) if dtype else torch.float32), mode=mode).numpy()
    resolved = resolve_quant_mode(batch) if mode == "auto" else mode
    assert np.abs(out - ref).max() <= STOL[(dtype, resolved)], np.abs(out - ref).max()


def test_simple_vit_apply_w8a8_takes_a_quantized_simple_vit_only():
    _, _, tm = _vit_pair()
    with pytest.raises(TypeError):
        simple_vit_apply_w8a8(quantize_vit(tm), torch.zeros(1, 32, 32, 3))
