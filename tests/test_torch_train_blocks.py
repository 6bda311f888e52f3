"""Training NesT and RegionViT: the tiny models' loss and gradients against
``jax.value_and_grad`` of vit_tpu's (RegionViT also with
``reference_quirks``' clipped bias gather), the relative-position bias's
gradient through ``QkvAttentionFn`` with chip_smoke's planted faults (dbias
not summed over the windows, its heads reversed, the regional pass's part
of the shared ``attn`` dropped), the SAME max pool's gradient on tied
windows, AdamW steps against ``vit_tpu.train.make_train_step``, dropout with
planted keep masks (RegionViT's scanned stage among them), ``init_params``
against flax's ``init``, and the trainer and its CLI.

The helpers are ``tests/test_torch_train_branches.py``'s (``SPECS``). The
card tests carry the ``cuda`` marker: ``python -m pytest --noconftest -m
cuda tests/test_torch_train_blocks.py``.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from test_torch_train_branches import (
    FP32_TOL,
    _rel,
    card_step_fills_every_gradient,
    check_adamw_steps,
    check_dropout,
    check_init_params,
    check_loss_and_grads,
    check_trainer_and_cli,
    images,
    jax_loss_and_grads,
    model_cases,
    port,
)
from test_torch_train_zoo import _KernelsAsTwins
from vit_tpu_torch import ops
from vit_tpu_torch import train as tt
from vit_tpu_torch.nn.conv import max_pool_same, same_padding
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

FAMILIES = ("nest", "region_vit")


@pytest.mark.parametrize("model,precision,mode,route", model_cases(FAMILIES) + [
    ("region_vit quirks", "fp32", "xla", "twins"), ("region_vit quirks", "fp32", "xla",
                                                    "functions")])
def test_loss_and_grads_match_jax(model, precision, mode, route, monkeypatch):
    """NesT (kernel 3 in each block attention, folded blocks in the batch;
    kernel 2 in each ConvMLP; the aggregate's conv, LayerNorm and SAME max
    pool in plain PyTorch; bf16 logits cast to fp32 by the loss) and
    RegionViT (kernel 3 twice a layer, the joint pass with the stage's
    relative-position bias needing a gradient; its first stage scanned in
    vit_tpu; with ``reference_quirks`` the clipped gather): loss and every
    gradient against ``jax.value_and_grad`` of vit_tpu's, within the bounds
    of ``test_torch_train_branches``."""
    check_loss_and_grads(model, precision, mode, route, monkeypatch)


# -- the bias's gradient and RegionViT's shared attention, with planted faults ------------


def _plant_qkv_bias_fault(monkeypatch, fault):
    """``QkvAttentionFn``'s backward with ``fault`` (chip_smoke's
    ``QKV_BIAS_BWD_FAULTS``) planted where its bias needs a gradient."""
    plain = ops.QkvAttentionFn.backward

    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        if bias is None or not ctx.needs_input_grad[3]:
            return plain(ctx, g)
        heads, scale = ctx.config
        dqkv, dbias = cs.faulty_grads("qkv_attention", [qkv, bias],
                                      dict(heads=heads, scale=scale), g, fault)
        return None, dqkv, None, dbias, None

    monkeypatch.setattr(ops.QkvAttentionFn, "backward", staticmethod(backward))


REGION_FAULTS = cs.QKV_BIAS_BWD_FAULTS + (cs.REGION_REGIONAL_FAULT,)


@pytest.mark.parametrize("fault", REGION_FAULTS)
def test_region_faults_fail_the_bound(fault, monkeypatch):
    """RegionViT on the card's route (fp32) with each planted fault: dbias
    taken from the first window, dbias with its heads reversed (both through
    ``QkvAttentionFn``'s backward), the regional pass run on its ``attn``'s
    parameters detached. Each moves a gradient past the 1e-5 bound the
    model is held to; the bias faults the tables' ``embedding`` gradient,
    the regional one the attention's parameters."""
    img, labels = images(0, 2, 112)
    _, jgrads = jax_loss_and_grads("region_vit", "fp32", "xla")
    tm = port("region_vit")
    _KernelsAsTwins(monkeypatch)
    if fault in cs.QKV_BIAS_BWD_FAULTS:
        _plant_qkv_bias_fault(monkeypatch, fault)
        scope = contextlib.nullcontext()
    else:
        scope = cs.region_regional_detached(tm)
    with scope:
        loss = tt.cross_entropy_loss(tm(torch.from_numpy(img), train=True),
                                     torch.from_numpy(labels))
        loss.backward()
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    over = sorted((_rel(p.grad, ref[k]), k) for k, p in tm.named_parameters()
                  if _rel(p.grad, ref[k]) > FP32_TOL)
    assert over, fault
    want = "rel_pos_bias" if fault in cs.QKV_BIAS_BWD_FAULTS else ".attn."
    assert any(want in k for _, k in over), (fault, over[-3:])
    assert abs(loss.item() - jax_loss_and_grads("region_vit", "fp32", "xla")[0]) <= FP32_TOL


def test_the_bias_function_faults_fail_on_the_joint_shape():
    """``check_function`` of kernel 3's Function (its twin forward) at
    RegionViT's joint pass, 8 windows of 50 tokens, 4 heads of 32, a [1, 4,
    50, 50] bias needing a gradient: every gradient within kernel_tol's
    form of autograd through the twin, and each planted fault
    (``function_faults``: dq and dk swapped, both QKV_BIAS_BWD_FAULTS)
    past it."""
    gen = torch.Generator().manual_seed(4)
    qkv = torch.randn(8, 50, 3 * 4 * 32, generator=gen)
    bias = torch.randn(1, 4, 50, 50, generator=gen)
    kw = dict(heads=4, scale=32**-0.5)
    g = torch.randn(8, 50, 128, generator=gen)
    assert cs.function_faults("qkv_attention", [qkv, bias], kw) == [
        *cs.QKV_BWD_FAULTS, *cs.QKV_BIAS_BWD_FAULTS]
    assert cs.function_faults("qkv_attention", [qkv, None], kw) == list(cs.QKV_BWD_FAULTS)
    err = cs.check_function("cpu", "qkv_attention", [qkv, bias], kw, g,
                            forward=cs.twin_forward("qkv_attention"))
    assert err <= 1e-5


# -- the SAME max pool's gradient on tied windows -------------------------------------------


def _tied(dtype, seed=3):
    """``[2, 8, 8, 4]`` (SAME pads (0, 1), as at NesT's 56 and 28) of the
    values 0, 1, 2 (most windows tied), one channel constant (every window
    tied), and a cotangent of the pooled ``[2, 4, 4, 4]``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (2, 8, 8, 4)).astype(np.float32)
    x[..., 2] = 1.0
    return x, rng.standard_normal((2, 4, 4, 4)).astype(np.float32)


def _split_ties(x):
    """A max pool whose gradient splits a tied window's cotangent evenly
    over its maxima (``amax`` over unfolded windows): a fault the bound must
    see."""
    _, h, w, _ = x.shape
    (pt, pb), (pl, pr) = same_padding(h, 3, 2), same_padding(w, 3, 2)
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=float("-inf"))
    return xc.unfold(2, 3, 2).unfold(3, 3, 2).amax(dim=(-2, -1)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_ties_route_the_gradient_as_flax(dtype):
    """NesT's SAME max pool (3x3, stride 2, SAME's pads of -inf) on tied
    windows: the port's gradient equals flax's ``nn.max_pool`` gradient bit
    for bit, eager and jitted (each tie's cotangent to the window's first
    maximum in row-major order, in both packages); the forward equal too. A
    pool that splits a tie's cotangent evenly over its maxima moves it."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    x, g = _tied(dtype)
    jdt = getattr(jnp, dtype)
    f = lambda a: jnp.sum(fnn.max_pool(a, (3, 3), strides=(2, 2), padding="SAME")
                          .astype(jnp.float32) * g)
    refs = [np.asarray(jax.grad(fn)(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
            for fn in (f, jax.jit(f))]
    assert np.array_equal(refs[0], refs[1])
    out = {}
    for name, pool in (("port", max_pool_same), ("split", _split_ties)):
        xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
        y = pool(xt)
        (y.float() * torch.from_numpy(g)).sum().backward()
        out[name] = xt.grad.float().numpy()
        ref_y = fnn.max_pool(jnp.asarray(x).astype(jdt), (3, 3), strides=(2, 2), padding="SAME")
        assert np.array_equal(y.float().detach().numpy(), np.asarray(ref_y.astype(jnp.float32)))
    assert np.array_equal(out["port"], refs[0])
    assert np.abs(out["split"] - refs[0]).max() > 0.1


# -- AdamW, dropout, init, the trainer ------------------------------------------------------


@pytest.mark.parametrize("model", FAMILIES)
def test_adamw_steps_match_jax(model):
    """Two AdamW updates against vit_tpu's (test_torch_train_branches'
    rule)."""
    check_adamw_steps(model)


@pytest.mark.parametrize("model", FAMILIES)
def test_dropout_with_planted_masks_matches_jax(model, monkeypatch):
    """NesT at dropout 0.25 (each block attention's ``drop`` after ``to_out``,
    its attention still kernel 3's route; each ConvMLP's ``drop1`` and
    ``drop2`` on the plain path) and RegionViT at attn_dropout and
    ff_dropout 0.25 (the regional and the joint pass materialized, each with
    ``attn_drop`` and ``out_drop``, the joint one with the bias; the MLP's two;
    stage 0's two layers drawn in the order of vit_tpu's ``nn.scan``): one
    queue of planted masks, the same draws, loss and gradients within
    1e-5."""
    check_dropout(model, monkeypatch)


@pytest.mark.parametrize("model", FAMILIES + ("region_vit quirks",))
def test_init_params_matches_flax_init(model):
    check_init_params(model)


@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_and_cli_take_the_family(name, tmp_path, capsys):
    check_trainer_and_cli(name, tmp_path, capsys)


def test_nest_takes_dropout():
    """NesT's constructor takes vit_tpu's ``dropout`` field (0 by default),
    handed to every block attention and ConvMLP."""
    tm = port("nest", dropout=0.3)
    rates = {type(m).__name__: m.dropout for m in tm.modules()
             if type(m).__name__ in ("_BlockAttention", "ConvMLP")}
    assert rates == {"_BlockAttention": 0.3, "ConvMLP": 0.3}
    assert port("nest").attn_0_0.dropout == 0.0


# -- on the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model", FAMILIES)
def test_a_card_step_fills_every_gradient(cuda, model):
    card_step_fills_every_gradient(model, cuda)


@pytest.mark.cuda
def test_qkv_function_at_regionvit_joint_shape_matches_its_twin(cuda):
    """Kernel 3's Function on the card at RegionViT's preset joint pass (2
    images' 64 windows of 50 tokens, 4 heads of 32, the [1, 4, 50, 50] fp32
    bias needing a gradient): one launch, every gradient within kernel_tol's
    form of autograd through the twin, the planted faults (the bias's two
    among them) past it."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    args = [torch.randn(128, 50, 384, generator=gen, device=cuda).bfloat16(),
            torch.randn(1, 4, 50, 50, generator=gen, device=cuda)]
    kw = dict(heads=4, scale=32**-0.5)
    g = torch.randn(128, 50, 128, generator=gen, device=cuda).bfloat16()
    ops.reset_launch_counts()
    cs.check_function("card", "qkv_attention", args, kw, g)
    assert ops.launch_counts()["qkv_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_pool_ties_on_the_card_route_as_on_the_host(cuda, dtype):
    """The SAME max pool's gradient on tied windows on the card equals the
    host's (flax's choice), at NesT's preset aggregate shape too (batch 8,
    56 x 56 x 192 of three values). The cotangents are small nonzero
    integers, whose sums (up to four windows share a pixel) are exact in
    bf16 in any order: the gradients are equal exactly when each tie is sent
    to the same element."""
    rng = np.random.default_rng(5)
    big = rng.integers(0, 3, (8, 56, 56, 192)).astype(np.float32)
    for x in (_tied("float32")[0], big):
        shape = (x.shape[0], -(-x.shape[1] // 2), -(-x.shape[2] // 2), x.shape[3])
        g = (rng.integers(1, 4, shape) * rng.choice([-1, 1], shape)).astype(np.float32)
        grads = []
        for dev in (cuda, "cpu"):
            xt = torch.from_numpy(x).to(dev, dtype).requires_grad_()
            (max_pool_same(xt).float() * torch.from_numpy(g).to(dev)).sum().backward()
            grads.append(xt.grad.float().cpu())
        moved = int((grads[0] != grads[1]).sum())
        assert moved == 0, (moved, tuple(x.shape))
