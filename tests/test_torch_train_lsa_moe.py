"""Training the small-dataset ViT and ViT-MoE: the tiny models' loss and
gradients against ``jax.value_and_grad`` of vit_tpu's, dropout with planted
keep masks (ViT-MoE's expert-hidden mask drawn over ``[E, B, C, F]``), LSA's
``log_temperature`` at init bit for bit and under grad, chip_smoke's
planted faults (``log_temperature`` detached, the expert mask without
``1/keep``), AdamW steps against ``vit_tpu.train.make_train_step``,
``init_params`` against flax's ``init`` (the experts' 3-D fan-in among it),
and the trainer and its CLI.

The helpers are ``tests/test_torch_train_branches.py``'s (``SPECS``). The
card tests carry the ``cuda`` marker: ``python -m pytest --noconftest -m
cuda tests/test_torch_train_lsa_moe.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_train_branches import (
    FP32_TOL,
    MASK_SEED,
    SPECS,
    _rel,
    card_step_fills_every_gradient,
    check_adamw_steps,
    check_dropout,
    check_init_params,
    check_loss_and_grads,
    check_trainer_and_cli,
    images,
    jax_drop,
    jax_loss_and_grads,
    model_cases,
    port,
    port_drop_grads,
)
from test_torch_train_heads import _MaskQueue
from test_torch_train_zoo import _KernelsAsTwins
from vit_tpu_torch import train as tt
from vit_tpu_torch.models import ViTMoE
from vit_tpu_torch.nn.attention import log_temperature_init
from vit_tpu_torch.nn.moe import expert_capacity
from vit_tpu_torch.utils import from_jax_params, init_params

torch.set_num_threads(2)

FAMILIES = ("vit_small_datasets", "vit_moe")


@pytest.mark.parametrize("model,precision,mode,route", model_cases(FAMILIES))
def test_loss_and_grads_match_jax(model, precision, mode, route, monkeypatch):
    """The small-dataset ViT (SPT, every LSA layer materialized in plain
    PyTorch with ``log_temperature`` under grad, kernel 2 in each MLP, its
    encoder scanned and rematted in vit_tpu) and ViT-MoE (kernel 1 in each
    attention, kernel 2 in its dense MLP, the MoE layer in plain PyTorch, its
    router trained through the gates): loss and every gradient against
    ``jax.value_and_grad`` of vit_tpu's, within the bounds of
    ``test_torch_train_branches``."""
    check_loss_and_grads(model, precision, mode, route, monkeypatch)


# -- LSA's learned temperature ----------------------------------------------------------------


@pytest.mark.parametrize("dim_head", [8, 16, 32, 48, 64, 80, 96, 128, 21, 29, 43, 133])
def test_log_temperature_init_is_vit_tpus_bit_for_bit(dim_head):
    """``log_temperature`` at construction and from ``init_params`` equals
    vit_tpu's ``jnp.full((), jnp.log(dim_head**-0.5), jnp.float32)`` bit for
    bit at the head widths of the presets and tiny configs, the others
    that are multiples of 16, and widths where other logs miss it: the
    float64 log rounded to fp32 is one ulp off at 21, a correctly rounded
    fp32 log at 29, 43 and 133."""
    import jax.numpy as jnp

    from vit_tpu_torch.nn.attention import Attention

    want = np.asarray(jnp.full((), jnp.log(dim_head**-0.5), jnp.float32))
    a = Attention(dim_head * 2, 2, dim_head, mask_self=True, learned_temperature=True,
                  device="cpu")
    assert a.log_temperature.detach().numpy().tobytes() == want.tobytes()
    init_params(a, torch.Generator().manual_seed(0))
    assert a.log_temperature.detach().numpy().tobytes() == want.tobytes()
    assert log_temperature_init(dim_head).dtype == torch.float32


def _run_faulty(model, scope, monkeypatch, drop=False):
    """The port's loss and gradients on the card's route (fp32) inside
    ``scope(tm)``; with ``drop``, at DROP's rates with planted masks."""
    img, labels = images(0, 2, SPECS[model][2])
    with monkeypatch.context() as mp:
        _KernelsAsTwins(mp)
        if drop:
            loss, tm = port_drop_grads(model, mp, _MaskQueue(MASK_SEED), scope)
        else:
            tm = port(model)
            with scope(tm):
                loss = tt.cross_entropy_loss(tm(torch.from_numpy(img), train=True),
                                             torch.from_numpy(labels))
                loss.backward()
    return loss, tm


def test_detached_temperature_fails_the_bound(monkeypatch):
    """The small-dataset ViT with LSA_TEMPERATURE_FAULT planted: every
    layer's ``log_temperature`` gets no gradient, where vit_tpu's is far
    from zero (the loss unmoved)."""
    jloss, jgrads = jax_loss_and_grads("vit_small_datasets", "fp32", "xla")
    loss, tm = _run_faulty("vit_small_datasets", cs.lsa_temperature_detached, monkeypatch)
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    temps = [k for k in ref if k.endswith("log_temperature")]
    assert len(temps) == 2 and all(float(ref[k].abs()) > 1e-4 for k in temps)
    assert all(tm.get_parameter(k).grad is None for k in temps)
    assert abs(loss.item() - jloss) <= FP32_TOL


# -- ViT-MoE's expert dropout ----------------------------------------------------------------


def test_expert_mask_is_drawn_over_e_b_c_f(monkeypatch):
    """Under ``train`` the MoE layer draws its one expert-hidden mask over
    ``[E, B, C, F]``, capacity slots that no token fills included, as flax's
    ``Dropout`` over vit_tpu's dispatched buffer; outside ``train``,
    none."""
    import vit_tpu_torch.nn.attention as tna

    cfg = SPECS["vit_moe"][1]
    moe = port("vit_moe", dropout=0.25).moe_1
    queue = _MaskQueue(3)
    monkeypatch.setattr(tna, "bernoulli", lambda keep, shape, gen, dev: torch.from_numpy(
        queue.draw(keep, shape)))
    x = torch.randn(2, 17, cfg["dim"])
    with torch.no_grad():
        moe(x, train=True)
        moe(x)
    c = expert_capacity(17, cfg["num_selected"], cfg["num_experts"], 1.25)
    assert queue.drawn == [(0.75, (cfg["num_experts"], 2, c, cfg["mlp_dim"]))]


@pytest.mark.parametrize("model", FAMILIES)
def test_dropout_with_planted_masks_matches_jax(model, monkeypatch):
    """The small-dataset ViT at dropout and emb_dropout 0.25 (``emb_drop``
    after the positions, each LSA layer's ``attn_drop`` and ``out_drop``,
    each MLP's two) and ViT-MoE at dropout 0.25 (each attention
    materialized with its two, the MoE layer's expert-hidden mask, the dense
    MLP's two, layer after layer): one queue of planted masks, the same
    draws at the same shapes, loss and gradients within 1e-5."""
    check_dropout(model, monkeypatch)


def test_unscaled_expert_mask_fails_the_bound(monkeypatch):
    """ViT-MoE at dropout 0.25 with EXPERT_MASK_FAULT planted (the same
    planted masks, the kept values not divided by the keep probability): its
    expert and router gradients leave the 1e-5 bound."""
    _, jgrads, _ = jax_drop("vit_moe")
    loss, tm = _run_faulty("vit_moe", lambda tm: cs.moe_mask_unscaled(), monkeypatch, drop=True)
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    over = [k for k, p in tm.named_parameters() if _rel(p.grad, ref[k]) > 100 * FP32_TOL]
    assert any("moe_1.expert_w1" in k for k in over), over


# -- AdamW, init, the trainer ------------------------------------------------------------


def _unrouted_experts(tm):
    """The values of ViT-MoE's experts that no token reached in the last
    update (their four tensors' gradients exactly zero): their gradient is
    zero by routing. At the tiny config one expert of four gets no token of
    ``images(1, 4)``: 4,192 of 36,750 values."""
    moe = tm.moe_1
    tensors = (moe.expert_w1, moe.expert_b1, moe.expert_w2, moe.expert_b2)
    idle = [e for e in range(moe.num_experts) if all(not t.grad[e].any() for t in tensors)]
    return sum(t[e].numel() for e in idle for t in tensors)


@pytest.mark.parametrize("model", FAMILIES)
def test_adamw_steps_match_jax(model):
    """Two AdamW updates against vit_tpu's (test_torch_train_branches'
    rule; ViT-MoE's unrouted experts left out of KEPT_SHARE's count: with
    them 87.9% of its values kept their gradient above ADAM_TAU in the first
    update, without them 99.2%)."""
    check_adamw_steps(model, _unrouted_experts if model == "vit_moe" else None)


@pytest.mark.parametrize("model", FAMILIES)
def test_init_params_matches_flax_init(model):
    """``init_params`` leaf by leaf against flax's ``init``: SPT's bias-free
    ``norm.scale`` ones and its ``proj`` lecun, each ``log_temperature``
    bit for bit; ViT-MoE's ``expert_w1`` / ``expert_w2`` lecun over flax's
    3-D fan-in (D * E and F * E), ``expert_b1`` / ``expert_b2`` zeros, the
    router a Dense."""
    check_init_params(model)


def test_expert_fan_in_is_flax_three_d_rule():
    """flax's ``lecun_normal`` over an ``(8, 512, 2048)`` expert kernel has
    std ``1 / sqrt(512 * 8)`` (0.0156), not ``1 / sqrt(512)`` (0.0442), and
    so has ``init_params``' ``expert_w1`` of the docs' ViT-MoE width."""
    import jax
    import jax.numpy as jnp
    from flax.linen import initializers

    ref = np.asarray(initializers.lecun_normal()(jax.random.PRNGKey(0), (8, 512, 2048),
                                                 jnp.float32))
    assert abs(ref.std() - (512 * 8) ** -0.5) <= 0.01 * (512 * 8) ** -0.5
    tm = ViTMoE(image_size=32, patch_size=16, num_classes=4, dim=512, depth=2, heads=8,
                mlp_dim=2048, device="cpu")
    init_params(tm, torch.Generator().manual_seed(0))
    for name, fan in (("expert_w1", 512 * 8), ("expert_w2", 2048 * 8)):
        std = float(getattr(tm.moe_1, name).detach().std())
        assert abs(std - fan**-0.5) <= 0.01 * fan**-0.5, (name, std)


def test_trainer_and_cli_take_the_small_dataset_vit(tmp_path, capsys):
    check_trainer_and_cli("vit_small_datasets", tmp_path, capsys)


def test_trainer_takes_vit_moe_with_dropout():
    """``make_train_step`` trains a ViT-MoE above dropout 0 (it refused one
    before), from ``init_params``, with its load-balance loss: two AdamW
    steps on the CPU give finite losses and move every parameter."""
    tm = ViTMoE(**dict(SPECS["vit_moe"][1], dropout=0.1), device="cpu")
    opt = tt.make_optimizer(1e-3, name="adamw")
    state = tt.create_train_state(tm, opt, torch.Generator().manual_seed(0))
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    step = tt.make_train_step(tm, opt, moe_aux_weight=0.01)
    x, y = (torch.from_numpy(a) for a in images(2, 4, 32))
    losses = [float(step(state, x, y)) for _ in range(2)]
    assert all(np.isfinite(losses))
    assert all(not torch.equal(p.detach(), before[k]) for k, p in tm.named_parameters())



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
def test_vit_moe_dropout_step_on_the_card(cuda):
    """A bf16 ViT-MoE at dropout 0.1 on the card under grad: no kernel
    launched (every attention materializes, every MLP takes its plain
    path), every gradient set and finite."""
    from vit_tpu_torch import ops

    tm = init_params(ViTMoE(**dict(SPECS["vit_moe"][1], dropout=0.1), dtype=torch.bfloat16,
                            device=cuda), torch.Generator(cuda).manual_seed(0))
    x = torch.randn(2, 32, 32, 3, device=cuda)
    ops.reset_launch_counts()
    tt.cross_entropy_loss(tm(x, train=True, generator=torch.Generator(cuda).manual_seed(1)),
                          torch.arange(2, device=cuda)).backward()
    assert not any(ops.launch_counts().values())
    for name, p in tm.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
