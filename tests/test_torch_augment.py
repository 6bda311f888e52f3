"""The port's augmentations and regularizers (``vit_tpu_torch/augment.py``)
against ``vit_tpu/augment.py`` on the CPU.

The deterministic pieces (``one_hot``, ``soft_cross_entropy``, ``Ema``,
``distillation_loss``) take the same numpy inputs as JAX's and must agree
with them. The random ones draw from a ``torch.Generator``, so they are held
to the properties ``tests/test_augment.py`` checks of JAX's, and to one
generator seed giving one result.
"""

import numpy as np
import pytest
import torch

from vit_tpu_torch import augment as aug
from vit_tpu_torch import train as tt

torch.set_num_threads(2)

_rng = np.random.default_rng(0)
IMG = _rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
LABELS = np.arange(8) % 4
LOGITS = _rng.standard_normal((8, 4)).astype(np.float32)
TEACHER = _rng.standard_normal((8, 4)).astype(np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- deterministic: against JAX ------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_one_hot_and_soft_cross_entropy_match_jax(smoothing):
    import jax.numpy as jnp
    from vit_tpu import augment as jaug

    ref = np.asarray(jaug.one_hot(jnp.asarray(LABELS), 4, smoothing))
    t = aug.one_hot(_t(LABELS), 4, smoothing)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), ref)
    ce = aug.soft_cross_entropy(_t(LOGITS), t)
    ref_ce = float(jaug.soft_cross_entropy(jnp.asarray(LOGITS), jnp.asarray(ref)))
    assert abs(float(ce) - ref_ce) <= 1e-6 * abs(ref_ce)
    if not smoothing:  # soft CE on one-hot targets is the hard CE
        assert abs(float(ce) - float(tt.cross_entropy_loss(_t(LOGITS), _t(LABELS)))) <= 1e-6


@pytest.mark.parametrize("decay", [0.0, 0.5, 0.999])
def test_ema_matches_jax(decay):
    import jax.numpy as jnp
    from vit_tpu import augment as jaug

    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    jema = jaug.Ema.init({k: jnp.asarray(v) for k, v in params.items()}, decay)
    ema = aug.Ema.init({k: _t(v) for k, v in params.items()}, decay)
    for i in range(5):
        new = {k: v + (i + 1) * rng.standard_normal(v.shape).astype(np.float32)
               for k, v in params.items()}
        jema = jema.update({k: jnp.asarray(v) for k, v in new.items()})
        ema.update({k: _t(v) for k, v in new.items()})
    for k in params:
        np.testing.assert_allclose(ema.params[k].numpy(), np.asarray(jema.params[k]),
                                   rtol=1e-6, atol=1e-6)


def test_ema_of_a_module_is_an_fp32_shadow():
    lin = torch.nn.Linear(3, 2).bfloat16()
    ema = aug.Ema.init(lin, decay=0.5)
    assert all(v.dtype == torch.float32 for v in ema.params.values())
    with torch.no_grad():
        lin.weight.fill_(2.0)
    w0 = ema.params["weight"].clone()
    ema.update(lin)
    torch.testing.assert_close(ema.params["weight"], w0 * 0.5 + 1.0, rtol=0, atol=0)


@pytest.mark.parametrize("hard,alpha,tau", [(True, 0.5, 1.0), (False, 0.3, 2.0),
                                            (True, 0.0, 1.0), (False, 1.0, 1.0)])
def test_distillation_loss_matches_jax(hard, alpha, tau):
    import jax.numpy as jnp
    from vit_tpu import augment as jaug

    t = aug.one_hot(_t(LABELS), 4, 0.1)
    distill = LOGITS[::-1].copy()
    ref = float(jaug.distillation_loss(jnp.asarray(LOGITS), jnp.asarray(distill),
                                       jnp.asarray(t.numpy()), jnp.asarray(TEACHER),
                                       alpha=alpha, tau=tau, hard=hard))
    teacher = _t(TEACHER).requires_grad_()
    loss = aug.distillation_loss(_t(LOGITS), _t(distill), t, teacher, alpha=alpha, tau=tau,
                                 hard=hard)
    assert abs(float(loss) - ref) <= 1e-6 * max(1.0, abs(ref))
    assert not loss.requires_grad  # the teacher carries no gradient


# -- random: the properties of tests/test_augment.py ---------------------------------------


def test_hflip_prob_edges():
    x = _t(IMG)
    assert torch.equal(aug.random_hflip(_gen(), x, prob=0.0), x)
    assert torch.equal(aug.random_hflip(_gen(), x, prob=1.0), x.flip(2))
    half = aug.random_hflip(_gen(), x, prob=0.5)
    flipped = [torch.equal(half[i], x[i].flip(1)) for i in range(8)]
    kept = [torch.equal(half[i], x[i]) for i in range(8)]
    assert all(f or k for f, k in zip(flipped, kept))


def test_random_crop_zero_padding_is_identity_and_moves_mass():
    x = _t(IMG)
    assert torch.equal(aug.random_crop(_gen(), x, padding=0), x)
    out = aug.random_crop(_gen(), x, padding=3)
    assert out.shape == x.shape
    assert float(out.abs().sum()) <= float(x.abs().sum()) + 1e-4
    # each sample is a window of its zero-padded image
    padded = torch.nn.functional.pad(x, (0, 0, 3, 3, 3, 3))
    for i in range(8):
        assert any(torch.equal(out[i], padded[i, a:a + 16, b:b + 16])
                   for a in range(7) for b in range(7))


def test_color_jitter_zero_is_identity_and_factors_stay_in_range():
    x = _t(IMG)
    assert torch.equal(aug.color_jitter(_gen(), x, brightness=0.0, contrast=0.0), x)
    out = aug.color_jitter(_gen(), x, brightness=0.2, contrast=0.0)
    ratio = (out / x).reshape(8, -1)
    assert torch.allclose(ratio, ratio[:, :1].expand_as(ratio), rtol=1e-4)
    assert bool(((ratio[:, 0] >= 0.8 - 1e-6) & (ratio[:, 0] <= 1.2 + 1e-6)).all())
    assert aug.color_jitter(_gen(), x.bfloat16()).dtype == torch.bfloat16


def test_mixup_preserves_batch_mean_and_target_rows():
    t = aug.one_hot(_t(LABELS), 4)
    mixed, tm = aug.mixup(_gen(), _t(IMG), t, alpha=0.4)
    assert mixed.shape == IMG.shape
    assert abs(float(mixed.mean()) - float(IMG.mean())) <= 1e-5 * max(1.0, abs(IMG.mean()))
    torch.testing.assert_close(tm.sum(-1), torch.ones(8), rtol=1e-5, atol=1e-6)


def test_cutmix_pixels_come_from_one_source_and_weights_match_area():
    t = aug.one_hot(_t(LABELS), 4)
    mixed, tm = aug.cutmix(_gen(3), _t(IMG), t, alpha=1.0)
    x = IMG
    partner = np.roll(x, 1, axis=0)
    m = mixed.numpy()
    from_self, from_partner = np.isclose(m, x), np.isclose(m, partner)
    assert np.all(from_self | from_partner)
    pasted = np.mean(from_partner[0] & ~from_self[0])
    torch.testing.assert_close(tm.sum(-1), torch.ones(8), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tm[0, int(LABELS[7])]), pasted, atol=0.02)


@pytest.mark.parametrize("prob,expect", [(0.0, "mixup"), (1.0, "cutmix")])
def test_mixup_or_cutmix_coin_edges(prob, expect):
    t = aug.one_hot(_t(LABELS), 4)
    mixed, tm = aug.mixup_or_cutmix(_gen(4), _t(IMG), t, cutmix_prob=prob)
    assert mixed.shape == IMG.shape and tm.shape == t.shape
    exact = np.isclose(mixed.numpy(), IMG) | np.isclose(mixed.numpy(), np.roll(IMG, 1, axis=0))
    assert exact.all() == (expect == "cutmix")


def test_random_erasing_edges():
    x = _t(IMG)
    assert torch.equal(aug.random_erasing(_gen(), x, prob=0.0), x)
    out = aug.random_erasing(_gen(), x, prob=1.0)
    zeroed = (out == 0.0).float().mean(dim=(1, 2, 3))
    assert bool((zeroed > 0).all()) and bool((zeroed < 0.6).all())


def test_beta_draws_have_the_beta_mean():
    gen = _gen(5)
    for a in (0.2, 1.0, 4.0):
        draws = np.array([aug.beta(gen, a, a, "cpu") for _ in range(2000)])
        assert ((draws >= 0) & (draws <= 1)).all()
        assert abs(draws.mean() - 0.5) <= 0.03
        # Var = 1 / (4 (2a + 1)) for Beta(a, a)
        assert abs(draws.var() - 1 / (4 * (2 * a + 1))) <= 0.2 / (4 * (2 * a + 1))


@pytest.mark.parametrize("fn", ["random_hflip", "random_crop", "color_jitter", "mixup",
                                "cutmix", "mixup_or_cutmix", "random_erasing"])
def test_one_seed_one_result(fn):
    t = aug.one_hot(_t(LABELS), 4)
    f = getattr(aug, fn)
    call = (lambda g: f(g, _t(IMG), t)) if "mix" in fn else (lambda g: (f(g, _t(IMG)),))
    a, b, c = call(_gen(7)), call(_gen(7)), call(_gen(8))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    if fn != "random_erasing":  # erasing at p 0.25 can leave both batches whole
        assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_augmented_train_step_learns():
    """An augmented (soft-target) step and a distillation step train the tiny
    ViT: the loss falls over a few steps on one batch."""
    from vit_tpu_torch.models import ViT

    model = ViT(image_size=16, patch_size=8, num_classes=4, dim=32, depth=2, heads=2,
                dim_head=16, mlp_dim=64, device="cpu")
    opt = tt.make_optimizer(1e-2)
    state = tt.create_train_state(model, opt, _gen(9))

    def augment_fn(g, imgs, lbls):
        return aug.mixup(g, aug.random_hflip(g, imgs), aug.one_hot(lbls, 4, 0.1), alpha=0.2)

    teacher = ViT(image_size=16, patch_size=8, num_classes=4, dim=32, depth=1, heads=2,
                  dim_head=16, mlp_dim=64, device="cpu")
    for kw in (dict(augment_fn=augment_fn), dict(teacher_apply=teacher)):
        step = tt.make_train_step(model, opt, remat=False, **kw)
        losses = [float(step(state, _t(IMG), _t(LABELS))) for _ in range(8)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], (kw, losses)
