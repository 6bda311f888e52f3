"""Batch augmentations and training regularizers (port of ``vit_tpu/augment.py``).

The deterministic pieces compute what ``vit_tpu``'s do, op for op:
``one_hot`` (with label smoothing), ``soft_cross_entropy``, ``Ema`` (an fp32
shadow of the parameters, ``e * d + p * (1 - d)``) and ``distillation_loss``.

The random ones take a ``torch.Generator`` where ``vit_tpu`` takes a PRNG key,
and draw on the generator's device. Their draws cannot be JAX's; their
distributions and rules are: ``random_hflip``, ``random_crop`` (zero pad,
then a random window back out), ``color_jitter``, ``mixup`` and ``cutmix``
(each sample with its roll-by-one partner, one lambda a batch from
Beta(alpha, alpha); cutmix's label weights are the pasted box's realized
area), ``mixup_or_cutmix`` (a coin a batch) and ``random_erasing``. Images
are NHWC batches, as in ``vit_tpu``. The Beta draw and the coins are read
on the host (one small copy a call).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn

# -- targets -------------------------------------------------------------------


def one_hot(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0) -> torch.Tensor:
    """Integer labels -> an fp32 target distribution; with ``smoothing=s`` the
    true class gets ``1 - s`` plus the uniform floor ``s / num_classes``."""
    t = nn.functional.one_hot(labels.long(), num_classes).float()
    if smoothing:
        t = t * (1.0 - smoothing) + smoothing / num_classes
    return t


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy against soft targets, in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(target_probs * logp, dim=-1))


# -- pixel-space augmentations (NHWC) -------------------------------------------


def _uniform(generator, shape, device, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo if (lo, hi) != (0.0, 1.0) else u


def random_hflip(generator: torch.Generator, images: torch.Tensor,
                 prob: float = 0.5) -> torch.Tensor:
    """Each sample flipped left-right with probability ``prob``."""
    flip = _uniform(generator, (images.shape[0],), images.device) < prob
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def random_crop(generator: torch.Generator, images: torch.Tensor, padding: int = 4) -> torch.Tensor:
    """Zero-pad ``padding`` pixels on each side, then take each sample's
    H x W window back out at an offset drawn uniformly from
    ``[0, 2 * padding]`` on each axis."""
    b, h, w, _ = images.shape
    padded = nn.functional.pad(images, (0, 0, padding, padding, padding, padding))
    off = torch.randint(0, 2 * padding + 1, (b, 2), generator=generator, device=images.device)
    rows = off[:, :1] + torch.arange(h, device=images.device)
    cols = off[:, 1:] + torch.arange(w, device=images.device)
    idx = torch.arange(b, device=images.device)[:, None, None]
    return padded[idx, rows[:, :, None], cols[:, None, :]]


def color_jitter(generator: torch.Generator, images: torch.Tensor, brightness: float = 0.2,
                 contrast: float = 0.2) -> torch.Tensor:
    """Per-sample brightness (a factor from ``[1 - b, 1 + b]``) then contrast
    about each image's mean (a factor from ``[1 - c, 1 + c]``), in fp32; the
    output keeps the input's dtype."""
    b = images.shape[0]
    x = images.float()
    if brightness:
        x = x * _uniform(generator, (b, 1, 1, 1), images.device, 1 - brightness, 1 + brightness)
    if contrast:
        f = _uniform(generator, (b, 1, 1, 1), images.device, 1 - contrast, 1 + contrast)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        x = mean + (x - mean) * f
    return x.to(images.dtype)


def _box_masks(generator, h: int, w: int, frac: torch.Tensor):
    """``[n, h, w]`` bool masks of boxes covering about ``frac`` (``[n]``) of
    the area (sides ``round(side * sqrt(frac))``, centres uniform, clipped at
    the border), and each box's realized area fraction (``vit_tpu``'s
    ``_box_mask``, one box a row)."""
    dev = frac.device
    rh = torch.round(h * torch.sqrt(frac)).long()
    rw = torch.round(w * torch.sqrt(frac)).long()
    cy = torch.randint(0, h, frac.shape, generator=generator, device=dev)
    cx = torch.randint(0, w, frac.shape, generator=generator, device=dev)
    y0, y1 = (cy - rh // 2).clamp(0, h), (cy + (rh + 1) // 2).clamp(0, h)
    x0, x1 = (cx - rw // 2).clamp(0, w), (cx + (rw + 1) // 2).clamp(0, w)
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    mask = ((ys >= y0[:, None, None]) & (ys < y1[:, None, None])
            & (xs >= x0[:, None, None]) & (xs < x1[:, None, None]))
    realized = ((y1 - y0) * (x1 - x0)).float() / float(h * w)
    return mask, realized


def beta(generator: torch.Generator, a: float, b: float, device) -> float:
    """One draw from Beta(a, b) by Johnk's method: U^(1/a) / (U^(1/a) +
    V^(1/b)), accepted when the sum is at most 1; in logs, so small ``a``
    and ``b`` do not underflow."""
    while True:
        u, v = torch.rand(2, generator=generator, device=device, dtype=torch.float64).tolist()
        if u == 0.0 or v == 0.0:
            continue
        lx, ly = math.log(u) / a, math.log(v) / b
        top = max(lx, ly)
        sx, sy = math.exp(lx - top), math.exp(ly - top)
        if math.log(sx + sy) + top <= 0.0:
            return sx / (sx + sy)


def mixup(generator: torch.Generator, images: torch.Tensor, target_probs: torch.Tensor,
          alpha: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixup: each sample convex-combined with its roll-by-one partner, one
    lambda ~ Beta(alpha, alpha) a batch, in fp32; targets likewise."""
    lam = beta(generator, alpha, alpha, images.device)
    partner = torch.roll(images, 1, dims=0)
    mixed = images.float() * lam + partner.float() * (1 - lam)
    t = target_probs * lam + torch.roll(target_probs, 1, dims=0) * (1 - lam)
    return mixed.to(images.dtype), t


def cutmix(generator: torch.Generator, images: torch.Tensor, target_probs: torch.Tensor,
           alpha: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """CutMix: one box of about ``1 - lambda`` of the area (lambda ~
    Beta(alpha, alpha)) pasted from each sample's roll-by-one partner; the
    targets mix by the box's realized area."""
    lam = beta(generator, alpha, alpha, images.device)
    frac = torch.full((1,), 1.0 - lam, device=images.device)
    mask, pasted = _box_masks(generator, images.shape[1], images.shape[2], frac)
    partner = torch.roll(images, 1, dims=0)
    mixed = torch.where(mask[0][None, :, :, None], partner, images)
    keep = 1.0 - pasted
    t = target_probs * keep + torch.roll(target_probs, 1, dims=0) * pasted
    return mixed, t


def mixup_or_cutmix(generator: torch.Generator, images: torch.Tensor, target_probs: torch.Tensor,
                    mixup_alpha: float = 0.2, cutmix_alpha: float = 1.0,
                    cutmix_prob: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """A coin a batch: cutmix with probability ``cutmix_prob``, else mixup
    (the DeiT recipe)."""
    coin = torch.rand((), generator=generator, device=images.device).item()
    if coin < cutmix_prob:
        return cutmix(generator, images, target_probs, cutmix_alpha)
    return mixup(generator, images, target_probs, mixup_alpha)


def random_erasing(generator: torch.Generator, images: torch.Tensor, prob: float = 0.25,
                   area_range: Tuple[float, float] = (0.02, 0.33)) -> torch.Tensor:
    """Random erasing: with probability ``prob`` a sample gets a zeroed box
    of an area fraction drawn uniformly from ``area_range``."""
    b, h, w, _ = images.shape
    apply = _uniform(generator, (b,), images.device) < prob
    frac = _uniform(generator, (b,), images.device, *area_range)
    masks, _ = _box_masks(generator, h, w, frac)
    erase = masks & apply[:, None, None]
    return torch.where(erase[..., None], torch.zeros((), dtype=images.dtype,
                                                     device=images.device), images)


# -- EMA of parameters ------------------------------------------------------------


ParamSource = Union[nn.Module, Mapping[str, torch.Tensor]]


def _named(params: ParamSource) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


class Ema:
    """An exponential moving average of parameters (the eval-time weights of
    the DeiT and CaiT recipes): an fp32 shadow ``params`` by name, moved by
    ``update`` to ``e * decay + p * (1 - decay)``, in place. Parameters
    only, as ``vit_tpu``'s over ``state.params``: a BatchNorm's running
    statistics are buffers and are not averaged."""

    def __init__(self, params: Dict[str, torch.Tensor], decay: float):
        self.params, self.decay = params, decay

    @staticmethod
    def init(params: ParamSource, decay: float = 0.9999) -> "Ema":
        """A shadow of ``params`` (a module's parameters, or tensors by name)."""
        return Ema({k: v.detach().float().clone() for k, v in _named(params).items()}, decay)

    @torch.no_grad()
    def update(self, new_params: ParamSource) -> "Ema":
        d = self.decay
        for k, p in _named(new_params).items():
            e = self.params[k]
            e.copy_(e * d + p.detach().float() * (1 - d))
        return self

    def state_dict(self) -> dict:
        return {"params": self.params, "decay": self.decay}

    def load_state_dict(self, state: dict) -> None:
        self.params = {k: v.clone() for k, v in state["params"].items()}
        self.decay = state["decay"]


# -- distillation -------------------------------------------------------------------


def distillation_loss(logits: torch.Tensor, distill_logits: torch.Tensor,
                      target_probs: torch.Tensor, teacher_logits: torch.Tensor,
                      alpha: float = 0.5, tau: float = 1.0, hard: bool = True,
                      ) -> torch.Tensor:
    """The LeViT / DeiT distillation objective: ``(1 - alpha)`` times the
    classification head's soft cross-entropy on ``target_probs``, plus
    ``alpha`` times the distill head's loss on the teacher: cross-entropy on
    the teacher's argmax (``hard``) or the soft KL at temperature ``tau``,
    scaled by ``tau**2``. The teacher's logits carry no gradient."""
    teacher_logits = teacher_logits.detach().float()
    ce = soft_cross_entropy(logits, target_probs)
    if hard:
        t = one_hot(teacher_logits.argmax(dim=-1), teacher_logits.shape[-1])
        dl = soft_cross_entropy(distill_logits, t)
    else:
        t = torch.softmax(teacher_logits / tau, dim=-1)
        logp = torch.log_softmax(distill_logits.float() / tau, dim=-1)
        dl = -torch.mean(torch.sum(t * logp, dim=-1)) * tau**2
    return (1 - alpha) * ce + alpha * dl


__all__ = ["one_hot", "soft_cross_entropy", "random_hflip", "random_crop", "color_jitter",
           "beta", "mixup", "cutmix", "mixup_or_cutmix", "random_erasing", "Ema",
           "distillation_loss"]
