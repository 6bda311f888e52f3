"""Training: loss, optimizers, schedules and the train step (port of
``vit_tpu/train.py:36-394``), and the single-card trainer of
``examples/train.py`` (``python -m vit_tpu_torch.train``).

One card, eager PyTorch. The state is a ``TrainState`` (the model, a
``torch.optim`` optimizer and its schedule, the step, the generator of the
step's dropout and augmentation draws). ``make_optimizer`` returns an
``Optimizer``, the recipe ``vit_tpu`` builds with optax:

- ``adamw``: ``torch.optim.AdamW`` (its update is optax's ``adamw`` within
  fp32 rounding: ``sqrt(v) / sqrt(1 - b2^t)`` where optax takes
  ``sqrt(v / (1 - b2^t))``);
- ``lamb``: ``Lamb``, optax's ``lamb`` (``scale_by_adam`` with eps 1e-6,
  ``add_decayed_weights``, ``scale_by_trust_ratio``, the learning rate);
- ``muon``: ``Muon``, optax's ``contrib.muon`` (Nesterov momentum
  orthogonalized by Newton-Schulz on the leaves of ``vit_tpu``'s tree that
  are matrices, NAdamW on the others);
- the learning rate a float or a schedule of the update count, evaluated as
  optax does: the first update uses ``schedule(0)``;
- ``grad_clip_norm``: ``clip_by_global_norm``, optax's rule (``g / norm *
  max_norm`` once ``norm >= max_norm``; ``torch.nn.utils.clip_grad_norm_``
  adds 1e-6 to the norm).

``make_train_step`` returns ``step(state, images, labels) -> loss``: the
forward with ``train=True`` (on the card the kernels forward and their
autograd Functions' backward: ``ops.AttentionBlockFn`` and ``ops.MlpFn`` for
ViT; ``ops.WindowAttentionBlockFn``, ``ops.FlashAttentionFn`` and
``ops.MlpFn`` for Twins-SVT; ``ops.FlashAttentionFn`` on kernel 5,
``ops.AttentionBlockFn`` and ``ops.MlpFn`` for T2T-ViT;
``ops.TalkingHeadsBlockFn`` and ``ops.MlpFn`` for CaiT;
``ops.ReattentionBlockFn`` and ``ops.MlpFn`` for DeepViT;
``ops.AttentionBlockFn`` and ``ops.MlpFn`` for EfficientViT's encoder and
CrossViT's encoders deeper than 1; ``ops.QkvAttentionFn`` and ``ops.MlpFn``
for ParallelViT's branches, PatchMerger-ViT's layers, NesT's blocks and
RegionViT's regional and joint passes, the latter's relative-position bias
taking its gradient through it; a bf16 ``Dense``
through ``nn.embed.MmRoundedFn``), per-block remat, ``accum_steps``
microbatches averaged before
one update, soft targets under ``augment_fn``, distillation under
``teacher_apply``, ViT-MoE's load-balance loss under ``moe_aux_weight``,
weight-only int8 QAT under ``qat`` (``utils.quantize.fake_quantized``).
Training is ported for ``ViT``, ``ViTMoE``, ``TwinsSVT``, ``T2TViT``,
``CaiT``, ``DeepViT``, ``CvT``, ``LeViT``, ``PiT``, ``SimpleViT``,
``EfficientViT``, ``CrossViT``, ``ParallelViT``, ``PatchMergerViT``,
``NesT`` and ``RegionViT``; ScalableViT, CrossFormer and the small-dataset
ViT raise, and so do ViT-MoE with dropout and a BatchNorm-folded
(``fold_bn=True``) CvT or LeViT, which is inference only. CaiT and DeepViT
reach kernels 7 and 8 only at ``dropout=0``: their presets' ``dropout=0.1``
takes ``vit_tpu``'s materializing route in training, which launches
neither; so do the presets' ``dropout=0.1`` of CrossViT, ParallelViT and
PatchMerger-ViT keep kernels 1, 2 and 3 out of their steps.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import math
import pathlib
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

from vit_tpu_torch import augment as aug

Schedule = Callable[[int], float]


@dataclasses.dataclass
class TrainState:
    """What a train step reads and advances: the model (its parameters),
    ``optimizer`` (``torch.optim``, its moments), ``scheduler`` (the
    learning rate of each update), ``step`` (updates made) and
    ``generator`` (dropout and augmentation draws; None: PyTorch's
    default)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    generator: Optional[torch.Generator] = None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of integer labels, log-softmax in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.take_along_dim(logp, labels.long()[:, None], dim=-1))


def top1_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of rows whose argmax logit is the label."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def warmup_cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                           end_lr_scale: float = 0.0) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule(0, base_lr, warmup_steps,
    total_steps, base_lr * end_lr_scale)``: linear from 0 to ``base_lr``
    over ``warmup_steps`` updates, then cosine to ``base_lr *
    end_lr_scale`` at ``total_steps``, held there after."""
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"total_steps {total_steps} must exceed warmup_steps {warmup_steps}")
    alpha = 0.0 if base_lr == 0.0 else end_lr_scale

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return -base_lr * (1.0 - count / warmup_steps) + base_lr
        t = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


class Lamb(torch.optim.Optimizer):
    """optax's ``lamb``: Adam's moments with bias correction (``eps`` added
    outside the square root), the decayed weights added, the whole update
    scaled by ``||p|| / ||u||`` (1 where either norm is 0), then by ``-lr``.
    The norms are over each parameter group: optax takes them over each leaf
    of ``vit_tpu``'s tree, where a scanned stack's leaf holds every layer
    (``trust_groups`` makes those groups)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("Lamb takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            updates = []
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                g, mu, nu = p.grad, state["exp_avg"], state["exp_avg_sq"]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                state["step"] += 1
                t = state["step"]
                mu_hat = mu / (1 - b1**t)
                nu_hat = nu / (1 - b2**t)
                u = mu_hat / (torch.sqrt(nu_hat) + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                updates.append((p, u))
            if not updates:
                continue
            norm = lambda ts: torch.sqrt(sum(torch.sum(t * t) for t in ts))
            p_norm, u_norm = norm([p for p, _ in updates]), norm([u for _, u in updates])
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            for p, u in updates:
                p.add_(-group["lr"] * (u * ratio))
        return None


def trust_groups(model: nn.Module) -> List[List[nn.Parameter]]:
    """The model's parameters grouped as the leaves of ``vit_tpu``'s tree:
    one group a parameter, except that the layers of a stack ``vit_tpu``
    scans (``model.jax_stages``, depth > 1) share one group a name
    (``encoder.blocks.*.attn.qkv_kernel``), as its stacked leaf does."""
    prefixes = [stage.replace("/", ".") + "." for stage, depth in
                getattr(model, "jax_stages", {}).items() if depth != 1]
    groups: Dict[str, List[nn.Parameter]] = {}
    for name, p in model.named_parameters():
        key = name
        for prefix in prefixes:
            if name.startswith(prefix):
                key = prefix + "*." + name[len(prefix):].split(".", 1)[1]
        groups.setdefault(key, []).append(p)
    return list(groups.values())


def leaf_groups(model: nn.Module) -> List[Tuple[int, List[nn.Parameter]]]:
    """``trust_groups`` with the rank of each group's leaf in ``vit_tpu``'s
    tree: the parameter's own rank, one more for the layers of a scanned
    stack (a group of more than one parameter), whose leaf stacks them."""
    return [(g[0].dim() + (len(g) > 1), g) for g in trust_groups(model)]


# optax 0.2.6's ``contrib.muon`` defaults, as ``vit_tpu`` builds it
NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5
MUON_BETA = 0.95
MUON_EPS = 1e-8


def orthogonalize(x: torch.Tensor) -> torch.Tensor:
    """optax's ``orthogonalize_via_newton_schulz`` of a matrix: transposed
    where it has more rows than columns, divided by its Frobenius norm plus
    ``MUON_EPS``, then ``NS_STEPS`` quintic Newton-Schulz steps ``a X + (b A
    + (c A) A) X``, ``A = X X^T``, in optax's operation order."""
    a, b, c = NS_COEFFS
    tall = x.shape[0] > x.shape[1]
    if tall:
        x = x.t()
    x = x / (torch.linalg.norm(x) + MUON_EPS)
    for _ in range(NS_STEPS):
        gram = x @ x.t()
        x = a * x + (b * gram + (c * gram) @ gram) @ x
    return x.t() if tall else x


class Muon(torch.optim.Optimizer):
    """optax's ``contrib.muon`` (0.2.6) as ``vit_tpu``'s ``make_optimizer``
    builds it: one parameter group a leaf of ``vit_tpu``'s tree
    (``leaf_groups``), labelled as optax labels the tree: ``muon`` where the
    leaf is a matrix, else ``adam``. The rank is the leaf's, not the port
    parameter's: a stack that ``vit_tpu`` scans holds its layers in one leaf
    of one more rank, so a depth-24 ViT's ``qkv_kernel`` ``[24, D, 3HD]``
    takes Adam while its stacked biases and LayerNorm scales ``[24, D]``
    take muon, orthogonalized across the layers. That is ``vit_tpu``'s
    behaviour, mirrored here.

    ``muon`` groups: momentum ``mu = (1 - beta) g + beta mu`` (``beta`` =
    ``MUON_BETA``), Nesterov ``beta mu / (1 - beta^(t+1)) + (1 - beta) g /
    (1 - beta^t)``, the leaf stacked and ``orthogonalize``d, scaled by
    ``sqrt(max(1, cols / rows))``, plus ``weight_decay`` times the
    parameter, times ``-lr``. ``adam`` groups: optax's ``adamw(b1, b2,
    MUON_EPS, weight_decay, nesterov=True)``, as muon builds it with
    ``vit_tpu``'s ``adam_weight_decay=weight_decay``: the same Nesterov
    first moment with ``b1``, ``nu / (1 - b2^t)``, ``mu_hat / (sqrt(nu_hat)
    + eps)``, plus the decayed weights, times ``-lr``. Groups are dicts
    ``{"params": [...], "muon": bool}`` sharing ``lr``, ``weight_decay`` and
    ``betas`` (``Optimizer.build`` drives them with one ``LambdaLR``)."""

    def __init__(self, params, lr=1e-3, weight_decay=0.0, betas=(0.9, 0.999)):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, betas=betas, muon=False))

    @torch.no_grad()
    def step(self, closure=None):
        """One update. The elementwise parts run as multi-tensor
        (``torch._foreach_*``) ops, in optax's operation order, over every
        group of one label and update count; Newton-Schulz runs a leaf at a
        time."""
        if closure is not None:
            raise NotImplementedError("Muon takes no closure")
        buckets = collections.defaultdict(list)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            if len(params) != len(group["params"]):
                raise ValueError("a stacked leaf's layers must all have gradients")
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    if not group["muon"]:
                        state["nu"] = torch.zeros_like(p)
                state["step"] += 1
            buckets[group["muon"], self.state[params[0]]["step"]].append((group, params))
        for (muon, t), entries in buckets.items():
            group = entries[0][0]
            params = [p for _, ps in entries for p in ps]
            grads = [p.grad for p in params]
            mus = [self.state[p]["mu"] for p in params]
            if muon:
                _moments_(mus, grads, MUON_BETA)
                mu_hat = iter(_nesterov(mus, grads, MUON_BETA, t))
                updates = []
                for _, ps in entries:
                    updates += self._orthogonalized([next(mu_hat) for _ in ps])
            else:
                b1, b2 = group["betas"]
                nus = [self.state[p]["nu"] for p in params]
                _moments_(mus, grads, b1)
                _moments_(nus, torch._foreach_mul(grads, grads), b2)
                updates = _nesterov(mus, grads, b1, t)
                denom = torch._foreach_sqrt(torch._foreach_div(nus, 1 - b2**t))
                torch._foreach_add_(denom, MUON_EPS)
                torch._foreach_div_(updates, denom)
            if group["weight_decay"]:
                torch._foreach_add_(updates, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_add_(params, torch._foreach_mul(updates, -group["lr"]))
        return None

    @staticmethod
    def _orthogonalized(mu_hat):
        """The leaf of ``mu_hat`` (its layers stacked), orthogonalized and
        scaled by ``sqrt(max(1, cols / rows))``, split back into its layers."""
        leaf = torch.stack(mu_hat) if len(mu_hat) > 1 else mu_hat[0]
        if leaf.dim() != 2:
            raise ValueError(f"muon takes matrices, got a leaf of shape {tuple(leaf.shape)}")
        u = orthogonalize(leaf)
        u = math.sqrt(max(1.0, leaf.shape[1] / leaf.shape[0])) * u
        return list(u.unbind(0)) if len(mu_hat) > 1 else [u]


def _moments_(ms, xs, decay):
    """optax's ``update_moment`` in place over lists: ``m = (1 - decay) x +
    decay m``."""
    torch._foreach_mul_(ms, decay)
    torch._foreach_add_(ms, torch._foreach_mul(xs, 1 - decay))


def _nesterov(ms, gs, decay, t):
    """optax's Nesterov first moment at update ``t``: ``decay m / (1 -
    decay^(t+1)) + (1 - decay) g / (1 - decay^t)``, new tensors."""
    hat = torch._foreach_div(ms, 1 - decay ** (t + 1))
    torch._foreach_mul_(hat, decay)
    torch._foreach_add_(hat, torch._foreach_mul(torch._foreach_div(gs, 1 - decay**t), 1 - decay))
    return hat


OPTIMIZERS = ("adamw", "lamb", "muon")


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A named optimizer recipe, built on a model's parameters by
    ``create_train_state`` (``build``): ``learning_rate`` a float or a
    schedule of the update count."""

    name: str
    learning_rate: Union[float, Schedule]
    weight_decay: float
    b1: float
    b2: float
    grad_clip_norm: Optional[float]

    def build(self, model: nn.Module
              ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
        """The optimizer on ``model``'s parameters (LAMB's in
        ``trust_groups``, muon's in ``leaf_groups``, labelled by rank) at a
        base rate of 1 and its ``LambdaLR``, which sets update k's rate to
        ``learning_rate(k)``. muon's Adam leaves decay at ``weight_decay``
        too, as ``vit_tpu`` passes ``adam_weight_decay=weight_decay``."""
        kw = dict(lr=1.0, betas=(self.b1, self.b2), weight_decay=self.weight_decay)
        if self.name == "adamw":
            opt = torch.optim.AdamW(model.parameters(), eps=1e-8, **kw)
        elif self.name == "lamb":
            opt = Lamb([{"params": g} for g in trust_groups(model)], eps=1e-6, **kw)
        else:
            opt = Muon([{"params": g, "muon": rank == 2} for rank, g in leaf_groups(model)], **kw)
        lr = self.learning_rate
        schedule = lr if callable(lr) else (lambda _: lr)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


def make_optimizer(learning_rate: Union[float, Schedule] = 1e-3, weight_decay: float = 0.05, *,
                   name: str = "adamw", grad_clip_norm: Optional[float] = None,
                   b1: float = 0.9, b2: float = 0.999) -> Optimizer:
    """``vit_tpu``'s named optimizer factory: ``"adamw"``, ``"lamb"`` or
    ``"muon"``, with ``grad_clip_norm`` clipping the global norm first."""
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r} (adamw|lamb|muon)")
    return Optimizer(name, learning_rate, weight_decay, b1, b2, grad_clip_norm)


@torch.no_grad()
def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: the global L2 norm of
    ``grads``; where it is at least ``max_norm``, every gradient becomes
    ``g / norm * max_norm``. Returns the norm (before clipping)."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm  # compared on the device: no read back
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def create_train_state(model: nn.Module, optimizer: Optional[Optimizer] = None,
                       generator: Optional[torch.Generator] = None, *,
                       init: bool = True) -> TrainState:
    """A step-0 state: ``init_params(model, generator)`` unless ``init`` is
    False (the caller has loaded weights, e.g. through ``from_jax_params``),
    then the optimizer built on the parameters."""
    from vit_tpu_torch.utils.init import init_params

    if init:
        init_params(model, generator)
    opt, sched = (optimizer or make_optimizer()).build(model)
    return TrainState(model, opt, sched, 0, generator)


def _trainable(model: nn.Module, moe_aux_weight: float, remat: bool) -> Callable:
    """``apply(images, generator) -> (logits, aux_losses)`` in training mode
    (``logits`` a pair ``(class, distill)`` for a two-head LeViT), or raise
    for a model whose training is not ported, or that cannot train: a
    BatchNorm-folded CvT or LeViT is inference only."""
    from vit_tpu_torch import models as m

    if isinstance(model, (m.CvT, m.LeViT)) and _folded(model):
        raise ValueError(f"a BatchNorm-folded {type(model).__name__} (fold_bn=True) is "
                         "inference only: train the unfolded model, then fold it")
    if isinstance(model, m.ViTMoE):
        return lambda x, gen: model(x, return_aux=True, train=True, generator=gen)
    if isinstance(model, (m.ViT, m.TwinsSVT, m.T2TViT, m.CaiT, m.DeepViT, m.CvT, m.LeViT, m.PiT,
                          m.SimpleViT, m.EfficientViT, m.CrossViT, m.ParallelViT,
                          m.PatchMergerViT, m.NesT, m.RegionViT, m.ScalableViT, m.CrossFormer,
                          m.ViTSmallDatasets)):
        if moe_aux_weight:
            raise ValueError("moe_aux_weight needs a model with MoE layers")
        return lambda x, gen: (model(x, train=True, generator=gen, remat=remat), [])
    raise NotImplementedError(
        f"training {type(model).__name__} is not ported: make_train_step trains the 18 "
        "families of vit_tpu_torch.models and ViTMoE")


def _folded(model: nn.Module) -> bool:
    """Whether ``model``'s BatchNorms are folded into its convs
    (``fold_bn=True``): it has conv layers that would carry one and none."""
    from vit_tpu_torch.nn.embed import BatchNorm

    return not any(isinstance(m, BatchNorm) for m in model.modules())


def make_train_step(model: nn.Module, optimizer: Optional[Optimizer] = None, *,
                    remat: bool = True, augment_fn: Optional[Callable] = None,
                    teacher_apply: Optional[Callable] = None, distill_alpha: float = 0.5,
                    distill_tau: float = 1.0, distill_hard: bool = True,
                    accum_steps: int = 1, qat: bool = False,
                    moe_aux_weight: float = 0.0) -> Callable:
    """``step(state, images, labels) -> loss`` (a 0-d fp32 tensor, not read
    back): one update of ``state`` in place.

    ``accum_steps=K`` splits the batch into K microbatches, sums their
    gradients, divides by K and makes one update (``vit_tpu/train.py:301-334``:
    with mean losses, the full batch's gradient up to rounding); a
    BatchNorm normalises each microbatch with its own statistics and
    updates its running ones K times, in microbatch order, as ``vit_tpu``
    threads them through its scan (``:179``).
    ``augment_fn(generator, images, labels) -> (images, target_probs)``
    switches the loss to soft targets. ``teacher_apply(images) -> logits``
    trains the student on ``distillation_loss``: a two-head student (LeViT
    with ``num_distill_classes``) its ``distill_head`` on the teacher and its
    class head on the targets, a single-head student its one head on both
    (``vit_tpu/train.py:264-276``); without a teacher a two-head student
    trains its class head alone.
    ``moe_aux_weight`` adds that weight times the mean of ViT-MoE's
    load-balance losses. ``remat`` checkpoints each encoder block.
    ``qat=True`` trains through the weight-only int8 view
    (``utils.quantize.fake_quantized``, vit_tpu/train.py:234-237): the
    forward, and remat's recompute in the backward, see exactly the weights
    the deployed ``quantized_apply`` of ``quantize_weights`` will use, and
    the gradients pass straight through to the float parameters.
    ``optimizer``: the recipe the state was built with (its clip)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    apply = _trainable(model, moe_aux_weight, remat)
    clip = (optimizer or make_optimizer()).grad_clip_norm
    from vit_tpu_torch.utils.quantize import fake_quantized

    def loss_of(images, labels, generator):
        if augment_fn is not None:
            images, targets = augment_fn(generator, images, labels)
        logits, aux = apply(images, generator)
        distill = None
        if isinstance(logits, tuple):  # LeViT's distillation head
            logits, distill = logits
        if teacher_apply is not None:
            t = targets if augment_fn is not None else aug.one_hot(labels, logits.shape[-1])
            with torch.no_grad():
                teacher = teacher_apply(images)
            loss = aug.distillation_loss(logits, logits if distill is None else distill, t,
                                         teacher, alpha=distill_alpha, tau=distill_tau,
                                         hard=distill_hard)
        elif augment_fn is not None:
            loss = aug.soft_cross_entropy(logits, targets)
        else:
            loss = cross_entropy_loss(logits, labels)
        if moe_aux_weight and aux:
            loss = loss + moe_aux_weight * (sum(aux) / len(aux))
        return loss

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if images.shape[0] % accum_steps:
            raise ValueError(f"batch {images.shape[0]} not divisible by accum_steps {accum_steps}")
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=images.device)
        for imgs, lbls in zip(images.chunk(accum_steps), labels.chunk(accum_steps)):
            with fake_quantized(state.model) if qat else contextlib.nullcontext():
                loss_i = loss_of(imgs, lbls, state.generator)
                loss_i.backward()
            loss = loss + loss_i.detach()
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p in params:  # optax's zero gradient of a leaf the loss never reads
            if p.grad is None:  # (a two-head LeViT's distill_head without a teacher)
                p.grad = torch.zeros_like(p)
        if accum_steps > 1:
            for p in params:
                p.grad.div_(accum_steps)
            loss = loss / accum_steps
        if clip is not None:
            clip_by_global_norm([p.grad for p in params], clip)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return loss

    return step


def make_eval_step(model: nn.Module) -> Callable:
    """``eval_step(images, labels) -> (loss, top1)`` of the model's current
    parameters, in inference mode (deterministic; BatchNorms on their running
    statistics), on the class head of a two-head LeViT
    (``vit_tpu/train.py:360``)."""

    def step(images, labels):
        with torch.inference_mode():
            logits = model(images)
            if isinstance(logits, tuple):  # LeViT's distillation head
                logits = logits[0]
            return cross_entropy_loss(logits, labels), top1_accuracy(logits, labels)

    return step


def evaluate(model: nn.Module, batches: Iterable) -> dict:
    """``(images, labels)`` batches through ``make_eval_step``: the
    sample-weighted ``{"loss", "top1", "samples"}``."""
    step = make_eval_step(model)
    n, loss_sum, acc_sum = 0, 0.0, 0.0
    for images, labels in batches:
        loss, top1 = step(images, labels)
        b = int(labels.shape[0])
        loss_sum += float(loss) * b
        acc_sum += float(top1) * b
        n += b
    if n == 0:
        raise ValueError("evaluate() got an empty batch iterable")
    return {"loss": loss_sum / n, "top1": acc_sum / n, "samples": n}


# -- the single-card trainer (examples/train.py) ---------------------------------


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m vit_tpu_torch.train",
                                 description="Train a model of MODEL_REGISTRY on one card (bf16), "
                                             "on a folder of JPEGs or on synthetic data.")
    ap.add_argument("--model", default="vit", help="MODEL_REGISTRY name")
    ap.add_argument("--config", default=None, metavar="JSON",
                    help="constructor kwargs over the registry's tiny config, as a JSON object "
                         "(e.g. ViT-L/16's)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ranks (not ported)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks (not ported)")
    ap.add_argument("--data", default=None, metavar="DIR",
                    help="directory of *.jpg files, file i (sorted) labelled i %% --classes, "
                         "through JpegFolderDataset (synthetic if unset)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="CheckpointManager run dir: step-numbered saves, keeps the newest 3")
    ap.add_argument("--save-every", type=int, default=100, help="checkpoint cadence in steps")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="restore the latest step of a --checkpoint-dir run and continue")
    ap.add_argument("--augment", action="store_true",
                    help="flip + mixup/cutmix + label smoothing 0.1")
    ap.add_argument("--ema", type=float, default=None, metavar="DECAY",
                    help="track an EMA of the parameters (e.g. 0.9999)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "lamb", "muon"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights, data and draws")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default) or the CPU (plain twins)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.dp * args.tp > 1:
        raise NotImplementedError("--dp / --tp: multi-GPU training is ROADMAP.md Queue 1 item 8")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("python -m vit_tpu_torch.train: no CUDA card (pass --device cpu)", file=sys.stderr)
        return 1
    from vit_tpu_torch.models import MODEL_REGISTRY
    from vit_tpu_torch.utils.checkpoint import CheckpointManager

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctor, cfg, size = MODEL_REGISTRY[args.model]
    cfg = {**cfg, **json.loads(args.config or "{}"), "num_classes": args.classes}
    if "image_size" in cfg:
        cfg["image_size"] = args.image_size
    else:
        args.image_size = size
    model = ctor(**cfg, dtype=torch.bfloat16, device=dev)

    gen = torch.Generator(dev).manual_seed(args.seed)
    if args.data:
        from vit_tpu_torch.data import JpegFolderDataset

        files = sorted(pathlib.Path(args.data).glob("*.jpg"))
        dataset = JpegFolderDataset([(str(f), i % args.classes) for i, f in enumerate(files)],
                                    args.batch, size=args.image_size, seed=args.seed, device=dev)
        # shuffled epochs, decoded and copied to the card ahead of the step
        batches = ((imgs, lbls) for _, imgs, lbls in
                   dataset.epochs(-(-args.steps // len(dataset))))
    else:
        images = torch.randn(args.batch, args.image_size, args.image_size, 3, generator=gen,
                             device=dev).to(torch.bfloat16)
        labels = torch.arange(args.batch, device=dev) % args.classes
        batches = itertools.repeat((images, labels))
    optimizer = make_optimizer(args.lr, name=args.optimizer, grad_clip_norm=1.0)

    mgr = CheckpointManager(args.checkpoint_dir, max_to_keep=3,
                            save_interval_steps=args.save_every) if args.checkpoint_dir else None
    state = create_train_state(model, optimizer, gen, init=not args.resume)
    ema = None
    if args.ema is not None:
        ema = aug.Ema.init(model, decay=args.ema)
    if args.resume:
        CheckpointManager(args.resume).restore(state, ema=ema)
        print(f"resumed from {args.resume} at step {state.step}")

    augment_fn = None
    if args.augment:
        def augment_fn(g, imgs, lbls):
            t = aug.one_hot(lbls, args.classes, smoothing=0.1)
            return aug.mixup_or_cutmix(g, aug.random_hflip(g, imgs), t)

    step = make_train_step(model, optimizer, augment_fn=augment_fn, accum_steps=args.accum)
    t0 = time.perf_counter()
    loss = None
    for i in range(args.steps):
        loss = step(state, *next(batches))
        if ema is not None:
            ema.update(model)
        if i == 0:
            float(loss)
            print(f"first step in {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
        if (i + 1) % 5 == 0 or i + 1 == args.steps:
            print(f"step {state.step}: loss {float(loss):.4f}")
        if mgr is not None and mgr.should_save(state.step):
            mgr.save(state.step, state, metrics={"loss": float(loss)}, ema=ema)
    if loss is not None and args.steps > 1:
        float(loss)  # waits for the last step
        dt = (time.perf_counter() - t0) / max(1, args.steps - 1)
        print(f"{args.batch / dt:.1f} img/s ({dt * 1e3:.1f} ms/step) on {dev}")
    if mgr is not None:
        mgr.save(state.step, state, metrics=None if loss is None else {"loss": float(loss)},
                 ema=ema, force=True)
        mgr.wait()
        print(f"checkpoints at steps {mgr.all_steps()} in {args.checkpoint_dir}")
        mgr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
