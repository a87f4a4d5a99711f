"""Optimizer recipes: a torch optimizer with a per-step learning rate.

Port of ``sr/train/optim.py``. An optax chain carries its schedule inside;
here a :class:`Recipe` pairs a factory of a ``torch.optim`` optimizer with
the schedule and sets the learning rate before each update. optax evaluates
the schedule at the count of updates made *before* the current one, so the
first ``halve_steps`` updates of :func:`adam_with_step_halving` run at the
base rate; :meth:`Recipe.step` takes that count. A recipe may also clip the
gradients first (VDSR's :func:`adjustable_grad_clip`), reading the same
count.

L2 weight decay added to the gradient before the update
(``optax.add_decayed_weights`` chained before ``adam``/``sgd``, DRCN and
VDSR) is the ``weight_decay`` of ``torch.optim.Adam`` and ``SGD``, which add
``wd · p`` to the gradient before the moments, not decoupled AdamW decay.

``optax.multi_transform`` over one optimizer at several learning rates
(FSRCNN's deconv at 0.1× the base, ``sr/models/fsrcnn.py:_make_tx``) is
:func:`with_lr_groups`: a labeller maps each top-level child of the model to
a group, each group is a ``torch.optim`` parameter group with an
``lr_mult``, and :meth:`Recipe.step` sets each group's rate to
``schedule(count) · lr_mult``, so no group silently trains at the base
rate.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]


def constant_schedule(lr: float) -> Schedule:
    return lambda count: lr


def step_decay_schedule(base_lr: float, steps_per_epoch: int,
                        decay_epochs: int, factor: float) -> Schedule:
    """lr · factor^(count // (decay_epochs · steps_per_epoch)); a constant
    lr when ``decay_epochs <= 0``."""
    if decay_epochs <= 0:
        return constant_schedule(base_lr)
    boundary = decay_epochs * steps_per_epoch
    return lambda count: base_lr * factor ** (count // boundary)


#: ``(grads, count) -> scale``: scales the gradients in place before the
#: update and returns the factor, a device scalar
Clip = Callable[[list[torch.Tensor], int], torch.Tensor]


#: ``model -> {top-level child name: group name}``
Labeller = Callable[[nn.Module], dict[str, str]]


@dataclass(frozen=True)
class Recipe:
    """An optimizer factory ``(params, lr) -> torch.optim.Optimizer``, its
    per-step schedule, an optional gradient clip, and optional parameter
    groups: ``groups`` maps a group's name to its learning-rate multiplier
    and ``label`` assigns each top-level child of the model to a group."""

    build: Callable[[Iterable[torch.nn.Parameter], float],
                    torch.optim.Optimizer]
    schedule: Schedule
    clip: Clip | None = None
    groups: dict[str, float] | None = None
    label: Labeller | None = None

    def init(self, model: nn.Module | Iterable[torch.nn.Parameter]
             ) -> torch.optim.Optimizer:
        """The optimizer over ``model``'s parameters (or a bare iterable of
        parameters, for a recipe without groups), each group at
        ``schedule(0) · lr_mult``."""
        lr0 = self.schedule(0)
        params = model.parameters() if isinstance(model, nn.Module) else model
        if self.groups is not None:
            if not isinstance(model, nn.Module):
                raise TypeError("a recipe with parameter groups labels a "
                                "model: pass the module, not its parameters")
            params = self._param_groups(model)
        optimizer = self.build(params, lr0)
        for group in optimizer.param_groups:
            group.setdefault("lr_mult", 1.0)
            group["lr"] = lr0 * group["lr_mult"]
        return optimizer

    def _param_groups(self, model: nn.Module) -> list[dict]:
        labels = self.label(model)
        members: dict[str, list] = {g: [] for g in self.groups}
        for name, p in model.named_parameters():
            top = name.split(".")[0]
            if top not in labels or labels[top] not in members:
                raise ValueError(f"parameter {name}: its top-level child "
                                 f"{top!r} has no group of {list(members)}")
            members[labels[top]].append(p)
        return [{"params": ps, "lr_mult": self.groups[g], "group": g}
                for g, ps in members.items() if ps]

    def step(self, optimizer: torch.optim.Optimizer, count: int
             ) -> torch.Tensor | None:
        """Apply the gradients: the clip at ``count``, then one update at
        ``schedule(count)``, where ``count`` is the number of updates made
        before this one. Returns the clip's scale (None without a clip)."""
        scale = None
        if self.clip is not None:
            scale = self.clip([p.grad for group in optimizer.param_groups
                               for p in group["params"]
                               if p.grad is not None], count)
        lr = self.schedule(count)
        for group in optimizer.param_groups:
            group["lr"] = lr * group.get("lr_mult", 1.0)
        optimizer.step()
        return scale


def adam(lr: float | Schedule, b1: float = 0.9, b2: float = 0.999,
         weight_decay: float = 0.0) -> Recipe:
    """optax.adam: eps 1e-8 outside the square root, bias-corrected;
    ``weight_decay`` chains ``optax.add_decayed_weights`` before it."""
    schedule = lr if callable(lr) else constant_schedule(lr)
    return Recipe(lambda params, lr0: torch.optim.Adam(
        params, lr=lr0, betas=(b1, b2), eps=1e-8,
        weight_decay=weight_decay), schedule)


def with_lr_groups(recipe: Recipe, groups: dict[str, float],
                   label: Labeller) -> Recipe:
    """``recipe`` over parameter groups (``optax.multi_transform`` of one
    optimizer at several rates): ``groups`` maps each group to its
    learning-rate multiplier, ``label`` each top-level child of the model
    to a group."""
    return dataclasses.replace(recipe, groups=dict(groups), label=label)


def adjustable_grad_clip(theta: float, schedule: Schedule) -> Clip:
    """VDSR's adjustable gradient clipping (Kim et al., CVPR'16 §3.4): the
    global norm of all gradients held to θ / lr(count), the gradients
    multiplied by ``min(1, lim / max(norm, 1e-12))`` as optax computes it
    (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``
    instead). Everything stays on the gradients' device: no host sync."""

    def clip(grads: list[torch.Tensor], count: int) -> torch.Tensor:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        lim = torch.full_like(norm, float(np.float32(theta)
                                          / np.float32(schedule(count))))
        scale = torch.clamp_max(lim / torch.clamp_min(norm, 1e-12), 1.0)
        torch._foreach_mul_(grads, scale)
        return scale

    return clip


def vdsr_sgd(base_lr: float, steps_per_epoch: int, decay_epochs: int = 20,
             factor: float = 0.1, momentum: float = 0.9,
             weight_decay: float = 1e-4, clip_theta: float = 0.4) -> Recipe:
    """VDSR's recipe: the adjustable clip, then L2 weight decay, then SGD
    with momentum (optax's trace: ``t = g + momentum · t``, ``p -= lr · t``)
    at lr·factor^(epoch // decay_epochs)."""
    sched = step_decay_schedule(base_lr, steps_per_epoch, decay_epochs,
                                factor)
    return Recipe(lambda params, lr0: torch.optim.SGD(
        params, lr=lr0, momentum=momentum, weight_decay=weight_decay),
        sched, clip=adjustable_grad_clip(clip_theta, sched))


def adam_with_step_halving(base_lr: float, halve_steps: int) -> Recipe:
    """EDSR's recipe: Adam with lr halved every ``halve_steps`` updates
    (Lim et al.: 2e5). ``<= 0`` means a constant lr, not halving every
    step."""
    return adam(step_decay_schedule(base_lr, 1, halve_steps, 0.5))
