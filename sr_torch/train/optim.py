"""Optimizer recipes: a torch optimizer with a per-step learning rate.

Port of the part of ``sr/train/optim.py`` that EDSR's recipe uses. An optax
chain carries its schedule inside; here a :class:`Recipe` pairs a factory of
a ``torch.optim`` optimizer with the schedule and sets the learning rate
before each update. optax evaluates the schedule at the count of updates
made *before* the current one, so the first ``halve_steps`` updates of
:func:`adam_with_step_halving` run at the base rate; :meth:`Recipe.step`
takes that count. VDSR's SGD with adjustable clipping comes with VDSR.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch

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


@dataclass(frozen=True)
class Recipe:
    """An optimizer factory ``(params, lr) -> torch.optim.Optimizer`` and
    its per-step schedule."""

    build: Callable[[Iterable[torch.nn.Parameter], float],
                    torch.optim.Optimizer]
    schedule: Schedule

    def init(self, params: Iterable[torch.nn.Parameter]
             ) -> torch.optim.Optimizer:
        return self.build(params, self.schedule(0))

    def step(self, optimizer: torch.optim.Optimizer, count: int) -> None:
        """Apply the gradients: one update at ``schedule(count)``, where
        ``count`` is the number of updates made before this one."""
        lr = self.schedule(count)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()


def adam(lr: float | Schedule, b1: float = 0.9, b2: float = 0.999) -> Recipe:
    """optax.adam: eps 1e-8 outside the square root, bias-corrected."""
    schedule = lr if callable(lr) else constant_schedule(lr)
    return Recipe(lambda params, lr0: torch.optim.Adam(
        params, lr=lr0, betas=(b1, b2), eps=1e-8), schedule)


def adam_with_step_halving(base_lr: float, halve_steps: int) -> Recipe:
    """EDSR's recipe: Adam with lr halved every ``halve_steps`` updates
    (Lim et al.: 2e5). ``<= 0`` means a constant lr, not halving every
    step."""
    return adam(step_decay_schedule(base_lr, 1, halve_steps, 0.5))
