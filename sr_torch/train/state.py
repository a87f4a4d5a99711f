"""Train state: everything a resumed run needs to continue exactly.

Port of ``sr/train/state.py``. The flax state is an immutable pytree of
params, optimizer state, step and PRNG key; here the model holds its
parameters, the optimizer its moments, and the state adds the recipe
(which carries the schedule), the number of updates made and the sampler's
generator, whose position :class:`sr_torch.utils.checkpoint.Checkpointer`
saves. Batch statistics join with the first batch-norm model.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from sr_torch.train.optim import Recipe


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: Recipe
    generator: torch.Generator
    step: int = 0
