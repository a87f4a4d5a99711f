"""Train state: everything a resumed run needs to continue exactly.

Port of ``sr/train/state.py``. The flax state is an immutable pytree of
params, optimizer state, step and PRNG key; here the model holds its
parameters, the optimizer its moments, and the state adds the recipe
(which carries the schedule), the number of updates made and the sampler's
generator, whose position :class:`sr_torch.utils.checkpoint.Checkpointer`
saves. A batch-norm model's running statistics are buffers of the model,
updated by its train-mode forwards and saved with its state dict;
:attr:`TrainState.batch_stats` reads them in flax's layout. A GAN's
discriminator state has no sampler (``generator=None``). In a
multi-process run ``replica`` is the model under
``DistributedDataParallel`` (``sr_torch.parallel.replicate``), which the
train step calls; checkpoints and inference read ``model`` itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from sr_torch.train.optim import Recipe
from sr_torch.utils.interop import to_jax_batch_stats


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: Recipe
    generator: torch.Generator | None
    step: int = 0
    replica: nn.Module | None = None

    @property
    def batch_stats(self) -> dict | None:
        """The model's batch-norm statistics as flax's nested
        ``batch_stats`` (numpy copies); None without batch norms."""
        return to_jax_batch_stats(self.model)
