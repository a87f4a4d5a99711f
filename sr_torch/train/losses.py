"""Loss functions of the training slice, computed in float32.

Port of ``sr/train/losses.py`` for the losses EDSR and the models after it
use first: MSE, L1 (EDSR) and Charbonnier (LapSRN). Each casts both
arguments to float32 before it subtracts, as the JAX functions do, and
reduces by the mean over all elements. DRCN's recursive supervision and
SRGAN's BCE come with those models.
"""

from __future__ import annotations

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred.to(torch.float32) - target.to(torch.float32)
    return torch.mean(d * d)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.to(torch.float32)
                                - target.to(torch.float32)))


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-3) -> torch.Tensor:
    """sqrt(diff² + eps²), a differentiable L1 (Lai et al., CVPR'17)."""
    d = pred.to(torch.float32) - target.to(torch.float32)
    return torch.mean(torch.sqrt(d * d + eps * eps))
