"""Loss functions of the training slice, computed in float32.

Port of ``sr/train/losses.py`` for the losses the port's models use: MSE,
L1 (EDSR), Charbonnier (LapSRN), DRCN's recursive supervision and SRGAN's
binary cross-entropy on logits. Each casts its arguments to float32 before
it computes, as the JAX functions do, and reduces by the mean over all
elements.
"""

from __future__ import annotations

import numpy as np
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


def recursive_supervision_loss(recursions: torch.Tensor, final: torch.Tensor,
                               target: torch.Tensor, alpha
                               ) -> tuple[torch.Tensor, dict]:
    """DRCN: α·mean_d MSE(y_d, t) + (1 − α)·MSE(final, t).

    ``recursions`` is (D, B, H, W, C), the per-recursion reconstructions;
    ``final`` the recursion-weighted ensemble; ``alpha`` a host number
    (annealed 1 → 0 over training), taken in float32 with ``1 − α``
    rounded there too, as the JAX loss computes both; it stays a scalar
    argument, so no host value is copied to the device."""
    d = recursions.to(torch.float32) - target.to(torch.float32)
    loss1 = torch.mean(torch.mean(d * d, dim=tuple(range(1, d.dim()))))
    loss2 = mse_loss(final, target)
    a = np.float32(alpha)
    loss = float(a) * loss1 + float(np.float32(1.0) - a) * loss2
    return loss, {"loss_rec": loss1, "loss_final": loss2}


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Binary cross-entropy on logits in float32, the stable form
    ``max(z, 0) − z·y + log1p(exp(−|z|))`` that ``sr/train/losses.py``
    computes (the discriminator returns logits; the sigmoid lives here)."""
    z = logits.to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(torch.clamp_min(z, 0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))
