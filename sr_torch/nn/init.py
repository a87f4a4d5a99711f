"""Weight initializers: flax's defaults, drawn from a ``torch.Generator``.

Port of ``sr/nn/init.py`` for what EDSR uses. Flax's default conv kernel
init is ``lecun_normal``: a normal truncated to ±2 standard deviations, with
the standard deviation corrected so that the truncated draw has variance
1 / fan_in. Biases start at zero. The numbers differ from JAX's for the
same seed; the tests carry weights across with ``from_jax_params`` instead.
"""

from __future__ import annotations

import math

import torch

# std of a standard normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """In place on an OIHW conv weight: fan_in = I·H·W."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std,
                                           2.0 * std, generator=generator)
