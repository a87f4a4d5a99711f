"""Weight initializers: the JAX package's menu, drawn from a
``torch.Generator``.

Port of ``sr/nn/init.py``. Flax's default conv kernel init is
``lecun_normal``: a normal truncated to ±2 standard deviations, with the
standard deviation corrected so that the truncated draw has variance
1 / fan_in. ``kaiming`` (He normal, VDSR) is the same draw at variance
2 / fan_in; ``normal_*`` (SRCNN-era nets, the GAN pair) are plain normals
of a fixed standard deviation. Biases start at zero. The numbers differ
from JAX's for the same seed; the tests carry weights across with
``from_jax_params`` instead.

A transposed conv's weight (``nn.ConvTranspose2d``, ``(in, out, kh, kw)``)
takes its fan-in as flax's ``ConvTranspose`` does from its HWIO kernel:
``kh·kw·in``. Read the torch way, the same tensor would give ``out·kh·kw``;
every initializer here takes ``transposed=True`` for such a weight.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

# std of a standard normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978

Init = Callable[..., torch.Tensor]


def fan_in(weight: torch.Tensor, transposed: bool = False) -> int:
    """Flax's fan-in of a conv weight: I·H·W of an OIHW weight, or of a
    transposed conv's ``(in, out, kh, kw)`` weight with ``transposed``."""
    if transposed:
        return weight.shape[0] * math.prod(weight.shape[2:])
    return math.prod(weight.shape[1:])


def _truncated_fan_in(weight: torch.Tensor, scale: float,
                      generator: torch.Generator | None,
                      transposed: bool = False) -> torch.Tensor:
    """jax's ``variance_scaling(scale, "fan_in", "truncated_normal")`` in
    place on a conv weight (see :func:`fan_in`)."""
    fan_in_ = fan_in(weight, transposed)
    std = math.sqrt(scale / fan_in_) / _TRUNC_STD
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std,
                                           2.0 * std, generator=generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: torch.Generator | None = None,
                  transposed: bool = False) -> torch.Tensor:
    return _truncated_fan_in(weight, 1.0, generator, transposed)


def kaiming_(weight: torch.Tensor,
             generator: torch.Generator | None = None,
             transposed: bool = False) -> torch.Tensor:
    """He normal, fan_in (``jax.nn.initializers.he_normal``)."""
    return _truncated_fan_in(weight, 2.0, generator, transposed)


def conv_normal(std: float = 0.02) -> Init:
    """Gaussian(0, std), in place."""

    def init(weight, generator=None, transposed=False):
        del transposed  # a fixed std reads no fan
        with torch.no_grad():
            return torch.nn.init.normal_(weight, 0.0, std,
                                         generator=generator)

    return init


INITIALIZERS: dict[str, Init] = {
    "normal_001": conv_normal(0.001),
    "normal_002": conv_normal(0.02),
    "normal_01": conv_normal(0.1),
    "kaiming": kaiming_,
}


def get_kernel_init(name: str | None) -> Init:
    """The initializer called ``name``; None or "default" is flax's
    ``lecun_normal``."""
    if name is None or name == "default":
        return lecun_normal_
    return INITIALIZERS[name]
