"""Conv interception, the port's ``flax.linen.intercept_methods``.

``sr/quant.py`` swaps every ``nn.Conv`` call (and with ``quantize_deconv``
every ``nn.ConvTranspose`` call) for its int8 path, or records each site's
input for calibration, by intercepting the module calls without touching
model code. The port's blocks route every conv and deconv through
``sr_torch.nn.blocks._apply_conv``, which hands ``(conv, x)`` to the active
interceptor before it casts ``x`` to the block's dtype:

    with intercept_convs(fn):
        y = model(x)

``fn(conv, x)`` returns the conv's output, or ``None`` to let the float conv
run. The interceptor lives in a :class:`contextvars.ContextVar`, so threads
of the server never see each other's. While one is active, ``ResnetBlock``
runs its convs one by one instead of through the fused kernel, so that each
conv is a site.

:func:`site_keys` names each conv and transposed conv by its flax module
path (``head/Conv_0``, ``blocks_3/Conv_1``, ``upsample_0/Conv_0``,
``DeconvBlock_0/ConvTranspose_0``), the keys of the JAX package's
calibrated scales. :func:`recurrent_convs` finds the convs of a block that
a model applies in a loop with shared weights (DRCN's recursion, marked
``recurrent``): the JAX package's calibration skips the sites inside its
``nn.scan`` by trace identity, and the port's skips these.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch
from torch import nn

from sr_torch.utils.interop import flax_path

#: the conv sites: convs, and the transposed convs of ``DeconvBlock``
SITES = (nn.Conv2d, nn.ConvTranspose2d)

Interceptor = Callable[[nn.Module, torch.Tensor], Optional[torch.Tensor]]

_ACTIVE: contextvars.ContextVar[Interceptor | None] = contextvars.ContextVar(
    "sr_torch_conv_interceptor", default=None)


@contextlib.contextmanager
def intercept_convs(fn: Interceptor):
    """Route every conv of the blocks through ``fn`` inside the block."""
    token = _ACTIVE.set(fn)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Interceptor | None:
    """The interceptor of the current context, if any."""
    return _ACTIVE.get()


def site_keys(model: nn.Module) -> dict[nn.Module, str]:
    """``{conv module: flax path}`` for every ``nn.Conv2d`` and
    ``nn.ConvTranspose2d`` in ``model``."""
    return {m: "/".join(flax_path(name))
            for name, m in model.named_modules()
            if isinstance(m, SITES)}


def recurrent_convs(model: nn.Module) -> set[nn.Conv2d]:
    """Every ``nn.Conv2d`` inside a submodule whose ``recurrent`` attribute
    is true."""
    return {c for m in model.modules() if getattr(m, "recurrent", False)
            for c in m.modules() if isinstance(c, nn.Conv2d)}
