"""Conv interception, the port's ``flax.linen.intercept_methods``.

``sr/quant.py`` swaps every ``nn.Conv`` call for its int8 path, or records
each conv's input for calibration, by intercepting the module calls without
touching model code. The port's blocks route every conv through
``sr_torch.nn.blocks._apply_conv``, which hands ``(conv, x)`` to the active
interceptor before it casts ``x`` to the block's dtype:

    with intercept_convs(fn):
        y = model(x)

``fn(conv, x)`` returns the conv's output, or ``None`` to let the float conv
run. The interceptor lives in a :class:`contextvars.ContextVar`, so threads
of the server never see each other's. While one is active, ``ResnetBlock``
runs its convs one by one instead of through the fused kernel, so that each
conv is a site.

:func:`site_keys` names each conv by its flax module path (``head/Conv_0``,
``blocks_3/Conv_1``, ``upsample_0/Conv_0``), the keys of the JAX package's
calibrated scales.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch
from torch import nn

from sr_torch.utils.interop import flax_path

Interceptor = Callable[[nn.Conv2d, torch.Tensor], Optional[torch.Tensor]]

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


def site_keys(model: nn.Module) -> dict[nn.Conv2d, str]:
    """``{conv module: flax path}`` for every ``nn.Conv2d`` in ``model``."""
    return {m: "/".join(flax_path(name))
            for name, m in model.named_modules()
            if isinstance(m, nn.Conv2d)}
