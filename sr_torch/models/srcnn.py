"""SRCNN — Dong et al., TPAMI 2015. (sr/models/srcnn.py:Net)

Three convs, 9-5-5 (c→64→32→c), ReLU after the first two, on the
bicubic-upscaled LR input (``pre_upsample``), with the SRCNN-era
``normal_001`` kernel init. Submodules carry flax's names
(``ConvBlock_0..2/Conv_0``), so ``from_jax_params`` loads the JAX
package's params as they are. MSE loss, Adam at 1e-3, one channel (Y).

``forward`` takes and returns NHWC tensors, like the flax module's
``__call__``; the output has the input's size.
"""

from __future__ import annotations

import torch
from torch import nn

from sr_torch.models.registry import ModelSpec, register
from sr_torch.nn.blocks import ConvBlock, _nhwc
from sr_torch.train.losses import mse_loss
from sr_torch.train.optim import adam


class Net(nn.Module):
    def __init__(self, num_channels: int = 1, base_filter: int = 64,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = base_filter
        kw = dict(kernel_init="normal_001", dtype=dtype, generator=generator)
        self.ConvBlock_0 = ConvBlock(num_channels, f, 9, act="relu", **kw)
        self.ConvBlock_1 = ConvBlock(f, f // 2, 5, act="relu", **kw)
        self.ConvBlock_2 = ConvBlock(f // 2, num_channels, 5, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ConvBlock_1(self.ConvBlock_0(x.permute(0, 3, 1, 2)))
        return _nhwc(self.ConvBlock_2(h))


def _make(cfg, generator: torch.Generator | None = None) -> Net:
    return Net(cfg.num_channels, cfg.base_filter, getattr(torch, cfg.dtype),
               generator)


def _loss(out, batch, ctx):
    return mse_loss(out, batch["hr"]), {}


SPEC = register(ModelSpec(
    name="SRCNN", make_model=_make, loss=_loss,
    make_tx=lambda cfg: adam(cfg.effective_lr),
    pre_upsample=True, default_channels=1, default_lr=1e-3))
