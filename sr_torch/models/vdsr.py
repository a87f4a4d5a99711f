"""VDSR — Kim et al., CVPR 2016. (sr/models/vdsr.py:Net)

``num_layers`` 3×3 convs (c→64, 64→64 × (num_layers − 2), 64→c), ReLU after
all but the last, no biases, He-normal (``kaiming``) kernel init, on the
bicubic-upscaled LR input, and the global residual: the net predicts the
difference to its input (``x + inp``). Submodules carry flax's names
(``ConvBlock_0..num_layers-1/Conv_0``). Recipe: MSE, SGD with momentum 0.9
and weight decay 1e-4, lr 0.1 decayed ×0.1 every 20 epochs, the global
gradient norm clipped to θ / lr (``vdsr_sgd``; θ = ``cfg.vdsr_clip_theta``,
0.05 as in the JAX package).

``forward`` takes and returns NHWC tensors; the output has the input's
size.
"""

from __future__ import annotations

import torch
from torch import nn

from sr_torch.models.registry import ModelSpec, register
from sr_torch.nn.blocks import ConvBlock, _nhwc
from sr_torch.train.losses import mse_loss
from sr_torch.train.optim import vdsr_sgd


class Net(nn.Module):
    def __init__(self, num_channels: int = 1, base_filter: int = 64,
                 num_layers: int = 20, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = base_filter
        kw = dict(kernel_init="kaiming", use_bias=False, dtype=dtype,
                  generator=generator)
        widths = [num_channels] + [f] * (num_layers - 1) + [num_channels]
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                widths[i], widths[i + 1], 3, act=None if last else "relu",
                **kw))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x.permute(0, 3, 1, 2)
        h = inp
        for i in range(self.num_layers):
            h = getattr(self, f"ConvBlock_{i}")(h)
        return _nhwc(h + inp)  # global residual learning


def _make(cfg, generator: torch.Generator | None = None) -> Net:
    return Net(cfg.num_channels, cfg.base_filter,
               dtype=getattr(torch, cfg.dtype), generator=generator)


def _loss(out, batch, ctx):
    return mse_loss(out, batch["hr"]), {}


SPEC = register(ModelSpec(
    name="VDSR", make_model=_make, loss=_loss,
    make_tx=lambda cfg: vdsr_sgd(cfg.effective_lr, cfg.steps_per_epoch,
                                 clip_theta=cfg.vdsr_clip_theta),
    pre_upsample=True, default_channels=1, default_lr=0.1))
