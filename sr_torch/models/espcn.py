"""ESPCN — Shi et al., CVPR 2016. (sr/models/espcn.py:Net)

Sub-pixel convolution net: 5-3-3 convs (c→64→32→c·r²) on the raw LR input,
then the pixel shuffle (``sr_torch/kernels/depth_to_space.py``), which also
adds the last conv's bias, as in ``PSBlock``. Under an interceptor (int8
serving, calibration) the intercepted conv keeps its bias and the shuffle
gets none. Submodules carry flax's names (``ConvBlock_0/Conv_0``,
``ConvBlock_1/Conv_0``, ``Conv_0``), so ``from_jax_params`` loads the JAX
package's params as they are. MSE loss, Adam at 1e-3, one channel (Y) by
default.

``forward`` takes and returns NHWC tensors, like the flax module's
``__call__``; ``preshuffle=True`` returns the last conv's output, the
pre-shuffle training target space (``cfg.preshuffle_loss='last'``).
"""

from __future__ import annotations

import torch
from torch import nn

from sr_torch.kernels.depth_to_space import depth_to_space
from sr_torch.models.registry import ModelSpec, register
from sr_torch.nn.blocks import ConvBlock, _apply_conv, _conv, _run_conv
from sr_torch.train.losses import mse_loss
from sr_torch.train.optim import adam


class Net(nn.Module):
    def __init__(self, num_channels: int = 1, base_filter: int = 64,
                 scale_factor: int = 4, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        f, r = base_filter, scale_factor
        self.num_channels = num_channels
        self.scale_factor = scale_factor
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        self.ConvBlock_0 = ConvBlock(num_channels, f, 5, act="relu", **kw)
        self.ConvBlock_1 = ConvBlock(f, f // 2, 3, act="relu", **kw)
        self.Conv_0 = _conv(f // 2, num_channels * r * r, 3, 1, True,
                            generator)

    def forward(self, x: torch.Tensor, preshuffle: bool = False
                ) -> torch.Tensor:
        h = self.ConvBlock_1(self.ConvBlock_0(x.permute(0, 3, 1, 2)))
        if preshuffle:
            # the shuffle is the net's last op: the 'last' pre-shuffle loss
            # takes the MSE against space_to_depth(hr) and skips it
            return _apply_conv(self.Conv_0, h, self.dtype).permute(
                0, 2, 3, 1).contiguous()
        y, bias = _run_conv(self.Conv_0, h, self.dtype, add_bias=False)
        return depth_to_space(y.permute(0, 2, 3, 1).contiguous(),
                              self.scale_factor, None, bias)


def _make(cfg, generator: torch.Generator | None = None) -> Net:
    return Net(cfg.num_channels, cfg.base_filter, cfg.scale_factor,
               getattr(torch, cfg.dtype), generator)


def _loss(out, batch, ctx):
    return mse_loss(out, batch["hr"]), {}


def _preshuffle_train(model):
    """No fold needed: the shuffle is ESPCN's final op, so the pre-shuffle
    output is the last conv's (B, h, w, c·r²) tensor."""

    def apply_fn(x):
        return model(x, preshuffle=True)

    return apply_fn, model.scale_factor


SPEC = register(ModelSpec(
    name="ESPCN", make_model=_make, loss=_loss,
    make_tx=lambda cfg: adam(cfg.effective_lr),
    pre_upsample=False, default_channels=1, default_lr=1e-3,
    preshuffle_train=_preshuffle_train))
