"""LapSRN — Lai et al., CVPR 2017. (sr/models/lapsrn.py:Net)

Laplacian pyramid on the raw LR input: log2(r) levels, each with

* a feature branch: D 3×3 convs (LeakyReLU 0.2) and a 4×4 stride-2
  transposed conv (``sr_torch/nn/blocks.py:DeconvBlock``),
* a residual conv (3×3, 64 → c) at the level's resolution,
* an image branch: a 4×4 stride-2 transposed conv of the running image,
  plus the residual.

Every kernel takes the ``kaiming`` init. flax numbers ``ConvBlock_i`` and
``DeconvBlock_j`` each in call order, which interleaves them per level
(the head conv; D feature convs, the feature deconv, the residual conv,
the image deconv), and the submodules carry those names, so
``from_jax_params`` loads the JAX package's params as they are.

In training (``self.training``) or with ``all_scales=True`` the forward
returns the tuple of level outputs (×2, ×4, ...), which deep supervision
trains and ``sr_torch.infer.upscale(net_scale=...)`` serves; otherwise the
last level. Charbonnier loss at every level against the HR image
bicubic-downscaled to the level's size (``clip=False``, then clamped to
[0, 1]) and the HR image itself at the last, Adam at 1e-4, one channel (Y).

``forward`` takes and returns NHWC tensors, like the flax module's
``__call__``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sr_torch.kernels.bicubic import resize2d_unit
from sr_torch.models.registry import ModelSpec, register
from sr_torch.nn.blocks import ConvBlock, DeconvBlock, _nhwc
from sr_torch.train.losses import charbonnier_loss
from sr_torch.train.optim import adam


class Net(nn.Module):
    def __init__(self, num_channels: int = 1, base_filter: int = 64,
                 num_convs: int = 5, scale_factor: int = 4,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        r = scale_factor
        if r & (r - 1) or r < 2:
            raise ValueError(f"LapSRN needs a power-of-2 scale, got {r}")
        self.levels = int(math.log2(r))
        self.num_convs = num_convs
        f, c = base_filter, num_channels
        kw = dict(kernel_init="kaiming", dtype=dtype, generator=generator)
        convs, deconvs = [ConvBlock(c, f, 3, act="lrelu", **kw)], []
        for _ in range(self.levels):
            convs += [ConvBlock(f, f, 3, act="lrelu", **kw)
                      for _ in range(num_convs)]
            deconvs.append(DeconvBlock(f, f, 4, 2, act="lrelu", **kw))
            convs.append(ConvBlock(f, c, 3, act=None, **kw))
            deconvs.append(DeconvBlock(c, c, 4, 2, act=None, **kw))
        for i, m in enumerate(convs):
            setattr(self, f"ConvBlock_{i}", m)
        for j, m in enumerate(deconvs):
            setattr(self, f"DeconvBlock_{j}", m)

    def forward(self, x: torch.Tensor, all_scales: bool = False):
        x = x.permute(0, 3, 1, 2)
        feat = self.ConvBlock_0(x)
        img, outs = x, []
        ci = 1
        for lvl in range(self.levels):
            h = feat
            for _ in range(self.num_convs):
                h = getattr(self, f"ConvBlock_{ci}")(h)
                ci += 1
            feat = getattr(self, f"DeconvBlock_{2 * lvl}")(h)
            residual = getattr(self, f"ConvBlock_{ci}")(feat)
            ci += 1
            img = getattr(self, f"DeconvBlock_{2 * lvl + 1}")(img) + residual
            outs.append(img)
        if self.training or all_scales:
            return tuple(_nhwc(o) for o in outs)
        return _nhwc(outs[-1])


def _make(cfg, generator: torch.Generator | None = None) -> Net:
    return Net(cfg.num_channels, cfg.base_filter, cfg.num_pyramid_convs,
               cfg.scale_factor, getattr(torch, cfg.dtype), generator)


def _loss(out, batch, ctx):
    hr = batch["hr"]
    total, metrics = 0.0, {}
    n = len(out)
    for lvl, pred in enumerate(out):
        h, w = pred.shape[1], pred.shape[2]
        target = hr if lvl == n - 1 else resize2d_unit(hr, (h, w))
        li = charbonnier_loss(pred, target)
        metrics[f"loss_x{2 ** (lvl + 1)}"] = li
        total = total + li
    return total, metrics


SPEC = register(ModelSpec(
    name="LapSRN", make_model=_make, loss=_loss,
    make_tx=lambda cfg: adam(cfg.effective_lr),
    pre_upsample=False, default_channels=1, default_lr=1e-4,
    multi_scale_out=True))
