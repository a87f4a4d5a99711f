"""SRResNet (the SRGAN generator) and the SRGAN discriminator.

Port of ``sr/models/srresnet.py`` (Ledig et al., CVPR 2017).

Generator: 9×9 conv + PReLU → 16 × (conv-BN-PReLU-conv-BN + skip) → 3×3
conv-BN + global skip → log2(r) sub-pixel ×2 stages (PSBlock with PReLU:
conv, the shuffle kernel with the conv's bias, then PReLU) → 9×9 output
conv. RGB. ``forward``, ``body`` and ``tail`` take and return NHWC
tensors like the flax module's ``__call__``/``body``/``tail``; the batch
norms follow the module's mode (``model.train()`` / ``model.eval()``), as
flax's follow ``train``. The tail is not affine (PReLUs between stages),
so serving folds the output conv through the last shuffle
(``sr_torch.kernels.shuffle_fold.make_folded_tail_predict``) instead of
collapsing the tail.

Discriminator: the VGG-style 8-conv tower (64…512, alternating stride 2,
LeakyReLU 0.2, BN from the 2nd conv) → dense 1024 → LeakyReLU → dense 1,
returning logits (the loss folds the sigmoid in,
``sr_torch.train.losses.bce_with_logits``). flax flattens the NHWC tower
output before the first dense layer, whose input width the HR crop fixes:
the port flattens in NHWC order too, so the dense kernel crosses with a
plain transpose, and takes the crop (``in_size``) when it is built.

Submodules carry flax's names (``head``, ``head_act``, ``blocks.{i}``,
``body_conv``, ``body_bn``, ``upsample.{j}``, ``out_conv``;
``ConvBlock_{i}``, ``Dense_0``, ``Dense_1``), so ``from_jax_params``
loads the JAX package's params and batch statistics as they are.
Registered as 'SRResNet': MSE, Adam at 1e-4 (the generator's
pre-training recipe); the adversarial recipe is 'SRGAN'
(``sr_torch/models/srgan.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sr_torch.models.registry import ModelSpec, register
from sr_torch.nn.blocks import (
    BatchNorm, ConvBlock, PReLU, PSBlock, ResnetBlock, _apply_conv, _conv)
from sr_torch.nn.init import lecun_normal_
from sr_torch.train.losses import mse_loss
from sr_torch.train.optim import adam


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)  # channels_last view of a contiguous NHWC


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class Net(nn.Module):
    def __init__(self, num_channels: int = 3, base_filter: int = 64,
                 num_resblocks: int = 16, scale_factor: int = 4,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if scale_factor & (scale_factor - 1) or scale_factor < 2:
            raise ValueError(f"SRResNet takes a power-of-2 scale, got "
                             f"{scale_factor}")
        f = base_filter
        self.num_channels = num_channels
        self.base_filter = base_filter
        self.scale_factor = scale_factor
        self.dtype = dtype
        kw = dict(kernel_init="normal_002", dtype=dtype, generator=generator)
        self.head = _conv(num_channels, f, 9, 1, True, generator,
                          "normal_002")
        self.head_act = PReLU()
        self.blocks = nn.ModuleList(
            ResnetBlock(f, 3, act="prelu", norm="batch", **kw)
            for _ in range(num_resblocks))
        self.body_conv = _conv(f, f, 3, 1, True, generator, "normal_002")
        self.body_bn = BatchNorm(f, dtype=dtype)
        self.upsample = nn.ModuleList(
            PSBlock(f, f, 2, act="prelu", **kw)
            for _ in range(int(math.log2(scale_factor))))
        self.out_conv = _conv(f, num_channels, 9, 1, True, generator,
                              "normal_002")

    def _body(self, x):
        x = self.head_act(_apply_conv(self.head, x, self.dtype))
        skip = x
        for blk in self.blocks:
            x = blk(x)
        return self.body_bn(_apply_conv(self.body_conv, x, self.dtype)) + skip

    def _tail(self, x):
        for up in self.upsample:
            x = up(x)
        return _apply_conv(self.out_conv, x, self.dtype)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        """Head + resblocks + conv-BN + global skip, all at LR size."""
        return _to_nhwc(self._body(_to_nchw(x)))

    def tail(self, x: torch.Tensor) -> torch.Tensor:
        """log2(r) × [conv → pixel shuffle → PReLU] + the 9×9 output conv.
        Not affine: the PReLUs sit between the stages."""
        return _to_nhwc(self._tail(_to_nchw(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _to_nhwc(self._tail(self._body(_to_nchw(x))))


class Discriminator(nn.Module):
    def __init__(self, num_channels: int = 3, base_filter: int = 64,
                 in_size: int = 96, dense_features: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if in_size % 16:
            raise ValueError(f"the discriminator's input size {in_size} must "
                             "divide by 16 (four stride-2 convs)")
        f = base_filter
        self.dtype = dtype
        # (features, stride, use_bn)
        tower = [(f, 1, False), (f, 2, True), (f * 2, 1, True),
                 (f * 2, 2, True), (f * 4, 1, True), (f * 4, 2, True),
                 (f * 8, 1, True), (f * 8, 2, True)]
        c = num_channels
        for i, (feats, stride, bn) in enumerate(tower):
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                c, feats, 3, stride, act="lrelu",
                norm="batch" if bn else None, kernel_init="normal_002",
                dtype=dtype, generator=generator))
            c = feats
        self.num_convs = len(tower)
        self.Dense_0 = _dense(c * (in_size // 16) ** 2, dense_features,
                              generator)
        self.Dense_1 = _dense(dense_features, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images → (B, 1) logits."""
        h = _to_nchw(x)
        for i in range(self.num_convs):
            h = getattr(self, f"ConvBlock_{i}")(h)
        h = _to_nhwc(h).reshape(h.shape[0], -1)  # flax's NHWC flatten
        h = F.leaky_relu(_apply_dense(self.Dense_0, h, self.dtype), 0.2)
        return _apply_dense(self.Dense_1, h, self.dtype)


def _dense(in_features: int, features: int,
           generator: torch.Generator | None) -> nn.Linear:
    """flax ``nn.Dense``: lecun_normal kernel (fan_in = in_features), zero
    bias."""
    layer = nn.utils.skip_init(nn.Linear, in_features, features)
    lecun_normal_(layer.weight, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


def _apply_dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def make_net(cfg, generator: torch.Generator | None = None) -> Net:
    return Net(cfg.num_channels, cfg.base_filter, cfg.num_resblocks,
               cfg.scale_factor, getattr(torch, cfg.dtype), generator)


def make_discriminator(cfg, generator: torch.Generator | None = None
                       ) -> Discriminator:
    """The discriminator for ``cfg``'s HR crop (``crop_size``)."""
    return Discriminator(cfg.num_channels, cfg.base_filter, cfg.crop_size,
                         dtype=getattr(torch, cfg.dtype),
                         generator=generator)


def _loss(out, batch, ctx):
    return mse_loss(out, batch["hr"]), {}


SPEC = register(ModelSpec(
    name="SRResNet", make_model=make_net, loss=_loss,
    make_tx=lambda cfg: adam(cfg.effective_lr),
    pre_upsample=False, default_channels=3, default_lr=1e-4,
    has_batchnorm=True))
