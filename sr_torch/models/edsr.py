"""EDSR — Lim et al., CVPRW 2017. (sr/models/edsr.py:Net)

BN-free residual blocks: head conv → B resblocks (conv-ReLU-conv, residual
scaling for wide variants) → tail conv + global skip → pixel-shuffle
upsampler (×2 stages; ×3 single stage) → output conv.

``forward``, ``body`` and ``tail`` take and return NHWC tensors, like the
flax module's ``__call__``/``body``/``tail``; inside, activations are
NCHW-logical in channels_last memory. Submodule names follow flax's
(``head``, ``blocks.{i}``, ``body_conv``, ``upsample.{j}``, ``out_conv``),
which ``sr_torch.utils.interop`` maps to ``blocks_{i}``/``upsample_{j}``.
The pre-shuffle training forwards join with the training slice.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from sr_torch.models.registry import ModelSpec, register
from sr_torch.nn.blocks import ConvBlock, PSBlock, ResnetBlock

_STAGES = {2: (2,), 3: (3,), 4: (2, 2), 8: (2, 2, 2)}


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)  # channels_last view of a contiguous NHWC


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class Net(nn.Module):
    def __init__(self, num_channels: int = 3, base_filter: int = 64,
                 num_resblocks: int = 16, scale_factor: int = 4,
                 res_scale: float = 1.0, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if scale_factor not in _STAGES:
            raise ValueError(f"unsupported scale {scale_factor}")
        f = base_filter
        self.num_channels = num_channels
        self.base_filter = base_filter
        self.scale_factor = scale_factor
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        self.head = ConvBlock(num_channels, f, 3, act=None, **kw)
        self.blocks = nn.ModuleList(
            ResnetBlock(f, 3, act="relu", norm=None, res_scale=res_scale, **kw)
            for _ in range(num_resblocks))
        self.body_conv = ConvBlock(f, f, 3, act=None, **kw)
        self.upsample = nn.ModuleList(
            PSBlock(f, f, s, act=None, **kw) for s in _STAGES[scale_factor])
        self.out_conv = ConvBlock(f, num_channels, 3, act=None, **kw)

    def _body(self, x):
        x = self.head(x)
        skip = x
        for blk in self.blocks:
            x = blk(x)
        return self.body_conv(x) + skip

    def _tail(self, x):
        for up in self.upsample:
            x = up(x)
        return self.out_conv(x)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        """Nonlinear trunk: head conv → resblocks → conv + global skip."""
        return _to_nhwc(self._body(_to_nchw(x)))

    def tail(self, x: torch.Tensor) -> torch.Tensor:
        """Upsampling tail — entirely AFFINE (PS convs and the output conv
        have no activations), so ``sr_torch.kernels.fused_tail`` can
        collapse it into one conv + one depth_to_space."""
        return _to_nhwc(self._tail(_to_nchw(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _to_nhwc(self._tail(self._body(_to_nchw(x))))

    def clone(self, dtype: torch.dtype) -> "Net":
        """A copy computing in ``dtype`` (flax's ``model.clone(dtype=...)``)."""
        other = copy.deepcopy(self)
        for m in other.modules():
            if hasattr(m, "dtype"):
                m.dtype = dtype
        return other


def _make(cfg, generator: torch.Generator | None = None) -> Net:
    return Net(cfg.num_channels, cfg.base_filter, cfg.num_resblocks,
               cfg.scale_factor, cfg.res_scale, getattr(torch, cfg.dtype),
               generator)


SPEC = register(ModelSpec(name="EDSR", make_model=_make, pre_upsample=False,
                          default_channels=3, default_lr=1e-4))
