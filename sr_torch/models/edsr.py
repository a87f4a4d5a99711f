"""EDSR — Lim et al., CVPRW 2017. (sr/models/edsr.py:Net)

BN-free residual blocks: head conv → B resblocks (conv-ReLU-conv, residual
scaling for wide variants) → tail conv + global skip → pixel-shuffle
upsampler (×2 stages; ×3 single stage) → output conv.

``forward``, ``body`` and ``tail`` take and return NHWC tensors, like the
flax module's ``__call__``/``body``/``tail``; inside, activations are
NCHW-logical in channels_last memory. Submodule names follow flax's
(``head``, ``blocks.{i}``, ``body_conv``, ``upsample.{j}``, ``out_conv``),
which ``sr_torch.utils.interop`` maps to ``blocks_{i}``/``upsample_{j}``.

The recipe is the paper's: L1 loss, Adam at 1e-4 halved every
``cfg.lr_halve_steps`` updates. Two pre-shuffle training forwards
(``cfg.preshuffle_loss``) fold the tail's convs through its shuffles
(``sr_torch/kernels/shuffle_fold.py``) and take the loss in pre-shuffle
space: 'last' folds the output conv through the last shuffle, 'full' every
tail conv through every earlier shuffle, so no shuffle runs at all.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from sr_torch.kernels.depth_to_space import space_to_depth
from sr_torch.kernels.shuffle_fold import (
    conv_nhwc, fold_shuffle_conv_kernel_torch)
from sr_torch.models.registry import ModelSpec, register
from sr_torch.nn.blocks import ConvBlock, PSBlock, ResnetBlock
from sr_torch.train.losses import l1_loss
from sr_torch.train.optim import adam_with_step_halving

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

    def forward_preshuffle(self, x: torch.Tensor) -> torch.Tensor:
        """Body and upsample stages with the last stage's shuffle left out:
        the pre-shuffle activation that feeds [d2s → out_conv]. Exact:
        EDSR's PSBlocks are act-free."""
        h = self._body(_to_nchw(x))
        for up in self.upsample[:-1]:
            h = up(h)
        return _to_nhwc(self.upsample[-1].preshuffle(h))

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


def _loss(out, batch, ctx):
    return l1_loss(out, batch["hr"]), {}


def _folded_conv(z, conv, factors):
    """``conv`` (a 3×3 SAME conv after the shuffles of ``factors``, in
    order) folded through all of them, innermost first, and run on the
    pre-shuffle ``z`` (NHWC) from the live weights: differentiable, so the
    gradients land in the unfolded weights."""
    w = conv.weight.to(z.dtype).permute(2, 3, 1, 0)  # OIHW → HWIO
    pad_lo = pad_hi = w.shape[0] // 2
    rep = 1
    for r in reversed(factors):
        if pad_lo != pad_hi:
            raise ValueError("the fold needs symmetric intermediate "
                             f"padding, got ({pad_lo},{pad_hi})")
        w, dmin = fold_shuffle_conv_kernel_torch(w, r, padding=pad_lo)
        pad_lo, pad_hi = -dmin, w.shape[0] - 1 + dmin
        rep *= r * r
    bias = conv.bias.repeat_interleave(rep).to(z.dtype)
    return conv_nhwc(z, w, bias, (pad_lo, pad_hi))


def _preshuffle_train(model):
    """Pre-shuffle training forward ('last'): body and stages with the last
    shuffle left out, then the output conv folded through that shuffle.
    Returns ``(apply_fn, r_last)``; the loss runs against
    ``space_to_depth(hr, r_last)`` (L1 is permutation-invariant), so the
    full-resolution shuffle and the 3-channel out conv leave the step."""
    r_last = _STAGES[model.scale_factor][-1]

    def apply_fn(x):
        h = model.forward_preshuffle(x)
        return _folded_conv(h, model.out_conv.Conv_0, (r_last,))

    return apply_fn, r_last


def _preshuffle_train_full(model):
    """Full-tail pre-shuffle training forward ('full'): every tail conv
    moved to LR resolution through every earlier shuffle by the exact fold
    identity, so no shuffle runs in the forward or the backward (×4: three
    3×3 convs at LR, 64→256→1024→48). Returns ``(apply_fn, target_fn)``;
    ``target_fn(hr)`` is the matching space_to_depth chain, last stage's
    factor first."""
    factors = _STAGES[model.scale_factor]

    def apply_fn(x):
        z = model.body(x)
        convs = [up.Conv_0 for up in model.upsample]
        for j, conv in enumerate(convs + [model.out_conv.Conv_0]):
            z = _folded_conv(z, conv, factors[:j])
        return z

    def target_fn(hr):
        z = hr
        for r in reversed(factors):
            z = space_to_depth(z, r)
        return z

    return apply_fn, target_fn


SPEC = register(ModelSpec(
    name="EDSR", make_model=_make, loss=_loss,
    # paper: lr halved every 2e5 minibatch updates (cfg.lr_halve_steps)
    make_tx=lambda cfg: adam_with_step_halving(cfg.effective_lr,
                                               cfg.lr_halve_steps),
    pre_upsample=False, default_channels=3, default_lr=1e-4,
    preshuffle_train=_preshuffle_train,
    preshuffle_train_full=_preshuffle_train_full))
