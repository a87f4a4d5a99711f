"""DRCN — Kim et al., CVPR 2016. (sr/models/drcn.py:Net)

Deeply-recursive net on the bicubic-upscaled LR input: an embedding net
(two 3×3 convs with ReLU), then ONE weight-shared recursion block applied
``num_recursions`` times. Each recursion runs the inference conv (+ ReLU)
on the recursion state and the shared reconstruction net (conv + ReLU,
conv to c) on the result, adds the input (the residual) and adds
``w_d · y_d`` to the ensemble, with ``w`` the learnable recursion weights
normalized to sum 1. The ensemble is accumulated as it goes, from
``zeros_like(input)`` and with ``w_d`` cast to y's dtype as flax does, so
the eval forward keeps no stack of features (O(1) memory in depth). In
training mode (``model.train()``) ``forward`` returns ``(final, ys)``, ys
the (D, B, H, W, c) per-recursion predictions that the recursive
supervision loss reads; in eval mode ``final`` only.

Where the JAX package scans the block with ``nn.scan``, the port loops in
Python over the same module. Submodules carry flax's names
(``ConvBlock_0``, ``ConvBlock_1``, ``Scan_RecBlock_0/{Conv_0,
ConvBlock_0/Conv_0, Conv_1}`` and the bare ``recursion_weights``), so
``from_jax_params`` loads the JAX package's params as they are; every conv,
the recursion's bare ones included, goes through
``sr_torch.nn.blocks._apply_conv``, so int8 serving and calibration see
each. The recursion block is marked ``recurrent``: the JAX package's
calibration cannot see into its scan and leaves those sites to dynamic
per-sample scales, and the port's does the same
(``sr_torch.nn.intercept.recurrent_convs``).

Loss: α·mean_d MSE(y_d) + (1 − α)·MSE(final), α annealed 1 → 0 over the
run (``_schedule``); Adam at 1e-4 with L2 weight decay 1e-4 added to the
gradient before Adam (not decoupled AdamW decay).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from sr_torch.models.registry import ModelSpec, register
from sr_torch.nn.blocks import ConvBlock, _apply_conv, _conv, _nhwc
from sr_torch.train.losses import recursive_supervision_loss
from sr_torch.train.optim import adam


class _RecBlock(nn.Module):
    """One recursion: the shared inference conv and the shared
    reconstruction net. (sr/models/drcn.py:_RecBlock)"""

    recurrent = True  # applied in a loop with shared weights

    def __init__(self, features: int, num_channels: int,
                 dtype: torch.dtype, generator: torch.Generator | None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = _conv(features, features, 3, 1, True, generator)
        self.ConvBlock_0 = ConvBlock(features, features, 3, act="relu",
                                     dtype=dtype, generator=generator)
        self.Conv_1 = _conv(features, num_channels, 3, 1, True, generator)

    def forward(self, h, acc, inp, w_d):
        """One step of the carry ``(h, acc)``: the new recursion state, the
        ensemble with ``w_d · y`` added, and this recursion's y."""
        h = torch.relu(_apply_conv(self.Conv_0, h, self.dtype))
        y = _apply_conv(self.Conv_1, self.ConvBlock_0(h), self.dtype)
        y = y + inp
        return h, acc + w_d.to(y.dtype) * y, y


class Net(nn.Module):
    def __init__(self, num_channels: int = 1, base_filter: int = 64,
                 num_recursions: int = 16,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = base_filter
        kw = dict(dtype=dtype, generator=generator)
        self.num_recursions = num_recursions
        self.ConvBlock_0 = ConvBlock(num_channels, f, 3, act="relu", **kw)
        self.ConvBlock_1 = ConvBlock(f, f, 3, act="relu", **kw)
        self.recursion_weights = nn.Parameter(
            torch.full((num_recursions,), 1.0 / num_recursions))
        self.Scan_RecBlock_0 = _RecBlock(f, num_channels, dtype, generator)

    def forward(self, x: torch.Tensor):
        inp = x.permute(0, 3, 1, 2)
        h = self.ConvBlock_1(self.ConvBlock_0(inp))
        w = self.recursion_weights / torch.sum(self.recursion_weights)
        acc = torch.zeros_like(inp)
        ys = []
        for d in range(self.num_recursions):
            h, acc, y = self.Scan_RecBlock_0(h, acc, inp, w[d])
            if self.training:
                ys.append(_nhwc(y))
        if self.training:
            return _nhwc(acc), torch.stack(ys)
        return _nhwc(acc)


def migrate_params_r2(params: dict) -> dict:
    """Round-2 → round-3 DRCN param layout (sr/models/drcn.py): round-2
    exports keep the recursion conv under ``Scan_RecStep_0/Conv_0`` and the
    reconstruction net at the top level (``ConvBlock_2``, ``Conv_0``). The
    weights are the same; only their paths moved.
    ``sr_torch.utils.checkpoint.load_params`` applies this."""
    if "Scan_RecStep_0" not in params:
        return params
    p = dict(params)
    p["Scan_RecBlock_0"] = {
        "Conv_0": p.pop("Scan_RecStep_0")["Conv_0"],
        "ConvBlock_0": p.pop("ConvBlock_2"),
        "Conv_1": p.pop("Conv_0"),
    }
    return p


def _make(cfg, generator: torch.Generator | None = None) -> Net:
    return Net(cfg.num_channels, cfg.base_filter, cfg.num_recursions,
               getattr(torch, cfg.dtype), generator)


def _loss(out, batch, ctx):
    final, ys = out
    return recursive_supervision_loss(ys, final, batch["hr"], ctx["alpha"])


def _schedule(cfg, step: int) -> dict:
    """α = clip(1 − step / total, 0, 1) in float32, as the JAX package
    computes it: recursive supervision fades in favour of the ensemble."""
    total = np.float32(max(cfg.num_epochs * cfg.steps_per_epoch, 1))
    return {"alpha": np.clip(np.float32(1.0) - np.float32(step) / total,
                             np.float32(0.0), np.float32(1.0))}


SPEC = register(ModelSpec(
    name="DRCN", make_model=_make, loss=_loss,
    make_tx=lambda cfg: adam(cfg.effective_lr, weight_decay=1e-4),
    schedule=_schedule, pre_upsample=True, default_channels=1,
    default_lr=1e-4))
