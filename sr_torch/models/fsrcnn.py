"""FSRCNN — Dong et al., ECCV 2016. (sr/models/fsrcnn.py:Net)

Hourglass on the raw LR input: a 5×5 feature conv (d=56) → a 1×1 shrink
(s=12) → m=4 mapping convs 3×3 → a 1×1 expand (d), each with its own
PReLU (one shared slope), then a 9×9 transposed conv of stride r with the
``normal_001`` init (``sr_torch/nn/blocks.py:DeconvBlock``). Submodules
carry flax's names (``ConvBlock_0..6/Conv_0``,
``DeconvBlock_0/ConvTranspose_0``), so ``from_jax_params`` loads the JAX
package's params as they are. MSE loss, Adam at 1e-3, the deconv tail at
0.1× that rate (``_label_lr_groups``), one channel (Y).

``forward`` takes and returns NHWC tensors, like the flax module's
``__call__``.
"""

from __future__ import annotations

import torch
from torch import nn

from sr_torch.models.registry import ModelSpec, register
from sr_torch.nn.blocks import ConvBlock, DeconvBlock, _nhwc
from sr_torch.train.losses import mse_loss
from sr_torch.train.optim import adam, with_lr_groups


class Net(nn.Module):
    def __init__(self, num_channels: int = 1, d: int = 56, s: int = 12,
                 m: int = 4, scale_factor: int = 4,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(act="prelu", dtype=dtype, generator=generator)
        convs = ([(num_channels, d, 5), (d, s, 1)] + [(s, s, 3)] * m
                 + [(s, d, 1)])
        for i, (cin, cout, k) in enumerate(convs):
            setattr(self, f"ConvBlock_{i}", ConvBlock(cin, cout, k, **kw))
        self.num_convs = len(convs)
        self.DeconvBlock_0 = DeconvBlock(
            d, num_channels, 9, scale_factor, act=None,
            kernel_init="normal_001", dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            h = getattr(self, f"ConvBlock_{i}")(h)
        return _nhwc(self.DeconvBlock_0(h))


def _make(cfg, generator: torch.Generator | None = None) -> Net:
    return Net(num_channels=cfg.num_channels, scale_factor=cfg.scale_factor,
               dtype=getattr(torch, cfg.dtype), generator=generator)


def _loss(out, batch, ctx):
    return mse_loss(out, batch["hr"]), {}


def _label_lr_groups(model: nn.Module) -> dict[str, str]:
    """'deconv' for every top-level child that contains a transposed conv,
    'base' otherwise: structural, as the JAX package's labeller inspects
    its param tree for flax's ``ConvTranspose``, so renaming
    ``DeconvBlock`` cannot move the tail into the wrong group."""
    return {name: ("deconv" if any(isinstance(m, nn.ConvTranspose2d)
                                   for m in child.modules()) else "base")
            for name, child in model.named_children()}


def _make_tx(cfg):
    # the deconv tail trains at 0.1× the base LR (Dong et al. ECCV'16 §4.2)
    return with_lr_groups(adam(cfg.effective_lr),
                          {"base": 1.0, "deconv": 0.1}, _label_lr_groups)


SPEC = register(ModelSpec(
    name="FSRCNN", make_model=_make, loss=_loss, make_tx=_make_tx,
    pre_upsample=False, default_channels=1, default_lr=1e-3))
