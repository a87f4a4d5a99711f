"""VGG19 feature extractor for the SRGAN perceptual loss.

Port of ``sr/train/vgg.py``: the torchvision ``vgg19.features`` conv tower
up to ``output_layer`` (SRGAN's φ22 is 'relu2_2', the paper's final φ54
'relu5_4'), on [0, 1] RGB NHWC input normalized with ImageNet's mean and
std, the normalization in the input's dtype and the convs in float32, as
the flax module computes them. Its weights are frozen: the gradient flows
through the tower to the generator's output and never into the tower.

:func:`load_vgg` reads a local torchvision ``vgg19`` state dict (a ``.pth``
file, for example the one ``scripts/make_synthetic_vgg.py`` writes, or
torchvision's ``vgg19-dcbb9e9d.pth``); ``None`` means no perceptual term;
``"random"`` draws a seeded random tower (flax's default conv init,
lecun_normal, from a ``torch.Generator``). Such a tower cannot equal the
JAX package's ``"random"`` tower bit for bit, since the two draw from
different generators; parity between the packages goes through one
shared ``.pth``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sr_torch.nn.init import lecun_normal_

# VGG19 'features' conv plan: (block, convs in the block, channels)
_PLAN = [(1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512)]

# ImageNet normalization (torchvision's)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def layer_names() -> list[str]:
    names = []
    for block, convs, _ in _PLAN:
        names += [f"relu{block}_{c}" for c in range(1, convs + 1)]
        names.append(f"pool{block}")
    return names


class VGG19Features(nn.Module):
    """The VGG19 conv tower up to ``output_layer`` (NHWC [0, 1] RGB in,
    NHWC features out). Convs are named ``conv{block}_{i}`` as in the flax
    module; only the convs up to the output layer exist."""

    def __init__(self, output_layer: str = "relu5_4",
                 generator: torch.Generator | None = None):
        super().__init__()
        names = layer_names()
        if output_layer not in names:
            raise ValueError(f"unknown output_layer {output_layer!r}")
        self.output_layer = output_layer
        # 'relu{b}_{i}' (conv{b}_{i} + ReLU) and 'pool{b}', in order
        self.plan = names[:names.index(output_layer) + 1]
        widths = {f"relu{b}_{i}": ch for b, n, ch in _PLAN
                  for i in range(1, n + 1)}
        c_in = 3
        for name in self.plan:
            if name.startswith("relu"):
                conv = nn.utils.skip_init(nn.Conv2d, c_in, widths[name], 3,
                                          padding=1)
                lecun_normal_(conv.weight, generator)
                with torch.no_grad():
                    conv.bias.zero_()
                self.add_module("conv" + name[4:], conv)
                c_in = widths[name]
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN))
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # ImageNet normalization in x's dtype, then float32 convs
        x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        h = x.permute(0, 3, 1, 2).to(torch.float32)
        for name in self.plan:
            if name.startswith("relu"):
                conv = getattr(self, "conv" + name[4:])
                h = torch.relu(F.conv2d(h, conv.weight, conv.bias,
                                        padding=1))
            else:
                h = F.max_pool2d(h, 2, 2)
        return h.permute(0, 2, 3, 1)


def load_torchvision_weights(model: VGG19Features, path: str
                             ) -> VGG19Features:
    """Copy a torchvision ``vgg19`` state dict's ``features.<i>`` convs
    (conv and ReLU interleaved, a pool after each block) into ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    idx = 0
    with torch.no_grad():
        for name in model.plan:
            if name.startswith("relu"):
                conv = getattr(model, "conv" + name[4:])
                conv.weight.copy_(sd[f"features.{idx}.weight"])
                conv.bias.copy_(sd[f"features.{idx}.bias"])
                idx += 2  # conv + relu
            else:
                idx += 1  # pool
    return model


def load_vgg(weights_path: str | None, output_layer: str = "relu5_4",
             seed: int = 0) -> VGG19Features | None:
    """The tower with its weights: None for no path (no perceptual term),
    ``"random"`` for a tower drawn from ``torch.Generator().manual_seed(
    seed)``, else a torchvision ``vgg19`` state dict file."""
    if weights_path is None:
        return None
    if weights_path == "random":
        return VGG19Features(output_layer,
                             torch.Generator().manual_seed(seed))
    return load_torchvision_weights(VGG19Features(output_layer),
                                    weights_path)
