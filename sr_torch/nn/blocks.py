"""NN building blocks: ConvBlock, ResnetBlock, PSBlock.

Port of ``sr/nn/blocks.py`` for the part of its menu that the port's
models use: the ``relu`` and ``None`` activations, no norm, the kernel
initializers of ``sr_torch/nn/init.py`` (``kernel_init``) and convs
without bias (``use_bias=False``). Other activations and norms raise until
their port slice lands.

Blocks take and return NCHW-logical tensors in ``torch.channels_last``
memory, which lays them out as NHWC, so ``x.permute(0, 2, 3, 1)`` hands the
kernels an NHWC tensor without a copy. Parameters are float32; ``dtype`` is
the compute dtype, as in the flax blocks. Each block names its convs
``Conv_0``/``Conv_1`` like flax does, so a parameter's path reads the same
in both packages.

* ``ResnetBlock`` without grad calls :func:`fused_resblock` (the CUDA
  kernel on the card, its plain version on the CPU). With grad on it runs
  conv → ReLU → conv, ·res_scale, + x as separate differentiable ops, as
  the JAX block does in training: the fused kernel, like the TPU kernel,
  has no backward.
* ``PSBlock`` runs its conv without the bias and hands the bias to
  :func:`depth_to_space`, which adds it as it shuffles (and differentiates
  through it under grad); under an interceptor the intercepted conv keeps
  its bias and the shuffle gets none. ``shuffle=False`` returns the conv's
  output before the shuffle, for the pre-shuffle training forwards.
* Other convs are ``F.conv2d``: the JAX package left them to XLA, outside
  any Pallas kernel.
* Every conv goes through :func:`_apply_conv`, which first offers it to the
  active interceptor (``sr_torch/nn/intercept.py``), as flax's
  ``intercept_methods`` sees each ``nn.Conv`` call of the JAX blocks. While
  one is active, ``ResnetBlock`` runs its two convs one by one, so int8
  serving and calibration see every conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sr_torch.kernels.depth_to_space import depth_to_space
from sr_torch.kernels.fused_resblock import (
    fused_resblock, pack_wgmma_weights, pack_weights)
from sr_torch.nn import intercept
from sr_torch.nn.init import get_kernel_init

_LATER = "lands in a later port slice"


def _check_menu(act, norm) -> None:
    if act not in (None, "none", "relu"):
        raise NotImplementedError(f"activation {act!r} {_LATER}")
    if norm is not None:
        raise NotImplementedError(f"norm {norm!r} {_LATER}")


def _conv(in_features: int, features: int, kernel_size: int, stride: int,
          use_bias: bool, generator: torch.Generator | None,
          kernel_init: str | None = None) -> nn.Conv2d:
    """A conv with the kernel init called ``kernel_init`` (None: flax's
    default, lecun_normal) and a zero bias."""
    conv = nn.utils.skip_init(nn.Conv2d, in_features, features, kernel_size,
                              stride=stride, padding=kernel_size // 2,
                              bias=use_bias)
    get_kernel_init(kernel_init)(conv.weight, generator)
    if use_bias:
        with torch.no_grad():
            conv.bias.zero_()
    return conv


def _run_conv(conv: nn.Conv2d, x: torch.Tensor, dtype, add_bias: bool
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``conv`` on ``x``: ``(y, bias_left)``. ``bias_left`` is the conv's
    bias in ``dtype`` when ``add_bias`` is false and the conv ran here
    without it, for the caller to add; else None (an interceptor's conv
    includes its bias)."""
    # the interceptor takes x before the cast, as flax's interceptor sees
    # nn.Conv's argument before nn.Conv casts it to its dtype
    fn = intercept.active()
    if fn is not None:
        y = fn(conv, x)
        if y is not None:
            return y, None
    bias = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype),
                 bias if add_bias else None, conv.stride, conv.padding)
    return y, None if add_bias else bias


def _apply_conv(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    return _run_conv(conv, x, dtype, add_bias=True)[0]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class ConvBlock(nn.Module):
    """Conv → [act]. (sr/nn/blocks.py:ConvBlock)"""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, act: str | None = "relu",
                 norm: str | None = None, use_bias: bool = True,
                 kernel_init: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_menu(act, norm)
        self.act = act
        self.dtype = dtype
        self.Conv_0 = _conv(in_features, features, kernel_size, stride,
                            use_bias, generator, kernel_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _apply_conv(self.Conv_0, x, self.dtype)
        return torch.relu(y) if self.act == "relu" else y


class ResnetBlock(nn.Module):
    """conv → relu → conv, + residual·res_scale. (sr/nn/blocks.py:ResnetBlock
    with ``norm=None``, ``act='relu'``, EDSR's body block)"""

    def __init__(self, features: int, kernel_size: int = 3,
                 act: str | None = "relu", norm: str | None = None,
                 res_scale: float = 1.0, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_menu(act, norm)
        if act != "relu" or kernel_size != 3:
            raise NotImplementedError(
                f"ResnetBlock(act={act!r}, kernel_size={kernel_size}) {_LATER}")
        self.res_scale = res_scale
        self.dtype = dtype
        self.Conv_0 = _conv(features, features, 3, 1, True, generator)
        self.Conv_1 = _conv(features, features, 3, 1, True, generator)
        self._packed = None
        self._packed_key = None

    def packed(self):
        """The operands and f32 biases for :func:`fused_resblock`, in the
        block's dtype on the weights' device: (9·C, C) operands, or for a
        bf16 block on a card the kernel's ``wgmma`` layout. Packed on first
        use and cached; packed again when a weight changes, moves or the
        dtype changes."""
        weights = (self.Conv_0.weight, self.Conv_0.bias,
                   self.Conv_1.weight, self.Conv_1.bias)
        key = (self.dtype, weights[0].device, *(p._version for p in weights))
        if self._packed_key != key:
            with torch.no_grad():
                w1, b1, w2, b2 = pack_weights(*weights)
                w1, w2 = w1.to(self.dtype), w2.to(self.dtype)
                if w1.is_cuda and self.dtype == torch.bfloat16:
                    w1, w2 = pack_wgmma_weights(w1), pack_wgmma_weights(w2)
                self._packed = (w1, b1, w2, b2)
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() or intercept.active() is not None:
            # conv → relu → conv, + residual (sr/nn/blocks.py:ResnetBlock):
            # differentiable, and each conv a site for an interceptor
            h = torch.relu(_apply_conv(self.Conv_0, x, self.dtype))
            h = _apply_conv(self.Conv_1, h, self.dtype)
            if self.res_scale != 1.0:
                h = h * torch.tensor(self.res_scale, dtype=h.dtype)
            return x + h
        y = fused_resblock(_nhwc(x.to(self.dtype)), *self.packed(),
                           res_scale=self.res_scale)
        return y.permute(0, 3, 1, 2)


class PSBlock(nn.Module):
    """Conv to C·r² then pixel shuffle → [act]. (sr/nn/blocks.py:PSBlock)"""

    def __init__(self, in_features: int, features: int, scale_factor: int = 2,
                 kernel_size: int = 3, act: str | None = "relu",
                 norm: str | None = None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_menu(act, norm)
        self.scale_factor = scale_factor
        self.act = act
        self.dtype = dtype
        self.Conv_0 = _conv(in_features, features * scale_factor ** 2,
                            kernel_size, 1, True, generator)

    def forward(self, x: torch.Tensor, shuffle: bool = True) -> torch.Tensor:
        if not shuffle:
            # the pre-shuffle tap of the training-side fold: exact only when
            # nothing follows the conv inside this block
            if self.act == "relu":
                raise ValueError("shuffle=False needs an act-free PSBlock")
            return _apply_conv(self.Conv_0, x, self.dtype)
        # the shuffle adds the conv's bias as it loads the conv's output
        # (flax's arithmetic: the conv rounded to dtype, then + bias), unless
        # an interceptor ran the conv with its bias
        y, bias = _run_conv(self.Conv_0, x, self.dtype, add_bias=False)
        # ReLU commutes with the shuffle, so the kernel applies it
        act = "relu" if self.act == "relu" else None
        return depth_to_space(_nhwc(y), self.scale_factor, act,
                              bias).permute(0, 3, 1, 2)
