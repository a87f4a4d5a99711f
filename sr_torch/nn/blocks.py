"""NN building blocks: ConvBlock, DeconvBlock, ResnetBlock, PSBlock,
Upsample2xBlock, PReLU, BatchNorm, InstanceNorm.

Port of ``sr/nn/blocks.py``: the activation menu (``relu``, ``prelu``,
``lrelu`` with slope 0.2, ``tanh``, ``sigmoid``, ``None``), the norm menu
(``"batch"`` with flax's BatchNorm semantics, ``"instance"`` as flax's
``GroupNorm`` with one channel a group, ``None``), the kernel initializers
of ``sr_torch/nn/init.py`` (``kernel_init``) and convs without bias
(``use_bias=False``). No zoo model uses instance norm or
``Upsample2xBlock``; they complete the JAX package's block menu.

Blocks take and return NCHW-logical tensors in ``torch.channels_last``
memory, which lays them out as NHWC, so ``x.permute(0, 2, 3, 1)`` hands the
kernels an NHWC tensor without a copy. Parameters are float32; ``dtype`` is
the compute dtype, as in the flax blocks. Each block names its submodules
like flax does (``Conv_0``/``Conv_1``, ``_NormAct_0/BatchNorm_0``,
``_NormAct_0/PReLU_0``, ``BatchNorm_0``, ``GroupNorm_0``), so a
parameter's path reads the same in both packages.

* :class:`BatchNorm` is ``flax.linen.BatchNorm(momentum=0.9)``, which
  ``torch.nn.BatchNorm2d`` is not: statistics in float32 whatever the
  input's dtype, the variance as E[x²] − E[x]² clipped at 0, the running
  variance updated with that (biased) batch variance, ``ra = 0.9·ra +
  0.1·batch``, eps 1e-5, and the output cast to the block's dtype. Train
  mode (``module.train()``) normalizes with the batch's statistics and
  updates the running ones, unless :func:`frozen_batch_stats` is active;
  eval mode uses the running ones. Parameters ``scale``/``bias`` and
  buffers ``mean``/``var`` carry flax's names. Under data parallelism
  (``sr_torch.parallel.replicate`` sets ``sync``) a train-mode forward
  takes E[x] and E[x²] over the whole group's batch, as flax's statistics
  are over the global batch under GSPMD: the per-process means are
  averaged with their gradient (one ``all_reduce`` forward, one
  backward), so the running statistics agree on every process.
* :class:`InstanceNorm` is ``flax.linen.GroupNorm(num_groups=None,
  group_size=1)``: per sample and channel, the mean and E[x²] − E[x]²
  (clipped at 0) over H and W in float32, eps 1e-6 (flax's default), the
  same normalize as :class:`BatchNorm`, the output in the block's dtype;
  parameters ``scale``/``bias``, no running statistics.
* :class:`PReLU` has one shared slope (flax param ``slope``, 0.25 at
  init), applied as ``where(x >= 0, x, x·a)`` in x's dtype.
* ``ResnetBlock`` with ``act='relu'`` and no norm (EDSR's) calls
  :func:`fused_resblock` without grad (the CUDA kernel on the card, its
  plain version on the CPU); with grad on, or any other activation or a
  norm (SRResNet's conv-BN-PReLU-conv-BN), it runs its convs and the norm
  as separate differentiable ops, as the JAX block does: the fused kernel
  computes conv → ReLU → conv only.
* ``PSBlock`` runs its conv without the bias and hands the bias to
  :func:`depth_to_space`, which adds it as it shuffles (and differentiates
  through it under grad); a ReLU without norm runs in the kernel too,
  anything else (SRResNet's PReLU) after the shuffle, in flax's order.
  Under an interceptor the intercepted conv keeps its bias and the shuffle
  gets none. :meth:`PSBlock.preshuffle` returns the output before the
  shuffle (the conv, then the activation where it commutes with the
  shuffle), for the pre-shuffle training forwards and the folded serving
  tails.
* :class:`Upsample2xBlock` is ×2 by ``'deconv'`` (a 4×4 stride-2
  ``DeconvBlock``), ``'ps'`` (a ``PSBlock``: the shuffle kernel) or
  ``'rnc'`` (nearest ×2, ``jax.image.resize``'s pixel repeat, then a 3×3
  ``ConvBlock``).
* ``DeconvBlock`` is a transposed conv with exact ×stride output (FSRCNN's
  9×9 stride 4, LapSRN's 4×4 stride 2): torch's ``ConvTranspose2d`` with
  ``p = ceil((k-s)/2)`` and ``output_padding = 2p-(k-s)``, the geometry
  that ``sr/nn/blocks.py:DeconvBlock`` pads for explicitly. Its weight
  ``(in, out, kh, kw)`` is flax's unflipped HWIO kernel flipped in space
  (``sr_torch/utils/interop.py``).
* Other convs and every deconv are ``F.conv2d`` / ``F.conv_transpose2d``:
  the JAX package left them to XLA, outside any Pallas kernel.
* Every conv and deconv goes through :func:`_apply_conv`, which first
  offers it to the active interceptor (``sr_torch/nn/intercept.py``), as
  flax's ``intercept_methods`` sees each ``nn.Conv`` and
  ``nn.ConvTranspose`` call of the JAX blocks. While
  one is active, ``ResnetBlock`` runs its two convs one by one, so int8
  serving and calibration see every conv. Norms and activations stay float
  between the int8 sites, as in ``sr.quant``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from sr_torch.kernels.depth_to_space import depth_to_space
from sr_torch.kernels.fused_resblock import (
    fused_resblock, pack_wgmma_weights, pack_weights)
from sr_torch.nn import intercept
from sr_torch.nn.init import get_kernel_init
from sr_torch.parallel.multihost import mean_over_replicas

_ACTS = (None, "none", "relu", "prelu", "lrelu", "tanh", "sigmoid")

_STATS_FROZEN: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "sr_torch_batch_stats_frozen", default=False)


def _check_menu(act, norm) -> None:
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}; the menu is {_ACTS}")
    if norm not in (None, "batch", "instance"):
        raise ValueError(f"unknown norm {norm!r} (None | 'batch' | "
                         "'instance')")


@contextlib.contextmanager
def frozen_batch_stats():
    """Train-mode batch norms inside normalize with the batch's statistics
    but leave their running statistics as they were: flax's train-mode
    ``apply`` whose mutated ``batch_stats`` the caller discards (the GAN
    step's detached fake and its adversarial D pass)."""
    token = _STATS_FROZEN.set(True)
    try:
        yield
    finally:
        _STATS_FROZEN.reset(token)


class PReLU(nn.Module):
    """Parametric ReLU with one shared slope (sr/nn/blocks.py:PReLU)."""

    def __init__(self, init_slope: float = 0.25):
        super().__init__()
        self.slope = nn.Parameter(torch.tensor(init_slope,
                                               dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * self.slope.to(x.dtype))


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of an NCHW-logical tensor; see the module docstring."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.sync = False  # statistics over the process group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            # flax's _compute_stats: float32, E[x²] − E[x]², clipped at 0
            x32 = x.to(torch.float32)
            mean, mean_sq = x32.mean((0, 2, 3)), x32.square().mean((0, 2, 3))
            if self.sync:  # the global batch's: the shards are equal
                mean, mean_sq = mean_over_replicas(
                    torch.stack([mean, mean_sq]))
            var = torch.clamp_min(mean_sq - mean.square(), 0.0)
            if not _STATS_FROZEN.get():
                m = self.momentum
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        # flax's _normalize: (x − mean) · (rsqrt(var + eps) · scale) + bias
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
        return (y + self.bias.view(1, -1, 1, 1)).to(self.dtype)


class InstanceNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups=None, group_size=1)`` over an
    NCHW-logical tensor; see the module docstring."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's _compute_stats over the spatial axes, float32
        x32 = x.to(torch.float32)
        mean = x32.mean((2, 3), keepdim=True)
        var = torch.clamp_min(x32.square().mean((2, 3), keepdim=True)
                              - mean.square(), 0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.view(1, -1, 1, 1)
        y = (x - mean) * mul
        return (y + self.bias.view(1, -1, 1, 1)).to(self.dtype)


#: a norm's module name, flax's
_NORM_NAMES = {"batch": "BatchNorm_0", "instance": "GroupNorm_0"}


def _add_norm(block: nn.Module, norm: str | None, features: int,
              dtype: torch.dtype) -> None:
    """Register ``norm``'s module on ``block`` under flax's name."""
    block.norm = norm
    if norm is not None:
        cls = BatchNorm if norm == "batch" else InstanceNorm
        block.add_module(_NORM_NAMES[norm], cls(features, dtype=dtype))


def _apply_norm(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if block.norm is None:
        return x
    return getattr(block, _NORM_NAMES[block.norm])(x)


def _activate(act: str | None, x: torch.Tensor) -> torch.Tensor:
    if act == "relu":
        return torch.relu(x)
    if act == "lrelu":
        return F.leaky_relu(x, 0.2)
    if act == "tanh":
        return torch.tanh(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    return x


class _NormAct(nn.Module):
    """[norm] → [act], the tail every flax block shares
    (sr/nn/blocks.py:_NormAct); PReLU is a module with its slope."""

    def __init__(self, features: int, norm: str | None, act: str | None,
                 dtype: torch.dtype):
        super().__init__()
        _check_menu(act, norm)
        self.act, self.dtype = act, dtype
        _add_norm(self, norm, features, dtype)
        if act == "prelu":
            self.PReLU_0 = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _apply_norm(self, x)
        if self.act == "prelu":
            return self.PReLU_0(x)
        return _activate(self.act, x)


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


def deconv_padding(kernel_size: int, stride: int) -> tuple[int, int]:
    """``(padding, output_padding)`` of a transposed conv whose output is
    exactly ``stride`` × its input: ``p = ceil((k-s)/2)``, ``op =
    2p-(k-s)`` (k4 s2 → (1, 0); k9 s4 → (3, 1))."""
    p = -(-(kernel_size - stride) // 2)
    return p, 2 * p - (kernel_size - stride)


def _deconv(in_features: int, features: int, kernel_size: int, stride: int,
            use_bias: bool, generator: torch.Generator | None,
            kernel_init: str | None = None) -> nn.ConvTranspose2d:
    """A transposed conv of exact ×``stride`` output with the kernel init
    called ``kernel_init`` (fan-in from flax's HWIO kernel) and a zero
    bias."""
    if kernel_size < stride:
        raise ValueError(f"a deconv of kernel {kernel_size} < stride "
                         f"{stride} has no exact ×stride geometry")
    p, op = deconv_padding(kernel_size, stride)
    deconv = nn.utils.skip_init(nn.ConvTranspose2d, in_features, features,
                                kernel_size, stride=stride, padding=p,
                                output_padding=op, bias=use_bias)
    get_kernel_init(kernel_init)(deconv.weight, generator, transposed=True)
    if use_bias:
        with torch.no_grad():
            deconv.bias.zero_()
    return deconv


def _run_conv(conv: nn.Conv2d | nn.ConvTranspose2d, x: torch.Tensor, dtype,
              add_bias: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
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
    if isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x.to(dtype), conv.weight.to(dtype),
                               bias if add_bias else None, conv.stride,
                               conv.padding, conv.output_padding)
    else:
        y = F.conv2d(x.to(dtype), conv.weight.to(dtype),
                     bias if add_bias else None, conv.stride, conv.padding)
    return y, None if add_bias else bias


def _apply_conv(conv: nn.Conv2d | nn.ConvTranspose2d, x: torch.Tensor,
                dtype) -> torch.Tensor:
    return _run_conv(conv, x, dtype, add_bias=True)[0]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class ConvBlock(nn.Module):
    """Conv → [norm] → [act]. (sr/nn/blocks.py:ConvBlock; a stride-s conv
    pads k//2 on both sides, flax's explicit pair)"""

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
        self._NormAct_0 = _NormAct(features, norm, act, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._NormAct_0(_apply_conv(self.Conv_0, x, self.dtype))


class DeconvBlock(nn.Module):
    """Transposed conv (exact ×stride upsampling) → [norm] → [act].
    (sr/nn/blocks.py:DeconvBlock; see :func:`deconv_padding`)"""

    def __init__(self, in_features: int, features: int, kernel_size: int = 4,
                 stride: int = 2, act: str | None = "relu",
                 norm: str | None = None, use_bias: bool = True,
                 kernel_init: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_menu(act, norm)
        self.dtype = dtype
        self.ConvTranspose_0 = _deconv(in_features, features, kernel_size,
                                       stride, use_bias, generator,
                                       kernel_init)
        self._NormAct_0 = _NormAct(features, norm, act, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._NormAct_0(_apply_conv(self.ConvTranspose_0, x,
                                           self.dtype))


class ResnetBlock(nn.Module):
    """conv → [norm] → act → conv → [norm], + residual·res_scale.
    (sr/nn/blocks.py:ResnetBlock: EDSR's conv-ReLU-conv, SRResNet's
    conv-BN-PReLU-conv-BN)"""

    def __init__(self, features: int, kernel_size: int = 3,
                 act: str | None = "relu", norm: str | None = None,
                 res_scale: float = 1.0, kernel_init: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_menu(act, norm)
        self.res_scale = res_scale
        self.dtype = dtype
        # the fused kernel's function: 3×3 conv → ReLU → conv, no norm
        self.fused = act == "relu" and norm is None and kernel_size == 3
        self.Conv_0 = _conv(features, features, kernel_size, 1, True,
                            generator, kernel_init)
        self._NormAct_0 = _NormAct(features, norm, act, dtype)
        self.Conv_1 = _conv(features, features, kernel_size, 1, True,
                            generator, kernel_init)
        _add_norm(self, norm, features, dtype)
        self._packed = None
        self._packed_key = None

    def packed(self):
        """The operands and f32 biases for :func:`fused_resblock`, in the
        block's dtype on the weights' device: (9·C, C) operands, or for a
        bf16 block the kernel's ``wgmma`` layout, on either device (the
        CPU's plain version unpacks it), so a program exported on one
        device runs on the other. Packed on first use and cached; packed
        again when a weight changes, moves or the dtype changes. None for a
        block the kernel does not compute."""
        if not self.fused:
            return None
        weights = (self.Conv_0.weight, self.Conv_0.bias,
                   self.Conv_1.weight, self.Conv_1.bias)
        key = (self.dtype, weights[0].device, *(p._version for p in weights))
        if self._packed_key != key:
            with torch.no_grad():
                w1, b1, w2, b2 = pack_weights(*weights)
                w1, w2 = w1.to(self.dtype), w2.to(self.dtype)
                if self.dtype == torch.bfloat16:
                    w1, w2 = pack_wgmma_weights(w1), pack_wgmma_weights(w2)
                self._packed = (w1, b1, w2, b2)
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.fused and not torch.is_grad_enabled()
                and intercept.active() is None):
            y = fused_resblock(_nhwc(x.to(self.dtype)), *self.packed(),
                               res_scale=self.res_scale)
            return y.permute(0, 3, 1, 2)
        # conv → [norm] → act → conv → [norm], + residual
        # (sr/nn/blocks.py:ResnetBlock): differentiable, and each conv a
        # site for an interceptor
        h = self._NormAct_0(_apply_conv(self.Conv_0, x, self.dtype))
        h = _apply_norm(self, _apply_conv(self.Conv_1, h, self.dtype))
        if self.res_scale != 1.0:
            h = h * torch.tensor(self.res_scale, dtype=h.dtype)
        return x + h


class PSBlock(nn.Module):
    """Conv to C·r² then pixel shuffle → [norm] → [act].
    (sr/nn/blocks.py:PSBlock)"""

    def __init__(self, in_features: int, features: int, scale_factor: int = 2,
                 kernel_size: int = 3, act: str | None = "relu",
                 norm: str | None = None, kernel_init: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_menu(act, norm)
        self.scale_factor = scale_factor
        self.act = act
        self.norm = norm
        self.dtype = dtype
        self.Conv_0 = _conv(in_features, features * scale_factor ** 2,
                            kernel_size, 1, True, generator, kernel_init)
        self._NormAct_0 = _NormAct(features, norm, act, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the shuffle adds the conv's bias as it loads the conv's output
        # (flax's arithmetic: the conv rounded to dtype, then + bias), unless
        # an interceptor ran the conv with its bias
        y, bias = _run_conv(self.Conv_0, x, self.dtype, add_bias=False)
        # ReLU commutes with the shuffle, so the kernel applies it; a norm
        # or another activation follows the shuffle
        in_kernel = self.act == "relu" and self.norm is None
        out = depth_to_space(_nhwc(y), self.scale_factor,
                             "relu" if in_kernel else None,
                             bias).permute(0, 3, 1, 2)
        return out if in_kernel else self._NormAct_0(out)

    def preshuffle(self, x: torch.Tensor) -> torch.Tensor:
        """The block's output before its shuffle, NCHW-logical: the conv
        with its bias, then the activation, which commutes with the shuffle
        (one shared PReLU slope, or ReLU); ``depth_to_space`` of this is
        ``forward(x)``. A norm does not commute and raises."""
        if self.norm is not None:
            raise ValueError("a PSBlock with a norm has no pre-shuffle form")
        return self._NormAct_0(_apply_conv(self.Conv_0, x, self.dtype))


class Upsample2xBlock(nn.Module):
    """×2 upsampling by ``'deconv'``, ``'ps'`` (sub-pixel) or ``'rnc'``
    (resize, then conv). (sr/nn/blocks.py:Upsample2xBlock; children named
    as flax's: ``DeconvBlock_0``, ``PSBlock_0``, ``ConvBlock_0``)"""

    def __init__(self, in_features: int, features: int,
                 upsample: str = "deconv", act: str | None = "relu",
                 norm: str | None = None, kernel_init: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(act=act, norm=norm, kernel_init=kernel_init, dtype=dtype,
                  generator=generator)
        self.upsample = upsample
        if upsample == "deconv":
            self.DeconvBlock_0 = DeconvBlock(in_features, features, 4, 2,
                                             **kw)
        elif upsample == "ps":
            self.PSBlock_0 = PSBlock(in_features, features, 2, 3, **kw)
        elif upsample == "rnc":
            self.ConvBlock_0 = ConvBlock(in_features, features, 3, 1, **kw)
        else:
            raise ValueError(f"unknown upsample mode {upsample!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.upsample == "deconv":
            return self.DeconvBlock_0(x)
        if self.upsample == "ps":
            return self.PSBlock_0(x)
        # jax.image.resize(..., "nearest") at exactly ×2 repeats each pixel
        return self.ConvBlock_0(F.interpolate(x, scale_factor=2,
                                              mode="nearest"))
