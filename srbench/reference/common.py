"""Plain float32 building blocks of the reference models.

The reference imports nothing of the program (``sr_torch``), of the JAX
package (``sr``) or of JAX: it is the published architecture written with
``torch.nn.functional`` alone. Tensors are NCHW inside a forward and NHWC at
its edges. Weights come as a dict keyed by the ``.npz`` paths of the
serving format (``head/Conv_0/kernel``), kernels HWIO, biases ``(N,)``.

* :func:`full_fp32`: TF32 off, so a float32 conv on the card is float32.
* :class:`Convs`: how a forward runs each conv, in float32 (the reference)
  or fake-quantized to ``bits`` with scales the reference calibrates
  itself (the control of the int8 cells, at 4 bits).
* :func:`collapse_affine_tail`: the one conv and shuffle that an
  activation-free upsampling tail equals, found by impulse probing in
  float64; the reference's own derivation of what the program's fused
  EDSR route serves.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_EPS = 1e-12


@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions and matmuls in full float32 (TF32 off) inside."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def conv(x: torch.Tensor, kernel: torch.Tensor,
         bias: torch.Tensor | None) -> torch.Tensor:
    """SAME, stride-1 conv of NCHW ``x`` with an HWIO ``kernel``."""
    k = kernel.shape[0]
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, padding=k // 2)


def prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """Parametric ReLU with one shared slope."""
    return torch.where(x >= 0, x, x * slope)


class Convs:
    """Runs each conv of a reference forward.

    ``bits=None``: float32. ``bits=n``: symmetric n-bit fake quantization,
    the scheme of a static int8 serving route at a coarser grid. Weights
    per output channel; activations per input channel with static scales,
    the input's channel amax over a calibration forward times
    ``headroom``, folded into the weights before they are quantized. Set
    ``calibrating`` for the calibration forward (which runs float and
    records), then clear it.
    """

    def __init__(self, bits: int | None = None, headroom: float = 1.25):
        self.bits = bits
        self.headroom = headroom
        self.calibrating = False
        self.amax: dict[str, torch.Tensor] = {}

    def __call__(self, site: str, x: torch.Tensor, kernel: torch.Tensor,
                 bias: torch.Tensor | None) -> torch.Tensor:
        if self.bits is None:
            return conv(x, kernel, bias)
        if self.calibrating:
            a = x.abs().amax(dim=(0, 2, 3))
            prev = self.amax.get(site)
            self.amax[site] = a if prev is None else torch.maximum(prev, a)
            return conv(x, kernel, bias)
        qmax = 2 ** (self.bits - 1) - 1
        s_x = torch.clamp_min(self.amax[site] * self.headroom / qmax, _EPS)
        w = kernel * s_x.view(1, 1, -1, 1)
        s_w = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)) / qmax, _EPS)
        q_w = torch.clamp(torch.round(w / s_w), -qmax, qmax)
        q_x = torch.clamp(torch.round(x / s_x.view(1, -1, 1, 1)), -qmax, qmax)
        y = conv(q_x, q_w, None) * s_w.view(1, -1, 1, 1)
        return y if bias is None else y + bias.view(1, -1, 1, 1)


FLOAT = Convs()


def collapse_affine_tail(tail, in_channels: int, r: int, support: int = 7
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(K, b)``: an HWIO ``(S, S, in_channels, C·r²)`` kernel and a
    ``(C·r²,)`` bias with ``pixel_shuffle(conv_SAME(y, K) + b, r) ==
    tail(y)`` wherever the tail's receptive field lies inside ``y``.

    ``tail``: NCHW float64 → NCHW float64 at ``r`` times the size, affine
    and translation-equivariant (no activation between its convs). The
    response to an impulse in channel c at p0, read backwards over the
    ``support`` window, is K's column c; the response to zeros is b.
    """
    s, c0 = support, support // 2
    p = 4 * s
    p0 = p // 2
    zeros = torch.zeros((1, in_channels, p, p), dtype=torch.float64)
    base = F.pixel_unshuffle(tail(zeros), r)
    b = base[0, :, p0, p0]
    y = torch.zeros((in_channels, in_channels, p, p), dtype=torch.float64)
    ch = torch.arange(in_channels)
    y[ch, ch, p0, p0] = 1.0
    resp = F.pixel_unshuffle(tail(y), r) - base
    lo = p0 + c0 - (s - 1)
    window = resp[:, :, lo:lo + s, lo:lo + s].flip(2, 3)
    return window.permute(2, 3, 0, 1).contiguous(), b
