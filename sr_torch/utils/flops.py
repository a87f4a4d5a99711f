"""Analytic conv FLOP counting for throughput reporting.

Port of ``sr/utils/flops.py``, with its convention: 1 MAC = 2 FLOPs; a
conv's forward cost is ``2 * out_pixels * kh * kw * (cin / groups) * cout``
(a transposed conv the same over its INPUT pixels: each input pixel
scatters a kh·kw·cin·cout stencil); elementwise work is ignored. A train
step costs 3× the forward (the backward computes gradients of both the
input and the weights, each a conv-sized contraction).

Counting is model-agnostic and reads shapes only: one batch-1 forward of a
CPU copy of the model, with the port's conv interceptor
(``sr_torch/nn/intercept.py``) recording each conv's geometry and letting
it run, scaled by the batch. No device work, no launch of a kernel.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from sr_torch.nn.intercept import intercept_convs


def _conv_flops(conv: nn.Module, x: torch.Tensor) -> int:
    """Forward FLOPs of ``conv`` on NCHW-logical ``x`` (batch included)."""
    b, cin, h, w = x.shape
    kh, kw = conv.kernel_size
    if isinstance(conv, nn.ConvTranspose2d):
        pixels = b * h * w
    else:
        (ph, pw), (sh, sw), (dh, dw) = conv.padding, conv.stride, conv.dilation
        pixels = (b * ((h + 2 * ph - dh * (kh - 1) - 1) // sh + 1)
                  * ((w + 2 * pw - dw * (kw - 1) - 1) // sw + 1))
    return 2 * pixels * kh * kw * (cin // conv.groups) * conv.out_channels


def conv_forward_flops(model: nn.Module, x_shape) -> int:
    """Total conv FLOPs of one forward pass of ``model`` on an NHWC
    ``x_shape`` batch: a batch-1 forward on a CPU copy, times the batch."""
    b, *rest = x_shape
    total = 0

    def record(conv, x):
        nonlocal total
        total += _conv_flops(conv, x)
        return None  # the float conv runs

    cpu_model = copy.deepcopy(model).to("cpu").eval()
    with torch.inference_mode(), intercept_convs(record):
        cpu_model(torch.zeros((1, *rest)))
    return b * total


def train_step_flops(model: nn.Module, x_shape) -> int:
    """fwd + bwd conv FLOPs of one train step (3× forward)."""
    return 3 * conv_forward_flops(model, x_shape)
