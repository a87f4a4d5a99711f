"""Fused EDSR residual block: plain PyTorch version + CUDA kernel.

Port of ``sr/kernels/fused_resblock.py``. One call computes an
inference-mode EDSR body block on NHWC activations,

    x + res_scale * (conv2(relu(conv1(x) + b1)) + b2)

with 3×3 SAME convs, float32 accumulation, float32 biases added before the
cast, and the intermediate cast to x's dtype — the TPU kernel's arithmetic.
Weights are packed as (9·C, C) matmul operands whose row ``(a*3 + b)*C + ci``
holds tap (a, b) of input channel ci, the order of the TPU kernel's im2col.

The tensor's device picks the path: a CPU tensor goes through
:func:`fused_resblock_plain`; a CUDA tensor launches the hand-written kernel
in ``csrc/fused_resblock.cu`` or raises. Inference only: the TPU kernel has
no VJP either. The TPU kernel's ``row_tile`` was a VMEM tiling knob and is
gone; any H and W work.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from sr_torch.kernels import _build
from sr_torch.utils.precision import no_tf32

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_CHANNELS = (16, 32, 48, 64)


def pack_weights(weight1, bias1, weight2, bias2):
    """Torch OIHW (C, C, 3, 3) conv weights → ((9·C, C) operands, f32 biases).

    ``w.permute(2, 3, 1, 0)`` is the flax HWIO kernel, so the reshape gives
    the TPU kernel's ``pack_weights`` layout. The operands keep the weights'
    dtype; the caller casts them to the activation dtype.
    """
    c = weight1.shape[0]

    def pack(w):
        return w.permute(2, 3, 1, 0).reshape(9 * c, c).contiguous()

    return (pack(weight1), bias1.to(torch.float32).contiguous(),
            pack(weight2), bias2.to(torch.float32).contiguous())


def fused_resblock_plain(x, w1, b1, w2, b2, res_scale: float = 1.0):
    """Reference block: float32 convs (TF32 off on CUDA), float32 bias,
    ReLU, intermediate cast to x's dtype, residual added in x's dtype."""
    c = x.shape[-1]

    def conv(inp, w, b):
        k = w.to(torch.float32).reshape(3, 3, c, c).permute(3, 2, 0, 1)
        y = F.conv2d(inp.to(torch.float32).permute(0, 3, 1, 2), k, padding=1)
        return y.permute(0, 2, 3, 1) + b.to(torch.float32)

    with no_tf32() if x.is_cuda else contextlib.nullcontext():
        h = torch.relu(conv(x, w1, b1)).to(x.dtype)
        acc = conv(h, w2, b2) * res_scale
    return x + acc.to(x.dtype)


@functools.cache
def _kernel():
    lib = _build.load("fused_resblock")
    fn = lib.sr_fused_resblock
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_operands(x, w1, b1, w2, b2) -> None:
    if x.dim() != 4:
        raise ValueError(f"fused_resblock takes NHWC, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_resblock kernel takes float32/bfloat16, "
                        f"got {x.dtype}")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"fused_resblock kernel takes C in {KERNEL_CHANNELS}, "
                         f"got {c}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_resblock kernel needs a contiguous, 16-byte "
                         "aligned NHWC tensor")
    for name, w in (("w1", w1), ("w2", w2)):
        if (w.shape != (9 * c, c) or w.dtype != x.dtype
                or w.device != x.device or not w.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({9 * c}, {c}) "
                             f"{x.dtype} tensor on {x.device}")
    for name, b in (("b1", b1), ("b2", b2)):
        if (b.shape != (c,) or b.dtype != torch.float32
                or b.device != x.device or not b.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({c},) float32 "
                             f"tensor on {x.device}")


def fused_resblock(x, w1, b1, w2, b2, res_scale: float = 1.0):
    """x: (B, H, W, C) NHWC; w: (9·C, C) packed in x's dtype; b: f32 (C,).

    CPU tensors take :func:`fused_resblock_plain`; CUDA tensors launch the
    kernel (C in 16/32/48/64, float32 or bfloat16) as two launches with a
    scratch intermediate. ``fused_resblock.launches`` counts the calls
    that launched it.
    """
    if x.device.type == "cpu":
        return fused_resblock_plain(x, w1, b1, w2, b2, res_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock runs on cpu or cuda, not {x.device}")
    _check_operands(x, w1, b1, w2, b2)
    b, h, w, c = x.shape
    mid = torch.empty_like(x)
    out = torch.empty_like(x)
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), mid.data_ptr(), out.data_ptr(), b, h, w, c,
                 _DTYPE_CODES[x.dtype], float(res_scale),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fused_resblock")
    fused_resblock.launches += 1
    return out


fused_resblock.launches = 0
