"""Pixel shuffle (depth_to_space): plain PyTorch version + CUDA kernel.

Port of ``sr/kernels/depth_to_space.py``. NHWC layout, the sub-pixel
upsampling of EDSR's ``PSBlock``s and of the fused affine tail, with the
preceding conv's bias and an optional ReLU fused in:

    out[b, h*r + i, w*r + j, c] = act(x[b, h, w, k] + bias[k]),
    k = c*r*r + i*r + j

The tensor's device picks the path: a CPU tensor goes through
:func:`depth_to_space_plain`; a CUDA tensor launches the hand-written kernel
in ``csrc/depth_to_space.cu`` (float32, bfloat16, or uint8 for the
fused-quant tail's u8 output) or raises. Nothing falls back from the kernel
to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sr_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def _check_act(act: str | None) -> None:
    if act not in (None, "relu"):
        raise ValueError(f"unsupported fused activation {act!r} (None|'relu')")


def _out_channels(x: torch.Tensor, r: int) -> int:
    if x.dim() != 4:
        raise ValueError(f"depth_to_space takes NHWC, got shape {tuple(x.shape)}")
    if r < 1 or x.shape[-1] % (r * r):
        raise ValueError(f"channels {x.shape[-1]} do not divide by r*r={r * r}")
    return x.shape[-1] // (r * r)


def _check_bias(x: torch.Tensor, bias: torch.Tensor | None) -> None:
    if bias is None:
        return
    if x.dtype == torch.uint8:
        raise ValueError("depth_to_space takes no bias for uint8")
    if (bias.shape != (x.shape[-1],) or bias.dtype != x.dtype
            or bias.device != x.device):
        raise ValueError(f"bias must be ({x.shape[-1]},) {x.dtype} on "
                         f"{x.device}, got {tuple(bias.shape)} {bias.dtype} "
                         f"on {bias.device}")


def depth_to_space_plain(x: torch.Tensor, r: int, act: str | None = None,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Reference pixel shuffle, NHWC (B,H,W,C·r²) → (B,H·r,W·r,C):
    ``act(x + bias)`` in x's dtype, then the reshape-permute."""
    _check_act(act)
    c = _out_channels(x, r)
    _check_bias(x, bias)
    if bias is not None:
        x = x + bias
    if act == "relu":
        x = torch.relu(x)
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)  # b,h,i,w,j,c
    return x.reshape(b, h * r, w * r, c)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of :func:`depth_to_space` (NHWC)."""
    b, hr_, wr_, c = x.shape
    if hr_ % r or wr_ % r:
        raise ValueError(f"spatial size {hr_}x{wr_} does not divide by {r}")
    h, w = hr_ // r, wr_ // r
    x = x.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)  # b,h,w,c,i,j
    return x.reshape(b, h, w, c * r * r)


@functools.cache
def _kernel():
    lib = _build.load("depth_to_space")
    fn = lib.sr_depth_to_space
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sr_depth_to_space_segments.argtypes = [ctypes.c_int64] * 4
    lib.sr_depth_to_space_segments.restype = ctypes.c_int64
    return lib, fn


def depth_to_space(x: torch.Tensor, r: int, act: str | None = None,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Pixel shuffle NHWC (B,H,W,C·r²) → (B,H·r,W·r,C) of ``act(x + bias)``;
    ``bias`` is (C·r²,) in x's dtype, on x's device (none for uint8).

    CPU tensors take :func:`depth_to_space_plain`; CUDA tensors launch the
    kernel, which needs a contiguous float32, bfloat16 or uint8 tensor with
    fewer than 2^31 input rows (B·H), one LR pixel of at most 64 KiB and at
    most 65535 of its staged segments in a row.
    ``depth_to_space.launches`` counts the kernel's launches.
    """
    _check_act(act)
    if x.device.type == "cpu":
        return depth_to_space_plain(x, r, act, bias)
    if x.device.type != "cuda":
        raise ValueError(f"depth_to_space runs on cpu or cuda, not {x.device}")
    c = _out_channels(x, r)
    _check_bias(x, bias)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"depth_to_space kernel takes float32/bfloat16/"
                        f"uint8, got {x.dtype}")
    if not x.is_contiguous() or not (bias is None or bias.is_contiguous()):
        raise ValueError("depth_to_space kernel needs a contiguous NHWC "
                         "tensor and a contiguous bias")
    b, h, w, cin = x.shape
    shape = (b, h * r, w * r, c)
    if x.numel() == 0:
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    lib, fn = _kernel()
    segs = lib.sr_depth_to_space_segments(w, c, r, x.element_size())
    if (b * h >= 2 ** 31 or cin * x.element_size() > 2 ** 16
            or segs > 65535):
        raise ValueError(f"depth_to_space kernel takes fewer than 2^31 input "
                         f"rows, LR pixels of at most 64 KiB and at most "
                         f"65535 segments a row, got {tuple(x.shape)} r={r} "
                         f"({segs} segments)")
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), 0 if bias is None else bias.data_ptr(),
                 out.data_ptr(), b, h, w, c, r, _DTYPE_CODES[x.dtype],
                 int(act == "relu"), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "depth_to_space")
    depth_to_space.launches += 1
    return out


depth_to_space.launches = 0
