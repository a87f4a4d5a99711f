"""k×k SAME stride-1 conv with a raw accumulator: plain version + CUDA kernel.

Port of ``sr/kernels/int8_conv.py``. NHWC activations, HWIO ``(k, k, C, N)``
weights, any odd ``k`` (the TPU kernel was the ``k=3`` case; the fused-quant
tail's composite conv is 7×7):

* :func:`conv_int8_im2col`: int8 × int8 → int32, the exact accumulator that
  ``sr/quant.py:int8_conv`` dequantizes;
* :func:`conv_bf16_im2col`: bf16 × bf16 → float32, the same kernel's bf16
  instantiation (``conv3x3_bf16_im2col``).

The tensor's device picks the path: CPU tensors go through the plain
versions; CUDA tensors launch the hand-written implicit GEMM in
``csrc/int8_conv.cu`` or raise. Nothing falls back from the kernel to the
plain version. The dequantize/bias epilogue stays with the caller, as the
TPU kernel left it to XLA.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from sr_torch.kernels import _build
from sr_torch.utils.precision import no_tf32

_DTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1}
_OUT_DTYPES = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
MAX_K = 25  # the largest odd k whose tiles fit one block's shared memory


def _check(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> int:
    """Validate NHWC ``x`` against HWIO ``w``; return ``k``."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv takes NHWC x and HWIO w, got shapes "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    k = w.shape[0]
    if w.shape[1] != k or k % 2 == 0:
        raise ValueError(f"conv takes an odd square kernel, got "
                         f"{tuple(w.shape[:2])}")
    if w.shape[2] != x.shape[-1]:
        raise ValueError(f"kernel takes C_in={w.shape[2]}, x has "
                         f"{x.shape[-1]} channels")
    if x.dtype != dtype or w.dtype != dtype:
        raise TypeError(f"conv takes {dtype} x and w, got {x.dtype} and "
                        f"{w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    return k


def conv_int8_plain(q_x: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """Reference: an exact float64 conv cast to int32 (every sum is an
    integer below 2^53; on CUDA no integer conv exists)."""
    k = _check(q_x, q_w, torch.int8)
    y = F.conv2d(q_x.permute(0, 3, 1, 2).to(torch.float64),
                 q_w.permute(3, 2, 0, 1).to(torch.float64), padding=k // 2)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def conv_bf16_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reference: a float32 conv of the bf16 values (TF32 off on CUDA)."""
    k = _check(x, w, torch.bfloat16)
    with no_tf32() if x.is_cuda else contextlib.nullcontext():
        y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float32),
                     w.permute(3, 2, 0, 1).to(torch.float32), padding=k // 2)
    return y.permute(0, 2, 3, 1).contiguous()


@functools.cache
def _kernel():
    lib = _build.load("int8_conv")
    fn = lib.sr_conv_im2col
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"conv runs on cpu or cuda, not {x.device}")
    if k > MAX_K:
        raise ValueError(f"conv kernel takes k <= {MAX_K}, got {k}")
    if not x.is_contiguous():
        raise ValueError("conv kernel needs a contiguous NHWC x")
    b, h, wd, c = x.shape
    n = w.shape[-1]
    if b > 65535 or max(h, wd, c, n) >= 2 ** 31:
        raise ValueError(f"conv kernel takes B <= 65535 and sizes below "
                         f"2^31, got {tuple(x.shape)} -> {n}")
    out = torch.empty((b, h, wd, n), dtype=_OUT_DTYPES[x.dtype],
                      device=x.device)
    # (k, k, N, C): each output channel's K run contiguous, as the MMA's
    # B operand is staged (37 KB for a 64->64 3x3 conv)
    w_nc = w.permute(0, 1, 3, 2).contiguous()
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_nc.data_ptr(), out.data_ptr(), b, h, wd, c,
                 n, k, _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "int8_conv")
    return out


def conv_int8_im2col(q_x: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """int8 (B,H,W,C) × int8 (k,k,C,N) → int32 (B,H,W,N), SAME, stride 1.

    CPU tensors take :func:`conv_int8_plain`; CUDA tensors launch the
    kernel. ``conv_int8_im2col.launches`` counts its launches.
    """
    k = _check(q_x, q_w, torch.int8)
    if q_x.device.type == "cpu":
        return conv_int8_plain(q_x, q_w)
    out = _launch(q_x, q_w, k)
    conv_int8_im2col.launches += 1
    return out


def conv_bf16_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 (B,H,W,C) × bf16 (k,k,C,N) → float32 (B,H,W,N), SAME, stride 1.

    CPU tensors take :func:`conv_bf16_plain`; CUDA tensors launch the
    kernel's bf16 instantiation. ``conv_bf16_im2col.launches`` counts its
    launches.
    """
    k = _check(x, w, torch.bfloat16)
    if x.device.type == "cpu":
        return conv_bf16_plain(x, w)
    out = _launch(x, w, k)
    conv_bf16_im2col.launches += 1
    return out


conv_int8_im2col.launches = 0
conv_bf16_im2col.launches = 0
