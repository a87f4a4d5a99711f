"""k×k SAME stride-1 int8 conv: plain versions + CUDA kernel.

Port of ``sr/kernels/int8_conv.py``. NHWC activations, HWIO ``(k, k, C, N)``
weights, any odd ``k`` (the TPU kernel was the ``k=3`` case; the fused-quant
tail's composite conv is 7×7):

* :func:`conv_int8_im2col`: int8 × int8 → int32, the exact accumulator that
  ``sr/quant.py:int8_conv`` dequantizes — the TPU kernel's function;
* :func:`conv_bf16_im2col`: bf16 × bf16 → float32, the same kernel's bf16
  instantiation (``conv3x3_bf16_im2col``);
* :func:`conv_int8_fused`: float32 in, float32 out — the quantize before
  the conv and the dequantize and bias after it (``sr/quant.py:int8_conv``)
  run inside the kernel, with the same roundings in the same order. The int8
  serving path calls this entry.

The tensor's device picks the path: CPU tensors go through the plain
versions; CUDA tensors launch the hand-written implicit GEMM in
``csrc/int8_conv.cu`` or raise. Nothing falls back from the kernel to the
plain version. The kernel takes its weights packed by :func:`pack_weights`:
the raw entries pack them per call, and the fused entry takes the packing
from its caller, who packs once (``packed=``).
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
MAX_K = 17  # the largest odd k whose tiles fit one block's shared memory
_CHUNK_BYTES = 64  # the kernel's K chunk: Cp is a multiple of it


def _check(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
           x_dtype: torch.dtype | None = None) -> int:
    """Validate NHWC ``x`` against HWIO ``w`` (``x`` in ``x_dtype`` when
    given, else in ``dtype``, like ``w``); return ``k``."""
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
    x_dtype = x_dtype or dtype
    if x.dtype != x_dtype or w.dtype != dtype:
        raise TypeError(f"conv takes {x_dtype} x and {dtype} w, got "
                        f"{x.dtype} and {w.dtype}")
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


def conv_int8_fused_plain(x: torch.Tensor, q_w: torch.Tensor,
                          scale: torch.Tensor, dequant: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          reciprocal: bool = False) -> torch.Tensor:
    """Reference of the fused entry: ``sr/quant.py:int8_conv``'s sequence,
    pass by pass. ``q = clamp(round(x / scale), ±127)`` (``x * scale``
    with ``reciprocal``), the exact int32 conv, then ``f32(acc) * dequant``
    and ``+ bias``, each rounded once."""
    x32 = x.to(torch.float32)
    y = x32 * scale if reciprocal else x32 / scale
    q_x = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    y = conv_int8_plain(q_x.contiguous(), q_w).to(torch.float32) * dequant
    if bias is not None:
        y = y + bias
    return y


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``(k, k, C, N)`` → the kernel's ``(k, k, N, Cp)``: each output
    channel's K run contiguous, as the MMA's B operand is staged, and
    zero-padded to ``Cp``, a multiple of the kernel's 64-byte K chunk."""
    k, _, c, n = w.shape
    per_chunk = _CHUNK_BYTES // w.element_size()
    cp = -(-c // per_chunk) * per_chunk
    packed = w.new_zeros((k, k, n, cp))
    packed[..., :c] = w.permute(0, 1, 3, 2)
    return packed


@functools.cache
def _kernel():
    lib = _build.load("int8_conv")
    raw = lib.sr_conv_im2col
    raw.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    raw.restype = ctypes.c_int
    fused = lib.sr_conv_int8_fused
    fused.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fused.restype = ctypes.c_int
    return lib, raw, fused


def _check_launch(x: torch.Tensor, w: torch.Tensor,
                  packed: torch.Tensor | None) -> None:
    """Validate a CUDA launch of ``x`` against HWIO ``w`` and its
    :func:`pack_weights` layout ``packed``."""
    if x.device.type != "cuda":
        raise ValueError(f"conv runs on cpu or cuda, not {x.device}")
    k = w.shape[0]
    if k > MAX_K:
        raise ValueError(f"conv kernel takes k <= {MAX_K}, got {k}")
    if not x.is_contiguous():
        raise ValueError("conv kernel needs a contiguous NHWC x")
    b, h, wd, c = x.shape
    n = w.shape[-1]
    if b > 65535 or max(h, wd, c, n) >= 2 ** 31:
        raise ValueError(f"conv kernel takes B <= 65535 and sizes below "
                         f"2^31, got {tuple(x.shape)} -> {n}")
    if packed is None:
        raise ValueError("the conv kernel takes its weights packed once by "
                         "the caller: pass packed=pack_weights(q_w)")
    per_chunk = _CHUNK_BYTES // w.element_size()
    if (packed.shape[:3] != (k, k, n) or packed.shape[3] < c
            or packed.shape[3] % per_chunk or packed.dtype != w.dtype
            or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError(f"packed weights {tuple(packed.shape)} "
                         f"{packed.dtype} do not fit HWIO "
                         f"{tuple(w.shape)}; use pack_weights")


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    packed = pack_weights(w)
    _check_launch(x, w, packed)
    b, h, wd, c = x.shape
    k, n = w.shape[0], w.shape[-1]
    out = torch.empty((b, h, wd, n), dtype=_OUT_DTYPES[x.dtype],
                      device=x.device)
    lib, raw, _ = _kernel()
    with torch.cuda.device(x.device):
        err = raw(x.data_ptr(), packed.data_ptr(), out.data_ptr(), b, h, wd,
                  c, packed.shape[3], n, k, _DTYPE_CODES[x.dtype],
                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "int8_conv")
    return out


def conv_int8_im2col(q_x: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """int8 (B,H,W,C) × int8 (k,k,C,N) → int32 (B,H,W,N), SAME, stride 1.

    CPU tensors take :func:`conv_int8_plain`; CUDA tensors launch the
    kernel. ``conv_int8_im2col.launches`` counts its launches.
    """
    _check(q_x, q_w, torch.int8)
    if q_x.device.type == "cpu":
        return conv_int8_plain(q_x, q_w)
    out = _launch(q_x, q_w)
    conv_int8_im2col.launches += 1
    return out


def conv_bf16_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 (B,H,W,C) × bf16 (k,k,C,N) → float32 (B,H,W,N), SAME, stride 1.

    CPU tensors take :func:`conv_bf16_plain`; CUDA tensors launch the
    kernel's bf16 instantiation. ``conv_bf16_im2col.launches`` counts its
    launches.
    """
    _check(x, w, torch.bfloat16)
    if x.device.type == "cpu":
        return conv_bf16_plain(x, w)
    out = _launch(x, w)
    conv_bf16_im2col.launches += 1
    return out


def _scale_strides(scale: torch.Tensor, b: int, c: int) -> tuple[int, int]:
    """(per-sample, per-channel) strides of a quantize scale."""
    if scale.numel() == 1:
        return 0, 0
    if scale.dim() == 1 and scale.shape[0] == c:
        return 0, 1
    if scale.dim() == 4 and scale.shape == (b, 1, 1, 1):
        return 1, 0
    raise ValueError(f"quantize scale of shape {tuple(scale.shape)}: want "
                     f"(), ({c},) or ({b}, 1, 1, 1)")


def conv_int8_fused(x: torch.Tensor, q_w: torch.Tensor, scale: torch.Tensor,
                    dequant: torch.Tensor, bias: torch.Tensor | None = None,
                    *, reciprocal: bool = False,
                    packed: torch.Tensor | None = None) -> torch.Tensor:
    """float32 (B,H,W,C) → float32 (B,H,W,N): quantize, int8 conv, dequantize
    and bias in one launch.

    ``scale``: the quantize scale, per tensor ``()``, per input channel
    ``(C,)`` or per sample ``(B, 1, 1, 1)``; ``x`` is divided by it, or
    multiplied with ``reciprocal``. ``dequant``: ``(N,)`` or ``(B, 1, 1,
    N)``. ``bias``: ``(N,)`` or ``None``. ``q_w``: int8 HWIO; ``packed``:
    its :func:`pack_weights` layout, packed once by the caller, which a CUDA
    launch requires. To divide, the kernel multiplies by
    ``torch.reciprocal(scale)`` (one small op per call) and divides only
    near a rounding tie. CPU tensors take :func:`conv_int8_fused_plain`;
    CUDA tensors launch the kernel, which equals it bit for bit.
    ``conv_int8_fused.launches`` counts its launches.
    """
    k = _check(x, q_w, torch.int8, x_dtype=torch.float32)
    if x.device.type == "cpu":
        return conv_int8_fused_plain(x, q_w, scale, dequant, bias,
                                     reciprocal)
    b, h, wd, c = x.shape
    n = q_w.shape[-1]
    _check_launch(x, q_w, packed)
    sb, sc = _scale_strides(scale, b, c)
    if dequant.numel() not in (n, b * n) or dequant.shape[-1] != n:
        raise ValueError(f"dequant of shape {tuple(dequant.shape)}: want "
                         f"({n},) or ({b}, 1, 1, {n})")
    dq_sb = 0 if dequant.numel() == n else n
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias of shape {tuple(bias.shape)}: want ({n},)")
    for name, t in (("scale", scale), ("dequant", dequant), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32
                              or t.device != x.device):
            raise ValueError(f"{name} must be float32 on {x.device}")
    scale, dequant = scale.contiguous(), dequant.contiguous()
    bias = None if bias is None else bias.contiguous()
    mul, divisor = ((scale, None) if reciprocal
                    else (torch.reciprocal(scale), scale))
    out = torch.empty((b, h, wd, n), dtype=torch.float32, device=x.device)
    lib, _, fused = _kernel()
    with torch.cuda.device(x.device):
        err = fused(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                    mul.data_ptr(),
                    None if divisor is None else divisor.data_ptr(), sb, sc,
                    dequant.data_ptr(), dq_sb,
                    None if bias is None else bias.data_ptr(),
                    b, h, wd, c, packed.shape[3], n, k,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "int8_conv")
    conv_int8_fused.launches += 1
    return out


conv_int8_im2col.launches = 0
conv_bf16_im2col.launches = 0
conv_int8_fused.launches = 0
