"""The port's three CUDA kernels as PyTorch operators (``torch.ops.sr_torch``).

Each kernel entry is one ``torch.library.custom_op`` with three
implementations, so the tensor's device picks the path inside the
dispatcher and ``torch.export`` can trace through it:

* ``cpu``: the kernel's plain PyTorch version;
* ``cuda``: the launch of the hand-written kernel (``csrc/*.cu``, built by
  ``_build`` and called through ``ctypes``), with its shape and contiguity
  checks; it raises on what the kernel does not take and never falls back
  to the plain version;
* fake: the output's shape and dtype from the (possibly symbolic) input
  sizes, which is all an exported program's trace needs.

The operators:

* ``sr_torch::depth_to_space(x, r, act, bias)``: the pixel shuffle NHWC
  (B,H,W,C·r²) → (B,rH,rW,C) of ``act(x + bias)``, float32, bfloat16 or
  uint8 (``sr/kernels/depth_to_space.py``). Differentiable: its backward
  (``register_autograd``) is the ReLU mask, then :func:`space_to_depth` of
  the gradient for x and its sum over B·H·W for the bias, how XLA
  transposes the JAX shuffle, which has no backward kernel. So the backward
  is the plain reshape-permute on either device.
* ``sr_torch::fused_resblock(x, w1, b1, w2, b2, res_scale)``: EDSR's
  inference body block ``x + s·(conv(relu(conv(x) + b1)) + b2)``
  (``sr/kernels/fused_resblock.py``). A bf16 block takes its weights in the
  ``wgmma`` layout of ``pack_wgmma_weights`` on either device (the CPU
  unpacks them), so a program traced on one device runs on the other;
  the CPU also takes the (9·C, C) operands, and float32 only those.
* ``sr_torch::conv_int8_im2col`` / ``conv_bf16_im2col`` (the raw k×k SAME
  conv entries, int8 → int32 and bf16 → float32, which pack the weights per
  call) and ``sr_torch::conv_int8_fused`` (float32 in and out: the quantize,
  the exact int8 conv, the dequantize and the bias in one launch; the
  weights packed once by the caller, ``packed=``, which the CPU ignores)
  (``sr/kernels/int8_conv.py``).

The Python wrappers below validate what is device-independent, call the
operator, and carry the launch counts (``depth_to_space.launches``, ...),
which only the ``cuda`` implementations raise. ``sr_torch.kernels.
{depth_to_space,fused_resblock,int8_conv}`` document and re-export them.
This module imports nothing of the port but ``_build``, so loading an
exported program needs no model code.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from sr_torch.kernels import _build

_NS = "sr_torch"


@contextlib.contextmanager
def no_tf32():
    """Turn TF32 off for cuDNN and matmul; restore the old values on exit
    (``sr_torch.utils.precision``): the plain versions' float32 convs on
    the card keep full precision.

    The switches are process-wide, so a caller that serves other threads
    at the same time holds them off for those threads too.
    """
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# pixel shuffle
# ---------------------------------------------------------------------------

_D2S_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


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


def _shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    b, h, w, cin = x.shape
    c = cin // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)  # b,h,i,w,j,c
    return x.reshape(b, h * r, w * r, c)


def depth_to_space_plain(x: torch.Tensor, r: int, act: str | None = None,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Reference pixel shuffle, NHWC (B,H,W,C·r²) → (B,H·r,W·r,C):
    ``act(x + bias)`` in x's dtype, then the reshape-permute."""
    _check_act(act)
    _out_channels(x, r)
    _check_bias(x, bias)
    if bias is not None:
        x = x + bias
    if act == "relu":
        x = torch.relu(x)
    return _shuffle(x, r)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of :func:`depth_to_space` (NHWC)."""
    b, hr_, wr_, c = x.shape
    if hr_ % r or wr_ % r:
        raise ValueError(f"spatial size {hr_}x{wr_} does not divide by {r}")
    h, w = hr_ // r, wr_ // r
    x = x.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)  # b,h,w,c,i,j
    return x.reshape(b, h, w, c * r * r)


@functools.cache
def _d2s_lib():
    lib = _build.load("depth_to_space")
    fn = lib.sr_depth_to_space
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sr_depth_to_space_segments.argtypes = [ctypes.c_int64] * 4
    lib.sr_depth_to_space_segments.restype = ctypes.c_int64
    return lib, fn


@torch.library.custom_op(f"{_NS}::depth_to_space", mutates_args=(),
                         device_types="cpu")
def _d2s_op(x: torch.Tensor, r: int, act: str | None,
            bias: torch.Tensor | None) -> torch.Tensor:
    out = depth_to_space_plain(x, r, act, bias)
    # an operator's output may not alias its input (r=1 without bias)
    return out.clone() if out.data_ptr() == x.data_ptr() else out


@_d2s_op.register_kernel("cuda")
def _d2s_cuda(x, r, act, bias):
    c = _out_channels(x, r)
    _check_bias(x, bias)
    if x.dtype not in _D2S_CODES:
        raise TypeError(f"depth_to_space kernel takes float32/bfloat16/"
                        f"uint8, got {x.dtype}")
    if not x.is_contiguous() or not (bias is None or bias.is_contiguous()):
        raise ValueError("depth_to_space kernel needs a contiguous NHWC "
                         "tensor and a contiguous bias")
    b, h, w, cin = x.shape
    shape = (b, h * r, w * r, c)
    if x.numel() == 0:
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    lib, fn = _d2s_lib()
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
                 out.data_ptr(), b, h, w, c, r, _D2S_CODES[x.dtype],
                 int(act == "relu"), _stream())
    _build.check(lib, err, "depth_to_space")
    depth_to_space.launches += 1
    return out


@_d2s_op.register_fake
def _d2s_fake(x, r, act, bias):
    b, h, w, cin = x.shape
    return x.new_empty((b, h * r, w * r, cin // (r * r)))


def _d2s_setup(ctx, inputs, output):
    _, r, act, _ = inputs
    ctx.r = r
    ctx.save_for_backward(output if act == "relu" else None)


def _d2s_backward(ctx, grad):
    (out,) = ctx.saved_tensors
    if out is not None:  # relu: pass the gradient where out > 0
        grad = grad.masked_fill(out <= 0, 0)
    grad_x = space_to_depth(grad, ctx.r)
    grad_bias = grad_x.sum((0, 1, 2)) if ctx.needs_input_grad[3] else None
    return grad_x, None, None, grad_bias


_d2s_op.register_autograd(_d2s_backward, setup_context=_d2s_setup)


def depth_to_space(x: torch.Tensor, r: int, act: str | None = None,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Pixel shuffle NHWC (B,H,W,C·r²) → (B,H·r,W·r,C) of ``act(x + bias)``;
    ``bias`` is (C·r²,) in x's dtype, on x's device (none for uint8).

    ``sr_torch::depth_to_space``: CPU tensors take
    :func:`depth_to_space_plain`; CUDA tensors launch the kernel, which
    needs a contiguous float32, bfloat16 or uint8 tensor with fewer than
    2^31 input rows (B·H), one LR pixel of at most 64 KiB and at most 65535
    of its staged segments in a row. Differentiable in x and the bias.
    ``depth_to_space.launches`` counts the kernel's launches.
    """
    _check_act(act)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"depth_to_space runs on cpu or cuda, not {x.device}")
    _out_channels(x, r)
    _check_bias(x, bias)
    return _d2s_op(x, r, act, bias)


depth_to_space.launches = 0


# ---------------------------------------------------------------------------
# fused residual block
# ---------------------------------------------------------------------------

_RESBLOCK_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_CHANNELS = (16, 32, 48, 64)
WGMMA_DIM = 64  # a packed tap is 64 output rows x 64 input channels
_WGMMA_SHAPE = (9, WGMMA_DIM, WGMMA_DIM)


def swizzle_k_major(m: torch.Tensor) -> torch.Tensor:
    """(..., 64, 64) bf16, row n holding its 64 K values (128 bytes) →
    wgmma's 128-byte swizzle: 16-byte chunk j of row n stored at chunk
    j ^ (n % 8). An involution: applied twice it gives ``m`` back."""
    n = torch.arange(WGMMA_DIM, device=m.device).view(-1, 1)
    j = torch.arange(8, device=m.device).view(1, -1)
    chunks = m.reshape(*m.shape[:-1], 8, 8)
    return chunks[..., n, j ^ (n % 8), :].reshape(m.shape).contiguous()


def unpack_wgmma_weights(w: torch.Tensor, c: int) -> torch.Tensor:
    """The (9, 64, 64) ``wgmma`` layout → the (9·C, C) operand it packs."""
    taps = swizzle_k_major(w)[:, :c, :c]  # (9, N, K): per tap, row n = out
    return taps.transpose(1, 2).reshape(9 * c, c)


def fused_resblock_plain(x, w1, b1, w2, b2, res_scale: float = 1.0):
    """Reference block: float32 convs (TF32 off on CUDA), float32 bias,
    ReLU, intermediate cast to x's dtype, residual added in x's dtype.
    Takes (9·C, C) operands, or for bf16 the (9, 64, 64) ``wgmma`` layout."""
    c = x.shape[-1]

    def conv(inp, w, b):
        if w.shape == _WGMMA_SHAPE and w.dtype == torch.bfloat16:
            w = unpack_wgmma_weights(w, c)
        k = w.to(torch.float32).reshape(3, 3, c, c).permute(3, 2, 0, 1)
        y = F.conv2d(inp.to(torch.float32).permute(0, 3, 1, 2), k, padding=1)
        return y.permute(0, 2, 3, 1) + b.to(torch.float32)

    with no_tf32() if x.is_cuda else contextlib.nullcontext():
        h = torch.relu(conv(x, w1, b1)).to(x.dtype)
        acc = conv(h, w2, b2) * res_scale
    return x + acc.to(x.dtype)


@functools.cache
def resblock_lib():
    """The loaded ``fused_resblock`` library and its block entry."""
    lib = _build.load("fused_resblock")
    fn = lib.sr_fused_resblock
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sr_wgmma_matmul.argtypes = [ctypes.c_void_p] * 4
    lib.sr_wgmma_matmul.restype = ctypes.c_int
    return lib, fn


def _check_resblock(x, w1, b1, w2, b2) -> None:
    """Validate a CUDA launch: bf16 takes ``pack_wgmma_weights`` operands,
    float32 the (9·C, C) ones."""
    if x.dim() != 4:
        raise ValueError(f"fused_resblock takes NHWC, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if x.dtype not in _RESBLOCK_CODES:
        raise TypeError(f"fused_resblock kernel takes float32/bfloat16, "
                        f"got {x.dtype}")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"fused_resblock kernel takes C in {KERNEL_CHANNELS}, "
                         f"got {c}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_resblock kernel needs a contiguous, 16-byte "
                         "aligned NHWC tensor")
    if x.dtype == torch.bfloat16:
        shape, how = _WGMMA_SHAPE, " (pack_wgmma_weights)"
    else:
        shape, how = (9 * c, c), ""
    for name, w in (("w1", w1), ("w2", w2)):
        if (w.shape != shape or w.dtype != x.dtype
                or w.device != x.device or not w.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape}{how} "
                             f"{x.dtype} tensor on {x.device}")
    for name, b in (("b1", b1), ("b2", b2)):
        if (b.shape != (c,) or b.dtype != torch.float32
                or b.device != x.device or not b.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({c},) float32 "
                             f"tensor on {x.device}")


@torch.library.custom_op(f"{_NS}::fused_resblock", mutates_args=(),
                         device_types="cpu")
def _resblock_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor,
                 res_scale: float) -> torch.Tensor:
    return fused_resblock_plain(x, w1, b1, w2, b2, res_scale)


@_resblock_op.register_kernel("cuda")
def _resblock_cuda(x, w1, b1, w2, b2, res_scale):
    _check_resblock(x, w1, b1, w2, b2)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    mid = None if x.dtype == torch.bfloat16 else torch.empty_like(x)
    lib, fn = resblock_lib()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), None if mid is None else mid.data_ptr(),
                 out.data_ptr(), b, h, w, c, _RESBLOCK_CODES[x.dtype],
                 float(res_scale), _stream())
    _build.check(lib, err, "fused_resblock")
    fused_resblock.launches += 1
    return out


@_resblock_op.register_fake
def _resblock_fake(x, w1, b1, w2, b2, res_scale):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def fused_resblock(x, w1, b1, w2, b2, res_scale: float = 1.0):
    """x: (B, H, W, C) NHWC; w: the convs' operands in x's dtype; b: f32
    (C,).

    ``sr_torch::fused_resblock``: CPU tensors take
    :func:`fused_resblock_plain`. CUDA tensors launch the kernel (C in
    16/32/48/64): bfloat16 as one launch, with w1 and w2 in the
    ``pack_wgmma_weights`` layout; float32 as two launches with a scratch
    intermediate, with (9·C, C) operands. Inference only.
    ``fused_resblock.launches`` counts the calls that launched it.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_resblock runs on cpu or cuda, not {x.device}")
    return _resblock_op(x, w1, b1, w2, b2, float(res_scale))


fused_resblock.launches = 0


# ---------------------------------------------------------------------------
# k×k SAME int8 conv
# ---------------------------------------------------------------------------

_CONV_CODES = {torch.int8: 0, torch.bfloat16: 1}
_CONV_OUT = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
MAX_K = 17  # the largest odd k the kernel takes (few channels; see below)
_NCHUNK = 64  # output channels per packed weight chunk, at most
_TAP_PACK_BYTES = 8  # C·element size at or below: the tap-packed class
_MAX_SMEM = 232448  # shared memory one block may use on the H100


class ConvLayout:
    """The kernel's shape class and weight packing for one conv:
    ``tap_packed`` (K holds a whole tap row: few channels), ``taps`` (k·k,
    or k tap rows), ``ks`` (32-byte K steps a tap), ``kbytes`` (real K
    bytes a tap), ``kp`` (K elements a tap, zero-padded to ks·32 bytes),
    ``nch`` (output channels a chunk: 64, or 32, 16, 8 where one chunk
    would not fit in shared memory), ``nchunks``, ``last_w`` (the last
    chunk's width, rounded up to wgmma's N), ``numel`` (elements of the
    packed weights)."""

    __slots__ = ("tap_packed", "taps", "ks", "kbytes", "kp", "nch",
                 "nchunks", "last_w", "numel")

    def __init__(self, *values):
        for name, value in zip(self.__slots__, values, strict=True):
            setattr(self, name, value)


def _mma_width(n: int) -> int:
    """wgmma's N for a chunk of ``n`` output channels."""
    return next(w for w in (8, 16, 32, 48, 64) if n <= w)


_ELEMENT_SIZE = {torch.int8: 1, torch.bfloat16: 2}


@functools.cache
def conv_layout(k: int, c: int, n: int, dtype: torch.dtype) -> ConvLayout:
    """The shape class and packing of a k×k conv of C→N channels in
    ``dtype`` (int8 or bfloat16), as ``csrc/int8_conv.cu:packing`` sets
    them: tap-packed when k > 1 and a pixel's C channels fill at most 8
    of a K step's 32 bytes, else one K run per tap; chunks of 64 outputs,
    halved while the kernel's smallest plan would not fit."""
    es = _ELEMENT_SIZE[dtype]
    tap_packed = k > 1 and c * es <= _TAP_PACK_BYTES
    taps = k if tap_packed else k * k
    kbytes = (k if tap_packed else 1) * c * es
    ks = -(-kbytes // 32)
    nch = _NCHUNK
    while True:
        nchunks = -(-n // nch)
        last_w = _mma_width(n - (nchunks - 1) * nch)
        lay = ConvLayout(tap_packed, taps, ks, kbytes, ks * 32 // es, nch,
                         nchunks, last_w,
                         taps * ks * 32 // es * ((nchunks - 1) * nch + last_w))
        if nch == 8 or _conv_smem_floor(lay, k, c, es) <= _MAX_SMEM:
            return lay
        nch //= 2


def conv_fits(k: int, c: int, n: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes a k×k conv of C→N channels in ``dtype``:
    a chunk of its weights and k quantized rows fit in shared memory."""
    lay = conv_layout(k, c, n, dtype)
    es = _ELEMENT_SIZE[dtype]
    return k <= MAX_K and _conv_smem_floor(lay, k, c, es) <= _MAX_SMEM


def conv_class(k: int, c: int, dtype: torch.dtype = torch.int8) -> str:
    """'tap-packed' (class 2, few channels) or 'per-tap' (class 1)."""
    return ("tap-packed" if conv_layout(k, c, 1, dtype).tap_packed
            else "per-tap")


def check_conv(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv runs on cpu or cuda, not {x.device}")
    return k


def conv_int8_plain(q_x: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """Reference: an exact float64 conv cast to int32 (every sum is an
    integer below 2^53; on CUDA no integer conv exists)."""
    k = check_conv(q_x, q_w, torch.int8)
    y = F.conv2d(q_x.permute(0, 3, 1, 2).to(torch.float64),
                 q_w.permute(3, 2, 0, 1).to(torch.float64), padding=k // 2)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def conv_bf16_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reference: a float32 conv of the bf16 values (TF32 off on CUDA)."""
    k = check_conv(x, w, torch.bfloat16)
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


def pack_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``(k, k, C, N)`` → the kernel's resident weights, 1-D.

    K of a tap is its C channels (per-tap class) or, tap-packed, the
    (dx, c) run of a whole tap row; zero-padded to whole 32-byte K steps.
    Output channels go in chunks of 64 (the last one zero-padded to
    wgmma's N); a chunk holds, for each tap and K step, its N × 32 bytes in
    wgmma's K-major layout with the 32-byte swizzle: row n's 32 bytes at
    32·n, its two 16-byte K halves swapped in rows with n // 4 odd. See
    :func:`conv_layout`."""
    k, _, c, n = w.shape
    lay = conv_layout(k, c, n, w.dtype)
    e = 32 // w.element_size()  # elements a K step
    full = w.new_zeros((lay.taps, lay.kp,
                        (lay.nchunks - 1) * lay.nch + lay.last_w))
    full[:, :lay.kbytes // w.element_size(), :n] = w.reshape(
        lay.taps, -1, n)
    chunks = []
    for i in range(lay.nchunks):
        nw = lay.nch if i + 1 < lay.nchunks else lay.last_w
        blk = full[:, :, i * lay.nch:i * lay.nch + nw].reshape(
            lay.taps, lay.ks, 2, e // 2, nw).permute(0, 1, 4, 2, 3)
        # (tap, step, row, K half, element); the 32-byte swizzle swaps the
        # halves of rows 4-7 of every 8
        swap = torch.arange(nw, device=w.device) // 4 % 2 == 1
        blk = torch.where(swap[:, None, None], blk.flip(3), blk)
        chunks.append(blk.reshape(-1))
    return torch.cat(chunks)


def _conv_smem_floor(lay: ConvLayout, k: int, c: int, es: int) -> int:
    """Shared memory of the kernel's smallest plan (``smem_floor`` in
    ``csrc/int8_conv.cu``): one MMA warpgroup, one staging stage of one
    pixel (a whole row when tap-packed) at 4 bytes an element, k quantized
    rows, one chunk of weights a block, and their barriers."""
    def up(a, b):
        return -(-a // b) * b

    w = lay.taps * lay.ks * 32 * (lay.nch if lay.nchunks > 1
                                  else lay.last_w)
    p = 64 + k - 1
    ring_row = up((64 if lay.tap_packed else p) * lay.ks * 32, 256)
    tab = up((2 * up(c, 4) + 2 * lay.nch) * 4, 16)
    stage = up((p if lay.tap_packed else 1) * c * 4 + 32, 128)
    return (up(w, 256) + k * ring_row + stage + tab
            + 8 * (3 + 2 * k) + 1024)


@functools.cache
def _conv_lib():
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
    lib.sr_conv_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.sr_conv_plan.restype = ctypes.c_int
    return lib, raw, fused


_PLAN_KEYS = ("tap_packed", "ks", "warpgroups", "stages", "piece_px",
              "ring_rows", "nslices", "band_rows", "items", "smem", "blocks",
              "blocks_per_sm")


def conv_plan(shape, n: int, k: int, fused: bool = True,
              dtype: torch.dtype = torch.int8) -> dict:
    """The plan the CUDA kernel takes for x of ``shape`` (B, H, W, C) → N
    outputs, k×k: the fused entry, or the raw one in ``dtype``. Needs the
    card (it asks the device for its SMs and the kernel's occupancy)."""
    b, h, w, c = shape
    lib, _, _ = _conv_lib()
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    code = 2 if fused else _CONV_CODES[dtype]
    _build.check(lib, lib.sr_conv_plan(b, h, w, c, n, k, code, out),
                 "int8_conv plan")
    plan = dict(zip(_PLAN_KEYS, out))
    plan["tap_packed"] = bool(plan["tap_packed"])
    return plan


def _check_conv_launch(x: torch.Tensor, w: torch.Tensor,
                       packed: torch.Tensor | None) -> ConvLayout:
    """Validate a CUDA launch of ``x`` against HWIO ``w`` and its
    :func:`pack_conv_weights` layout ``packed``; return the layout."""
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
    lay = conv_layout(k, c, n, w.dtype)
    if (packed.shape != (lay.numel,) or packed.dtype != w.dtype
            or packed.device != x.device or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(f"packed weights {tuple(packed.shape)} "
                         f"{packed.dtype} do not fit HWIO "
                         f"{tuple(w.shape)}; use pack_weights")
    need = _conv_smem_floor(lay, k, c, w.element_size())
    if need > _MAX_SMEM:
        raise ValueError(
            f"conv kernel keeps a chunk of 8 or more output channels of its "
            f"weights resident in shared memory: k={k}, C={c} "
            f"({conv_class(k, c, w.dtype)}) needs {need} bytes, more than "
            f"the {_MAX_SMEM} a block has (no conv of the port is that "
            f"large)")
    return lay


def _raw_launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    packed = pack_conv_weights(w)
    lay = _check_conv_launch(x, w, packed)
    b, h, wd, c = x.shape
    k, n = w.shape[0], w.shape[-1]
    out = torch.empty((b, h, wd, n), dtype=_CONV_OUT[x.dtype],
                      device=x.device)
    lib, raw, _ = _conv_lib()
    with torch.cuda.device(x.device):
        err = raw(x.data_ptr(), packed.data_ptr(), out.data_ptr(), b, h, wd,
                  c, lay.kp, n, k, _CONV_CODES[x.dtype], _stream())
    _build.check(lib, err, "int8_conv")
    return out


def _conv_fake(x, w):
    b, h, wd, _ = x.shape
    return x.new_empty((b, h, wd, w.shape[-1]), dtype=_CONV_OUT[x.dtype])


@torch.library.custom_op(f"{_NS}::conv_int8_im2col", mutates_args=(),
                         device_types="cpu")
def _int8_op(q_x: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    return conv_int8_plain(q_x, q_w)


@_int8_op.register_kernel("cuda")
def _int8_cuda(q_x, q_w):
    out = _raw_launch(q_x, q_w)
    conv_int8_im2col.launches += 1
    return out


@torch.library.custom_op(f"{_NS}::conv_bf16_im2col", mutates_args=(),
                         device_types="cpu")
def _bf16_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return conv_bf16_plain(x, w)


@_bf16_op.register_kernel("cuda")
def _bf16_cuda(x, w):
    out = _raw_launch(x, w)
    conv_bf16_im2col.launches += 1
    return out


_int8_op.register_fake(_conv_fake)
_bf16_op.register_fake(_conv_fake)


def conv_int8_im2col(q_x: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """int8 (B,H,W,C) × int8 (k,k,C,N) → int32 (B,H,W,N), SAME, stride 1.

    ``sr_torch::conv_int8_im2col``: CPU tensors take
    :func:`conv_int8_plain`; CUDA tensors launch the kernel.
    ``conv_int8_im2col.launches`` counts its launches.
    """
    check_conv(q_x, q_w, torch.int8)
    return _int8_op(q_x, q_w)


def conv_bf16_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 (B,H,W,C) × bf16 (k,k,C,N) → float32 (B,H,W,N), SAME, stride 1.

    ``sr_torch::conv_bf16_im2col``: CPU tensors take
    :func:`conv_bf16_plain`; CUDA tensors launch the kernel's bf16
    instantiation. ``conv_bf16_im2col.launches`` counts its launches.
    """
    check_conv(x, w, torch.bfloat16)
    return _bf16_op(x, w)


conv_int8_im2col.launches = 0
conv_bf16_im2col.launches = 0


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


@torch.library.custom_op(f"{_NS}::conv_int8_fused", mutates_args=(),
                         device_types="cpu")
def _fused_op(x: torch.Tensor, q_w: torch.Tensor, scale: torch.Tensor,
              dequant: torch.Tensor, bias: torch.Tensor | None,
              reciprocal: bool, packed: torch.Tensor | None) -> torch.Tensor:
    return conv_int8_fused_plain(x, q_w, scale, dequant, bias, reciprocal)


@_fused_op.register_kernel("cuda")
def _fused_cuda(x, q_w, scale, dequant, bias, reciprocal, packed):
    b, h, wd, c = x.shape
    k, n = q_w.shape[0], q_w.shape[-1]
    lay = _check_conv_launch(x, q_w, packed)
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
    lib, _, fused = _conv_lib()
    with torch.cuda.device(x.device):
        err = fused(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                    mul.data_ptr(),
                    None if divisor is None else divisor.data_ptr(), sb, sc,
                    dequant.data_ptr(), dq_sb,
                    None if bias is None else bias.data_ptr(),
                    b, h, wd, c, lay.kp, n, k, _stream())
    _build.check(lib, err, "int8_conv")
    conv_int8_fused.launches += 1
    return out


@_fused_op.register_fake
def _fused_fake(x, q_w, scale, dequant, bias, reciprocal, packed):
    b, h, wd, _ = x.shape
    return x.new_empty((b, h, wd, q_w.shape[-1]), dtype=torch.float32)


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
    its :func:`pack_conv_weights` layout, packed once by the caller, which
    a CUDA launch requires and the CPU ignores. To divide, the kernel
    multiplies by ``torch.reciprocal(scale)`` (one small op per call) and
    divides only near a rounding tie. ``sr_torch::conv_int8_fused``: CPU
    tensors take :func:`conv_int8_fused_plain`; CUDA tensors launch the
    kernel, which equals it bit for bit. ``conv_int8_fused.launches``
    counts its launches.
    """
    check_conv(x, q_w, torch.int8, x_dtype=torch.float32)
    return _fused_op(x, q_w, scale, dequant, bias, reciprocal, packed)


conv_int8_fused.launches = 0
