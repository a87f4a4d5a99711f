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
in ``csrc/fused_resblock.cu`` or raises. bf16 runs one launch per block
with ``wgmma`` products and takes its weights in the layout
:func:`pack_wgmma_weights` makes (callers pack once); float32 runs two
launches on the CUDA cores with a scratch intermediate and takes the
(9·C, C) operands, as the plain version does. Inference only: the TPU kernel
has no VJP either. The TPU kernel's ``row_tile`` was a VMEM tiling knob and
is gone; any H and W work.
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


_WGMMA_DIM = 64  # a packed tap is 64 output rows x 64 input channels


def _swizzle_k_major(m: torch.Tensor) -> torch.Tensor:
    """(..., 64, 64) bf16, row n holding its 64 K values (128 bytes) →
    wgmma's 128-byte swizzle: 16-byte chunk j of row n stored at chunk
    j ^ (n % 8)."""
    n = torch.arange(_WGMMA_DIM, device=m.device).view(-1, 1)
    j = torch.arange(8, device=m.device).view(1, -1)
    chunks = m.reshape(*m.shape[:-1], 8, 8)
    return chunks[..., n, j ^ (n % 8), :].reshape(m.shape).contiguous()


def pack_wgmma_weights(w: torch.Tensor) -> torch.Tensor:
    """A (9·C, C) bf16 operand → the bf16 kernel's (9, 64, 64) layout: per
    tap a K-major matrix (row n = output channel, its C input channels),
    zero-padded to 64 × 64 and swizzled for ``wgmma``."""
    c = w.shape[1]
    out = w.new_zeros((9, _WGMMA_DIM, _WGMMA_DIM))
    out[:, :c, :c] = w.reshape(9, c, c).transpose(1, 2)
    return _swizzle_k_major(out)


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
    lib.sr_wgmma_matmul.argtypes = [ctypes.c_void_p] * 4
    lib.sr_wgmma_matmul.restype = ctypes.c_int
    return lib, fn


def wgmma_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(64, 64) bf16 @ (64, 64) bf16 → float32 through the resblock
    kernel's ``ldmatrix`` / descriptor / ``wgmma`` helpers: one product, to
    hold them against a plain matmul on the card. CUDA tensors only."""
    if a.device.type != "cuda":
        raise ValueError(f"wgmma_matmul runs on cuda, not {a.device}")
    shape = (_WGMMA_DIM, _WGMMA_DIM)
    if (a.shape != shape or b.shape != shape or a.dtype != torch.bfloat16
            or b.dtype != torch.bfloat16 or b.device != a.device):
        raise ValueError("wgmma_matmul takes two (64, 64) bf16 tensors on "
                         "one card")
    a = a.contiguous()
    packed = _swizzle_k_major(b.t())  # row n holds column n of b
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    lib, _ = _kernel()
    with torch.cuda.device(a.device):
        err = lib.sr_wgmma_matmul(a.data_ptr(), packed.data_ptr(),
                                  out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "wgmma_matmul")
    return out


def _check_operands(x, w1, b1, w2, b2) -> None:
    """Validate a CUDA launch: bf16 takes :func:`pack_wgmma_weights`
    operands, float32 the (9·C, C) ones."""
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
    if x.dtype == torch.bfloat16:
        shape, how = (9, _WGMMA_DIM, _WGMMA_DIM), " (pack_wgmma_weights)"
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


def fused_resblock(x, w1, b1, w2, b2, res_scale: float = 1.0):
    """x: (B, H, W, C) NHWC; w: the convs' operands in x's dtype; b: f32
    (C,).

    CPU tensors take :func:`fused_resblock_plain` with (9·C, C) operands.
    CUDA tensors launch the kernel (C in 16/32/48/64): bfloat16 as one
    launch, with w1 and w2 in the :func:`pack_wgmma_weights` layout;
    float32 as two launches with a scratch intermediate, with (9·C, C)
    operands. ``fused_resblock.launches`` counts the calls that launched
    it.
    """
    if x.device.type == "cpu":
        return fused_resblock_plain(x, w1, b1, w2, b2, res_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock runs on cpu or cuda, not {x.device}")
    _check_operands(x, w1, b1, w2, b2)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    mid = None if x.dtype == torch.bfloat16 else torch.empty_like(x)
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), None if mid is None else mid.data_ptr(),
                 out.data_ptr(), b, h, w, c, _DTYPE_CODES[x.dtype],
                 float(res_scale), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fused_resblock")
    fused_resblock.launches += 1
    return out


fused_resblock.launches = 0
