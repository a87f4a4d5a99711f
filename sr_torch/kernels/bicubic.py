"""Pillow-parity resampling: float32 matrix products and the exact u8 path.

Port of ``sr/kernels/bicubic.py``. The reference
degrades HR images to LR with ``PIL.Image.resize(..., BICUBIC)``, whose
resampler widens its support by the scale factor on downscale and runs two
separable passes (horizontal first) with the intermediate image clamped to
[0, 255]. For a fixed (in_size, out_size) pair the per-output-pixel weights
are constant, so a resize is two dense products with precomputed matrices.

The coefficient code (:func:`precompute_coeffs`, :func:`resize_matrix`) is
the port's own numpy copy. Two resamplers use it:

  * :func:`resize2d` runs the products in float32 with ``torch.einsum`` on
    the tensor's device (the training degradation; within one u8 step of
    Pillow).
  * :func:`pil_resize_exact_u8` replicates Pillow's uint8 fixed-point
    passes on the host in numpy, bit for bit (the eval degradation, so a
    reported PSNR is against exactly the reference's LR).

:func:`resize2d_unit` and :func:`img_interp` are ``resize2d`` for
[0, 1]-normalized tensors: the bicubic upscale that feeds the pre-upsample
models (SRCNN, VDSR, DRCN). No Pallas kernel lives here: the JAX package
leaves these products to XLA too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Pillow's fixed-point coefficient precision for 8-bit channels
# (libImaging/Resample.c: #define PRECISION_BITS (32 - 8 - 2)).
PRECISION_BITS = 32 - 8 - 2

#: Pillow filter supports (libImaging/Resample.c struct filters).
_SUPPORT = {"bicubic": 2.0, "bilinear": 1.0, "box": 0.5}


def _bicubic_filter(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution kernel with a=-0.5 (Pillow's bicubic)."""
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


def _bilinear_filter(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _box_filter(x: np.ndarray) -> np.ndarray:
    return np.where((x > -0.5) | (x == -0.5), np.where(x < 0.5, 1.0, 0.0), 0.0)


_FILTERS = {
    "bicubic": _bicubic_filter,
    "bilinear": _bilinear_filter,
    "box": _box_filter,
}


def precompute_coeffs(
    in_size: int, out_size: int, filter: str = "bicubic"
) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-pixel resampling taps, exactly as Pillow computes them.

    Returns ``(bounds, kk)`` where ``bounds[o]`` is the first input index
    contributing to output pixel ``o`` and ``kk[o, :]`` the (normalized)
    float64 tap weights (zero-padded to the common kernel size).
    """
    support = _SUPPORT[filter]
    filt = _FILTERS[filter]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    sup = support * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(sup)) * 2 + 1
    bounds = np.zeros(out_size, dtype=np.int64)
    kk = np.zeros((out_size, ksize), dtype=np.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = max(int(center - sup + 0.5), 0)
        xmax = min(int(center + sup + 0.5), in_size)
        n = xmax - xmin
        w = filt((np.arange(n) + xmin - center + 0.5) * ss)
        wsum = w.sum()
        if wsum != 0.0:
            w = w / wsum
        bounds[o] = xmin
        kk[o, :n] = w
    return bounds, kk


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, filter: str = "bicubic") -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix, cached per
    (in, out, filter). Callers must not write to it."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    bounds, kk = precompute_coeffs(in_size, out_size, filter)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        lo = bounds[o]
        n = min(kk.shape[1], in_size - lo)
        m[o, lo : lo + n] = kk[o, :n]
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_matrix(in_size: int, out_size: int, filter: str,
                   device: torch.device) -> torch.Tensor:
    # one upload per device: a copy from pageable host memory would wait
    # for the stream at every call
    return torch.from_numpy(resize_matrix(in_size, out_size, filter)).to(device)


def resize2d(
    x: torch.Tensor,
    out_hw: tuple[int, int],
    filter: str = "bicubic",
    clip: bool = True,
) -> torch.Tensor:
    """Pillow-parity separable resize of NHWC (or HWC/HW) float images.

    ``x`` holds values in [0, 255]; ``clip`` clamps the width pass and the
    result to [0, 255] as Pillow's uint8 passes do (pass ``clip=False`` for
    other ranges). Both products run in float32 (``einsum`` lowers to a
    matmul, which PyTorch keeps out of TF32 by default); the result takes
    x's dtype.
    """
    h_out, w_out = out_hw
    squeeze = x.dim() == 2, x.dim() <= 3
    if x.dim() == 2:
        x = x[None, :, :, None]
    elif x.dim() == 3:
        x = x[None]
    _, h_in, w_in, _ = x.shape
    dtype = x.dtype
    xf = x.to(torch.float32)
    if w_in != w_out:
        mw = _device_matrix(w_in, w_out, filter, x.device)
        xf = torch.einsum("bhwc,ow->bhoc", xf, mw)
        if clip:
            # Pillow clamps the intermediate pass to [0, 255] (uint8 image)
            xf = xf.clamp(0.0, 255.0)
    if h_in != h_out:
        mh = _device_matrix(h_in, h_out, filter, x.device)
        xf = torch.einsum("bhwc,oh->bowc", xf, mh)
    if clip:
        xf = xf.clamp(0.0, 255.0)
    out = xf.to(dtype)
    if squeeze[1]:
        out = out[0]
    if squeeze[0]:
        out = out[..., 0]
    return out


def resize2d_unit(x: torch.Tensor, out_hw: tuple[int, int],
                  filter: str = "bicubic") -> torch.Tensor:
    """:func:`resize2d` for [0, 1]-normalized tensors: no intermediate
    clamp, the result clamped to [0, 1]."""
    return resize2d(x, out_hw, filter, clip=False).clamp(0.0, 1.0)


def img_interp(x: torch.Tensor, scale_factor: int,
               filter: str = "bicubic") -> torch.Tensor:
    """Bicubic-upscale an (H, W), (H, W, C) or NHWC image in [0, 1] by
    ``scale_factor``: the pre-upsampling step of SRCNN, VDSR and DRCN."""
    h, w = (x.shape[-3], x.shape[-2]) if x.dim() >= 3 else x.shape
    return resize2d_unit(x, (h * scale_factor, w * scale_factor), filter)


# ---------------------------------------------------------------------------
# Host-side bit-exact Pillow path (uint8 fixed-point, numpy)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _int_coeff_matrix(in_size: int, out_size: int, filter: str = "bicubic") -> np.ndarray:
    """Dense (out, in) int64 matrix of Pillow's quantized coefficients,
    cached per (in, out, filter). Callers must not write to it."""
    bounds, kk = precompute_coeffs(in_size, out_size, filter)
    v = kk * (1 << PRECISION_BITS)
    ikk = np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5)).astype(np.int64)
    m = np.zeros((out_size, in_size), dtype=np.int64)
    for o in range(out_size):
        lo = bounds[o]
        n = min(ikk.shape[1], in_size - lo)
        m[o, lo : lo + n] = ikk[o, :n]
    return m


def _pass_u8(img: np.ndarray, m: np.ndarray) -> np.ndarray:
    """One fixed-point pass contracting the LAST axis of ``img`` with m.T."""
    acc = img.astype(np.int64) @ m.T
    acc += 1 << (PRECISION_BITS - 1)
    acc >>= PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def pil_resize_exact_u8(
    img: np.ndarray, out_hw: tuple[int, int], filter: str = "bicubic"
) -> np.ndarray:
    """Bit-exact replica of ``PIL.Image.resize`` for uint8 (H,W[,C]) arrays.

    Matches Pillow's pass order (horizontal, then vertical) including the
    intermediate uint8 rounding between passes.
    """
    if img.dtype != np.uint8:
        raise TypeError(f"the exact path takes uint8, got {img.dtype}")
    out_h, out_w = out_hw
    chan_last = img.ndim == 3
    x = img
    h_in, w_in = x.shape[:2]
    if w_in != out_w:  # horizontal pass: contract W
        m = _int_coeff_matrix(w_in, out_w, filter)
        if chan_last:
            x = np.moveaxis(_pass_u8(np.moveaxis(x, 1, -1), m), -1, 1)
        else:
            x = _pass_u8(x, m)
    if h_in != out_h:  # vertical pass: contract H
        m = _int_coeff_matrix(h_in, out_h, filter)
        x = np.moveaxis(_pass_u8(np.moveaxis(x, 0, -1), m), -1, 0)
    return x
