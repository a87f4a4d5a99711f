"""Reference-convention image quality metrics.

Port of ``sr/eval/metrics.py``. The evaluation conventions of the reference
repo (reference: utils.py:PSNR, utils.py:shave,
dataset.py:calculate_valid_crop_size, dataset.py:load_img):

  * PSNR is ``20·log10(255 / rmse)`` computed on de-normalized ([0,255])
    arrays, on the Y channel of YCbCr for 1-channel models.
  * A border of ``scale_factor`` pixels is shaved before PSNR.
  * Test images are center-cropped to a multiple of the scale factor.
  * YCbCr follows PIL's JPEG/BT.601 full-range convention.

:func:`psnr` and :func:`ssim` run on the host in float64 (numpy, scipy).
:func:`ssim_device` and the YCbCr conversions are torch ops on the tensor's
device, in true float32: on the card PyTorch runs float32 convolutions in
TF32 by default, which keeps about three decimal digits, and SSIM's
``E[x²] − μ²`` variances cancel catastrophically under that (the JAX package
measured SSIM of 1.05–3.87 on the TPU from the same trap with bf16 passes).
So the blurs and the colour matrix run with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sr_torch.utils.precision import no_tf32


def calculate_valid_crop_size(crop_size: int, scale_factor: int) -> int:
    """Largest size ≤ crop_size divisible by scale_factor.

    (reference: dataset.py:calculate_valid_crop_size)
    """
    return crop_size - (crop_size % scale_factor)


def modulo_crop(img, scale_factor: int):
    """Center-crop (H, W[, C]) image so H and W divide by scale_factor."""
    h, w = img.shape[:2]
    ch = calculate_valid_crop_size(h, scale_factor)
    cw = calculate_valid_crop_size(w, scale_factor)
    top = (h - ch) // 2
    left = (w - cw) // 2
    return img[top : top + ch, left : left + cw]


def shave(img, border: int):
    """Remove ``border`` pixels from every spatial edge.

    Accepts (H,W), (H,W,C) or (B,H,W,C) arrays or tensors.
    (reference: utils.py:shave)
    """
    if border == 0:
        return img
    if img.ndim == 2 or img.ndim == 3:
        return img[border:-border, border:-border]
    if img.ndim == 4:
        return img[:, border:-border, border:-border, :]
    raise ValueError(f"unsupported ndim {img.ndim}")


def psnr(pred, target, max_val: float = 255.0, border: int = 0) -> float:
    """Peak signal-to-noise ratio on de-normalized arrays.

    (reference: utils.py:PSNR — ``20·log10(255 / rmse)`` after shave.)
    Inputs may be any float/int arrays of identical shape; computed in
    float64 on host for determinism.
    """
    p = np.asarray(shave(pred, border), dtype=np.float64)
    t = np.asarray(shave(target, border), dtype=np.float64)
    return psnr_from_mse(np.mean((p - t) ** 2), max_val)


def psnr_from_mse(mse, max_val: float = 255.0) -> float:
    """``20·log10(max_val / sqrt(mse))`` in numpy float64; inf at 0."""
    mse = np.float64(mse)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(max_val / np.sqrt(mse)))


_RADIUS = 5  # 11-tap gaussian window, sigma 1.5 (truncate = radius/sigma)


def _check_window(shape) -> None:
    if shape[0] < 2 * _RADIUS + 1 or shape[1] < 2 * _RADIUS + 1:
        raise ValueError(f"image {tuple(shape)} smaller than the 11x11 window")


def ssim(pred, target, max_val: float = 255.0, border: int = 0) -> float:
    """Structural similarity (Wang et al. 2004, the SR papers' second
    metric alongside PSNR; the reference reports PSNR only).

    Canonical constants: 11×11 gaussian window σ=1.5, K1=0.01, K2=0.03;
    the SSIM map is averaged over the valid region (window fully inside
    the image — the MATLAB ``filter2(..., 'valid')`` convention of the SR
    literature). Inputs are de-normalized ([0, max_val]) arrays, (H,W) or
    (H,W,C) (channels averaged); ``border`` is shaved first, like
    :func:`psnr`. Computed on host in float64.
    """
    from scipy.ndimage import gaussian_filter

    p = np.asarray(shave(pred, border), dtype=np.float64)
    t = np.asarray(shave(target, border), dtype=np.float64)
    if p.ndim == 2:
        p, t = p[..., None], t[..., None]
    _check_window(p.shape)

    sigma, radius = 1.5, _RADIUS
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def filt(x):
        # per-axis sigma (0 = no filtering over channels)
        return gaussian_filter(x, (sigma, sigma, 0.0),
                               truncate=radius / sigma, mode="constant")

    def valid(x):
        return x[radius:-radius, radius:-radius]

    mu_p, mu_t = filt(p), filt(t)
    var_p = filt(p * p) - mu_p * mu_p
    var_t = filt(t * t) - mu_t * mu_t
    cov = filt(p * t) - mu_p * mu_t
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2)
    )
    return float(np.mean(valid(ssim_map)))


def _gaussian_kernel_1d(sigma: float = 1.5, radius: int = _RADIUS) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def ssim_device(pred: torch.Tensor, target: torch.Tensor,
                max_val: float = 255.0, border: int = 0) -> torch.Tensor:
    """SSIM equal to :func:`ssim`, as a scalar tensor on the inputs' device,
    so eval can report SSIM without copying the image to the host.

    Same conventions as the host path: 11×11 gaussian σ=1.5, valid-window
    mean, ``border`` shaved first, (H,W) or (H,W,C) with channels averaged.
    Computed in float32 on NORMALIZED inputs (SSIM is scale-invariant:
    p/max, t/max with C1=0.01², C2=0.03² is the same algebra with ~1e-7
    instead of ~1e-3 float32 rounding). The five blurs run as one batch of
    two separable VALID convolutions with the 11-tap gaussian (equal to
    ``gaussian_filter(mode='constant')`` cropped to the valid region), with
    TF32 off.
    """
    p = torch.as_tensor(shave(pred, border)).to(torch.float32) / max_val
    t = torch.as_tensor(shave(target, border)).to(torch.float32) / max_val
    if p.dim() == 2:
        p, t = p[..., None], t[..., None]
    _check_window(p.shape)
    c1, c2 = 0.01**2, 0.03**2
    k1 = torch.as_tensor(_gaussian_kernel_1d(), dtype=torch.float32,
                         device=p.device)
    n = 2 * _RADIUS + 1
    # (5·C, 1, H, W): the five blurred quantities, channels into the batch
    stack = torch.cat([v.permute(2, 0, 1) for v in
                       (p, t, p * p, t * t, p * t)])[:, None]
    with no_tf32():
        y = F.conv2d(stack, k1.view(1, 1, n, 1))
        y = F.conv2d(y, k1.view(1, 1, 1, n))
    mu_p, mu_t, e_pp, e_tt, e_pt = y[:, 0].chunk(5)
    var_p = e_pp - mu_p * mu_p
    var_t = e_tt - mu_t * mu_t
    cov = e_pt - mu_p * mu_t
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2)
    )
    return ssim_map.mean()


# ---------------------------------------------------------------------------
# YCbCr — PIL convert('YCbCr') parity (JPEG full-range BT.601)
# ---------------------------------------------------------------------------

# Forward matrix, applied to RGB in [0,255]; offsets added after.
_RGB2YCBCR = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float64,
)
_YCBCR_OFFSET = np.array([0.0, 128.0, 128.0], dtype=np.float64)

_YCBCR2RGB = np.linalg.inv(_RGB2YCBCR)


def _mix(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``x @ m.T`` over the last axis in true float32 (TF32 off on the
    card)."""
    mt = torch.as_tensor(m, dtype=torch.float32, device=x.device)
    with no_tf32():
        return torch.einsum("...c,kc->...k", x, mt)


def rgb_to_ycbcr(rgb, unit_range: bool = False) -> torch.Tensor:
    """RGB → YCbCr (full-range BT.601, the PIL 'YCbCr' convention), float32
    on the input's device.

    ``rgb`` is (..., 3). If ``unit_range``, values are in [0,1] and the
    chroma offset is 128/255.
    """
    off = _YCBCR_OFFSET / 255.0 if unit_range else _YCBCR_OFFSET
    x = torch.as_tensor(rgb).to(torch.float32)
    return _mix(x, _RGB2YCBCR) + torch.as_tensor(
        off, dtype=torch.float32, device=x.device)


def ycbcr_to_rgb(ycc, unit_range: bool = False) -> torch.Tensor:
    """YCbCr → RGB inverse of :func:`rgb_to_ycbcr` (unclipped)."""
    off = _YCBCR_OFFSET / 255.0 if unit_range else _YCBCR_OFFSET
    x = torch.as_tensor(ycc).to(torch.float32)
    x = x - torch.as_tensor(off, dtype=torch.float32, device=x.device)
    return _mix(x, _YCBCR2RGB)
