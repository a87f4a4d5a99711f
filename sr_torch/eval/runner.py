"""Evaluation harness: the reference's ``model.test()`` conventions.

Port of ``sr/eval/runner.py``. Per test image (reference: each wrapper's
``test`` + dataset.py test branch):

  1. modulo-crop the HR image to a multiple of the scale factor;
  2. degrade to LR with BIT-EXACT Pillow bicubic (``sr_torch/data/native.py``,
     the native library or its numpy twin);
  3. bicubic-upscale the LR back up (eval baseline + pre-upsample input);
  4. run the model on the device; de-normalize; report Y-channel PSNR and
     SSIM after shaving ``scale_factor`` border pixels — for BOTH the model
     output and the bicubic baseline.

1-channel models operate on Y of YCbCr; chroma is bicubic-upscaled and
merged back for the kept images (reference behavior). The model's metrics
are computed on the host in float64, or on the device in float32
(``on_device_metrics``), where only two scalars leave the card.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from sr_torch.data.native import resize_bicubic_u8
from sr_torch.eval.metrics import (
    modulo_crop, psnr, rgb_to_ycbcr, ssim, ssim_device)
from sr_torch.eval.tiling import RECEPTIVE_FIELD, tiled_predict
from sr_torch.utils.device import resolve_device


@dataclass
class ImageResult:
    name: str
    psnr_sr: float
    psnr_bicubic: float
    ssim_sr: float | None = None  # SSIM (host path f64 / device path f32)
    ssim_bicubic: float | None = None
    sr: np.ndarray | None = None  # uint8 HWC (render channels)
    bicubic: np.ndarray | None = None
    hr: np.ndarray | None = None


@dataclass
class EvalResult:
    dataset: str
    scale_factor: int
    images: list[ImageResult] = field(default_factory=list)

    @property
    def avg_psnr_sr(self) -> float:
        return float(np.mean([r.psnr_sr for r in self.images]))

    @property
    def avg_psnr_bicubic(self) -> float:
        return float(np.mean([r.psnr_bicubic for r in self.images]))

    def summary(self) -> dict:
        return {
            "dataset": self.dataset,
            "scale_factor": self.scale_factor,
            "num_images": len(self.images),
            "psnr_sr": round(self.avg_psnr_sr, 4),
            "psnr_bicubic": round(self.avg_psnr_bicubic, 4),
            **self._ssim_summary(),
        }

    def _ssim_summary(self) -> dict:
        """Mean SSIM over the images that have it (images whose shaved
        size is under the 11×11 window carry None — they are excluded
        from the mean, not allowed to suppress the metric)."""
        pairs = [(r.ssim_sr, r.ssim_bicubic) for r in self.images
                 if r.ssim_sr is not None]
        if not pairs:
            return {}
        out = {
            "ssim_sr": round(float(np.mean([p[0] for p in pairs])), 4),
            "ssim_bicubic": round(float(np.mean([p[1] for p in pairs])), 4),
        }
        if len(pairs) != len(self.images):
            out["ssim_images"] = len(pairs)
        if out["ssim_sr"] > 1.0001 or out["ssim_bicubic"] > 1.0001:
            # impossible for a correct SSIM: the signature of low-precision
            # blurs in the device metric (metrics.ssim_device)
            print(f"[eval] WARNING: SSIM > 1 ({out}) — device-metric "
                  "precision bug; values are invalid", file=sys.stderr)
        return out


def _rgb_to_y(rgb_u8: np.ndarray) -> np.ndarray:
    y = rgb_to_ycbcr(torch.from_numpy(rgb_u8.astype(np.float32)))[..., 0]
    return y.numpy().astype(np.float64)


def _device_y_metrics(sr: torch.Tensor, hr_u8: np.ndarray, channels: int,
                      color_space: str, border: int):
    """Y-channel PSNR + SSIM of the SR output, computed on its device;
    only the scalars leave it.

    Equal to the host path up to float32 reduction error (≤1e-4 dB PSNR,
    ≤1e-5 SSIM on real image sizes). SSIM is None when the shaved image is
    smaller than the 11×11 window (host-path convention).
    """
    if sr.dtype == torch.uint8:  # predict emits u8 (sr_torch.quant.to_u8)
        sr_u8f = sr.to(torch.float32)
    else:
        sr_u8f = torch.clamp(torch.round(sr.to(torch.float32) * 255.0), 0, 255)
    hr = torch.tensor(hr_u8, device=sr.device).to(torch.float32)
    if channels != 1 and color_space == "rgb":
        y_sr = rgb_to_ycbcr(sr_u8f)[..., 0]
        y_hr = rgb_to_ycbcr(hr)[..., 0]
    else:  # 1 channel or a YCbCr-encoded set: channel 0 is Y
        y_sr, y_hr = sr_u8f[..., 0], hr[..., 0]
    if border:
        y_sr = y_sr[..., border:-border, border:-border]
        y_hr = y_hr[..., border:-border, border:-border]
    mse = torch.mean((y_sr - y_hr) ** 2)
    val = 20.0 * torch.log10(255.0 / torch.sqrt(torch.clamp_min(mse, 1e-20)))
    # match the host path on perfect reconstruction (inf, not ~248 dB)
    p = torch.where(mse == 0.0, torch.full_like(val, float("inf")), val)
    if y_sr.shape[0] >= 11 and y_sr.shape[1] >= 11:
        p, s = torch.stack([p, ssim_device(y_sr, y_hr)]).tolist()
        return p, s
    return float(p), None


def _pad_plan(ih: int, iw: int, win: int, halo: int) -> tuple[bool, bool, bool]:
    """Shape-bucketing decision for one model input: (pad_h, pad_w,
    fallback). A dim below the tiling window is zero-padded up to it
    unless fewer than 8 valid model-input pixels would survive the
    halo shave (dim ≤ halo+7) — those images run native-size."""
    pad_h, pad_w = ih < win, iw < win
    fallback = (pad_h and ih - halo < 8) or (pad_w and iw - halo < 8)
    return pad_h and not fallback, pad_w and not fallback, fallback


def _prep_eval_image(img, r: int, channels: int, pre_upsample: bool):
    """The harness's per-image input contract (reference:
    dataset.py:DatasetFromFolder test mode): modulo-crop → exact bicubic
    LR → bicubic-up baseline → normalized model input. Returns
    ``(hr, bicubic, model_in_u8, x)`` with ``x`` a (1,h,w,C) float32
    [0,1] numpy batch shaped exactly as ``evaluate`` feeds ``predict_fn``."""
    if img.ndim == 2:
        img = img[:, :, None]
    hr = modulo_crop(img, r)
    h, w = hr.shape[:2]
    lr = resize_bicubic_u8(hr, (h // r, w // r))
    bc = resize_bicubic_u8(lr, (h, w))
    if channels == 1:
        model_in = (bc if pre_upsample else lr)[..., :1]
    else:
        model_in = bc if pre_upsample else lr
        if model_in.shape[-1] == 1:
            model_in = np.repeat(model_in, 3, axis=2)
    return hr, bc, model_in, model_in.astype(np.float32)[None] / 255.0


def eval_model_inputs(dataset, scale_factor: int, channels: int,
                      pre_upsample: bool, device: str | torch.device = "cuda"):
    """Yield every image's model input exactly as ``evaluate`` feeds it, as
    a tensor on ``device`` — the calibration corpus for static int8
    (``sr_torch.quant.calibrate_scales_batches``)."""
    device = resolve_device(device)
    for i in range(len(dataset)):
        x = _prep_eval_image(dataset[i], scale_factor, channels,
                             pre_upsample)[3]
        yield torch.from_numpy(x).to(device)


def _static_predict(predict_fn, tile: int, halo: int, net_scale: int,
                    fallback_shapes: set):
    """``predict_fn`` through halo-tiled inference at one window shape:
    inputs under the window are zero-padded right/bottom up to it (top/left
    stay flush, so the network's own SAME boundary applies there as in the
    unpadded forward), bigger ones tile at ``max_tiles_per_call=8`` with
    every call full; the output is cropped back. Inputs too small to pad
    run native-size and are recorded in ``fallback_shapes``."""
    win = tile + 2 * halo

    def run(x):
        ih, iw = x.shape[1], x.shape[2]
        pad_h, pad_w, fallback = _pad_plan(ih, iw, win, halo)
        if fallback:
            fallback_shapes.add((ih, iw))
        elif pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, max(win - iw, 0), 0, max(win - ih, 0)))
        out = tiled_predict(predict_fn, x, net_scale, tile=tile, halo=halo,
                            max_tiles_per_call=8, fixed_chunk=True)
        return out[:, : ih * net_scale, : iw * net_scale]

    return run


def evaluate(
    predict_fn,
    dataset,
    scale_factor: int,
    channels: int = 1,
    pre_upsample: bool = False,
    dataset_name: str = "",
    shave_border: int | None = None,
    keep_images: bool = False,
    color_space: str = "ycbcr",
    on_device_metrics: bool = False,
    static_shapes: bool = False,
    tile: int = 96,
    model_name: str = "",
    device: str | torch.device = "cuda",
) -> EvalResult:
    """Run the harness over a FolderDataset/SyntheticDataset/
    ProceduralDataset.

    ``predict_fn(x)`` maps a (1,h,w,channels) float32 [0,1] tensor on
    ``device`` to the SR output tensor on that device (float in [0,1], or
    uint8). ``device`` defaults to the card; pass ``"cpu"`` for the plain
    PyTorch versions of the kernels. ``color_space`` describes how dataset
    images are encoded ('ycbcr' per the reference loader, or 'rgb').
    ``on_device_metrics`` computes the SR PSNR **and SSIM** on the device
    and copies only the scalars (the SR image itself is only fetched when
    ``keep_images``).

    ``static_shapes`` routes every image through exact halo-tiled
    inference at ONE window shape (``tile + 2·halo``) and one batch shape
    per route, so a mixed-size dataset runs at a fixed set of shapes.
    Equal to the direct forward because the halo covers the model's
    receptive field (``model_name`` selects it from
    ``sr_torch.eval.tiling.RECEPTIVE_FIELD``). Images smaller than the
    window are zero-padded on the RIGHT/BOTTOM and the output cropped
    back; their metrics cover the VALID region only (the ≤halo-wide band
    along a padded edge saw the pad, not the network's own boundary).
    Images so small that fewer than 8 valid model-input pixels would
    remain (dim ≤ halo+7) run native-size, reported by a message.
    """
    device = resolve_device(device)
    r = scale_factor
    border = r if shave_border is None else shave_border
    res = EvalResult(dataset_name or getattr(dataset, "name", "test"), r)

    net_scale = 1 if pre_upsample else scale_factor
    if static_shapes:
        halo = RECEPTIVE_FIELD.get(model_name.lower(), 48)
        win = tile + 2 * halo
        fallback_shapes: set = set()
        predict_fn = _static_predict(predict_fn, tile, halo, net_scale,
                                     fallback_shapes)

    names = dataset.names
    for i in range(len(dataset)):
        hr, bc, model_in, x = _prep_eval_image(
            dataset[i], r, channels, pre_upsample)
        with torch.inference_mode():
            sr_dev = predict_fn(torch.from_numpy(x).to(device))

        # metric region for shape-bucketed padded images: drop the
        # ≤halo-wide output band along each PADDED edge; everything else
        # equals the unpadded forward by conv locality. vh/vw stay None
        # (full image) for unpadded images.
        vh = vw = None
        if static_shapes:
            ih, iw = model_in.shape[:2]
            pad_h, pad_w, _ = _pad_plan(ih, iw, win, halo)
            if pad_h:
                vh = (ih - halo) * net_scale
            if pad_w:
                vw = (iw - halo) * net_scale
        hr_v, bc_v = hr[:vh, :vw], bc[:vh, :vw]
        rgb = channels != 1 and color_space == "rgb"

        if on_device_metrics and not keep_images:
            hr_cmp = hr_v[..., :1] if channels == 1 else hr_v
            p_sr, s_sr = _device_y_metrics(sr_dev[0][:vh, :vw], hr_cmp,
                                           channels, color_space, border)
            if rgb:
                y_hr, y_bc = _rgb_to_y(hr_v), _rgb_to_y(bc_v)
            else:
                y_hr = hr_v[..., 0].astype(np.float64)
                y_bc = bc_v[..., 0].astype(np.float64)
            p_bc = psnr(y_bc, y_hr, border=border)
            try:
                s_bc = ssim(y_bc, y_hr, border=border)
            except ValueError:  # smaller than the 11x11 SSIM window
                s_bc = None
            res.images.append(
                ImageResult(names[i], p_sr, p_bc, ssim_sr=s_sr,
                            ssim_bicubic=s_bc)
            )
            continue

        sr = sr_dev[0].cpu()
        if sr.dtype == torch.uint8:  # predict emits u8 (sr_torch.quant.to_u8)
            sr_u8 = sr.numpy()
        else:
            sr_u8 = np.clip(np.round(sr.float().numpy() * 255.0),
                            0, 255).astype(np.uint8)
        sr_v = sr_u8[:vh, :vw]

        # --- PSNR on Y (the reference's parity metric) ----------------
        if rgb:
            y_hr, y_bc, y_sr = map(_rgb_to_y, (hr_v, bc_v, sr_v))
        else:  # 1 channel or a YCbCr-encoded set: channel 0 is Y
            y_hr, y_bc, y_sr = (
                hr_v[..., 0].astype(np.float64),
                bc_v[..., 0].astype(np.float64),
                sr_v[..., 0].astype(np.float64),
            )
        p_sr = psnr(y_sr, y_hr, border=border)
        p_bc = psnr(y_bc, y_hr, border=border)
        try:
            s_sr = ssim(y_sr, y_hr, border=border)
            s_bc = ssim(y_bc, y_hr, border=border)
        except ValueError:  # image smaller than the 11x11 SSIM window
            s_sr = s_bc = None

        rendered = None
        if keep_images:
            if channels == 1 and hr.shape[-1] == 3:
                # merge SR Y with bicubic chroma (reference render path)
                rendered = np.concatenate([sr_u8[..., :1], bc[..., 1:]], axis=-1)
            else:
                rendered = sr_u8
        res.images.append(
            ImageResult(
                names[i], p_sr, p_bc,
                ssim_sr=s_sr, ssim_bicubic=s_bc,
                sr=rendered,
                bicubic=bc if keep_images else None,
                hr=hr if keep_images else None,
            )
        )
    if static_shapes and fallback_shapes:
        print(
            f"[eval] static_shapes: {len(fallback_shapes)} distinct "
            f"input shape(s) were too small to pad-and-mask (≤{halo + 7}px "
            f"against a {halo}px receptive-field halo) and ran native-size "
            "forwards"
        )
    return res
