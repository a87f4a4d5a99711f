"""One-call inference API: upscale an image with a trained model.

Port of ``sr/infer.py`` for 3-channel models that take the raw LR image
(EDSR), in float or int8: it loads exported params (the JAX package's
``.npz`` format), routes big images through halo-tiled inference,
optionally uses the fused affine tail, runs every conv as int8
(``quantize``), and can quantize the output to uint8 on the device.

    from sr_torch.infer import upscale
    sr_img = upscale(img_u8, "EDSR", "results/EDSR_x4/EDSR_params.npz",
                     scale_factor=4, quantize="static", fused=True)

Every entry point runs on ``device="cuda"`` unless the caller asks for the
CPU. 1-channel and pre-upsample models (bicubic input, chroma merge),
``self_ensemble`` and ``net_scale`` land in later port slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from sr_torch.eval.tiling import RECEPTIVE_FIELD, tiled_predict
from sr_torch.kernels.fused_tail import (
    make_fused_tail_predict, make_fused_tail_predict_quant)
from sr_torch.models.registry import get_spec
from sr_torch.quant import make_quantized_predict, to_u8
from sr_torch.utils.checkpoint import load_params
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params

_LATER = "lands in a later port slice"


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is visible."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device


def make_serving_predict(model, fused: bool, quantize: bool | str = False,
                         calib_headroom: float = 1.0,
                         output_u8: bool = False, calib_batches=None):
    """The serving-variant policy (``sr/infer.py:make_serving_predict``):
    ``fused`` collapses the affine tail (EDSR), else the exact graph runs.
    ``quantize`` runs every conv as int8: ``True``/``"dynamic"`` with
    per-sample activation scales on the exact graph; ``"static"`` with
    scales calibrated on the first batch (or ``calib_batches``), composed
    with the collapsed tail when ``fused``. ``output_u8`` quantizes the
    output to uint8 on the device. The returned function takes and returns
    NHWC tensors on the model's device."""
    if quantize:
        if quantize not in (True, "dynamic", "static"):
            raise ValueError(
                f"quantize must be False/True/'dynamic'/'static', "
                f"got {quantize!r}")
        mode = "static" if quantize == "static" else "dynamic"
        if mode == "static" and fused:
            return make_fused_tail_predict_quant(
                model, calib_headroom=calib_headroom, output_u8=output_u8,
                calib_batches=calib_batches)
        return make_quantized_predict(model, mode,
                                      calib_headroom=calib_headroom,
                                      output_u8=output_u8,
                                      calib_batches=calib_batches)
    fn = make_fused_tail_predict(model) if fused else model
    if output_u8:
        return lambda x: to_u8(fn(x))
    return fn


@functools.lru_cache(maxsize=8)
def _load(model_name: str, params_path: str, params_mtime: float,
          scale_factor: int, num_channels: int | None, dtype: str,
          fused: bool, quantize: bool | str, output_u8: bool,
          calib_headroom: float, device: torch.device):
    # params_mtime keys the cache so a re-exported file at the same path
    # is picked up instead of serving stale weights
    del params_mtime
    spec = get_spec(model_name)
    channels = num_channels or spec.default_channels
    if spec.pre_upsample or channels != 3:
        raise NotImplementedError(
            f"{model_name} with {channels} channels (bicubic input / chroma "
            f"merge) {_LATER}")
    cfg = SRConfig(model_name=model_name, scale_factor=scale_factor,
                   num_channels=channels, dtype=dtype)
    model = spec.make_model(cfg)
    params, batch_stats = load_params(params_path)
    if batch_stats is not None:
        raise NotImplementedError(f"batch-norm models {_LATER}")
    from_jax_params(model, params)
    model = model.to(device).eval()
    # a static predict keeps its calibration in the cached function, so
    # later requests reuse the first request's scales, as in sr.infer
    return make_serving_predict(model, fused, quantize,
                                calib_headroom=calib_headroom,
                                output_u8=output_u8)


def upscale(
    img: np.ndarray,
    model_name: str,
    params_path: str,
    scale_factor: int = 4,
    num_channels: int | None = None,
    dtype: str = "bfloat16",
    tile: int | None = 256,
    fused: bool = False,
    quantize: bool | str = False,
    output_u8: bool = True,
    calib_headroom: float = 1.25,
    self_ensemble: bool = False,
    net_scale: int | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Super-resolve a uint8 (H, W[, C]) image → uint8 (rH, rW, 3).

    ``tile``: route images larger than this through exact halo-tiled
    inference (None = always full-image). ``fused``: use the collapsed
    affine tail (interior-identical, faster; ``sr_torch/kernels/
    fused_tail.py``). ``quantize``: int8 convs (``sr_torch/quant.py``):
    ``True``/``"dynamic"`` or ``"static"``, which calibrates activation
    scales on the first image (the first chunk of tiles) and composes with
    ``fused=True``; ``calib_headroom`` multiplies those scales, a clip
    margin for inputs hotter than the first. ``output_u8`` (default on):
    quantize to uint8 on the device, bit-equal to the host conversion. A
    3-channel model takes the image in whatever color space it was trained
    in. ``device`` defaults to the card; pass ``"cpu"`` for the plain
    PyTorch versions of the kernels.
    """
    if self_ensemble or net_scale:
        raise NotImplementedError(f"self_ensemble / net_scale {_LATER}")
    device = resolve_device(device)
    fn = _load(model_name, params_path, os.path.getmtime(params_path),
               scale_factor, num_channels, dtype, fused, quantize, output_u8,
               calib_headroom, device)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=2)
    x = torch.from_numpy(img.astype(np.float32)[None] / 255.0).to(device)
    halo = RECEPTIVE_FIELD.get(model_name.lower(), 48)
    with torch.inference_mode():
        if tile is not None and max(x.shape[1], x.shape[2]) > tile:
            out = tiled_predict(fn, x, scale_factor, tile=tile, halo=halo)
        else:
            out = fn(x)
        out = out[0].cpu()
    if out.dtype == torch.uint8:  # device already quantized (output_u8)
        return out.numpy()
    return np.clip(np.round(out.float().numpy() * 255.0),
                   0, 255).astype(np.uint8)
