"""One-call inference API: upscale an image with a trained model.

Port of ``sr/infer.py``, in float or int8: it loads exported params (the
JAX package's ``.npz`` format), picks the input convention (the raw LR
image for EDSR, ESPCN, SRResNet and SRGAN; for the pre-upsample models
SRCNN, VDSR and DRCN the image bicubic-upscaled on the host,
``resize_bicubic_u8``, with a net whose output has its input's size),
routes big images through halo-tiled inference, optionally uses the fused
or folded tail, runs every conv as int8 (``quantize``), and can quantize
the output to uint8 on the device. Batch-norm models (SRResNet, SRGAN's
generator) load their ``batch_stats`` from the file and serve in eval
mode. A 1-channel model super-resolves the luma of an RGB (or YCbCr)
image and merges bicubic-upscaled chroma back; one full-image bicubic
upscale serves a pre-upsample model's input and the chroma.

    from sr_torch.infer import upscale
    sr_img = upscale(img_u8, "EDSR", "results/EDSR_x4/EDSR_params.npz",
                     scale_factor=4, quantize="static", fused=True)

A pyramid model (LapSRN) trained at ×``net_scale`` serves each smaller
power-of-2 scale from its intermediate level
(:func:`make_pyramid_level_predict`).

``self_ensemble`` averages the 8 D4 flips and rotations
(``sr_torch/eval/ensemble.py``) below the tiling, in float32, before the
one u8 rounding. Every entry point runs on ``device="cuda"`` unless the
caller asks for the CPU.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from sr_torch.data.native import resize_bicubic_u8
from sr_torch.eval.ensemble import (
    TRANSFORMS, make_self_ensemble_predict, transform)
from sr_torch.eval.metrics import rgb_to_ycbcr, ycbcr_to_rgb
from sr_torch.eval.tiling import RECEPTIVE_FIELD, tiled_predict
from sr_torch.kernels.fused_tail import (
    make_fused_tail_predict, make_fused_tail_predict_quant)
from sr_torch.kernels.shuffle_fold import (
    make_folded_tail_predict, make_folded_tail_predict_quant)
from sr_torch.models.registry import get_spec
from sr_torch.quant import make_quantized_predict, to_u8
from sr_torch.utils.checkpoint import load_params
from sr_torch.utils.config import SRConfig
from sr_torch.utils.device import resolve_device
from sr_torch.utils.interop import from_jax_params


def tail_kind(model) -> str | None:
    """How ``fused`` serves ``model``: ``"affine"`` for an activation-free
    pixel-shuffle tail (EDSR), which collapses to one conv; ``"folded"``
    for a tail whose stages carry an activation (SRResNet's and SRGAN's
    PReLU), whose output conv folds through the last shuffle; None for a
    model without a ``tail`` (ESPCN, SRCNN, VDSR, DRCN). The JAX package
    reaches the same routes by trying the affine collapse first."""
    if not hasattr(model, "tail"):
        return None
    affine = all(up.act in (None, "none") and up.norm is None
                 for up in model.upsample)
    return "affine" if affine else "folded"


def make_serving_predict(model, fused: bool, quantize: bool | str = False,
                         calib_headroom: float = 1.0,
                         output_u8: bool = False, calib_batches=None):
    """The serving-variant policy (``sr/infer.py:make_serving_predict``):
    ``fused`` collapses an affine tail (EDSR) and folds the output conv of
    an activation-bearing one (SRResNet, SRGAN) through the last shuffle,
    by :func:`tail_kind`; a model without a ``tail`` (ESPCN, SRCNN, VDSR,
    DRCN), or ``fused=False``, runs the exact graph: ``fused`` is a hint.
    ``quantize`` runs every conv as int8: ``True``/``"dynamic"`` with
    per-sample activation scales on the exact graph; ``"static"`` with
    scales calibrated on the first batch (or ``calib_batches``), composed
    with the collapsed or folded tail when ``fused``. ``output_u8``
    quantizes the output to uint8 on the device. The returned function
    takes and returns NHWC tensors on the model's device. Every route
    serves the model in eval mode (batch norms on their running
    statistics, as ``train=False`` in the JAX package), so this puts
    ``model`` in eval mode."""
    model.eval()
    kind = tail_kind(model) if fused else None
    if quantize:
        if quantize not in (True, "dynamic", "static"):
            raise ValueError(
                f"quantize must be False/True/'dynamic'/'static', "
                f"got {quantize!r}")
        mode = "static" if quantize == "static" else "dynamic"
        kw = dict(calib_headroom=calib_headroom, output_u8=output_u8,
                  calib_batches=calib_batches)
        if mode == "static" and kind == "affine":
            return make_fused_tail_predict_quant(model, **kw)
        if mode == "static" and kind == "folded":
            return make_folded_tail_predict_quant(model, **kw)
        return make_quantized_predict(model, mode, **kw)
    fn = {"affine": make_fused_tail_predict,
          "folded": make_folded_tail_predict}.get(kind, lambda m: m)(model)
    if output_u8:
        return lambda x: to_u8(fn(x))
    return fn


def make_pyramid_level_predict(model, spec, trained_scale: int,
                               select_scale: int, output_u8: bool = False):
    """Serve a pyramid model's intermediate ×``select_scale`` level
    (``sr/infer.py:make_pyramid_level_predict``): one net trained at
    ``trained_scale`` serves every power-of-2 scale below it from its
    deep-supervised level outputs. The exact level graph, in eval mode:
    the fused and int8 rewrites target single-output tails."""
    if not spec.multi_scale_out:
        raise ValueError(
            f"{spec.name} has no intermediate scales; net_scale "
            "only applies to pyramid models (LapSRN)")
    if select_scale & (select_scale - 1) or not (
            1 < select_scale < trained_scale):
        raise ValueError(
            f"net_scale={trained_scale} serves power-of-2 scales "
            f"2..{trained_scale // 2}, got {select_scale}")
    level = int(math.log2(select_scale)) - 1
    model.eval()

    def predict(x):
        y = model(x, all_scales=True)[level]
        return to_u8(y) if output_u8 else y

    return predict


@functools.lru_cache(maxsize=8)
def _load(model_name: str, params_path: str, params_mtime: float,
          scale_factor: int, num_channels: int | None, dtype: str,
          fused: bool, quantize: bool | str, output_u8: bool,
          calib_headroom: float, device: torch.device,
          select_scale: int | None = None):
    """``(spec, channels, predict)`` for the model at ``params_path``, built
    at ``scale_factor``; ``select_scale`` (below it) serves that pyramid
    level."""
    # params_mtime keys the cache so a re-exported file at the same path
    # is picked up instead of serving stale weights
    del params_mtime
    spec = get_spec(model_name)
    channels = num_channels or spec.default_channels
    cfg = SRConfig(model_name=model_name, scale_factor=scale_factor,
                   num_channels=channels, dtype=dtype)
    model = spec.make_model(cfg)
    params, batch_stats = load_params(params_path)
    from_jax_params(model, params, batch_stats)
    model = model.to(device).eval()
    if select_scale is not None and select_scale != scale_factor:
        if quantize:
            # the JAX package's contract: the int8 rewrites target the
            # final single-output tail, not a deep-supervised level, and a
            # refusal beats serving float under a quantize flag
            raise ValueError(
                "net_scale (pyramid level serving) does not compose "
                "with quantize — serve the exact level graph "
                "(drop --quantize) or the full-scale output")
        # fused is a hint: a pyramid has no fused tail, so the level is
        # served by its exact graph, not refused
        return spec, channels, make_pyramid_level_predict(
            model, spec, scale_factor, select_scale, output_u8=output_u8)
    # a static predict keeps its calibration in the cached function, so
    # later requests reuse the first request's scales, as in sr.infer
    return spec, channels, make_serving_predict(
        model, fused, quantize, calib_headroom=calib_headroom,
        output_u8=output_u8)


def _to_u8(y) -> np.ndarray:
    """A float [0, 255] array → uint8, rounded half to even and clipped."""
    return np.clip(np.round(np.asarray(y)), 0, 255).astype(np.uint8)


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
    color_space: str = "rgb",
    output_u8: bool = True,
    calib_headroom: float = 1.25,
    self_ensemble: bool = False,
    net_scale: int | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Super-resolve a uint8 (H, W[, C]) image → uint8 (rH, rW, C).

    ``tile``: route images larger than this through exact halo-tiled
    inference (None = always full-image). ``fused``: use the collapsed
    affine tail where the model has one (EDSR: interior-identical, faster;
    ``sr_torch/kernels/fused_tail.py``), or the output conv folded through
    the last shuffle (SRResNet, SRGAN: exact;
    ``sr_torch/kernels/shuffle_fold.py``). ``quantize``: int8 convs
    (``sr_torch/quant.py``): ``True``/``"dynamic"`` or ``"static"``, which
    calibrates activation scales on the first image (the first chunk of
    tiles) and composes with ``fused=True``; ``calib_headroom`` multiplies
    those scales, a clip margin for inputs hotter than the first.
    ``output_u8`` (default on): quantize to uint8 on the device, bit-equal
    to the host conversion. ``color_space`` declares how a 3-channel
    ``img`` is encoded ('rgb' or 'ycbcr'): a 1-channel model
    super-resolves the luma (converting from RGB when needed), merges
    bicubic-upscaled chroma back and returns the input's encoding; a
    3-channel model takes the image as it is (feed it the space it was
    trained in). ``net_scale``: the scale the params were trained at, when
    it differs from ``scale_factor``: a pyramid model (LapSRN) then serves
    the matching intermediate level of the one trained net (for example
    ``scale_factor=2, net_scale=4``); other models, other scales and
    ``quantize`` raise ``ValueError``, as in the JAX package.
    ``self_ensemble``: average the 8 D4 flip/rotation variants (the EDSR
    paper's '+' mode, 8 forwards), in float32 before the u8 rounding; a
    static int8 predict then calibrates on all 8 variants of the image (of
    a tile-sized centre crop when the image is tiled). ``device`` defaults
    to the card; pass ``"cpu"`` for the plain PyTorch versions of the
    kernels.
    """
    device = resolve_device(device)
    # with net_scale the model builds at its trained scale and the
    # predict serves the level of the requested one; ensemble members
    # stay float (the wrapper quantizes once)
    spec, channels, fn = _load(model_name, params_path,
                               os.path.getmtime(params_path),
                               net_scale or scale_factor, num_channels,
                               dtype, fused, quantize,
                               output_u8 and not self_ensemble,
                               calib_headroom, device,
                               scale_factor if net_scale else None)
    base_fn = fn
    if self_ensemble:
        fn = make_self_ensemble_predict(fn, output_u8=output_u8)
    if img.ndim == 2:
        img = img[:, :, None]
    r = scale_factor
    h, w = img.shape[:2]
    # a 1-channel model works on luma: RGB input goes to YCbCr first,
    # rounded to u8 as the JAX package rounds it
    to_rgb_out = channels == 1 and img.shape[-1] == 3 and color_space == "rgb"
    if to_rgb_out:
        img = _to_u8(rgb_to_ycbcr(img.astype(np.float32)).numpy())
    chroma = channels == 1 and img.shape[-1] == 3
    # one full-image bicubic upscale serves a pre-upsample model's input
    # and the chroma merge
    bc_full = (resize_bicubic_u8(img, (h * r, w * r))
               if spec.pre_upsample or chroma else None)
    # the network's output/input size ratio: 1 for a pre-upsample net
    model_in, out_factor = (bc_full, 1) if spec.pre_upsample else (img, r)
    if channels == 1:
        net_in = model_in[..., :1]
    else:
        net_in = (model_in if model_in.shape[-1] == 3
                  else np.repeat(model_in, 3, axis=2))
    x = torch.from_numpy(net_in.astype(np.float32)[None] / 255.0).to(device)
    tiled = tile is not None and max(x.shape[1], x.shape[2]) > tile
    if self_ensemble and hasattr(base_fn, "calibrate"):
        # static int8: the first-call calibration would see the identity
        # member only, and the others' ranges can exceed it. Calibrate on
        # all 8 D4 variants up front (a no-op once the cached predict is
        # calibrated), of a tile-sized centre crop when tiled
        cal = x
        if tiled:
            ch, cw = min(tile, x.shape[1]), min(tile, x.shape[2])
            top, left = (x.shape[1] - ch) // 2, (x.shape[2] - cw) // 2
            cal = x[:, top:top + ch, left:left + cw]
        base_fn.calibrate([transform(cal, f, k) for f, k in TRANSFORMS])
    halo = RECEPTIVE_FIELD.get(model_name.lower(), 48)
    with torch.inference_mode():
        if tiled:
            out = tiled_predict(fn, x, out_factor, tile=tile, halo=halo)
        else:
            out = fn(x)
        out = out[0].cpu()
    if out.dtype == torch.uint8:  # device already quantized (output_u8)
        sr_u8 = out.numpy()
    else:
        sr_u8 = _to_u8(out.float().numpy() * 255.0)
    if chroma:
        # the model's luma with the full-image bicubic upscale's chroma
        sr_u8 = np.concatenate([sr_u8[..., :1], bc_full[..., 1:]], axis=-1)
    if to_rgb_out:
        sr_u8 = _to_u8(ycbcr_to_rgb(sr_u8.astype(np.float32)).numpy())
    return sr_u8
