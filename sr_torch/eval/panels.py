"""Result rendering: loss curves and bicubic | SR | GT comparison panels.

Port of ``sr/eval/panels.py`` (the reference's ``utils.py:plot_loss``,
``plot_test_result`` and ``save_img``). ``to_displayable`` and ``save_img``
give the JAX package's pixels: 1-channel images repeat to gray RGB, YCbCr
goes to RGB through :func:`sr_torch.eval.metrics.ycbcr_to_rgb`, rounded and
clipped to uint8, and Pillow writes the PNG.

The JAX package draws its loss curve and panels with matplotlib; the port
draws them with Pillow's ``ImageDraw`` alone, so that rendering needs no
plotting library. A panel's frame, titles and text therefore differ in
their pixels from matplotlib's; the three images inside it do not: each is
pasted at its own size, pixel for pixel the displayable image, at the
offsets :func:`panel_offsets` gives (matplotlib resamples them to its axes).
"""

from __future__ import annotations

import math
import os

import numpy as np

PANEL_MARGIN = 10  # px around and between the images
PANEL_TITLE = 36  # px of title band above the images (two text lines)


def _ycc_to_rgb_u8(img: np.ndarray) -> np.ndarray:
    from sr_torch.eval.metrics import ycbcr_to_rgb

    rgb = ycbcr_to_rgb(img.astype(np.float32)).numpy()
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def to_displayable(img: np.ndarray, color_space: str = "ycbcr") -> np.ndarray:
    """uint8 HWC (1 or 3 channels) → RGB/gray uint8 for rendering."""
    if img.shape[-1] == 1:
        return np.repeat(img, 3, axis=-1)
    if color_space == "ycbcr":
        return _ycc_to_rgb_u8(img)
    return img


def save_img(img: np.ndarray, path: str, color_space: str = "ycbcr") -> None:
    """(reference: utils.py:save_img)"""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(to_displayable(img, color_space)).save(path)


def plot_loss(losses: list[float], path: str, title: str = "training loss",
              size: tuple[int, int] = (600, 400)) -> None:
    """(reference: utils.py:plot_loss) The losses as a polyline over their
    index, with the title, the axis names and the y range as text."""
    from PIL import Image, ImageDraw

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    w, h = size
    img = Image.new("RGB", size, "white")
    d = ImageDraw.Draw(img)
    left, top, right, bottom = 70, 30, w - 20, h - 40
    d.rectangle((left, top, right, bottom), outline="black")
    d.text((left, 8), title, fill="black")
    d.text(((left + right) // 2 - 15, bottom + 18), "epoch", fill="black")
    d.text((8, (top + bottom) // 2), "loss", fill="black")
    ys = [float(v) for v in losses if math.isfinite(float(v))]
    if ys:
        lo, hi = min(ys), max(ys)
        span = (hi - lo) or 1.0
        d.text((8, top), f"{hi:.4g}", fill="black")
        d.text((8, bottom - 10), f"{lo:.4g}", fill="black")
        n = max(len(ys) - 1, 1)
        pts = [(left + (right - left) * i / n,
                bottom - (bottom - top) * (v - lo) / span)
               for i, v in enumerate(ys)]
        if len(pts) == 1:
            x, y = pts[0]
            d.ellipse((x - 2, y - 2, x + 2, y + 2), fill="blue")
        else:
            d.line(pts, fill="blue", width=2)
    img.save(path)


def panel_offsets(images: list[np.ndarray]) -> list[tuple[int, int]]:
    """The (row, column) of each image's top-left pixel in a panel."""
    out, x = [], PANEL_MARGIN
    for im in images:
        out.append((PANEL_TITLE, x))
        x += im.shape[1] + PANEL_MARGIN
    return out


def plot_test_result(
    bicubic: np.ndarray,
    sr: np.ndarray,
    hr: np.ndarray,
    path: str,
    psnr_bicubic: float | None = None,
    psnr_sr: float | None = None,
    color_space: str = "ycbcr",
) -> None:
    """bicubic | SR | ground-truth panel with PSNR captions.

    (reference: utils.py:plot_test_result)
    """
    from PIL import Image, ImageDraw

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    imgs = [to_displayable(im, color_space) for im in (bicubic, sr, hr)]
    titles = [
        "Bicubic" + (f"\n{psnr_bicubic:.2f} dB"
                     if psnr_bicubic is not None else ""),
        "SR" + (f"\n{psnr_sr:.2f} dB" if psnr_sr is not None else ""),
        "Ground truth",
    ]
    offsets = panel_offsets(imgs)
    width = offsets[-1][1] + imgs[-1].shape[1] + PANEL_MARGIN
    height = PANEL_TITLE + max(im.shape[0] for im in imgs) + PANEL_MARGIN
    panel = Image.new("RGB", (width, height), "white")
    d = ImageDraw.Draw(panel)
    for im, title, (row, col) in zip(imgs, titles, offsets):
        d.multiline_text((col, 4), title, fill="black")
        panel.paste(Image.fromarray(np.ascontiguousarray(im)), (col, row))
    panel.save(path)
