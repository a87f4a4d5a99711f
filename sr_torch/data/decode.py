"""Host-side image decode: files → uint8 numpy arrays.

Port of ``sr/data/decode.py``. Only decoding happens on the host (PIL);
the eval harness degrades, predicts and scores from these arrays.
(reference: dataset.py:is_image_file, dataset.py:load_img)
"""

from __future__ import annotations

import os

import numpy as np

_IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm", ".pgm",
                   ".tif", ".tiff")


def is_image_file(filename: str) -> bool:
    """(reference: dataset.py:is_image_file)"""
    return filename.lower().endswith(_IMG_EXTENSIONS)


def load_img(path: str, color_space: str = "ycbcr") -> np.ndarray:
    """Decode an image file to a uint8 (H, W, C) array.

    ``color_space``: 'ycbcr' (PIL convert('YCbCr'), the reference's eval
    convention — reference: dataset.py:load_img), 'rgb', or 'y' (Y channel
    only, shape (H, W, 1)).
    """
    from PIL import Image

    with Image.open(path) as im:
        if color_space == "rgb":
            arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
        elif color_space in ("ycbcr", "y"):
            arr = np.asarray(im.convert("YCbCr"), dtype=np.uint8)
            if color_space == "y":
                arr = arr[:, :, :1]
        else:
            raise ValueError(f"unknown color_space {color_space!r}")
    return arr


def list_images(directory: str) -> list[str]:
    """Sorted image paths under a directory (non-recursive)."""
    return sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if is_image_file(f)
    )
