"""Datasets: the procedural ``synthetic`` set, folders of images, and the
training and test sets by name.

Port of ``sr/data/datasets.py`` with the reference's directory conventions
(reference: data.py:get_training_set, data.py:get_test_set):

  * BSDS300 lives at ``<root>/BSDS300/images/{train,test}``;
  * named test sets (Set5, Set14, BSD100, Urban100) live at
    ``<root>/test/<name>``.

:class:`SyntheticDataset` is a numpy copy that makes the same uint8 images,
bit for bit, from the same seed, so tests and the smoke run need no
download. The port never downloads: BSDS300 must be extracted beforehand.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from sr_torch.data.decode import list_images, load_img



def _bsds300(data_dir: str) -> str:
    """The extracted ``BSDS300/images`` directory; raises if it is absent,
    since the port never downloads."""
    root = os.path.join(data_dir, "BSDS300", "images")
    if not os.path.isdir(root):
        raise RuntimeError(
            f"BSDS300 not found at {root}: download and extract "
            f"BSDS300-images.tgz into {data_dir} beforehand (sr_torch "
            "never downloads), or use 'synthetic' / 'procedural'")
    return root


@dataclass
class FolderDataset:
    """All images of a folder, decoded once to uint8 host arrays."""

    paths: list[str]
    color_space: str = "ycbcr"

    def __post_init__(self):
        self._cache: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        if i not in self._cache:
            self._cache[i] = load_img(self.paths[i], self.color_space)
        return self._cache[i]

    @property
    def names(self) -> list[str]:
        return [os.path.splitext(os.path.basename(p))[0] for p in self.paths]


@dataclass
class SyntheticDataset:
    """Deterministic procedural natural-ish images: sums of oriented
    sinusoids plus smoothed noise, quantized to uint8."""

    num_images: int = 16
    size: tuple[int, int] = (128, 128)
    channels: int = 3
    seed: int = 0

    def __len__(self) -> int:
        return self.num_images

    def __getitem__(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + i)
        h, w = self.size
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        img = np.zeros((h, w, self.channels))
        for _ in range(6):
            fx, fy = rng.uniform(0.01, 0.2, size=2)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(10, 40)
            wave = amp * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
            img += wave[..., None] * rng.uniform(0.3, 1.0, size=self.channels)
        # smoothed noise for texture
        noise = rng.normal(0, 20, size=(h, w, self.channels))
        k = np.array([0.25, 0.5, 0.25])
        for ax in (0, 1):
            noise = np.apply_along_axis(
                lambda v: np.convolve(v, k, mode="same"), ax, noise
            )
        img = img + noise + 128.0
        return np.clip(img, 0, 255).astype(np.uint8)

    @property
    def names(self) -> list[str]:
        return [f"synthetic_{i:03d}" for i in range(self.num_images)]


def procedural_split(split: str, color_space: str = "ycbcr"):
    """The procedural corpus's ``split``, not yet generated: 512 ('train')
    or 128 ('test') images at 384², seed 0 (the splits draw disjoint PRNG
    streams). ``get_training_set`` and ``get_test_set`` return it for
    'procedural', materialized through :func:`procedural_cache`; calling
    ``materialize`` on it there first (with ``workers``) fills their
    cache."""
    from sr_torch.data.procedural import ProceduralDataset

    return ProceduralDataset(
        num_images={"train": 512, "test": 128}[split], size=(384, 384),
        seed=0, split=split, color_space=color_space)


def procedural_cache(data_dir: str) -> str:
    """Where the procedural splits of ``data_dir`` are cached."""
    return os.path.join(data_dir, "procedural_cache")


def get_training_set(data_dir: str, datasets: list[str] | str,
                     color_space: str = "ycbcr"):
    """Training dataset by name(s). (reference: data.py:get_training_set)

    ``'synthetic'`` → 32 synthetic images at 160² (seed 0);
    ``'procedural'`` → the 512-image 384² train split (seed 0), generated
    once and cached under ``data_dir/procedural_cache`` with the JAX
    package's file name; either stands alone. ``'bsds300'`` → the
    extracted ``BSDS300/images/train`` (never downloaded); any other name →
    the images of ``data_dir/train/<name>``. Several folder names
    concatenate into one :class:`FolderDataset`.
    """
    if isinstance(datasets, str):
        datasets = [datasets]
    paths: list[str] = []
    for name in datasets:
        lname = name.lower()
        if lname in ("synthetic", "procedural"):
            if len(datasets) > 1:
                raise ValueError(
                    f"'{lname}' is a standalone dataset and cannot be "
                    f"concatenated with {[d for d in datasets if d != name]}"
                )
            if lname == "procedural":
                return procedural_split("train", color_space).materialize(
                    procedural_cache(data_dir))
            return SyntheticDataset(num_images=32, size=(160, 160), seed=0)
        if lname == "bsds300":
            paths += list_images(os.path.join(_bsds300(data_dir), "train"))
        else:
            paths += list_images(os.path.join(data_dir, "train", name))
    if not paths:
        raise RuntimeError(
            f"no training images found for {datasets} in {data_dir}")
    return FolderDataset(paths, color_space)


def get_test_set(data_dir: str, dataset: str, color_space: str = "ycbcr"):
    """Test dataset by name. (reference: data.py:get_test_set)

    'synthetic' → 5 synthetic images at 128² (seed 7); 'procedural' → 128
    held-out images at 384², generated once and cached under
    ``data_dir/procedural_cache``; 'bsds300' → the extracted
    ``BSDS300/images/test``; otherwise ``data_dir/test/<name>``.
    """
    lname = dataset.lower()
    if lname == "synthetic":
        return SyntheticDataset(num_images=5, size=(128, 128), seed=7)
    if lname == "procedural":
        return procedural_split("test", color_space).materialize(
            procedural_cache(data_dir))
    if lname == "bsds300":
        return FolderDataset(
            list_images(os.path.join(_bsds300(data_dir), "test")),
            color_space)
    return FolderDataset(list_images(os.path.join(data_dir, "test", dataset)),
                         color_space)
