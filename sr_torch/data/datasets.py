"""Training corpora: the procedural ``synthetic`` set.

Port of the part of ``sr/data/datasets.py`` that the training slice needs.
:class:`SyntheticDataset` is a numpy copy that makes the same uint8 images,
bit for bit, from the same seed, so tests and the smoke run train on data
without a download. The folder datasets (BSDS300, named test sets) and the
``procedural`` corpus come with the eval slice and raise here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_LATER = "lands in a later port slice (eval)"


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


def get_training_set(data_dir: str, datasets: list[str] | str,
                     color_space: str = "ycbcr") -> SyntheticDataset:
    """Training dataset by name: ``'synthetic'`` (32 images at 160², seed
    0, as in the JAX package). ``data_dir`` and ``color_space`` serve the
    folder datasets, which raise until their slice lands."""
    del data_dir, color_space
    if isinstance(datasets, str):
        datasets = [datasets]
    if [d.lower() for d in datasets] == ["synthetic"]:
        return SyntheticDataset(num_images=32, size=(160, 160), seed=0)
    raise NotImplementedError(
        f"training set {datasets!r} {_LATER} (the port trains on "
        "'synthetic' for now; nothing is downloaded)")
