"""On-device training pipeline: a uint8 image bank and a patch sampler.

Port of ``sr/data/pipeline.py``. The whole corpus is decoded once on the
host, orientation-normalized, stacked and placed on the device as uint8.
Each batch is then made on the device from a ``torch.Generator`` on the
bank's device, with no host work and no host sync:

* :meth:`PatchPipeline.draw` takes the batch's random numbers from the
  generator: per sample an image index, a random-scale index, a top/left
  corner (uniform over the *unpadded* extent for that scale's patch size),
  a rot90 count and a horizontal flip.
* :meth:`PatchPipeline.transform` is a deterministic function of the bank
  and those draws: one gather of a max-patch square per sample (index
  tensors, not a Python loop), the random-scale resize as a batched pair
  of products with the draw's zero-padded Pillow-parity matrix (width pass,
  clamp to [0, 255], height pass, clamp), rot90 then flip, the bicubic LR
  degradation, and division by 255 in the pipeline's dtype. A
  pre-upsample pipeline adds ``bc``, the LR bicubic-upscaled back to the
  crop (the input of SRCNN, VDSR and DRCN). With ``scale_factors`` each
  sample draws its own factor and the batch holds ``hr`` and ``bc`` only
  (``bc`` keeps one shape across factors); every factor's ``bc`` is
  computed for the whole batch and each sample picks its own, as the JAX
  sampler's ``lax.switch`` under ``vmap`` does. Pillow clamps after the
  width pass, so the down- and up-resize stay two separate resizes.

The JAX sampler draws with ``jax.random`` and the port with a
``torch.Generator``: the numbers differ, the distributions do not. The tests
feed JAX's draws to :meth:`transform` and hold it against ``PatchPipeline``.

The three ``random_scale_mode`` values differ in the draw only. 'item' and
'matrix' draw a scale per sample, 'batch' one per batch. The JAX package's
'item'/'batch' slice exactly p×p and resize it; 'matrix' edge-pads the bank
and slices a max-patch square whose extra rows and columns meet zero weights.
The port does the latter for all three: clamping the gather's indices to the
image is the edge padding, and a zero-padded matrix computes the p×p resize
(for scale 1.0, an identity that copies exactly).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from sr_torch.kernels.bicubic import resize2d, resize_matrix
from sr_torch.utils.device import resolve_device

RANDOM_SCALES = (1.0, 0.9, 0.8, 0.7, 0.6, 0.5)


def stack_corpus(images: list[np.ndarray], channels: int) -> np.ndarray:
    """Orientation-normalize + center-crop a corpus to a common (N,H,W,C).

    Portrait images are rotated 90° (rotation is part of the augmentation
    menu anyway), then all images are center-cropped to the minimum
    common size.
    """
    normed = []
    for im in images:
        if im.ndim == 2:
            im = im[:, :, None]
        if im.shape[0] > im.shape[1]:
            im = np.rot90(im, axes=(0, 1)).copy()
        if channels == 1 and im.shape[2] >= 1:
            im = im[:, :, :1]
        elif channels == 3 and im.shape[2] == 1:
            im = np.repeat(im, 3, axis=2)
        else:
            im = im[:, :, :channels]
        normed.append(im)
    hmin = min(im.shape[0] for im in normed)
    wmin = min(im.shape[1] for im in normed)
    out = np.stack(
        [
            im[
                (im.shape[0] - hmin) // 2 : (im.shape[0] - hmin) // 2 + hmin,
                (im.shape[1] - wmin) // 2 : (im.shape[1] - wmin) // 2 + wmin,
            ]
            for im in normed
        ]
    )
    return np.ascontiguousarray(out)


def augment(hr: torch.Tensor, rot: torch.Tensor, flip: torch.Tensor
            ) -> torch.Tensor:
    """Per sample ``np.rot90(x, rot)`` over (H, W), then ``x[:, ::-1]`` where
    ``flip`` is 1: one gather with per-sample index maps. hr: (B, n, n, C)."""
    b, n = hr.shape[0], hr.shape[1]
    ar = torch.arange(n, device=hr.device)
    i, j = ar.view(1, n, 1), ar.view(1, 1, n)
    j = torch.where(flip.view(-1, 1, 1) == 1, n - 1 - j, j)
    k = rot.view(-1, 1, 1)
    # rot90 by k: out[i, j] = x[src_i, src_j]
    src_i = torch.where(k == 0, i, torch.where(
        k == 1, j, torch.where(k == 2, n - 1 - i, n - 1 - j)))
    src_j = torch.where(k == 0, j, torch.where(
        k == 1, n - 1 - i, torch.where(k == 2, n - 1 - j, i)))
    return hr[torch.arange(b, device=hr.device).view(-1, 1, 1), src_i, src_j]


@dataclass
class PatchPipeline:
    """(lr, hr) patch-batch sampler over a device-resident corpus.

    Args mirror the JAX pipeline's: ``crop_size`` (HR patch),
    ``scale_factor``, ``batch_size``, ``channels`` (1 = Y, 3 = RGB),
    ``augment`` (rot/flip), ``random_scale`` and ``random_scale_mode``.
    ``pre_upsample`` adds the bicubic-upscaled LR ``bc``; ``scale_factors``
    (which needs it) draws each sample's factor from the tuple and gives
    ``{"hr", "bc"}``. ``dtype`` is the batch's dtype; ``device`` holds the
    bank and makes the batches (the card unless the caller asks for the
    CPU).
    """

    images: list[np.ndarray] | np.ndarray
    crop_size: int = 128
    scale_factor: int = 4
    batch_size: int = 32
    channels: int = 3
    augment: bool = True
    random_scale: bool = True
    random_scale_mode: str = "matrix"
    pre_upsample: bool = False
    scale_factors: tuple = ()
    dtype: torch.dtype = torch.float32
    device: str | torch.device = "cuda"
    _bank: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        if isinstance(self.images, np.ndarray):
            bank = self.images
        else:
            bank = stack_corpus(list(self.images), self.channels)
        n, h, w, c = bank.shape
        if c != self.channels:
            raise ValueError(f"corpus has {c} channels, pipeline "
                             f"{self.channels}")
        crop = self.crop_size
        max_patch = int(np.ceil(crop / min(RANDOM_SCALES)))
        if self.random_scale and max_patch > min(h, w):
            raise ValueError(
                f"crop_size {crop} with random_scale needs images "
                f"≥{max_patch}px, corpus is {h}x{w}")
        if not self.random_scale and crop > min(h, w):
            # a patch smaller than the crop would be bicubic-UPSCALED into
            # a fake HR target
            raise ValueError(
                f"crop_size {crop} exceeds the corpus ({h}x{w}); reduce "
                "crop_size (build_patch_pipeline does this automatically)")
        if crop % self.scale_factor:
            raise ValueError("crop_size must divide by scale_factor")
        if self.random_scale_mode not in ("item", "batch", "matrix"):
            raise ValueError(
                f"random_scale_mode must be 'item', 'batch' or 'matrix', "
                f"got {self.random_scale_mode!r}")
        if self.scale_factors:
            if not self.pre_upsample:
                raise ValueError(
                    "multi-scale batches need pre_upsample=True (only the "
                    "bicubic-upscaled input has a static shape across "
                    "scales)")
            for r in self.scale_factors:
                if crop % r:
                    raise ValueError(f"crop_size must divide by scale {r}")
        self.device = resolve_device(self.device)
        self._shape = (n, h, w)
        scales = RANDOM_SCALES if self.random_scale else (1.0,)
        sizes = [min(int(round(crop / s)), min(h, w)) for s in scales]
        self._sizes = torch.tensor(sizes, device=self.device)
        self._patch = max(sizes)
        # per scale a (crop, max_patch) resize matrix, zero past its own
        # patch size; None when the only scale is 1.0 (patch == crop)
        self._resize = None
        if len(scales) > 1:
            m = np.zeros((len(scales), crop, self._patch), np.float32)
            for i, p in enumerate(sizes):
                m[i, :, :p] = resize_matrix(p, crop)
            self._resize = torch.from_numpy(m).to(self.device)
        self._bank = torch.from_numpy(bank).to(self.device)

    # -- the batch: draws, then a deterministic transform ------------------

    def draw(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The batch's random numbers, (B,) int64 tensors on the bank's
        device: ``index``, ``scale`` (into :data:`RANDOM_SCALES`, or 0
        without random scale), ``top``, ``left``, ``rot`` (0-3) and
        ``flip`` (0/1; both 0 without augment), and with ``scale_factors``
        ``factor`` (into that tuple)."""
        n, h, w = self._shape
        bsz, dev = self.batch_size, self._bank.device

        def ints(hi, size=bsz):
            return torch.randint(0, hi, (size,), generator=generator,
                                 device=dev)

        index = ints(n)
        n_scales = len(self._sizes)
        if self.random_scale_mode == "batch":
            scale = ints(n_scales, 1).expand(bsz)
        else:
            scale = ints(n_scales)
        # corners uniform over [0, dim - p] for the drawn scale's patch p
        p = self._sizes[scale]
        u = torch.rand((2, bsz), generator=generator, device=dev,
                       dtype=torch.float64)
        top = torch.minimum((u[0] * (h - p + 1)).long(), h - p)
        left = torch.minimum((u[1] * (w - p + 1)).long(), w - p)
        rot, flip = ints(4), ints(2)
        if not self.augment:
            rot, flip = torch.zeros_like(rot), torch.zeros_like(flip)
        out = {"index": index, "scale": scale, "top": top, "left": left,
               "rot": rot, "flip": flip}
        if self.scale_factors:
            out["factor"] = ints(len(self.scale_factors))
        return out

    def transform(self, bank: torch.Tensor, draws: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        """{"hr": (B, crop, crop, C), "lr": (B, crop/r, crop/r, C)[, "bc":
        (B, crop, crop, C)]} in [0, 1] and the pipeline's dtype, from
        ``bank`` (N, H, W, C) uint8 and the draws of :meth:`draw` (or
        JAX's, in the tests); with ``scale_factors`` {"hr", "bc"}."""
        _, h, w = self._shape
        crop = self.crop_size
        ar = torch.arange(self._patch, device=bank.device)
        rows = (draws["top"].view(-1, 1) + ar).clamp_max(h - 1)
        cols = (draws["left"].view(-1, 1) + ar).clamp_max(w - 1)
        patch = bank[draws["index"].view(-1, 1, 1), rows.unsqueeze(2),
                     cols.unsqueeze(1)].to(torch.float32)
        if self._resize is None:
            hr = patch
        else:
            m = self._resize[draws["scale"]]  # (B, crop, max_patch)
            # width pass → clamp → height pass, Pillow's order and clamp
            t = torch.einsum("bow,bhwc->bhoc", m, patch).clamp(0.0, 255.0)
            hr = torch.einsum("boh,bhwc->bowc", m, t).clamp(0.0, 255.0)
        if self.augment:
            hr = augment(hr, draws["rot"], draws["flip"])
        if self.scale_factors:
            # every factor's degradation for the whole batch, then each
            # sample's own (the JAX sampler's switch under vmap)
            bcs = torch.stack([
                resize2d(resize2d(hr, (crop // r, crop // r)), (crop, crop))
                for r in self.scale_factors])
            bc = bcs[draws["factor"], torch.arange(hr.shape[0],
                                                   device=hr.device)]
            out = {"hr": hr, "bc": bc}
        else:
            lr_size = crop // self.scale_factor
            out = {"hr": hr, "lr": resize2d(hr, (lr_size, lr_size))}
            if self.pre_upsample:
                out["bc"] = resize2d(out["lr"], (crop, crop))
        return {k: (v / 255.0).to(self.dtype) for k, v in out.items()}

    def __call__(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """One (lr, hr[, bc]) batch dict, NHWC in [0, 1]."""
        return self.transform(self._bank, self.draw(generator))

    @property
    def bank(self) -> torch.Tensor:
        """The device-resident corpus (N, H, W, C) uint8."""
        return self._bank

    def batches(self, generator: torch.Generator, num: int | None = None
                ) -> Iterator[dict]:
        """Infinite (or ``num``-long) stream of batches."""
        i = 0
        while num is None or i < num:
            yield self(generator)
            i += 1


def build_patch_pipeline(cfg, spec, images: list[np.ndarray],
                         device: str | torch.device = "cuda") -> PatchPipeline:
    """Corpus-aware construction: reduce crop_size to fit the corpus (warn),
    turn random scale off when the 0.5× patch would not fit, drop
    multi-scale factors for a model that is not pre-upsample (warn), and
    reduce the crop to a multiple of every factor in play (warn)."""
    min_dim = min(min(im.shape[0], im.shape[1]) for im in images)
    crop = cfg.crop_size
    if crop > min_dim:
        crop = (min_dim // cfg.scale_factor) * cfg.scale_factor
        print(f"[warn] crop_size reduced to {crop} for a {min_dim}px corpus")
    random_scale = crop * 2 <= min_dim
    scale_factors = tuple(cfg.scale_factors or ())
    if scale_factors and not spec.pre_upsample:
        print(f"[warn] {cfg.model_name} is not pre-upsample; "
              "--multi_scale ignored")
        scale_factors = ()
    if scale_factors:
        # divisible by every multi-scale factor and by the config's own
        # scale_factor, which the sampler checks too
        lcm = int(np.lcm.reduce(np.array(scale_factors
                                         + (cfg.scale_factor,))))
        if crop % lcm:
            crop = (crop // lcm) * lcm
            print(f"[warn] crop_size reduced to {crop} (divisible by "
                  f"all of {scale_factors} and x{cfg.scale_factor})")
    return PatchPipeline(
        images, crop_size=crop, scale_factor=cfg.scale_factor,
        batch_size=cfg.batch_size, channels=cfg.num_channels,
        pre_upsample=spec.pre_upsample, random_scale=random_scale,
        scale_factors=scale_factors,
        random_scale_mode=cfg.random_scale_mode, device=device,
    )
