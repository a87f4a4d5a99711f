"""Procedural high-entropy SR benchmark corpus.

Port of ``sr/data/procedural.py``: the same numpy code, so image ``i`` of a
dataset is the same uint8 array, bit for bit, as the JAX package's. The
older ``SyntheticDataset`` saturates around 25.4 dB at x4: its smoothed
noise is unpredictable (no model can recover it) and its band-limited
sinusoids are trivially recoverable. These images carry STRUCTURED,
learnable high-frequency content instead:

  * multi-octave value noise with a ~1/f amplitude spectrum (natural
    backgrounds; low octaves recoverable, high octaves attenuated);
  * dozens of anti-aliased geometric shapes (rotated rectangles,
    ellipses, line segments) with flat / gradient / oriented-grating /
    square-wave fills — sharp, sub-pixel-positioned edges and textures;
  * glyph-like stroke rows (text analogue: dense thin strokes);
  * correlated RGB (shape edges aligned across channels, like natural
    images — also what Y-channel eval assumes).

No white noise is added anywhere: every pixel is a deterministic function
of geometry, so reconstruction quality is model-limited, not
noise-limited. Everything is vectorized numpy; each shape's SDF is
evaluated only on its bounding box. Image ``i`` is a pure function of
``(seed, split, i)``. The set stands in for Set5/Set14/BSDS where no
network is available.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

# split mixers: train/test draw from disjoint PRNG streams even when the
# user passes the same seed
_SPLIT_SALT = {"train": 0x5EED, "test": 0x7E57}

# bump on ANY change to the generation code — it keys the on-disk corpus
# cache (a stale cache would silently serve the old benchmark)
GEN_VERSION = 2


def _bilinear_upsample(grid: np.ndarray, h: int, w: int) -> np.ndarray:
    """(gh, gw) -> (h, w) bilinear, endpoints aligned to image corners."""
    gh, gw = grid.shape
    y = np.linspace(0, gh - 1, h)
    x = np.linspace(0, gw - 1, w)
    y0 = np.clip(y.astype(np.int64), 0, gh - 2)
    x0 = np.clip(x.astype(np.int64), 0, gw - 2)
    fy = (y - y0)[:, None]
    fx = (x - x0)[None, :]
    a = grid[y0][:, x0]
    b = grid[y0][:, x0 + 1]
    c = grid[y0 + 1][:, x0]
    d = grid[y0 + 1][:, x0 + 1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def _value_noise(rng: np.random.Generator, h: int, w: int,
                 octaves: int = 5, persistence: float = 0.55) -> np.ndarray:
    """Multi-octave value noise, ~1/f amplitude spectrum, unit-ish range."""
    out = np.zeros((h, w))
    amp, total = 1.0, 0.0
    for o in range(octaves):
        g = 4 * (2 ** o)
        if g >= min(h, w):
            break
        grid = rng.normal(size=(g + 1, g + 1))
        out += amp * _bilinear_upsample(grid, h, w)
        total += amp
        amp *= persistence
    return out / max(total, 1e-9)


def _coverage(sdf: np.ndarray) -> np.ndarray:
    """Signed distance (px) -> anti-aliased coverage in [0, 1]."""
    return np.clip(0.5 - sdf, 0.0, 1.0)


def _fill(rng: np.random.Generator, yy: np.ndarray, xx: np.ndarray,
          color: np.ndarray) -> np.ndarray:
    """A shape's interior pattern on its bbox grid -> (bh, bw, 3)."""
    kind = rng.integers(0, 4)
    if kind == 0:  # flat
        return np.broadcast_to(color, (*yy.shape, 3)).copy()
    if kind == 1:  # linear gradient toward a second color
        c2 = rng.uniform(0, 255, size=3)
        ang = rng.uniform(0, 2 * np.pi)
        t = (np.cos(ang) * xx + np.sin(ang) * yy)
        t = (t - t.min()) / max(float(np.ptp(t)), 1e-9)
        return color * (1 - t[..., None]) + c2 * t[..., None]
    # oriented grating — learnable texture. Frequencies stay mostly
    # below the x4-recoverable band (LR Nyquist = 0.125 cycles/HR-px):
    # content above it aliases away under downsampling and acts as
    # structured NOISE, capping PSNR for every model equally (measured:
    # a 0.45 cycles/px ceiling left EDSR only +0.39 dB over bicubic).
    # A small tail above keeps some genuinely hard texture.
    if rng.uniform() < 0.8:
        freq = rng.uniform(0.02, 0.11)
    else:
        freq = rng.uniform(0.11, 0.25)
    ang = rng.uniform(0, 2 * np.pi)
    phase = rng.uniform(0, 2 * np.pi)
    wave = np.sin(2 * np.pi * freq * (np.cos(ang) * xx + np.sin(ang) * yy)
                  + phase)
    if kind == 3:  # square wave (bar texture): sharp, learnable edges
        wave = np.tanh(6.0 * wave)
    c2 = rng.uniform(0, 255, size=3)
    t = (wave[..., None] + 1) / 2
    return color * (1 - t) + c2 * t


def _composite(canvas: np.ndarray, top: int, left: int,
               cov: np.ndarray, fill: np.ndarray, alpha: float) -> None:
    """Alpha-composite a bbox patch onto the canvas in place."""
    h, w = cov.shape
    view = canvas[top:top + h, left:left + w]
    a = (cov * alpha)[..., None]
    view *= (1 - a)
    view += fill * a


def _bbox_grid(h: int, w: int, cy: float, cx: float, radius: float):
    """Clipped bbox around (cy, cx) with ``radius`` margin + coord grids."""
    top = max(0, int(np.floor(cy - radius)))
    bot = min(h, int(np.ceil(cy + radius)) + 1)
    left = max(0, int(np.floor(cx - radius)))
    right = min(w, int(np.ceil(cx + radius)) + 1)
    if bot <= top or right <= left:
        return None
    yy, xx = np.mgrid[top:bot, left:right].astype(np.float64)
    return top, left, yy - cy, xx - cx


def _draw_shape(rng: np.random.Generator, canvas: np.ndarray) -> None:
    h, w, _ = canvas.shape
    kind = rng.integers(0, 3)
    cy, cx = rng.uniform(0, h), rng.uniform(0, w)
    color = rng.uniform(0, 255, size=3)
    alpha = rng.uniform(0.75, 1.0)
    if kind == 0:  # rotated rectangle
        hh, hw = rng.uniform(4, h / 4, size=2)
        ang = rng.uniform(0, np.pi)
        r = float(np.hypot(hh, hw))
        g = _bbox_grid(h, w, cy, cx, r)
        if g is None:
            return
        top, left, dy, dx = g
        ca, sa = np.cos(ang), np.sin(ang)
        u = ca * dx + sa * dy
        v = -sa * dx + ca * dy
        sdf = np.maximum(np.abs(u) - hw, np.abs(v) - hh)
    elif kind == 1:  # ellipse
        a, b = rng.uniform(4, h / 4, size=2)
        g = _bbox_grid(h, w, cy, cx, float(max(a, b)))
        if g is None:
            return
        top, left, dy, dx = g
        q = np.sqrt((dx / a) ** 2 + (dy / b) ** 2)
        sdf = (q - 1.0) * min(a, b)
    else:  # thick line segment
        length = rng.uniform(8, h / 2)
        thick = rng.uniform(0.6, 4.0)
        ang = rng.uniform(0, np.pi)
        ey, ex = np.sin(ang) * length / 2, np.cos(ang) * length / 2
        g = _bbox_grid(h, w, cy, cx, float(length / 2 + thick + 1))
        if g is None:
            return
        top, left, dy, dx = g
        t = np.clip((dx * ex + dy * ey) / (ex * ex + ey * ey + 1e-12),
                    -1, 1)
        sdf = np.hypot(dx - t * ex, dy - t * ey) - thick
    cov = _coverage(sdf)
    yy, xx = np.mgrid[0:cov.shape[0], 0:cov.shape[1]].astype(np.float64)
    _composite(canvas, top, left, cov, _fill(rng, yy, xx, color), alpha)


def _draw_glyph_rows(rng: np.random.Generator, canvas: np.ndarray) -> None:
    """Text analogue: rows of short dense strokes (high-freq structure
    with strong spatial regularity, like print on a page)."""
    h, w, _ = canvas.shape
    n_rows = rng.integers(1, 4)
    for _ in range(n_rows):
        row_y = rng.uniform(0.1 * h, 0.9 * h)
        glyph_h = rng.uniform(5, 14)
        color = rng.uniform(0, 255, size=3)
        x = rng.uniform(0, 0.2 * w)
        while x < w - 2:
            gw_ = rng.uniform(2, glyph_h * 0.8)
            for _ in range(rng.integers(1, 4)):  # strokes per glyph
                y0 = row_y + rng.uniform(-glyph_h / 2, glyph_h / 2)
                x0 = x + rng.uniform(0, gw_)
                ang = rng.choice([0.0, np.pi / 2, np.pi / 4, 3 * np.pi / 4])
                length = rng.uniform(2, glyph_h)
                thick = rng.uniform(0.5, 1.2)
                ey, ex = (np.sin(ang) * length / 2,
                          np.cos(ang) * length / 2)
                g = _bbox_grid(h, w, y0, x0,
                               float(length / 2 + thick + 1))
                if g is None:
                    continue
                top, left, dy, dx = g
                t = np.clip((dx * ex + dy * ey)
                            / (ex * ex + ey * ey + 1e-12), -1, 1)
                sdf = np.hypot(dx - t * ex, dy - t * ey) - thick
                cov = _coverage(sdf)
                fill = np.broadcast_to(color, (*cov.shape, 3)).copy()
                _composite(canvas, top, left, cov, fill, 0.95)
            x += gw_ + rng.uniform(1, 4)


def generate_procedural_image(rng: np.random.Generator, h: int,
                              w: int) -> np.ndarray:
    """One (h, w, 3) uint8 image: 1/f background + shapes + glyph rows."""
    # correlated-RGB background: one luminance field + two LOW-octave
    # chroma fields (natural images carry most color variation at low
    # frequency)
    # octaves capped at 4 (coarsest feature ~6 px at 384): finer noise
    # octaves are below the x4-recoverable band and would act as an
    # un-learnable PSNR floor (see _fill's frequency note)
    lum = _value_noise(rng, h, w, octaves=4)
    c1 = _value_noise(rng, h, w, octaves=3)
    c2 = _value_noise(rng, h, w, octaves=3)
    base = 128.0 + 52.0 * lum
    canvas = np.stack([base + 26.0 * c1,
                       base - 13.0 * c1 + 22.0 * c2,
                       base - 26.0 * c2], axis=-1)
    n_shapes = rng.integers(40, 90)  # edge-dense: where SR models win
    for _ in range(n_shapes):
        _draw_shape(rng, canvas)
    _draw_glyph_rows(rng, canvas)
    return np.clip(np.round(canvas), 0, 255).astype(np.uint8)


@dataclass
class ProceduralDataset:
    """Deterministic procedural benchmark images (see module docstring).

    ``split`` ('train'/'test') salts the PRNG stream so the two splits
    are disjoint even at the same ``seed``; image ``i`` depends only on
    ``(seed, split, i)``, never on ``num_images`` — growing the corpus
    keeps every existing image bit-identical. ``color_space`` mirrors
    FolderDataset: images generate as RGB and convert through PIL's
    YCbCr (the reference's eval convention) when asked, so Y-channel
    models train/eval on real luma, exactly like on disk corpora.
    """

    num_images: int = 128
    size: tuple[int, int] = (384, 384)
    color_space: str = "rgb"
    seed: int = 0
    split: str = "train"

    def __post_init__(self):
        if self.split not in _SPLIT_SALT:
            raise ValueError(f"split must be train/test, got {self.split!r}")
        if self.color_space not in ("rgb", "ycbcr"):
            raise ValueError(f"unknown color_space {self.color_space!r}")
        self._cache: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return self.num_images

    def __getitem__(self, i: int) -> np.ndarray:
        if i not in self._cache:
            rng = np.random.default_rng(
                np.random.SeedSequence(
                    [self.seed, _SPLIT_SALT[self.split], i]))
            h, w = self.size
            img = generate_procedural_image(rng, h, w)
            if self.color_space == "ycbcr":
                from PIL import Image

                img = np.asarray(
                    Image.fromarray(img).convert("YCbCr"), np.uint8)
            self._cache[i] = img
        return self._cache[i]

    @property
    def names(self) -> list[str]:
        return [f"procedural_{self.split}_{i:03d}"
                for i in range(self.num_images)]

    def cache_path(self, cache_dir: str) -> str:
        """The .npz under ``cache_dir`` that :meth:`materialize` reads or
        writes: the JAX package's file name, a function of the key."""
        import os

        h, w = self.size
        return os.path.join(
            cache_dir, f"procedural_v{GEN_VERSION}_{self.split}_s{self.seed}_"
            f"{h}x{w}_{self.color_space}_n{self.num_images}.npz")

    def materialize(self, cache_dir: str | None,
                    workers: int = 1) -> "ProceduralDataset":
        """Generate (or load) the whole corpus up front.

        Generation costs ~0.5 s/image; a 512-image training corpus is
        ~4 min of host work per process without a cache. With
        ``cache_dir`` the stacked uint8 corpus persists as one .npz
        (content is a pure function of the key, so the cache can never
        go stale). Unwritable/absent dirs degrade to in-memory
        generation. ``workers`` > 1 generates in that many spawned
        processes (the same images: each depends only on its index); they
        import the caller's main module, so call it from one that does not
        import torch. Returns self for chaining.
        """
        import os

        path = None
        if cache_dir:
            path = self.cache_path(cache_dir)
            if os.path.exists(path):
                stack = np.load(path)["images"]
                self._cache = {i: stack[i] for i in range(len(stack))}
                return self
        if workers > 1:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            todo = [i for i in range(self.num_images) if i not in self._cache]
            # the workers get a copy with an empty cache: this one fills
            # while later chunks are still being sent
            with ProcessPoolExecutor(
                    workers, mp_context=mp.get_context("spawn")) as ex:
                self._cache.update(zip(todo, ex.map(
                    replace(self).__getitem__, todo, chunksize=8)))
        stack = np.stack([self[i] for i in range(self.num_images)])
        if path is not None:
            try:
                os.makedirs(cache_dir, exist_ok=True)
                # atomic publish via rename, one temp file per writer
                tmp = f"{path}.{os.getpid()}.tmp.npz"
                np.savez(tmp, images=stack)
                os.replace(tmp, path)
            except OSError as e:
                print(f"[procedural] cache write skipped: {e}")
        return self
