"""Traffic kind ``photos``: one user's photos upscaled one after another.

A closed loop with one client: each request is a uint8 photo on the host
handed to ``sr_torch.infer.upscale`` with the weights' ``.npz`` (written
at set-up under ``$TMPDIR``), timed from the call to its return, and the
next request follows at once. The pool holds ``pool_photos`` photos made
on the device from the seed (:func:`srbench.images.scenes`), every
geometry of ``long_side`` × ``short_sides``, landscape and portrait,
equally often, so that every seed serves the same sizes in another
order. Set-up runs one request of each geometry (the first calibrates a
static int8 route).

A seeded sample of requests (one every ``check_every_requests`` on
average, at most ``check_max_requests``) keeps its answer, to be judged
after the window.
"""

from __future__ import annotations

import os
import random
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from srbench import images, program, reference, weights
from srbench.kinds import phase, sample


def geometries(traffic: dict) -> list[tuple[int, int]]:
    """LR ``(height, width)`` of each kind of photo: every short side,
    landscape then portrait."""
    t = traffic
    return ([(s, t["long_side"]) for s in t["short_sides"]]
            + [(t["long_side"], s) for s in t["short_sides"]])


def make_pool(traffic: dict, seed: int, device) -> list[np.ndarray]:
    """The mix's uint8 photos on the host, ``pool_photos // len(geometries)``
    of each geometry, in an order drawn from the seed."""
    geoms = geometries(traffic)
    per = traffic["pool_photos"] // len(geoms)
    g = weights.generator(seed, "photos", device)
    pool = []
    for h, w in geoms:
        pool += list(images.to_u8(images.scenes(per, h, w, g, device))
                     .cpu().numpy())
    random.Random(weights.derived_seed(seed, "order")).shuffle(pool)
    return pool


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 variant: str | None = None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.variant = variant
        self.scale = config["scale_factor"]

    def setup(self) -> None:
        t, dev = self.traffic, self.device
        with phase("photos"):
            self.pool = make_pool(t, self.seed, dev)
        first = self.pool[0]
        c = t["weights_crop"]
        top, left = (first.shape[0] - c) // 2, (first.shape[1] - c) // 2
        crop = torch.from_numpy(first[None, top:top + c, left:left + c]
                                .copy()).to(dev).float() / 255.0
        ref = reference.load(self.config["reference"])
        with phase("weights"):
            self.params, self.stats = weights.make(ref, self.config,
                                                   self.seed, dev, crop)
            self.tmp = tempfile.TemporaryDirectory(prefix="srbench-")
            path = os.path.join(self.tmp.name, "params.npz")
            weights.write_npz(path, self.params, self.stats)
        self.predict = self._predict(path)
        self.keep = sample(self.seed, "check", t["check_every_requests"],
                           t["check_max_requests"])
        self.kept: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        seen = set()
        for img in self.pool:
            if img.shape not in seen:
                seen.add(img.shape)
                with phase(f"warm-up {img.shape[0]}x{img.shape[1]}"):
                    self.predict(img)

    def _predict(self, path: str):
        fn = program.upscale_call(self.config, path, self.traffic["tile"],
                                  self.device,
                                  None if self.variant != "control"
                                  else "control")
        if not (self.variant and self.variant.startswith("fault:")):
            return fn
        fault = self.variant.split(":", 1)[1]
        if fault != "answer_altered":
            raise ValueError(f"no fault {fault!r} in this kind")
        shift = self.scale

        def altered(img):
            # the photo stitched one LR pixel off
            return np.roll(fn(img), shift, axis=1)

        return altered

    def _loop(self, seconds=None, requests=None, spans=None, first=0):
        stats = {"attempted": 0, "failed": 0, "latencies_s": [],
                 "lr_shapes": []}
        t0 = time.perf_counter()
        i = first
        while True:
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            if requests is not None and i - first >= requests:
                break
            img = self.pool[i % len(self.pool)]
            stats["attempted"] += 1
            try:
                if spans is not None:
                    with spans("srbench.request"):
                        ts = time.perf_counter()
                        out = self.predict(img)
                else:
                    ts = time.perf_counter()
                    out = self.predict(img)
                stats["latencies_s"].append(time.perf_counter() - ts)
                stats["lr_shapes"].append((1, img.shape[0], img.shape[1]))
                if seconds is not None and i in self.keep:
                    self.kept[i] = (img, out)
            except Exception:  # a failed request is counted, not fatal
                traceback.print_exc(file=sys.stderr)
                stats["failed"] += 1
            i += 1
        stats["window_s"] = time.perf_counter() - t0
        stats["next"] = i
        return stats

    def window(self, seconds: float) -> dict:
        """The measured window: requests until ``seconds`` have passed;
        the last one runs to its end."""
        s = self._loop(seconds=seconds)
        self.next = s["next"]
        s["landed"] = len(s["latencies_s"])
        return s

    def traced(self) -> None:
        """The traced segment: ``trace_requests`` more requests, each
        inside a ``srbench.request`` span."""
        from torch.profiler import record_function

        self._loop(requests=self.traffic["trace_requests"],
                   spans=record_function, first=self.next)

    def answers(self) -> list:
        """``(photo_u8, output_u8)`` of every sampled request."""
        return [self.kept[i] for i in sorted(self.kept)]

    def release(self) -> None:
        self.predict = None
        program.release()
        self.tmp.cleanup()
