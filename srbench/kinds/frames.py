"""Traffic kind ``frames``: video frames super-resolved in batches.

A pool of ``pool_frames`` distinct uint8 frames (``clip_frames``
consecutive frames a clip, :func:`srbench.images.clips`) is made on the
device from the seed. Each batch is ``batch`` consecutive frames of one
clip, the batches in a seeded order, cycled. For each batch the caller
turns the uint8 frames into float32 / 255 on the device, calls the served
route (``sr_torch.infer.make_serving_predict``) under
``torch.inference_mode``, as ``upscale`` calls it, and copies the uint8
output back to pinned host memory on a copy stream, as a job that encodes
the frames needs them; at most ``max_in_flight`` batches are in flight,
the host waiting for the oldest to land before it dispatches another.

The window counts every batch whose frames landed on the host; its
length runs from the first dispatch to the last landing. A seeded sample
of batches (one every ``check_every_batches`` on average, at most
``check_max_batches``) lands in buffers of its own, to be judged after
the window.
"""

from __future__ import annotations

import collections
import contextlib
import random
import sys
import time
import traceback

import torch

from srbench import check, images, program, reference, weights
from srbench.kinds import phase, sample


def make_pool(traffic: dict, seed: int, device) -> torch.Tensor:
    """The mix's uint8 frames, ``(pool_frames, lr_height, lr_width, 3)``,
    clip after clip."""
    t = traffic
    g = weights.generator(seed, "frames", device)
    return images.clips(t["pool_frames"] // t["clip_frames"],
                        t["clip_frames"], t["lr_height"], t["lr_width"], g,
                        device)


def batch_order(traffic: dict, seed: int) -> list[int]:
    """The order of the pool's batches (batch j is frames j·batch …
    (j+1)·batch − 1), a permutation drawn from the seed."""
    order = list(range(traffic["pool_frames"] // traffic["batch"]))
    random.Random(weights.derived_seed(seed, "order")).shuffle(order)
    return order


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 variant: str | None = None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.variant = variant
        self.cuda = self.device.type == "cuda"
        t = traffic
        self.scale = config["scale_factor"]
        self.batch = t["batch"]
        self.n_batches = t["pool_frames"] // t["batch"]
        self.out_shape = (t["batch"], t["lr_height"] * self.scale,
                          t["lr_width"] * self.scale, config["num_channels"])

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        t, dev = self.traffic, self.device
        with phase("frames"):
            self.pool = make_pool(t, self.seed, dev)
        self.order = batch_order(t, self.seed)
        c = t["weights_crop"]
        top, left = (t["lr_height"] - c) // 2, (t["lr_width"] - c) // 2
        crop = self.pool[:1, top:top + c, left:left + c].float() / 255.0
        ref = reference.load(self.config["reference"])
        with phase("weights"):
            self.params, self.stats = weights.make(ref, self.config,
                                                   self.seed, dev, crop)
        with phase("program"):
            self.predict = self._predict()
        self.keep = sample(self.seed, "check", t["check_every_batches"],
                           t["check_max_batches"])
        self.kept: dict[int, tuple[int, torch.Tensor]] = {}
        with phase("host buffers"):
            self.ring = [self._host() for _ in range(t["max_in_flight"] + 1)]
            self.spare = [self._host() for _ in range(t["check_max_batches"])]
        self.copy_stream = torch.cuda.Stream(dev) if self.cuda else None
        # warm-up: the first batch calibrates a static int8 route; every
        # later batch has the same shape
        for i in range(t["warmup_batches"]):
            with phase(f"warm-up batch {i}"):
                self._dispatch(i, self.ring[0])
                if self.cuda:
                    torch.cuda.synchronize()

    def _predict(self):
        fault = None
        if self.variant and self.variant.startswith("fault:"):
            fault = self.variant.split(":", 1)[1]
        bits = self.config["control"].get("reference_bits")
        if self.variant == "control" and bits:
            first = self._batch_u8(0).float() / 255.0
            fn = check.reference_predict(self.config, self.params,
                                         self.stats, bits, first)
        else:
            fn = program.serving_predict(self.config, self.params,
                                         self.stats, self.device,
                                         self.variant)
        if fault is None:
            return fn
        if fault != "answer_altered":
            raise ValueError(f"no fault {fault!r} in this kind")

        def altered(x):
            y = fn(x).clone()
            y[0] = y[1]  # the first frame gets its neighbour's output
            return y

        return altered

    def _host(self) -> torch.Tensor:
        return torch.empty(self.out_shape, dtype=torch.uint8,
                           pin_memory=self.cuda)

    def _batch_u8(self, i: int) -> torch.Tensor:
        j = self.order[i % self.n_batches]
        return self.pool[j * self.batch:(j + 1) * self.batch]

    # -- one batch -------------------------------------------------------
    def _dispatch(self, i: int, buf: torch.Tensor, spans=None,
                  enqueue=None) -> torch.cuda.Event | None:
        """Queue batch ``i`` into ``buf``; the copy's event (None on the
        CPU, where the copy is done on return)."""
        span = spans or _no_span
        # served as upscale serves: no autograd
        with torch.inference_mode():
            with span("srbench.convert"):
                x = self._batch_u8(i).to(torch.float32).div_(255.0)
            with span("srbench.predict"):
                t0 = time.perf_counter()
                y = self.predict(x)
                if enqueue is not None:
                    enqueue.append(time.perf_counter() - t0)
        with span("srbench.copy"):
            if not self.cuda:
                buf.copy_(y)
                return None
            self.copy_stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.copy_stream):
                buf.copy_(y, non_blocking=True)
                y.record_stream(self.copy_stream)
                ev = torch.cuda.Event()
                ev.record(self.copy_stream)
        return ev

    def _loop(self, seconds=None, batches=None, spans=None, first=0):
        t = self.traffic
        pending = collections.deque()
        stats = {"attempted": 0, "failed": 0, "landed": 0, "enqueue_s": []}
        span = spans or _no_span

        def land():
            ev = pending.popleft()
            with span("srbench.wait"):
                if ev is not None:
                    ev.synchronize()
            stats["landed"] += 1

        t0 = time.perf_counter()
        i = first
        while True:
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            if batches is not None and i - first >= batches:
                break
            while len(pending) >= t["max_in_flight"]:
                land()
            stats["attempted"] += 1
            keep = (seconds is not None and i in self.keep
                    and bool(self.spare))
            buf = self.spare.pop() if keep else self.ring[i % len(self.ring)]
            try:
                pending.append(self._dispatch(i, buf, spans,
                                              stats["enqueue_s"]))
                if keep:
                    self.kept[i] = (self.order[i % self.n_batches], buf)
            except Exception:  # a failed batch is counted, not fatal
                traceback.print_exc(file=sys.stderr)
                stats["failed"] += 1
            i += 1
        while pending:
            land()
        stats["window_s"] = time.perf_counter() - t0
        stats["next"] = i
        return stats

    # -- the runner's interface -----------------------------------------
    def window(self, seconds: float) -> dict:
        """The measured window: batches until ``seconds`` have passed,
        then every batch in flight lands."""
        s = self._loop(seconds=seconds)
        self.next = s["next"]
        h, w = self.traffic["lr_height"], self.traffic["lr_width"]
        s["lr_shapes"] = [(self.batch, h, w)] * s["landed"]
        s["out_pixels"] = s["landed"] * self.batch * h * w * self.scale ** 2
        return s

    def traced(self) -> None:
        """The traced segment: ``trace_batches`` more batches, each step
        inside a ``srbench.*`` span."""
        from torch.profiler import record_function

        self._loop(batches=self.traffic["trace_batches"],
                   spans=record_function, first=self.next)

    def answers(self) -> list:
        """``(frames_u8, output_u8)`` of every sampled batch that landed,
        in dispatch order."""
        return [(self.pool[j * self.batch:(j + 1) * self.batch], buf)
                for _, (j, buf) in sorted(self.kept.items())]

    def release(self) -> None:
        self.predict = None
        program.release()


def _no_span(name):
    return contextlib.nullcontext()
