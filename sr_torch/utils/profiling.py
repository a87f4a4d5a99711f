"""Profiling and debugging hooks.

Port of ``sr/utils/profiling.py``:

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json`` under ``log_dir``, loadable in Perfetto or
  ``chrome://tracing``);
* :func:`op_profile`: per-op time of ``fn(*args)``, with the JAX package's
  keys. The JAX package parses XLA's profiler dump (its xplane protobuf,
  ``parse_xplane``, or the Chrome export); the port reads the profiler's
  own events, so ``parse_xplane`` has no counterpart here. On the card the
  rows are the CUDA kernels' device time; on the CPU, which has no device
  track, the host ops' time (as the JAX package falls back to its host
  track);
* :class:`StepTimer`: steps/s and megapixels/s over a window of steps,
  synced through a scalar the caller hands it;
* :func:`enable_nan_debugging`: ``torch.autograd.set_detect_anomaly``, so
  the backward of the op that made a NaN raises with its forward's trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/trace'): run_steps()`` → ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def _sync() -> None:
    """Wait for the device's queue, where there is one (CPU ops return
    done)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def op_profile(fn, *args, iters: int = 3, log_dir: str | None = None):
    """Per-op time breakdown of ``fn(*args)``.

    Warms ``fn`` outside the trace, runs it ``iters`` times under
    :func:`trace` and aggregates the profiler's events by name. Returns
    ``{"programs": [...], "ops": [...], "log_dir": ...}`` (the Chrome trace
    kept at ``log_dir``), each entry ``{"name", "ms_per_iter",
    "count_per_iter", "pct"}``: *ops* are the CUDA kernels (device time)
    on the card, the top-level host ops (``aten::``, ``sr_torch::``) on the
    CPU; *programs* are the ``sr_torch::`` operators' host rows, the
    counterpart of XLA's whole-module ``jit_*`` rows. ``pct`` is of the
    summed op time.
    """
    import collections
    import tempfile

    fn(*args)  # build and warm outside the trace
    _sync()
    log_dir = log_dir or tempfile.mkdtemp(prefix="sr_torch_opprof_")
    with trace(log_dir) as prof:
        for _ in range(iters):
            fn(*args)
            _sync()

    on_device = torch.cuda.is_available()
    dur = collections.defaultdict(float)  # microseconds
    cnt = collections.Counter()
    programs = []
    for e in prof.key_averages():
        if e.key.startswith("sr_torch::"):
            programs.append({
                "name": e.key,
                "ms_per_iter": round(e.cpu_time_total / 1e3 / iters, 4),
                "count_per_iter": e.count / iters})
        if on_device:
            # the kernels themselves: events on the device's track
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dur[e.key] += e.self_device_time_total
                cnt[e.key] += e.count
        elif e.key.startswith(("aten::", "sr_torch::")):
            dur[e.key] += e.self_cpu_time_total
            cnt[e.key] += e.count
    ops = []
    total = sum(dur.values())
    for name, d in sorted(dur.items(), key=lambda kv: -kv[1]):
        ops.append({"name": name, "ms_per_iter": round(d / 1e3 / iters, 4),
                    "count_per_iter": cnt[name] / iters,
                    "pct": round(100.0 * d / total, 2) if total else 0.0})
    programs.sort(key=lambda r: -r["ms_per_iter"])
    return {"programs": programs, "ops": ops, "log_dir": log_dir}


class StepTimer:
    """Wall-clock throughput over a window of steps.

    Call :meth:`tick` once per step with a device scalar to sync on
    (e.g. the loss); reading it forces completion of the step's work.
    """

    def __init__(self, pixels_per_step: float = 0.0, window: int = 50):
        self.pixels_per_step = pixels_per_step
        self.window = window
        self._count = 0
        self._t0 = None
        self.last_steps_per_s = 0.0
        self.last_mps = 0.0

    def tick(self, sync_scalar=None) -> dict | None:
        if sync_scalar is not None:
            float(sync_scalar)  # forces the step chain to complete
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return None
        self._count += 1
        if self._count >= self.window:
            dt = now - self._t0
            self.last_steps_per_s = self._count / dt
            self.last_mps = self.pixels_per_step * self._count / dt / 1e6
            self._count = 0
            self._t0 = now
            return {
                "steps_per_s": round(self.last_steps_per_s, 3),
                "megapixels_per_s": round(self.last_mps, 3),
            }
        return None
