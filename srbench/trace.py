"""The traced segment: capture with ``torch.profiler`` and reduce.

:func:`capture` runs a callable under the profiler (CPU and CUDA
activities, input shapes recorded) inside a ``srbench.window`` annotation
that ends after a synchronise, and keeps four lists, all times in
microseconds on the profiler's one clock:

* ``device``: every operation that ran on the card (kernels, copies,
  sets), ``(name, start, end)``; ``kernels`` is the same without copies
  and sets;
* ``ops``: the program's operators as the dispatcher saw them, ``(name,
  input shapes, start, end)``, for the per-launch bounds of its kernels;
* ``spans``: the benchmark's own host spans (``srbench.*`` annotations).

The reductions below are pure functions of such lists, so the CPU tests
hold them to hand-worked timelines.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

WINDOW = "srbench.window"


@dataclass
class Trace:
    window: tuple[float, float]
    device: list = field(default_factory=list)
    kernels: list = field(default_factory=list)
    ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def capture(fn, cuda: bool = True) -> Trace:
    """Run ``fn()`` under the profiler; the trace of that window. Without
    ``cuda`` only the host is traced (the CPU tests)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities, record_shapes=True) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    return from_events(prof.events())


def from_events(events) -> Trace:
    """A :class:`Trace` from the profiler's ``FunctionEvent`` list."""
    window = None
    device, ops, spans = [], [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type.name == "CUDA":
            # device-side ranges of user annotations span kernels and are
            # not operations
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("srbench.")):
                device.append((e.name, start, end))
        elif e.name == WINDOW:
            window = (start, end)
        elif e.name.startswith("srbench."):
            spans.append((e.name, start, end))
        elif "::" in e.name:
            ops.append((e.name, e.input_shapes, start, end))
    if window is None:
        raise RuntimeError("the trace holds no srbench.window annotation")
    device.sort(key=lambda d: d[1])
    return Trace(window, device, [d for d in device if not _is_copy(d[0])],
                 ops, spans)


def clipped(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """``(start, end)`` of each interval cut to [lo, hi], empty ones
    dropped, sorted by start."""
    out = [(max(s, lo), min(e, hi)) for _, s, e in intervals]
    return sorted((s, e) for s, e in out if e > s)


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(name, start, end)`` intervals inside
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in clipped(intervals, lo, hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, at = [], lo
    for s, e in clipped(intervals, lo, hi):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def span_at(spans, t: float, default: str = "no srbench span") -> str:
    """Name of the innermost (shortest) span open at time ``t``."""
    open_ = [(e - s, name) for name, s, e in spans if s <= t <= e]
    return min(open_)[1] if open_ else default


def launches(trace: Trace, op: str, kernel: str
             ) -> list[tuple[list, str, float]] | None:
    """``(input shapes, kernel name, kernel µs)`` of each call of the
    operator ``op`` paired in order with the kernels whose name matches the
    regular expression ``kernel`` (one stream runs them in the order they
    were queued). None where there is nothing to read, or where the counts
    differ: then the kernels are not one a call."""
    calls = sorted((s, shapes) for n, shapes, s, _ in trace.ops if n == op)
    rx = re.compile(kernel)
    hits = [(name, e - s) for name, s, e in trace.kernels if rx.search(name)]
    if not calls or len(calls) != len(hits):
        return None
    return [(shapes, name, us) for (_, shapes), (name, us)
            in zip(calls, hits)]


def roofline_pct(pairs, bound_s) -> float | None:
    """The sum of ``bound_s(shapes, kernel name)`` over the launches of
    :func:`launches`, over the sum of their kernel time, in percent; None
    where there are no launches or a bound is None."""
    if not pairs:
        return None
    bounds = [bound_s(shapes, name) for shapes, name, _ in pairs]
    total_us = sum(us for _, _, us in pairs)
    if None in bounds or total_us <= 0:
        return None
    return 100.0 * sum(bounds) / (total_us * 1e-6)


def busy_idle(trace: Trace) -> tuple[float, float]:
    """``(busy_s, window_s)``: the union of device operations inside the
    traced window, and the window's length."""
    lo, hi = trace.window
    return union_length(trace.device, lo, hi) * 1e-6, (hi - lo) * 1e-6


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the benchmark span open at their middle; seconds."""
    by_name: dict[str, float] = {}
    for name, s, e in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace.window
    gaps = sorted(idle_gaps(trace.device, lo, hi), key=lambda g: g[0] - g[1])
    named = [[span_at(trace.spans, (s + e) / 2), (e - s) * 1e-6]
             for s, e in gaps[:top]]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": named}
