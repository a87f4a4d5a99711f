"""The harness: finds every piece of a cell by name and runs it.

Nothing here names a cell, a configuration, a traffic mix or a metric:

* ``BENCHMARK.json`` at the root lists the cells, the configurations with
  their files, and the metrics;
* ``srbench/traffic/<mix>.json`` is a traffic mix, which names its kind
  (``srbench/kinds/<kind>.py``) and holds its parameters;
* a configuration's file names the program's model, its serving route,
  its control and its reference (``srbench/reference/<name>.py``);
* ``srbench/limits/<cell>.json`` holds the limits of the numbers that
  decide ``correct``;
* ``srbench/end_to_end/<metric>.py`` and ``srbench/layer_metrics/
  <metric>.py`` each hold a ``read(ctx)`` that returns the metric's value,
  or None where it finds nothing to read; a metric ``<name>.<part>``
  without a file of its own is read by ``<name>.py``.

So a later change adds a cell, a configuration, a mix or a metric as new
files and entries.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from pathlib import Path

import torch

from srbench import check, kinds, program, trace

ROOT = Path(__file__).resolve().parents[1]


def read_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it leads to, under ``root``."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.spec = read_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for c in self.spec["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; it has "
                       f"{[c['name'] for c in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return dict(read_json(self.root / c["file"]), name=name)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return dict(read_json(self.root / "srbench" / "traffic"
                              / f"{name}.json"), name=name)

    def limits(self, cell: str) -> dict:
        return read_json(self.root / "srbench" / "limits" / f"{cell}.json")

    def metrics(self, cell: str, family: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell``
        reports."""
        return [m for m in self.spec[family]
                if cell in m.get("workloads", [cell])]

    def reader(self, family: str, name: str):
        """The module of ``srbench/<family>/<name>.py``, loaded from its
        file (metric names hold dots); where that file is missing, the
        one of the name before its first dot, so a quantity split by the
        end-to-end metric it moves (``mfu.frames``, ``mfu.photo``) keeps
        one reader (``mfu.py``)."""
        folder = self.root / "srbench" / family
        path = folder / f"{name}.py"
        if not path.exists():
            path = folder / f"{name.split('.', 1)[0]}.py"
        spec = importlib.util.spec_from_file_location(
            f"srbench_{family}_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


@dataclass
class Context:
    """What a metric's reader reads."""
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window: dict
    trace: trace.Trace | None


_FAMILY = {False: ("end_to_end", "end_to_end"),
           True: ("per_layer", "layer_metrics")}


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             traced: bool, clock, device="cuda",
             variant: str | None = None) -> tuple[dict, dict]:
    """One run of the cell ``name``: ``(result, readings)``. ``clock()``
    gives the seconds since the process started (set-up is measured from
    there). ``variant``: None, ``"control"`` or ``"fault:<name>"``."""
    cell = bench.cell(name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(name)
    cuda = torch.device(device).type == "cuda"
    print(f"setup before the cell: {clock():.3f} s", file=sys.stderr)
    build_s = None
    if cuda:
        with kinds.phase("CUDA context"):
            torch.zeros(1, device=device)
        build_s = program.build_kernels()
        print(f"setup kernel build: {build_s} s", file=sys.stderr)
    runner = kinds.load(traffic["kind"]).Runner(config, traffic, seed, device,
                                                variant)
    runner.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = clock()
    win = runner.window(seconds)
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    tr = trace.capture(runner.traced, cuda) if traced else None
    answers = runner.answers()
    runner.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = check.compare(config, runner.params, runner.stats, answers,
                             device)
    correct, checks = check.judge(readings, limits, win["failed"])
    ctx = Context(cell, config, traffic, setup_s, win, tr)
    family, folder = _FAMILY[traced]
    metrics = {}
    for m in bench.metrics(name, family):
        value = bench.reader(folder, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev,
              "setup_parts": {"kernel_build_s": build_s}}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = trace.busy_idle(tr)
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = checks
    return result, readings


def process_clock():
    """``clock()``: seconds since this process started, from the kernel's
    record of its start (``/proc``), so the interpreter's own start and
    every import count as set-up; else since this call."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")

        def since_start():
            with open("/proc/uptime") as f:
                return float(f.read().split()[0]) - start

        since_start()
        return since_start
    except (OSError, ValueError, IndexError):
        import time

        t0 = time.perf_counter()
        return lambda: time.perf_counter() - t0
