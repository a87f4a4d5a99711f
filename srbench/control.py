"""Readings that set a cell's limits: sound runs, the control and faults.

    python3 -m srbench.control --workload <cell> --seeds 1,2,3 \
        --variants sound,control,fault:answer_altered --seconds 4

runs, in one process, each variant of the cell on each seed for a short
window and prints one JSON line a run with its readings (``srbench/
check.py``) and whether it came out correct under the current limits.
``sound`` is the program as the configuration states; ``control`` the
configuration's control (the program's lower-precision route, or the
reference fake-quantized to ``reference_bits``); ``fault:<name>`` the
timed path broken as the cell's traffic kind plants it. The window keeps
its first answers (up to the mix's cap) rather than a sparse sample, so a
short window compares as many answers as a full run does. Like a run of
the benchmark, it refuses to start without the cards the cell asks for,
so every reading it prints is the card's. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="sound,control")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    from srbench.run import has_cards, use_checkout_caches

    use_checkout_caches()
    from srbench import harness

    bench = harness.Bench(harness.ROOT)
    if not has_cards(bench.cell(args.workload), args.workload):
        return 3
    dense = _DenseBench(bench)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for variant in args.variants.split(","):
            t0 = time.perf_counter()
            result, readings = harness.run_cell(
                dense, args.workload, seed, args.seconds, False,
                lambda: time.perf_counter() - t0,
                variant=None if variant == "sound" else variant)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant,
                              "correct": result["correct"],
                              "attempted": result["attempted"],
                              "readings": readings}), flush=True)
    return 0


class _DenseBench:
    """A view of the benchmark whose mixes keep their first answers."""

    def __init__(self, bench):
        self._bench = bench

    def __getattr__(self, name):
        return getattr(self._bench, name)

    def traffic(self, name):
        t = self._bench.traffic(name)
        for key in ("check_every_batches", "check_every_requests"):
            if key in t:
                t[key] = 1
        return t


if __name__ == "__main__":
    sys.exit(main())
