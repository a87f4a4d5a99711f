"""One run of one benchmark cell on the card.

    python3 -m srbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (inputs and weights from the seed,
the program's build, warm-up of every shape the cell uses) is timed from
the process's start; then the window runs for ``--seconds``; with
``--trace 1`` a short traced segment follows it; then the answers sampled
in the window are judged against the reference. The last line of
standard output is the result as one JSON object; the last lines of
standard error are the numbers compared, each beside its limit. The
result's ``setup_parts`` records apart what ``setup_s`` holds of a
checkout's first build: the seconds of the program's kernel build, and
whether the run found no bytecode cache under ``build/`` (the first run
in its checkout).

Exits with a code other than 0, and prints no result, without a card (or
with fewer cards than the cell asks for), and when JAX, flax, optax or the
JAX package (``sr``) is loaded in this process once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: top-level modules the run may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sr")

def use_checkout_caches() -> None:
    """Point Python's bytecode cache at a fixed directory under ``build/``
    in the checkout, before torch loads: the first run of a checkout fills
    it and every later run reads it. Where the environment writes no
    bytecode and the installed packages hold none for the modules torch
    loads lazily, each process would compile those sources again (seconds
    of every run's set-up). The program's kernels build into
    ``build/sr_torch_kernels/`` of the checkout by themselves; it uses no
    Triton, ``torch.compile`` or ``cpp_extension`` cache."""
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``modules`` (default ``sys.modules``) that are
    JAX's or the JAX package's, compared whole."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def has_cards(cell: dict, name: str) -> bool:
    """Whether torch sees the CUDA devices ``cell`` asks for; says so on
    standard error where it does not."""
    import torch

    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell["chips"]:
        print(f"srbench: {name} needs {cell['chips']} CUDA device(s); torch "
              f"sees {seen}, so no result", file=sys.stderr)
        return False
    return True


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    first_in_checkout = not (ROOT / "build" / "pycache").is_dir()
    use_checkout_caches()

    from srbench.harness import Bench, process_clock, run_cell

    clock = process_clock()
    import torch

    bench = Bench(ROOT)
    if not has_cards(bench.cell(args.workload), args.workload):
        return 3
    result, readings = run_cell(bench, args.workload, args.seed, args.seconds,
                                bool(args.trace), clock)
    result["setup_parts"]["first_in_checkout"] = first_in_checkout
    bad = forbidden_modules()
    if bad:
        print(f"srbench: the process holds {bad} after the window; the "
              "benchmark runs without JAX and the JAX package, so no "
              "result", file=sys.stderr)
        return 4
    print(f"card: {card_line()}")
    print(json.dumps(result))
    sys.stdout.flush()
    for name, value in readings.items():
        print(f"reading {name}: {value}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
