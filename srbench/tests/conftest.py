"""Tiny copies of the benchmark for CPU runs of the harness."""

import json
import shutil
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent

#: the mixes cut to a size a CPU test holds; every answer of the window
#: is judged
TINY = {
    "reds_frames": dict(lr_height=24, lr_width=40, batch=2, pool_frames=8,
                        clip_frames=4, warmup_batches=1, weights_crop=16,
                        check_every_batches=1, check_max_batches=2,
                        trace_batches=2),
    "div2k_photo": dict(long_side=72, short_sides=[40, 48], pool_photos=4,
                        tile=24, weights_crop=16, check_every_requests=1,
                        check_max_requests=2, trace_requests=2),
}


def tiny_copy(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``srbench/`` under ``dest`` with
    the mixes cut to :data:`TINY`."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(PKG, dest / "srbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, cut in TINY.items():
        path = dest / "srbench" / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(cut)
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(tmp_path)
