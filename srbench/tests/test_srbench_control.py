"""``correct`` against its control and the planted fault, at a size a CPU
test holds: the sound program passes each cell's limits, the control (the
precision below the configuration's) and an answer altered where it is
produced do not. On the card, at the cells' own sizes and on three seeds
or more, ``python3 -m srbench.control`` reads the same variants."""

import json
import subprocess
import sys

import pytest

from srbench import harness

CELLS = ["edsr_baseline_x4.reds_frames.bf16",
         "srresnet_x4.div2k_photo.bf16",
         "edsr_baseline_x4.reds_frames.int8",
         "srresnet_x4.reds_frames.int8"]


def _run(root, cell, variant, seconds=1.5):
    bench = harness.Bench(root)
    result, readings = harness.run_cell(bench, cell, 2 ** 31 + 3, seconds,
                                        False, lambda: 0.0, device="cpu",
                                        variant=variant)
    assert readings["images"] > 0, readings
    return result


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("variant, want", [
    (None, True), ("control", False), ("fault:answer_altered", False)])
def test_correct_decides(tiny_root, cell, variant, want):
    result = _run(tiny_root, cell, variant)
    assert result["correct"] is want, result["checks"]
    assert result["failed"] == 0


def test_every_cell_has_a_test_here():
    names = [c["name"] for c in harness.Bench().spec["workloads"]]
    assert sorted(names) == sorted(CELLS)


def test_control_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; this holds the refusal without one")
    out = subprocess.run(
        [sys.executable, "-m", "srbench.control", "--workload", CELLS[0],
         "--seeds", "1", "--seconds", "1"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no result" in out.stderr


@pytest.mark.cuda
def test_a_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "srbench.run", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert "resblock_roofline" in result["metrics"]
    assert result["setup_parts"]["kernel_build_s"] >= 0
