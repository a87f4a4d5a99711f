"""sr_torch.bench without a card: the marginal estimator on fixed timings,
the record's keys and headline rules against ``bench.py``'s, and the
refusal to run on a host without a GPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sr_torch import bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PX = (bench.LR_SIZE * bench.SCALE) ** 2
MP_S, MP_L = bench.B_SMALL * PX / 1e6, bench.B_LARGE * PX / 1e6


def test_constants_are_bench_pys():
    tree = ast.parse((ROOT / "bench.py").read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = [t for t in node.targets if isinstance(t, ast.Tuple)]
            for t in node.targets:
                if isinstance(t, ast.Name):
                    consts[t.id] = ast.literal_eval(node.value)
            for t in names:
                for n, v in zip(t.elts, node.value.elts):
                    consts[n.id] = ast.literal_eval(v)
    for name in ("REF_GPU_MPS", "LR_SIZE", "SCALE", "B_SMALL", "B_LARGE",
                 "ITERS", "REPEATS"):
        assert getattr(bench, name) == consts[name], name
    assert dict(bench.TRAIN_K) == {"EDSR": (40, 120), "ESPCN": (100, 300)}


def test_marginals_keep_only_resolved_deltas():
    """Δt at or under 2 ms is noise and drops out; the rest give
    Δwork/Δt."""
    times = [(0.010, 0.030), (0.010, 0.012), (0.010, 0.0115), (0.02, 0.01)]
    assert bench.marginals(64, 192, times) == pytest.approx([128 / 0.020])


def test_serving_value_is_the_median_marginal():
    times = [(0.2, 0.3), (0.2, 0.28), (0.2, 0.35)]  # Δt 0.1, 0.08, 0.15
    want = (MP_L - MP_S) / 0.1  # the median of the three marginals
    assert want > max(MP_L / t for _, t in times)
    assert bench.serving_value(MP_S, MP_L, times) == pytest.approx(want)


def test_serving_value_is_floored_by_the_best_observed_rate():
    """A median marginal below the best observed b192 rate (a fixed cost
    that shrank between the two sizes) loses to the observed rate."""
    times = [(0.05, 0.30), (0.05, 0.20), (0.05, 0.25)]
    observed = MP_L / 0.20
    assert (MP_L - MP_S) / 0.2 < observed  # the median marginal
    assert bench.serving_value(MP_S, MP_L, times) == pytest.approx(observed)


def test_serving_value_without_a_resolved_marginal_is_the_observed():
    times = [(0.1, 0.101), (0.1, 0.1015)]
    assert bench.marginals(MP_S, MP_L, times) == []
    assert bench.serving_value(MP_S, MP_L, times) == pytest.approx(
        MP_L / 0.101)


KEYS = {"metric", "value", "unit", "vs_baseline", "bf16_exact_mps",
        "bf16_fused_mps", "bf16_fused_vs_baseline", "bf16_best_mps",
        "train"}
TRAIN = {"EDSR": {"steps_per_s": 50.0, "model_tflops": 4.9},
         "ESPCN": {"steps_per_s": 300.0, "model_tflops": 0.4}}


def test_record_has_bench_pys_keys():
    """``bench.py:main`` builds its record as a dict literal plus the
    ``train`` key: the port's record has exactly those keys."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    want = {"train"}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record"
                        for t in node.targets)):
            want |= {k.value for k in node.value.keys}
    assert want == KEYS
    rec = bench.build_record(900.0, 1400.0, 600.0, TRAIN)
    assert set(rec) == KEYS
    assert rec["unit"] == "MP/s" and rec["train"] == TRAIN
    json.dumps(rec)


@pytest.mark.parametrize("exact,fused,quant,value,label,best", [
    (900.0, 1400.0, 600.0, 1400.0, "fused-tail inference mode", 1400.0),
    (900.0, 800.0, 600.0, 900.0, "exact graph", 900.0),
    (900.0, 1400.0, 1500.0, 1500.0, bench.INT8_LABEL, 1400.0),
    (900.0, 800.0, 850.0, 900.0, "exact graph", 900.0),
])
def test_headline_rules(exact, fused, quant, value, label, best):
    """bench.py:276-321: fused is the headline unless slower than exact
    (then ``bf16_fused_mps`` still reports the fused number); int8 takes
    the headline only when faster than the best float mode."""
    rec = bench.build_record(exact, fused, quant, TRAIN)
    assert rec["value"] == value and rec["bf16_best_mps"] == best
    assert rec["metric"] == ("EDSR x4 SR inference throughput (output MP/s, "
                             f"1 chip, {label})")
    assert rec["bf16_exact_mps"] == exact and rec["bf16_fused_mps"] == fused
    assert rec["vs_baseline"] == round(value / 15.0, 2)
    assert rec["bf16_fused_vs_baseline"] == round(fused / 15.0, 2)


def test_bench_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "sr_torch.bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "cuda" in out.stderr.lower()
