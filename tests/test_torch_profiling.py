"""``sr_torch/utils/profiling.py`` against ``sr/utils/profiling.py``, on
the CPU: ``StepTimer`` gives the JAX package's outputs on a fixed sequence
of clock ticks (tolerance 0), ``op_profile`` returns the JAX package's keys
(its CPU rows: the host ops, as the JAX package falls back to its host
track), ``trace`` writes a Chrome trace, ``enable_nan_debugging`` toggles
anomaly detection."""

import json
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from sr.utils import profiling as jax_profiling
from sr_torch.kernels.ops import depth_to_space
from sr_torch.utils import profiling

torch.set_num_threads(1)


def _run_timer(cls, ticks, monkeypatch, **kw):
    clock = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timer = cls(**kw)
    out = [timer.tick(0.5 if i % 2 else None) for i in range(len(ticks))]
    return out, timer.last_steps_per_s, timer.last_mps


def test_step_timer_equals_jax(monkeypatch):
    ticks = [0.0, 0.011, 0.023, 0.030, 0.052, 0.061, 0.070, 0.093, 0.101,
             0.124, 0.130]
    kw = dict(pixels_per_step=32 * 64 * 64, window=3)
    got = _run_timer(profiling.StepTimer, ticks, monkeypatch, **kw)
    want = _run_timer(jax_profiling.StepTimer, ticks, monkeypatch, **kw)
    assert got == want
    assert sum(r is not None for r in got[0]) == 3


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    f = jax.jit(lambda x: jnp.tanh(x @ x).sum())
    r = jax_profiling.op_profile(f, jnp.ones((32, 32)), iters=2,
                                 log_dir=str(tmp_path_factory.mktemp("jp")))
    return set(r), {k for row in r["ops"] for k in row}


def test_op_profile_returns_jax_keys(jax_keys, tmp_path):
    top, op_keys = jax_keys
    x = torch.randn(2, 8, 8, 16)
    r = profiling.op_profile(lambda a: torch.relu(depth_to_space(a, 2)), x,
                             iters=2, log_dir=str(tmp_path))
    assert set(r) == top == {"programs", "ops", "log_dir"}
    assert r["ops"] and all(set(row) == op_keys for row in r["ops"])
    assert abs(sum(row["pct"] for row in r["ops"]) - 100.0) < 0.5
    (prog,) = r["programs"]  # the operator's host row
    assert prog["name"] == "sr_torch::depth_to_space"
    assert set(prog) == {"name", "ms_per_iter", "count_per_iter"}
    assert prog["count_per_iter"] == 1.0
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_nan_debugging_toggles_anomaly_detection():
    try:
        profiling.enable_nan_debugging(True)
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
