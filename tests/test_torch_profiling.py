"""``sr_torch/utils/profiling.py`` against ``sr/utils/profiling.py``, on
the CPU: ``StepTimer`` gives the JAX package's outputs on a fixed sequence
of clock ticks (tolerance 0), ``op_profile`` returns the JAX package's keys
(its CPU rows: the host ops, as the JAX package falls back to its host
track), ``trace`` writes a Chrome trace, ``enable_nan_debugging`` toggles
anomaly detection. The port's own spans and counters: a span records
nothing without a profiler, nests as the serving layers do under one, is
named after no operator and reaches the benchmark's trace; the tiling's
counters give the photo geometries' pixels."""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import profile, record_function

from sr.utils import profiling as jax_profiling
from sr_torch.eval.tiling import RECEPTIVE_FIELD, tiled_predict
from sr_torch.infer import upscale
from sr_torch.kernels.ops import depth_to_space
from sr_torch.models.registry import get_spec
from sr_torch.utils import profiling
from sr_torch.utils.checkpoint import save_params
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import to_jax_batch_stats, to_jax_params
from srbench import trace as srbench_trace

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

    def fn(a):
        with profiling.span("sr_torch::test.step"):  # not an op's row
            return torch.relu(depth_to_space(a, 2))

    r = profiling.op_profile(fn, x, iters=2, log_dir=str(tmp_path))
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


# -- the program's spans and counters ----------------------------------

#: (model, quantize, image (h, w), tile): every int8 route once (the
#: quantized exact graph, tiled; EDSR's collapsed int8 tail; SRResNet's
#: folded int8 tail) and a float route
ROUTES = [("ESPCN", "static", (40, 30), 16), ("EDSR", "static", (12, 10), None),
          ("SRResNet", "static", (12, 10), None),
          ("SRResNet", False, (12, 10), None)]


@pytest.fixture(scope="module")
def params_npz(tmp_path_factory):
    """``{model: .npz path}``: each model at its default widths, weights
    from a seeded init."""
    d = tmp_path_factory.mktemp("spans")
    paths = {}
    for name in sorted({r[0] for r in ROUTES}):
        spec = get_spec(name)
        m = spec.make_model(SRConfig(model_name=name,
                                     num_channels=spec.default_channels),
                            torch.Generator().manual_seed(0))
        paths[name] = str(d / f"{name}.npz")
        save_params(paths[name], to_jax_params(m), to_jax_batch_stats(m))
    return paths


def _upscale(params_npz, name, quantize, hw, tile):
    img = np.random.default_rng(0).integers(0, 256, (*hw, 3), np.uint8)
    return upscale(img, name, params_npz[name], dtype="float32", tile=tile,
                   fused=True, quantize=quantize, device="cpu")


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in profiling.counters().items()
            if v != before.get(k, 0)}


def test_span_off_records_nothing_and_counters_count(params_npz,
                                                     monkeypatch):
    opened = []
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        lambda name: opened.append(name))
    assert profiling.span("sr_torch::a") is profiling.span("sr_torch::b")
    before = profiling.counters()
    _upscale(params_npz, *ROUTES[0])
    assert opened == []
    # 40×30 at tile 16, halo 5: six 26×26 windows in one call
    assert _delta(before) == {"tiling.image_px": 1200, "tiling.calls": 1,
                              "tiling.window_px": 6 * 26 * 26}
    profiling.count("test.only", 3)
    profiling.count("test.only")
    assert profiling.counters()["test.only"] - before.get("test.only", 0) \
        == 4


@pytest.fixture(scope="module")
def traced(params_npz):
    """``{route: profiler events}`` of one upscale a route, after a
    warm-up call (the static routes calibrate on their first)."""
    out = {}
    for route in ROUTES:
        _upscale(params_npz, *route)
        with profile() as prof:
            with record_function(srbench_trace.WINDOW):
                _upscale(params_npz, *route)
        out[route] = prof.events()
    return out


def _chain(e):
    names = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        names.append(e.name)
    return names


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: f"{r[0]}-{r[1]}")
def test_spans_nest_as_the_layers_do(traced, route):
    events = traced[route]
    names = [e.name for e in events]
    assert names.count("sr_torch::upscale") == 1
    for step in ("pre", "forward", "fetch", "post"):
        (e,) = [e for e in events if e.name == f"sr_torch::upscale.{step}"]
        assert _chain(e)[0] == "sr_torch::upscale"
    routes = [e for e in events if e.name == "sr_torch::route.forward"]
    assert routes and all(_chain(e)[0] == "sr_torch::upscale.forward"
                          for e in routes)
    sites = [e for e in events if e.name == "sr_torch::int8.site"]
    for e in sites:
        assert _chain(e)[:2] == ["sr_torch::route.forward",
                                 "sr_torch::upscale.forward"]
    # every int8 operator call sits in a site span of its own, the
    # collapsed and folded tails' included
    calls = [e for e in events if e.name == "sr_torch::conv_int8_fused"]
    assert len(calls) == len(sites) and bool(sites) == bool(route[1])
    assert all(_chain(e)[0] == "sr_torch::int8.site" for e in calls)


def test_no_span_is_named_after_an_operator(traced):
    ops = {n for n in torch._C._dispatch_get_all_op_names()
           if n.startswith("sr_torch::")}
    assert "sr_torch::conv_int8_fused" in ops
    spans = {e.name for events in traced.values() for e in events
             if e.is_user_annotation and e.name.startswith("sr_torch::")}
    assert spans == {"sr_torch::upscale", "sr_torch::upscale.pre",
                     "sr_torch::upscale.forward", "sr_torch::upscale.fetch",
                     "sr_torch::upscale.post", "sr_torch::route.forward",
                     "sr_torch::int8.site"}
    assert not spans & ops


def test_the_benchmark_trace_keeps_the_spans(traced):
    tr = srbench_trace.from_events(traced[ROUTES[0]])
    names = [name for name, _, _, _ in tr.ops]
    for name in ("sr_torch::upscale.pre", "sr_torch::upscale.fetch",
                 "sr_torch::route.forward", "sr_torch::int8.site"):
        assert name in names
    lo, hi = tr.window
    assert all(lo <= s <= e <= hi for name, _, s, e in tr.ops
               if name.startswith("sr_torch::upscale"))
    assert not tr.spans  # the benchmark's own spans stay apart


def _zeros_x4(t):
    return t.new_zeros((t.shape[0], 4 * t.shape[1], 4 * t.shape[2],
                        t.shape[3]))


@pytest.mark.parametrize("h, w, window_px, image_px", [
    (288, 510, 396_288, 146_880), (339, 510, 466_464, 172_890),
    (384, 510, 473_344, 195_840), (510, 288, 396_288, 146_880),
    (200, 150, 30_000, 30_000)])
def test_tiling_counts_the_pixels_it_runs(h, w, window_px, image_px):
    # the photo cell's tiling: tile 256, SRResNet's halo; the last case
    # fits one window and runs whole
    assert RECEPTIVE_FIELD["srresnet"] == 44
    before = profiling.counters()
    tiled_predict(_zeros_x4, torch.zeros((1, h, w, 1), dtype=torch.uint8),
                  4, tile=256, halo=44)
    assert _delta(before) == {"tiling.image_px": image_px,
                              "tiling.window_px": window_px,
                              "tiling.calls": 1}


@pytest.mark.parametrize("per_call, fixed_chunk, calls, tiles", [
    (3, False, 2, 6), (3, True, 2, 6), (16, False, 1, 4), (16, True, 1, 16)])
def test_tiling_counts_padding_tiles(per_call, fixed_chunk, calls, tiles):
    # 288×510 is 4 windows of 288×344: at 3 tiles a call the second call
    # repeats its last tile twice; fixed_chunk pads every call to
    # max_tiles_per_call
    before = profiling.counters()
    tiled_predict(_zeros_x4, torch.zeros((1, 288, 510, 1),
                                         dtype=torch.uint8),
                  4, tile=256, halo=44, max_tiles_per_call=per_call,
                  fixed_chunk=fixed_chunk)
    assert _delta(before) == {"tiling.image_px": 288 * 510,
                              "tiling.window_px": tiles * 288 * 344,
                              "tiling.calls": calls}
