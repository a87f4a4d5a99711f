"""The readers of the program's own spans and counters on a hand-made
timeline (microseconds), their silence where the program has neither,
and a traced CPU run of each cell that prints the metrics of its cell."""

import sys
import types

import pytest

from srbench import harness, trace
from srbench.harness import Context

# window 0–100; device busy 10–40, 50–60, a copy 70–80, 95–100 (and past)
DEVICE = [("kernel_a", 10, 30), ("kernel_b", 25, 40), ("kernel_a", 50, 60),
          ("Memcpy DtoH (Device -> Pageable)", 70, 80),
          ("kernel_c", 95, 110)]
OPERATOR = ("sr_torch::conv_int8_fused", [[8, 180, 320, 64]], 12, 13)


def _ctx(spans=(), window=None):
    ops = [OPERATOR] + [(name, [], s, e) for name, s, e in spans]
    kernels = [d for d in DEVICE if not d[0].startswith("Memcpy")]
    tr = trace.Trace((0, 100), list(DEVICE), kernels, ops, [])
    return Context({}, {}, {}, 1.0, window or {}, tr)


def _read(name, ctx):
    return harness.Bench().reader("layer_metrics", name).read(ctx)


def test_upscale_pre_ms():
    # pre spans of 8, 4 and 10 µs: the median 8 µs
    ctx = _ctx([("sr_torch::upscale.pre", 0, 8),
                ("sr_torch::upscale.pre", 50, 54),
                ("sr_torch::upscale.pre", 60, 70)])
    assert _read("upscale_pre_ms.photo", ctx) == pytest.approx(8e-3)


def test_upscale_fetch_host_ms():
    # 35–45 holds device 35–40: 5 µs of host; 62–82 holds the copy 70–80:
    # 10; 90–100 holds 95–100: 5; the median 5 µs
    ctx = _ctx([("sr_torch::upscale.fetch", 35, 45),
                ("sr_torch::upscale.fetch", 62, 82),
                ("sr_torch::upscale.fetch", 90, 100)])
    assert _read("upscale_fetch_host_ms.photo", ctx) == pytest.approx(5e-3)


def test_int8_site_host_us():
    # sites of 2, 8 and 5 µs; the operator call inside one is no site
    ctx = _ctx([("sr_torch::int8.site", 12, 14),
                ("sr_torch::int8.site", 16, 24),
                ("sr_torch::int8.site", 30, 35)])
    assert _read("int8_site_host_us.frames", ctx) == pytest.approx(5.0)


def test_route_idle_pct():
    # device idle 0–10, 40–50, 60–70, 80–95; routes 5–45 and 55–90 cover
    # 5 + 5 + 10 + 10 µs of it: 30% of the window
    ctx = _ctx([("sr_torch::route.forward", 5, 45),
                ("sr_torch::route.forward", 55, 90)])
    assert _read("route_idle_pct.frames", ctx) == pytest.approx(30.0)
    assert _read("device_idle_pct.frames", ctx) == pytest.approx(45.0)


def _profiling_module(monkeypatch, counts):
    mod = types.ModuleType("sr_torch.utils.profiling")
    if counts is not None:
        mod.counters = lambda: dict(counts)
    monkeypatch.setitem(sys.modules, "sr_torch.utils.profiling", mod)


def test_tile_overcompute(monkeypatch):
    _profiling_module(monkeypatch, {"tiling.image_px": 515_610,
                                    "tiling.window_px": 1_336_096,
                                    "tiling.calls": 3})
    assert _read("tile_overcompute.photo", _ctx()) == pytest.approx(
        1_336_096 / 515_610)


SPAN_METRICS = ["upscale_pre_ms.photo", "upscale_fetch_host_ms.photo",
                "int8_site_host_us.frames", "route_idle_pct.frames"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_silent_without_the_spans(name):
    # a program without spans (the operator's call is not one), or no trace
    assert _read(name, _ctx()) is None
    assert _read(name, Context({}, {}, {}, 1.0, {}, None)) is None


@pytest.mark.parametrize("counts", [None, {}, {"tiling.calls": 2}])
def test_tile_overcompute_silent_without_the_counters(monkeypatch, counts):
    _profiling_module(monkeypatch, counts)
    assert _read("tile_overcompute.photo", _ctx()) is None


NEW = set(SPAN_METRICS) | {"tile_overcompute.photo"}


@pytest.mark.parametrize("cell", [c["name"] for c in
                                  harness.Bench().spec["workloads"]])
def test_a_traced_run_prints_its_cells_metrics(tiny_root, cell):
    bench = harness.Bench(tiny_root)
    want = {m["name"] for m in bench.metrics(cell, "per_layer")} & NEW
    assert want
    result, _ = harness.run_cell(bench, cell, 2 ** 31 + 7, 0.5, True,
                                 lambda: 0.0, device="cpu")
    got = {k: v["value"] for k, v in result["metrics"].items() if k in NEW}
    assert set(got) == want
    if "tile_overcompute.photo" in got:
        assert got["tile_overcompute.photo"] >= 1.0
    assert not [n for n, _ in result["breakdown"]["device_ops"]
                if n.startswith("sr_torch::")]
