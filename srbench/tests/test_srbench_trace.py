"""The trace reductions, roofline, mfu and idle arithmetic on a
hand-made timeline (microseconds)."""

import pytest

from srbench import counts, trace
from srbench.harness import Context

# window 0–100; kernels 10–30 and 25–40 overlap, 50–60, a copy 70–80,
# and one kernel 95–110 runs past the window's end
DEVICE = [("void (anonymous namespace)::resblock_bf16_kernel<64>(x)", 10, 30),
          ("sm90_xmma_fprop_cudnn", 25, 40),
          ("void (anonymous namespace)::resblock_bf16_kernel<64>(x)", 50, 60),
          ("Memcpy DtoH (Device -> Pinned)", 70, 80),
          ("void (anonymous namespace)::d2s_staged<unsigned char, false>(x)",
           95, 110)]
OPS = [("sr_torch::fused_resblock", [[8, 180, 320, 64], [9, 64, 64], [64],
                                     [9, 64, 64], [64], []], 5, 6),
       ("aten::conv2d", [[1]], 20, 21),
       ("sr_torch::fused_resblock", [[8, 180, 320, 64], [9, 64, 64], [64],
                                     [9, 64, 64], [64], []], 45, 46),
       ("sr_torch::depth_to_space", [[8, 180, 320, 48], [], [], []], 90, 91)]
SPANS = [("srbench.predict", 0, 45), ("srbench.wait", 40, 65),
         ("srbench.copy", 60, 100)]


def _trace():
    kernels = [d for d in DEVICE if not d[0].startswith("Memcpy")]
    return trace.Trace((0, 100), list(DEVICE), kernels, list(OPS), list(SPANS))


def test_union_and_gaps():
    t = _trace()
    # union inside [0, 100]: 10–40, 50–60, 70–80, 95–100 = 30+10+10+5
    assert trace.union_length(t.device, 0, 100) == 55
    assert trace.idle_gaps(t.device, 0, 100) == [(0, 10), (40, 50),
                                                  (60, 70), (80, 95)]
    busy, window = trace.busy_idle(t)
    assert (busy, window) == pytest.approx((55e-6, 100e-6))


def test_gap_named_by_innermost_span():
    t = _trace()
    assert trace.span_at(t.spans, 42) == "srbench.wait"   # both open
    assert trace.span_at(t.spans, 5) == "srbench.predict"
    assert trace.span_at(t.spans, 150) == "no srbench span"
    b = trace.breakdown(t)
    assert b["idle_gaps"][0] == ["srbench.copy", pytest.approx(15e-6)]
    assert [n for n, _ in b["device_ops"]][0].endswith("resblock_bf16_kernel"
                                                         "<64>(x)")
    assert b["device_ops"][0][1] == pytest.approx(30e-6)


def test_launches_pair_calls_with_kernels():
    t = _trace()
    pairs = trace.launches(t, "sr_torch::fused_resblock",
                           r"(^|\s|::)resblock_bf16_kernel\b")
    assert [us for _, _, us in pairs] == [20, 10]
    # more calls than kernels: nothing to read
    t.ops.append(OPS[0])
    assert trace.launches(t, "sr_torch::fused_resblock",
                          r"(^|\s|::)resblock_bf16_kernel\b") is None


def test_roofline_shares():
    t = _trace()
    pairs = trace.launches(t, "sr_torch::fused_resblock",
                           r"(^|\s|::)resblock_bf16_kernel\b")
    bound = counts.resblock_bound_s((8, 180, 320, 64))
    got = trace.roofline_pct(pairs, lambda s, n: bound)
    assert got == pytest.approx(100 * 2 * bound / 30e-6)
    assert trace.roofline_pct([], lambda s, n: bound) is None
    assert trace.roofline_pct(pairs, lambda s, n: None) is None


def _reader(folder, name):
    from srbench.harness import Bench

    return Bench().reader(folder, name)


def _ctx(tr, window, serving=None):
    cfg = {"base_filter": 64, "num_channels": 3, "kernel_size": 3,
           "head_kernel_size": 3, "out_kernel_size": 3, "num_resblocks": 16,
           "upsample_factors": [2, 2],
           "serving": serving or {"dtype": "bfloat16", "quantize": False}}
    return Context({}, cfg, {}, 1.0, window, tr)


def test_layer_readers_on_the_timeline():
    t = _trace()
    ctx = _ctx(t, {"enqueue_s": [0.001, 0.003]})
    assert _reader("layer_metrics", "device_idle_pct.frames").read(ctx) == \
        pytest.approx(45.0)
    assert _reader("layer_metrics", "host_enqueue_ms.frames").read(ctx) == \
        pytest.approx(2.0)
    # the d2s kernel: u8 from its template argument, 15 µs
    d2s = _reader("layer_metrics", "d2s_roofline.frames").read(ctx)
    assert d2s == pytest.approx(
        100 * counts.d2s_bound_s((8, 180, 320, 48), 1, False) / 15e-6)
    assert _reader("layer_metrics", "int8_conv_roofline").read(ctx) is None
    no_trace = _ctx(None, {})
    assert _reader("layer_metrics", "resblock_roofline").read(no_trace) is None


def test_upscale_host_ms():
    # request 0–50 holds kernels 10–40 (30 µs): 20 µs of host time;
    # request 50–100 holds 50–60 and 95–100 (15 µs): 35 µs
    t = _trace()
    t.spans = [("srbench.request", 0, 50), ("srbench.request", 50, 100)]
    got = _reader("layer_metrics", "upscale_host_ms.photo").read(_ctx(t, {}))
    assert got == pytest.approx(27.5e-3)


def test_mfu_arithmetic():
    window = {"lr_shapes": [(8, 180, 320)] * 100, "window_s": 2.0}
    ctx = _ctx(None, window)
    ops = 100 * counts.model_ops(ctx.config, 8, 180, 320)
    assert counts.mfu_pct(ctx) == pytest.approx(100 * ops / 2.0 / 989e12)
    ctx8 = _ctx(None, window, {"dtype": "bfloat16", "quantize": "static"})
    assert counts.mfu_pct(ctx8) == pytest.approx(100 * ops / 2.0 / 1979e12)
    assert counts.mfu_pct(_ctx(None, {"lr_shapes": [], "window_s": 1.0})) \
        is None


def test_end_to_end_readers():
    lat = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    ctx = _ctx(None, {"latencies_s": lat, "out_pixels": 3e8,
                      "window_s": 2.0})
    assert _reader("end_to_end", "latency_p50_ms").read(ctx) == \
        pytest.approx(50.5)
    assert _reader("end_to_end", "latency_p95_ms").read(ctx) == \
        pytest.approx(95.05)
    assert _reader("end_to_end", "throughput_mps").read(ctx) == \
        pytest.approx(150.0)
    assert _reader("end_to_end", "setup_s").read(ctx) == 1.0
