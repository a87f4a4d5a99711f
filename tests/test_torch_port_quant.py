"""sr_torch int8 serving against the JAX package: the int8 conv's plain
versions, the quantizers, calibration, ``quantized_apply``, the static
predict, the fused-quant tail, ``upscale(quantize=...)`` and the server.

Weights come from a JAX ``init`` and cross with ``from_jax_params``; inputs
come from ``np.random.default_rng``. Everything runs on the CPU, where the
int8 conv takes its exact float64 plain version. The CUDA kernel is held to
that plain version on a card, in tests/test_torch_port_cuda.py.
"""

import http.client
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from sr.infer import upscale as jax_upscale
from sr.kernels.fused_tail import (
    make_fused_tail_predict_quant as jax_fused_tail_quant)
from sr.kernels.int8_conv import (
    conv3x3_bf16_im2col, conv3x3_int8_im2col, conv3x3_int8_reference)
from sr.models.edsr import Net as FlaxEDSR
from sr.quant import calibrate_scales as jax_calibrate
from sr.quant import quantize_activation as jax_qact
from sr.quant import quantize_activation_static as jax_qact_static
from sr.quant import quantize_kernel as jax_qkernel
from sr.quant import quantized_apply as jax_quantized_apply
from sr_torch import quant
from sr_torch.infer import upscale
from sr_torch.kernels.depth_to_space import depth_to_space_plain
from sr_torch.kernels.fused_tail import make_fused_tail_predict_quant
from sr_torch.kernels.int8_conv import (
    conv_bf16_im2col, conv_bf16_plain, conv_int8_im2col, conv_int8_plain)
from sr_torch.models.edsr import Net
from sr_torch.nn.intercept import intercept_convs, site_keys
from sr_torch.quant import (
    calibrate_scales, calibrate_scales_batches, make_quantized_predict,
    quantize_activation, quantize_activation_static, quantize_kernel,
    quantized_apply, to_u8)
from sr_torch.serve import SRService, serve_background
from sr_torch.utils.interop import from_jax_params
from test_torch_port_d2s_bias import with_random_biases
from test_torch_port_serve import _img, _png, edsr_params  # noqa: F401

torch.set_num_threads(1)


def _q(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _edsr_pair(scale, seed=0, dtype="float32", hw=(12, 10), batch=2):
    """2 blocks × 16 filters, the same weights in both packages."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(seed).uniform(0, 1, (batch, *hw, 3))
    x = x.astype(np.float32)
    jm = FlaxEDSR(3, 16, 2, scale, 1.0, jdt)
    v = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    params = jax.tree.map(np.array, v["params"])
    tm = from_jax_params(Net(3, 16, 2, scale, dtype=tdt), params)
    return jm, v, tm, x


# ------------------------------------------------------ the conv kernel ----

@pytest.mark.parametrize("b,h,w,c,n", [
    (1, 8, 8, 8, 8), (2, 16, 12, 8, 16), (1, 6, 10, 4, 4), (1, 5, 7, 4, 8),
    (2, 5, 7, 3, 16),  # EDSR's head: C=3
])
def test_conv_int8_plain_matches_reference_and_pallas(b, h, w, c, n):
    """Exact: the shapes of tests/test_pallas_int8.py, plus C=3."""
    rng = np.random.default_rng(b * 100 + h + c)
    q_x, q_w = _q(rng, (b, h, w, c)), _q(rng, (3, 3, c, n))
    got = conv_int8_plain(torch.from_numpy(q_x), torch.from_numpy(q_w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(conv3x3_int8_reference(q_x, q_w)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(conv3x3_int8_im2col(q_x, q_w,
                                                    interpret=True)))


def test_conv_int8_plain_saturated_inputs_exact():
    """±127 everywhere at C=64: the accumulator reaches 9·64·127²."""
    q_x = np.full((1, 8, 8, 64), 127, np.int8)
    q_w = np.full((3, 3, 64, 8), -127, np.int8)
    got = conv_int8_im2col(torch.from_numpy(q_x), torch.from_numpy(q_w))
    assert int(got.min()) == -9 * 64 * 127 * 127
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(conv3x3_int8_im2col(q_x, q_w,
                                                    interpret=True)))


@pytest.mark.parametrize("k", [1, 5, 7])
def test_conv_int8_plain_any_odd_k_matches_lax(k):
    """k=7 is the fused-quant tail's composite conv, which the JAX package
    runs as an XLA int8 conv."""
    rng = np.random.default_rng(k)
    q_x, q_w = _q(rng, (2, 9, 11, 16)), _q(rng, (k, k, 16, 12))
    want = lax.conv_general_dilated(
        q_x, q_w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = conv_int8_im2col(torch.from_numpy(q_x), torch.from_numpy(q_w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv_bf16_plain_matches_pallas_interpret():
    """Both sum exact bf16 products in float32, in another order."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 12, 16, 8)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((3, 3, 8, 8)) * 0.2, jnp.bfloat16)
    want = np.asarray(conv3x3_bf16_im2col(x, w, interpret=True))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    got = conv_bf16_im2col(t(x), t(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, conv_bf16_plain(t(x), t(w)))


def test_conv_wrappers_refuse_bad_operands_and_take_plain_on_cpu():
    q_x = torch.zeros((1, 6, 6, 8), dtype=torch.int8)
    before = conv_int8_im2col.launches
    with pytest.raises(ValueError, match="odd square"):
        conv_int8_im2col(q_x, torch.zeros((4, 4, 8, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="C_in"):
        conv_int8_im2col(q_x, torch.zeros((3, 3, 4, 8), dtype=torch.int8))
    with pytest.raises(TypeError, match="int8"):
        conv_int8_im2col(q_x.float(), torch.zeros((3, 3, 8, 8)))
    with pytest.raises(TypeError, match="bfloat16"):
        conv_bf16_im2col(q_x.float(), torch.zeros((3, 3, 8, 8)))
    conv_int8_im2col(q_x, torch.zeros((3, 3, 8, 8), dtype=torch.int8))
    assert conv_int8_im2col.launches == before  # no kernel on the CPU


# --------------------------------------------------------- quantizers ----

def test_quantizers_match_jax_exactly():
    rng = np.random.default_rng(6)
    kernel = (rng.standard_normal((3, 3, 8, 5)) * 0.1).astype(np.float32)
    kernel[..., 2] = 0.0  # an all-zero channel takes the EPS floor
    x = (rng.standard_normal((3, 5, 4, 8)) * [[[[1, 10, 0.01, 3] * 2]]])
    x = x.astype(np.float32)
    pairs = [(quantize_kernel(torch.from_numpy(kernel)), jax_qkernel(kernel)),
             (quantize_activation(torch.from_numpy(x)), jax_qact(x))]
    for scale in (0.013, np.abs(x).max(axis=(0, 1, 2)) / 127.0 * 0.5):
        pairs.append((quantize_activation_static(torch.from_numpy(x), scale),
                      jax_qact_static(x, scale)))
    for (q, s), (jq, js) in pairs:
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# -------------------------------------------------------- calibration ----

@pytest.mark.parametrize("per_channel,headroom",
                         [(True, 1.0), (False, 1.0), (True, 1.25)])
def test_calibrate_scales_matches_jax(per_channel, headroom):
    """f32 models: the same site keys, values within rtol 1e-6 (the two
    float graphs may sum in another order; on these inputs they agree
    exactly)."""
    jm, v, tm, x = _edsr_pair(4)
    want = jax_calibrate(jm, v, x, headroom=headroom,
                         per_channel=per_channel, train=False)
    got = calibrate_scales(tm, torch.from_numpy(x), headroom=headroom,
                           per_channel=per_channel)
    assert set(got) == set(want) == set(site_keys(tm).values())
    assert "blocks_1/Conv_1" in got and "upsample_1/Conv_0" in got
    for k in want:
        assert np.ndim(got[k]) == (1 if per_channel else 0)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_calibrate_scales_batches_keeps_max():
    _, _, tm, x = _edsr_pair(2, batch=1)
    x1 = torch.from_numpy(x)
    x2 = 3.0 * x1
    agg = calibrate_scales_batches(tm, [x1, x2])
    only2 = calibrate_scales(tm, x2)
    assert set(agg) == set(only2)
    for k in agg:  # the brighter batch dominates every site
        np.testing.assert_array_equal(agg[k], np.maximum(
            calibrate_scales(tm, x1)[k], only2[k]))
    with pytest.raises(ValueError, match="empty"):
        calibrate_scales_batches(tm, [])


# ---------------------------------------------------- quantized apply ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("mode", ["per_channel", "per_tensor", "dynamic",
                                  "missing_site"])
def test_quantized_apply_equals_jax_bit_for_bit(mode, scale, dtype):
    """Given JAX's scales, the port's int8 forward equals
    ``sr.quant.quantized_apply`` exactly: the same quantizers, an exact
    int32 accumulator, and the same float32 rescale, bias and cast. Both
    run float32 activations whatever the model's dtype; a site missing
    from the scales runs dynamic."""
    jm, v, tm, x = _edsr_pair(scale, dtype=dtype)
    scales = None
    if mode != "dynamic":
        scales = jax_calibrate(jm, v, x, per_channel=mode != "per_tensor",
                               train=False)
    if mode == "missing_site":
        del scales["blocks_1/Conv_0"]
    want = np.asarray(jax_quantized_apply(jm, v, x, scales=scales,
                                          train=False))
    got = quantized_apply(tm, torch.from_numpy(x), scales=scales)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["per_channel", "dynamic"])
def test_quantized_apply_with_random_biases_equals_jax_bit_for_bit(mode,
                                                                   dtype):
    """Every conv's bias nonzero, the PS convs' too. Under the int8
    interceptor the int8 conv adds a PS conv's bias in its store and the
    shuffle adds none, as ``sr.quant`` does: a bias added twice or dropped
    breaks the equality. The JAX package calibrates the scales (on the
    biased float graph); the port's calibration on the same graph agrees
    within rtol 1e-6."""
    jm, v, _, x = _edsr_pair(4, seed=5, dtype=dtype)
    params = with_random_biases(v["params"], 5)
    assert np.abs(params["upsample_1"]["Conv_0"]["bias"]).min() > 0
    tdt = getattr(torch, dtype)
    tm = from_jax_params(Net(3, 16, 2, 4, dtype=tdt), params)
    scales = None
    if mode != "dynamic":
        scales = jax_calibrate(jm, {"params": params}, x, train=False)
        if dtype == "float32":
            ours = calibrate_scales(tm, torch.from_numpy(x))
            for k in scales:
                np.testing.assert_allclose(ours[k], scales[k], rtol=1e-6)
    want = np.asarray(jax_quantized_apply(jm, {"params": params}, x,
                                          scales=scales, train=False))
    got = quantized_apply(tm, torch.from_numpy(x), scales=scales)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_apply_refuses_what_no_port_model_has():
    for conv in (torch.nn.Conv2d(4, 4, 3, stride=2, padding=1),
                 torch.nn.Conv2d(4, 4, 3, padding=1, groups=2),
                 torch.nn.Conv2d(4, 4, 2, padding=1),
                 torch.nn.ConvTranspose2d(4, 4, 4, stride=2, padding=1)):
        with pytest.raises(NotImplementedError, match="later port slice"):
            quant.int8_conv(torch.zeros((1, 4, 6, 6)), conv)


def test_interceptor_sees_every_conv_once_per_forward():
    """The unfused ResnetBlock path under an interceptor: each of the 2·2
    body convs, head, body_conv, two PS convs and the out conv is a site,
    in forward order."""
    _, _, tm, x = _edsr_pair(4, batch=1)
    keys = site_keys(tm)
    seen = []
    with torch.inference_mode(), intercept_convs(
            lambda conv, inp: seen.append(keys[conv])):
        tm(torch.from_numpy(x))
    assert seen == ["head/Conv_0", "blocks_0/Conv_0", "blocks_0/Conv_1",
                    "blocks_1/Conv_0", "blocks_1/Conv_1", "body_conv/Conv_0",
                    "upsample_0/Conv_0", "upsample_1/Conv_0",
                    "out_conv/Conv_0"]


def test_static_predict_calibrates_once_and_is_batch_independent(
        monkeypatch):
    """mode='static' calibrates once, on the first batch; the scales are
    then constants, so an image's output does not depend on what it is
    batched with (tests/test_quant.py:448)."""
    _, _, tm, x = _edsr_pair(2, batch=1)
    calls = []
    real = quant.calibrate_scales
    monkeypatch.setattr(quant, "calibrate_scales",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fn = make_quantized_predict(tm, "static")
    x0 = torch.from_numpy(x)
    solo = fn(x0)
    paired = fn(torch.cat([x0, 2.0 * torch.flip(x0, (1,))]))[:1]
    assert torch.equal(solo, paired)
    assert len(calls) == 1
    fn.calibrate([x0 * 5])  # no-op once calibrated
    assert torch.equal(fn(x0), solo) and len(calls) == 1
    with pytest.raises(ValueError, match="mode"):
        make_quantized_predict(tm, "per_tensor")


# --------------------------------------------------- fused-quant tail ----

def test_fused_tail_quant_interior_matches_jax():
    """Both packages probe the composite kernel K in float32 and round it
    to int8 on the host; K may differ in its last float bits, which can
    move a weight across an int8 rounding edge. Measured interior error
    against JAX on this input: 0.0 (equal); held at 1e-2 of the output
    range. The u8 output, quantized before the shuffle, equals to_u8 of
    the float output."""
    jm, v, tm, x = _edsr_pair(2, hw=(16, 16), batch=1)
    m = (7 // 2) * 2  # border band: support//2 · r
    want = np.asarray(jax_fused_tail_quant(jm, v)(x))
    fn = make_fused_tail_predict_quant(tm)
    got = fn(torch.from_numpy(x))
    assert got.shape == want.shape == (1, 32, 32, 3)
    rng_ = max(want.max() - want.min(), 1e-3)
    err = np.abs(got.numpy() - want)[:, m:-m, m:-m].max() / rng_
    assert err <= 1e-2, err
    fn_u8 = make_fused_tail_predict_quant(tm, output_u8=True)
    got_u8 = fn_u8(torch.from_numpy(x))
    assert got_u8.dtype == torch.uint8
    assert torch.equal(got_u8, to_u8(got))


def test_fused_tail_quant_shuffles_u8_before_the_tail_output():
    """d2s is a permutation, so shuffling u8 equals quantizing the
    shuffled floats (the plain shuffle on u8, as the kernel runs it)."""
    z = torch.from_numpy(np.random.default_rng(7).uniform(
        -0.1, 1.1, (1, 5, 6, 12)).astype(np.float32))
    assert torch.equal(depth_to_space_plain(to_u8(z), 2),
                       to_u8(depth_to_space_plain(z, 2)))


# ------------------------------------------------ upscale and serving ----

def test_full_width_quantized_apply_equals_jax_with_shared_scales(
        edsr_params):
    """Full-width EDSR ×4 (the serving fixture): given JAX's calibrated
    scales, the port's int8 forward equals JAX's bit for bit."""
    from sr.utils.checkpoint import load_params

    params, _ = load_params(edsr_params)
    jm = FlaxEDSR(3, 64, 16, 4)
    tm = from_jax_params(Net(3, 64, 16, 4), params)
    x = _img(8, 10, 9).astype(np.float32)[None] / 255.0
    scales = jax_calibrate(jm, {"params": params}, x, train=False)
    want = np.asarray(jax_quantized_apply(jm, {"params": params}, x,
                                          scales=scales, train=False))
    got = quantized_apply(tm, torch.from_numpy(x), scales=scales)
    np.testing.assert_array_equal(got.numpy(), want)


def test_upscale_static_fused_matches_jax(edsr_params):
    """Full-width EDSR ×4, quantize='static', fused, tile=12 and the
    default bf16 model dtype on both packages. Each package calibrates on
    its own bf16 float graph; the two graphs round differently, so the
    scales differ in their last bits (up to 4.4e-4 relative even in f32 at
    this width) and some activations round to the neighbouring int8 level.
    The int8 path's own error against f32 is up to 13 levels here, so the
    two packages agree only to int8 noise. Measured: max 12 u8 levels,
    mean 1.09; held at max 16, mean 2. With shared scales the forward is
    bit-exact (the test above)."""
    img = _img(5, 20, 18)
    kw = dict(scale_factor=4, tile=12, fused=True, quantize="static")
    want = jax_upscale(img, "EDSR", edsr_params, **kw)
    got = upscale(img, "EDSR", edsr_params, device="cpu", **kw)
    assert got.shape == want.shape == (80, 72, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 16 and diff.mean() <= 2, (diff.max(), diff.mean())


@pytest.mark.parametrize("quantize", ["dynamic", "static"])
def test_upscale_int8_exact_graph_close_to_float(edsr_params, quantize):
    """The int8 exact graph (no fused tail) against the f32 float graph:
    int8 noise only (tests/test_quant.py:298 holds the mean at 4)."""
    img = _img(6, 12, 14)
    ref = upscale(img, "EDSR", edsr_params, dtype="float32", device="cpu")
    out = upscale(img, "EDSR", edsr_params, quantize=quantize, device="cpu")
    assert out.shape == ref.shape == (48, 56, 3)
    assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).mean() <= 4


def test_server_quantize_static_roundtrip(edsr_params):
    service = SRService(model_name="EDSR", params=edsr_params, scale_factor=4,
                        quantize="static", device="cpu")
    httpd, port = serve_background(service)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/info")
        info = json.loads(conn.getresponse().read())
        assert info["quantize"] == "static" and info["fused"] is True
        img = _img(7, 12, 16)
        conn.request("POST", "/upscale", body=_png(img),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200, body
        from PIL import Image

        got = np.asarray(Image.open(io.BytesIO(body)))
        want = upscale(img, "EDSR", edsr_params, fused=True,
                       quantize="static", device="cpu")
        np.testing.assert_array_equal(got, want)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_serve_cli_parses_quantize(monkeypatch):
    from sr_torch import serve

    class Stop(Exception):
        pass

    seen = {}

    def fake_service(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(serve, "SRService", fake_service)
    for argv, want in (([], False), (["--quantize"], "dynamic"),
                       (["--quantize", "static"], "static")):
        with pytest.raises(Stop):
            serve.main(["--model_name", "EDSR", "--params", "p.npz", *argv])
        assert seen["quantize"] == want and seen["calib_headroom"] == 1.25
