"""sr_torch serves and evaluates FSRCNN and LapSRN ×4 on Y against the JAX
package: ``int8_deconv`` (the phase-packed int8 conv and the shuffle) bit
for bit against ``sr.quant.int8_deconv``, the phase repack against a
float64 transposed conv, calibration keys and scales, int8 forwards with
shared scales with and without ``quantize_deconv``, the sites and shuffles
a forward runs, ``upscale`` on RGB images (whole and in halo tiles, float
and int8), LapSRN's pyramid levels through ``net_scale`` and the refusals
of ``sr.infer``, the HTTP service with ``--net_scale`` and ``evaluate`` on
Y.

Small models (FSRCNN d=16 s=8 m=2, LapSRN 16 filters × 2 convs a level)
for the int8 and eval checks; ``upscale`` builds the repo's full widths
(FSRCNN 56/12/4, LapSRN 64 × 5), so its params do too. Weights come from
a JAX ``init``, redrawn He-scaled with nonzero biases; everything runs on
the CPU.
"""

import http.client
import io

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sr.eval.runner import evaluate as jax_evaluate
from sr.infer import upscale as jax_upscale
from sr.models.registry import get_spec as jax_get_spec
from sr.quant import calibrate_scales as jax_calibrate
from sr.quant import int8_deconv as jax_int8_deconv
from sr.quant import quantized_apply as jax_quantized_apply
from sr.utils.checkpoint import save_params as jax_save_params
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch import quant
from sr_torch.data.datasets import SyntheticDataset
from sr_torch.data.native import resize_bicubic_u8
from sr_torch.eval.runner import evaluate
from sr_torch.infer import upscale
from sr_torch.nn.blocks import DeconvBlock, deconv_padding
from sr_torch.quant import (
    calibrate_scales, int8_deconv, make_quantized_predict, phase_pack,
    quantized_apply)
from sr_torch.serve import SRService, serve_background
from sr_torch.utils.interop import from_jax_params
from test_torch_fsrcnn_models import _fsrcnn_pair, _init, _lapsrn_pair, lively

torch.set_num_threads(1)

MODELS = ("FSRCNN", "LapSRN")
PAIRS = {"FSRCNN": _fsrcnn_pair, "LapSRN": _lapsrn_pair}


def pair(name, seed, r=4):
    """(flax module, its variables, the port module with the same params,
    eval mode)."""
    jm, tm = PAIRS[name](r)
    x = np.zeros((1, 8, 8, 1), np.float32)
    params = _init(jm, x, seed)
    from_jax_params(tm, params)
    return jm, {"params": params}, tm


def _x(seed, b=2, hw=(11, 9)):
    return np.random.default_rng(seed).uniform(0, 1, (b, *hw, 1)).astype(
        np.float32)


# ------------------------------------------------------- int8 deconv ----

#: (k, s, C_in, N): LapSRN's feature and image deconvs, FSRCNN's tail
_DECONVS = ((4, 2, 6, 5), (4, 2, 1, 1), (9, 4, 7, 1))


def _flax_deconv(k, s, n, kernel, bias, x, static_scale):
    """``sr.quant.int8_deconv`` on a bound ``nn.ConvTranspose`` with
    DeconvBlock's padding pair."""
    p, _ = deconv_padding(k, s)

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, xx):
            m = fnn.ConvTranspose(n, (k, k), strides=(s, s),
                                  padding=((k - 1 - p, s - 1 + p),) * 2)
            m(xx)  # bind the module's params
            return jax_int8_deconv(xx, m, static_scale=static_scale)

    return np.asarray(Wrap().apply(
        {"params": {"ConvTranspose_0": {"kernel": kernel, "bias": bias}}},
        jnp.asarray(x)))


@pytest.mark.parametrize("mode", ["per_channel", "per_tensor", "dynamic"])
@pytest.mark.parametrize("k,s,cin,n", _DECONVS)
def test_int8_deconv_equals_jax_bit_for_bit(k, s, cin, n, mode):
    """Quantize the deconv's own kernel per output channel, repack it into
    s² sub-pixel phases, the fused int8 conv, the shuffle: equal to
    ``lax.conv_transpose``'s int32 accumulator, dequantized and biased as
    the JAX package does, on an odd 5×7 input with a seeded non-symmetric
    kernel and a nonzero bias."""
    rng = np.random.default_rng(k * 100 + cin)
    x = rng.normal(0, 1, (2, 5, 7, cin)).astype(np.float32)
    kernel = rng.normal(0, 0.3, (k, k, cin, n)).astype(np.float32)
    bias = rng.normal(0, 0.1, (n,)).astype(np.float32)
    scale = {"per_channel": np.abs(x).max((0, 1, 2)) / 127 * 0.8,
             "per_tensor": float(np.abs(x).max() / 127 * 0.8),
             "dynamic": None}[mode]
    want = _flax_deconv(k, s, n, kernel, bias, x, scale)
    tm = DeconvBlock(cin, n, k, s, act=None)
    from_jax_params(tm, {"ConvTranspose_0": {"kernel": kernel,
                                             "bias": bias}})
    got = int8_deconv(torch.from_numpy(x).permute(0, 3, 1, 2),
                      tm.ConvTranspose_0, scale).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 5 * s, 7 * s, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,s", [(4, 2), (9, 4), (9, 2), (5, 3), (2, 2),
                                 (6, 4)])
def test_phase_pack_equals_the_transposed_conv(k, s):
    """The phase-packed SAME conv, shuffled at r=s, equals
    ``F.conv_transpose2d`` at DeconvBlock's geometry exactly in float64
    (both geometries of the zoo and four others)."""
    rng = np.random.default_rng(k * 10 + s)
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, 7)))
    w = torch.from_numpy(rng.normal(size=(3, 4, k, k)))
    p, op = deconv_padding(k, s)
    want = F.conv_transpose2d(x, w, stride=s, padding=p, output_padding=op)
    wp = phase_pack(w.permute(2, 3, 0, 1), s)
    r = wp.shape[0] // 2
    y = F.conv2d(x, wp.permute(3, 2, 0, 1), padding=r)
    got = quant.depth_to_space(y.permute(0, 2, 3, 1).contiguous(), s)
    assert got.shape == (2, 5 * s, 7 * s, 4)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=0,
                               atol=1e-12)
    if (k, s) in ((4, 2), (9, 4)):  # the zoo's: offsets d in {-1, 0, 1}
        assert wp.shape[:2] == (3, 3)
    # no tap row or column of the packed kernel is empty: R is the least
    assert wp[0].abs().sum() > 0 and wp[:, 0].abs().sum() > 0


def test_int8_sites_refuse_what_the_port_cannot_run():
    """A deconv is ``int8_deconv``'s site, not ``int8_conv``'s; a deconv
    of another geometry than DeconvBlock's exact ×stride is refused, never
    run in float."""
    d = DeconvBlock(4, 4, 4, 2).ConvTranspose_0
    with pytest.raises(TypeError, match="int8_deconv"):
        quant.int8_conv(torch.zeros((1, 4, 6, 6)), d)
    for bad in (torch.nn.ConvTranspose2d(4, 4, 4, stride=2, padding=0),
                torch.nn.ConvTranspose2d(4, 4, 4, stride=2, padding=1,
                                         groups=2),
                torch.nn.ConvTranspose2d(4, 4, (4, 3), stride=2,
                                         padding=1)):
        with pytest.raises(NotImplementedError, match="later port slice"):
            int8_deconv(torch.zeros((1, 4, 6, 6)), bad)
    with pytest.raises(TypeError, match="ConvTranspose2d"):
        int8_deconv(torch.zeros((1, 4, 6, 6)),
                    torch.nn.Conv2d(4, 4, 3, padding=1))


# ------------------------------------------------------ int8 forwards ----

@pytest.mark.parametrize("name", MODELS)
def test_calibration_keys_and_scales_equal_jax(name):
    """The port calibrates every conv and every deconv, as
    ``sr.quant.calibrate_scales`` records deconv inputs whether or not
    they will run int8: the same keys, per channel and per tensor, the
    scales within 1e-5 relative (the float forwards' summation order)."""
    jm, v, tm = pair(name, seed=13)
    x = _x(14)
    for per_channel in (True, False):
        want = jax_calibrate(jm, v, x, per_channel=per_channel)
        got = calibrate_scales(tm, torch.from_numpy(x),
                               per_channel=per_channel)
        assert set(got) == set(want)
        assert sum("ConvTranspose" in k for k in got) == (
            1 if name == "FSRCNN" else 4)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


@pytest.mark.parametrize("mode", ["per_channel", "per_tensor", "dynamic"])
@pytest.mark.parametrize("name", MODELS)
def test_int8_deconv_forward_equals_jax_bit_for_bit(name, mode):
    """With ``quantize_deconv`` every conv and deconv runs int8; given the
    JAX package's scales the port's forward equals
    ``sr.quant.quantized_apply(..., quantize_deconv=True)`` exactly, the
    activations and adds between the sites float32 in both (the reference
    op by op, under ``jax.disable_jit``)."""
    jm, v, tm = pair(name, seed=11)
    x = _x(12)
    scales = None
    if mode != "dynamic":
        scales = jax_calibrate(jm, v, x, per_channel=mode == "per_channel")
    with jax.disable_jit():
        want = np.asarray(jax_quantized_apply(jm, v, x, scales=scales,
                                              quantize_deconv=True))
    got = quantized_apply(tm, torch.from_numpy(x), scales=scales,
                          quantize_deconv=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["per_channel", "dynamic"])
@pytest.mark.parametrize("name", MODELS)
def test_default_int8_runs_deconvs_float(name, mode):
    """By default the deconvs run in the compute dtype (float32 here) and
    only the convs run int8, as in the JAX package. FSRCNN's deconv is its
    last op: within 1e-6 of JAX's (its float32 summation order). LapSRN's
    deconvs feed int8 sites, where a float32 rounding apart can move an
    activation across a quantization step, so the bound is that step's
    effect: mean 1e-5, max 2e-3."""
    jm, v, tm = pair(name, seed=15)
    x = _x(16)
    scales = None if mode == "dynamic" else jax_calibrate(jm, v, x)
    with jax.disable_jit():
        want = np.asarray(jax_quantized_apply(jm, v, x, scales=scales))
    got = quantized_apply(tm, torch.from_numpy(x), scales=scales).numpy()
    d = np.abs(got - want)
    if name == "FSRCNN":
        assert d.max() <= 1e-6, d.max()
    else:
        assert d.mean() <= 1e-5 and d.max() <= 2e-3, (d.mean(), d.max())
    # and the deconvs did run float: int8 deconvs give another output
    all_int8 = quantized_apply(tm, torch.from_numpy(x), scales=scales,
                               quantize_deconv=True).numpy()
    assert np.abs(all_int8 - got).max() > 1e-4


@pytest.mark.parametrize("quantize_deconv", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_sites_and_shuffles_a_forward(monkeypatch, name, quantize_deconv):
    """At full width, one static int8 forward runs 7 (FSRCNN) or 13
    (LapSRN) fused int8 convs and no shuffle; with ``quantize_deconv`` 8
    and 1, or 17 and 4: each deconv one phase-packed 3×3 conv of s²·N
    outputs and one shuffle at r=s."""
    from sr_torch.models.registry import get_spec
    from sr_torch.utils.config import SRConfig

    tm = get_spec(name).make_model(SRConfig(model_name=name)).eval()
    calls = {"int8": [], "d2s": []}
    real_int8, real_d2s = quant.conv_int8_fused, quant.depth_to_space

    def int8_seen(xh, q_w, *a, **kw):
        calls["int8"].append((q_w.shape[0], xh.shape[-1], q_w.shape[-1]))
        return real_int8(xh, q_w, *a, **kw)

    def d2s_seen(y, r, *a, **kw):
        calls["d2s"].append((y.shape[-1], r))
        return real_d2s(y, r, *a, **kw)

    monkeypatch.setattr(quant, "conv_int8_fused", int8_seen)
    monkeypatch.setattr(quant, "depth_to_space", d2s_seen)
    x = torch.from_numpy(_x(17, b=1, hw=(6, 5)))
    fn = make_quantized_predict(tm, "static", quantize_deconv=quantize_deconv)
    out = fn(x)
    assert out.shape == (1, 24, 20, 1)
    calls = {"int8": [], "d2s": []}
    fn(x)
    n_int8, n_d2s = {("FSRCNN", False): (7, 0), ("FSRCNN", True): (8, 1),
                     ("LapSRN", False): (13, 0),
                     ("LapSRN", True): (17, 4)}[name, quantize_deconv]
    assert (len(calls["int8"]), len(calls["d2s"])) == (n_int8, n_d2s)
    if name == "FSRCNN":
        assert calls["int8"][:2] == [(5, 1, 56), (1, 56, 12)]
        if quantize_deconv:
            assert calls["int8"][-1] == (3, 56, 16)
            assert calls["d2s"] == [(16, 4)]
    elif quantize_deconv:
        assert sorted(set(calls["d2s"])) == [(4, 2), (256, 2)]
        assert (3, 64, 256) in calls["int8"] and (3, 1, 4) in calls["int8"]


# ------------------------------------------------------------ upscale ----

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Full-width params of each model (what ``upscale`` builds) in the
    JAX package's ``.npz``: He-scaled kernels, biases N(0, 0.02²); FSRCNN's
    deconv bias +0.5 so its outputs spread over [0, 1] (LapSRN's image
    branch carries the input)."""
    out = {}
    root = tmp_path_factory.mktemp("fsrcnn_lapsrn")
    for i, name in enumerate(MODELS):
        jm = jax_get_spec(name).make_model(JaxSRConfig(model_name=name,
                                                       dtype="float32"))
        v = jm.init(jax.random.key(50 + i), jnp.zeros((1, 8, 8, 1)))
        params = lively(jax.tree.map(np.asarray, v["params"]), 50 + i)
        if name == "FSRCNN":
            params["DeconvBlock_0"]["ConvTranspose_0"]["bias"] += 0.5
            params["DeconvBlock_0"]["ConvTranspose_0"]["kernel"] *= 0.3
        else:
            for j in (1, 3):  # the image deconvs: about a 2× upsample
                params[f"DeconvBlock_{j}"]["ConvTranspose_0"]["kernel"] = (
                    np.full((4, 4, 1, 1), 0.25, np.float32))
            for j in (6, 12):
                params[f"ConvBlock_{j}"]["Conv_0"]["kernel"] *= 0.1
        path = str(root / f"{name}_params.npz")
        jax_save_params(path, params)
        out[name] = path
    return out


def _rgb(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("name", MODELS)
def test_upscale_rgb_matches_jax(served, name):
    """An RGB image: Y into the net, chroma from ``resize_bicubic_u8``, back
    to RGB. f32 on both sides, the port whole and in halo tiles (the
    model's receptive field, FSRCNN 12, LapSRN 32) against JAX whole: max 1
    u8 level (a .5 straddled by float rounding), mean 0.01."""
    img = _rgb(30, 40, 34)
    want = jax_upscale(img, name, served[name], dtype="float32", tile=None)
    assert want.shape == (160, 136, 3) and 10 < want.mean() < 245
    for tile in (None, 16):
        got = upscale(img, name, served[name], dtype="float32", tile=tile,
                      device="cpu")
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(np.int32) - want)
        assert d.max() <= 1 and d.mean() <= 0.01, (tile, d.max(), d.mean())


def test_upscale_ycbcr_chroma_is_bicubic_bit_for_bit(served):
    img = _rgb(31, 11, 9)
    got = upscale(img, "FSRCNN", served["FSRCNN"], dtype="float32",
                  color_space="ycbcr", device="cpu")
    np.testing.assert_array_equal(
        got[..., 1:], resize_bicubic_u8(img, (44, 36))[..., 1:])


@pytest.mark.parametrize("name", MODELS)
def test_upscale_int8_close_to_jax(served, name):
    """End to end each package calibrates on its own float graph, so the
    scales differ in the last bits: int8 noise of a few levels (max 16,
    mean 2, the bound of the other models), static and dynamic."""
    img = _rgb(32, 12, 10)
    for quantize in ("static", "dynamic"):
        want = jax_upscale(img, name, served[name], quantize=quantize,
                           fused=True)
        got = upscale(img, name, served[name], quantize=quantize,
                      fused=True, device="cpu")
        d = np.abs(got.astype(np.int32) - want)
        assert d.max() <= 16 and d.mean() <= 2, (quantize, d.max(),
                                                 d.mean())


@pytest.mark.parametrize("fused", [False, True])
def test_net_scale_serves_the_x2_level_like_jax(served, fused):
    """LapSRN trained at ×4 serves ×2 from its first level with
    ``scale_factor=2, net_scale=4``: f32 against ``sr.infer.upscale``'s
    same call, max 1 u8 level, whole and in halo tiles; ``fused`` is a hint
    a pyramid ignores (the exact level graph, not an error). The ×2 output
    is not the ×4 output downscaled: it is level 0 of an ``all_scales``
    forward."""
    img = _rgb(34, 30, 26)
    want = jax_upscale(img, "LapSRN", served["LapSRN"], scale_factor=2,
                       net_scale=4, dtype="float32", tile=None, fused=fused)
    assert want.shape == (60, 52, 3)
    for tile in (None, 16):
        got = upscale(img, "LapSRN", served["LapSRN"], scale_factor=2,
                      net_scale=4, dtype="float32", tile=tile, fused=fused,
                      device="cpu")
        d = np.abs(got.astype(np.int32) - want)
        assert got.shape == want.shape and d.max() <= 1, (tile, d.max())
    full = upscale(img, "LapSRN", served["LapSRN"], dtype="float32",
                   device="cpu")
    assert full.shape == (120, 104, 3)
    same = upscale(img, "LapSRN", served["LapSRN"], scale_factor=4,
                   net_scale=4, dtype="float32", device="cpu")
    np.testing.assert_array_equal(same, full)


@pytest.mark.parametrize("kw,what", [
    (dict(name="LapSRN", scale_factor=2, net_scale=4, quantize="static"),
     "does not compose with quantize"),
    (dict(name="LapSRN", scale_factor=3, net_scale=4), "power-of-2"),
    (dict(name="LapSRN", scale_factor=8, net_scale=4), "power-of-2"),
    (dict(name="FSRCNN", scale_factor=2, net_scale=4),
     "no intermediate scales")])
def test_net_scale_refusals_match_jax(served, kw, what):
    img = _rgb(35, 8, 6)
    name = kw.pop("name")
    with pytest.raises(ValueError, match=what):
        jax_upscale(img, name, served[name], **kw)
    with pytest.raises(ValueError, match=what):
        upscale(img, name, served[name], device="cpu", **kw)


def test_service_serves_the_x2_level(served):
    """``SRService(net_scale=4, scale_factor=2)``: ``/info`` reports it and
    ``POST /upscale`` returns what ``upscale`` returns."""
    from PIL import Image

    service = SRService(model_name="LapSRN", params=served["LapSRN"],
                        scale_factor=2, net_scale=4, device="cpu")
    assert service.info()["net_scale"] == 4
    httpd, port = serve_background(service)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        img = _rgb(36, 10, 12)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        conn.request("POST", "/upscale", body=buf.getvalue(),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200, body
        got = np.asarray(Image.open(io.BytesIO(body)))
        want = upscale(img, "LapSRN", served["LapSRN"], scale_factor=2,
                       net_scale=4, fused=True, device="cpu")
        assert got.shape == (20, 24, 3)
        np.testing.assert_array_equal(got, want)
    finally:
        httpd.shutdown()
        httpd.server_close()


# --------------------------------------------------------------- eval ----

@pytest.mark.parametrize("on_dev", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("name", MODELS)
def test_evaluate_on_y_matches_jax(name, on_dev):
    """``evaluate(channels=1)`` with the same model in both packages, host
    and device metrics: within 1e-3 dB and 1e-5 SSIM, the bicubic baseline
    exactly."""
    jm, v, tm = pair(name, seed=40)
    ds = SyntheticDataset(num_images=2, size=(64, 56), channels=3, seed=8)
    kw = dict(scale_factor=4, channels=1, color_space="ycbcr")
    want = jax_evaluate(jax.jit(lambda x: jm.apply(v, x)), ds, **kw)
    with torch.no_grad():
        got = evaluate(tm, ds, device="cpu", on_device_metrics=on_dev, **kw)
    for a, b in zip(got.images, want.images, strict=True):
        assert abs(a.psnr_sr - b.psnr_sr) <= 1e-3, (a.psnr_sr, b.psnr_sr)
        assert a.psnr_bicubic == b.psnr_bicubic
        assert abs(a.ssim_sr - b.ssim_sr) <= 1e-5, (a.ssim_sr, b.ssim_sr)
    assert np.isfinite(want.avg_psnr_sr)
