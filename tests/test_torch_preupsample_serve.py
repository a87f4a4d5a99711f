"""sr_torch serves and evaluates the pre-upsample models, SRCNN, VDSR and
DRCN ×4 on Y, against the JAX package: int8 forwards with shared scales
(static and dynamic) bit for bit, DRCN's 2 static and 48 dynamic int8
sites a forward and its calibration keys, ``upscale`` on RGB images (the
host bicubic input, whole and tiled at each model's halo, float and int8),
the HTTP service and ``evaluate(pre_upsample=True)``.

Small models (SRCNN at its widths, VDSR 4 × 16, DRCN 3 × 8) for the int8
and eval checks; ``upscale`` builds the repo's full widths (SRCNN 64/32,
VDSR 20 × 64, DRCN 64 × 16 recursions), so its params do too. Weights come
from a JAX ``init``, redrawn He-scaled; everything runs on the CPU.
"""

import http.client
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.eval.runner import evaluate as jax_evaluate
from sr.infer import upscale as jax_upscale
from sr.models.drcn import Net as FlaxDRCN
from sr.models.registry import get_spec as jax_get_spec
from sr.quant import calibrate_scales as jax_calibrate
from sr.quant import quantized_apply as jax_quantized_apply
from sr.utils.checkpoint import save_params as jax_save_params
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch import quant
from sr_torch.data.datasets import SyntheticDataset
from sr_torch.data.native import resize_bicubic_u8
from sr_torch.eval.runner import evaluate
from sr_torch.infer import make_serving_predict, upscale
from sr_torch.models import drcn
from sr_torch.nn.intercept import recurrent_convs, site_keys
from sr_torch.quant import (
    calibrate_scales, make_quantized_predict, quantized_apply)
from sr_torch.serve import SRService, serve_background
from sr_torch.utils.interop import to_jax_params
from test_torch_preupsample_models import MODELS, _x, lively, pair

torch.set_num_threads(1)


# --------------------------------------------------------------- int8 ----

@pytest.mark.parametrize("mode", ["per_channel", "per_tensor", "dynamic"])
@pytest.mark.parametrize("name", MODELS)
def test_int8_with_shared_scales_equals_jax_bit_for_bit(name, mode):
    """Given the JAX package's scales, the port's int8 forward equals
    ``sr.quant.quantized_apply`` exactly: SRCNN's 9×9 over one channel and
    5×5 sites (XLA's int8 conv in the JAX package), VDSR's bias-free 3×3
    sites and residual, DRCN's embedding sites with static scales and its
    recursion's sites with dynamic per-sample scales at every recursion.

    ``quantized_apply`` runs op by op, except inside DRCN's ``nn.scan``,
    whose body XLA compiles, contracting multiply-adds (the dequantize and
    bias, the ensemble update) into fused multiply-adds. The reference runs
    under ``jax.disable_jit``, so the scan's body too runs the package's
    arithmetic as written, one rounding an operation; the compiled scan is
    a few ulps (≤ 1e-6) away."""
    jm, v, tm = pair(name, seed=11)
    x = _x(name, 12)
    scales = None
    if mode != "dynamic":
        scales = jax_calibrate(jm, v, x, per_channel=mode == "per_channel")
    with jax.disable_jit():
        want = np.asarray(jax_quantized_apply(jm, v, x, scales=scales))
    got = quantized_apply(tm, torch.from_numpy(x), scales=scales)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    compiled = np.asarray(jax_quantized_apply(jm, v, x, scales=scales))
    np.testing.assert_allclose(got.numpy(), compiled, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_calibration_keys_equal_jax(name):
    """The port calibrates the same sites as ``sr.quant.calibrate_scales``:
    every conv of SRCNN and VDSR, DRCN's two embedding convs only."""
    jm, v, tm = pair(name, seed=13)
    x = _x(name, 14)
    want = jax_calibrate(jm, v, x)
    got = calibrate_scales(tm, torch.from_numpy(x))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    if name == "DRCN":
        assert set(got) == {"ConvBlock_0/Conv_0", "ConvBlock_1/Conv_0"}


def test_drcn_serves_2_static_and_48_dynamic_sites(monkeypatch):
    """At the repo's 16 recursions, a static int8 DRCN forward runs 50 int8
    convs: the 2 embedding sites with their calibrated scales and the
    recursion's 3 sites with a per-sample scale at each of the 16
    recursions; the JAX package calibrates the same two keys."""
    tm = drcn.Net(1, 8, 16).eval()
    keys = site_keys(tm)
    rec = {keys[c] for c in recurrent_convs(tm)}
    assert rec == {"Scan_RecBlock_0/Conv_0",
                   "Scan_RecBlock_0/ConvBlock_0/Conv_0",
                   "Scan_RecBlock_0/Conv_1"}
    fm = FlaxDRCN(1, 8, 16)
    v = {"params": to_jax_params(tm)}
    x = _x("DRCN", 15, b=1)
    scales = calibrate_scales(tm, torch.from_numpy(x))
    assert set(scales) == set(jax_calibrate(fm, v, x))
    kinds = []
    real = quant.conv_int8_fused

    def counted(xh, q_w, scale, *a, **kw):
        kinds.append("dynamic" if scale.dim() == 4 else "static")
        return real(xh, q_w, scale, *a, **kw)

    monkeypatch.setattr(quant, "conv_int8_fused", counted)
    got = make_quantized_predict(tm, "static")(torch.from_numpy(x))
    assert kinds.count("static") == 2 and kinds.count("dynamic") == 48
    with jax.disable_jit():  # the scan's body op by op, as above
        want = np.asarray(jax_quantized_apply(fm, v, x, scales=scales))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", MODELS)
def test_fused_is_a_hint_these_models_ignore(name):
    """No model of the family has an affine tail: ``fused`` runs the exact
    graph, and static int8 with ``fused`` the exact-graph static int8."""
    _, _, tm = pair(name, seed=16)
    x = torch.from_numpy(_x(name, 17, b=1))
    with torch.no_grad():
        assert torch.equal(make_serving_predict(tm, fused=True)(x), tm(x))
    assert torch.equal(make_serving_predict(tm, fused=True,
                                            quantize="static")(x),
                       make_quantized_predict(tm, "static")(x))


# ------------------------------------------------------------ serving ----

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Full-width params of each model (what ``upscale`` builds) in the
    JAX package's ``.npz``: He-scaled kernels, the last conv ×0.1 (VDSR's
    and DRCN's residual stays small) and SRCNN's output bias +0.5, so
    outputs spread over [0, 1]."""
    out = {}
    root = tmp_path_factory.mktemp("preupsample")
    for i, name in enumerate(MODELS):
        jm = jax_get_spec(name).make_model(JaxSRConfig(model_name=name,
                                                       dtype="float32"))
        v = jm.init(jax.random.key(20 + i), jnp.zeros((1, 8, 8, 1)))
        params = lively(jax.tree.map(np.asarray, v["params"]), 20 + i,
                        bias_std=0.02)
        if name == "SRCNN":
            params["ConvBlock_2"]["Conv_0"]["bias"] += 0.5
            params["ConvBlock_2"]["Conv_0"]["kernel"] *= 0.1
        elif name == "VDSR":
            params["ConvBlock_19"]["Conv_0"]["kernel"] *= 0.1
        else:
            params["Scan_RecBlock_0"]["Conv_1"]["kernel"] *= 0.1
        path = str(root / f"{name}_params.npz")
        jax_save_params(path, params)
        out[name] = path
    return out


def _rgb(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


#: (RGB image, tile forcing halo tiles at each model's receptive field)
_TILED = {"SRCNN": ((16, 14), 16), "VDSR": ((14, 13), 12),
          "DRCN": ((14, 13), 8)}


@pytest.mark.parametrize("name", MODELS)
def test_upscale_rgb_matches_jax(served, name):
    """An RGB image: Y bicubic-upscaled on the host (``resize_bicubic_u8``)
    into the net, whose output has its input's size, chroma from the same
    upscale, back to RGB. f32 on both sides, the port whole and in halo
    tiles (halo = the model's receptive field) against JAX whole: max 1 u8
    level (a .5 straddled by float rounding), mean 0.01."""
    (h, w), tile = _TILED[name]
    img = _rgb(30, h, w)
    want = jax_upscale(img, name, served[name], dtype="float32", tile=None)
    assert want.shape == (4 * h, 4 * w, 3) and 10 < want.mean() < 245
    for t in (None, tile):
        got = upscale(img, name, served[name], dtype="float32", tile=t,
                      device="cpu")
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(np.int32) - want)
        assert d.max() <= 1 and d.mean() <= 0.01, (t, d.max(), d.mean())


def test_upscale_ycbcr_chroma_is_bicubic_bit_for_bit(served):
    img = _rgb(31, 11, 9)
    got = upscale(img, "SRCNN", served["SRCNN"], dtype="float32",
                  color_space="ycbcr", device="cpu")
    np.testing.assert_array_equal(
        got[..., 1:], resize_bicubic_u8(img, (44, 36))[..., 1:])


@pytest.mark.parametrize("name", MODELS)
def test_upscale_int8_close_to_jax(served, name):
    """End to end each package calibrates on its own float graph, so the
    scales differ in the last bits: int8 noise of a few levels (max 16,
    mean 2, the EDSR and ESPCN bound), static and dynamic."""
    img = _rgb(32, 12, 10)
    for quantize in ("static", "dynamic"):
        want = jax_upscale(img, name, served[name], quantize=quantize,
                           fused=True)
        got = upscale(img, name, served[name], quantize=quantize,
                      fused=True, device="cpu")
        d = np.abs(got.astype(np.int32) - want)
        assert d.max() <= 16 and d.mean() <= 2, (quantize, d.max(),
                                                 d.mean())


def test_service_serves_a_pre_upsample_model(served):
    from PIL import Image

    service = SRService(model_name="VDSR", params=served["VDSR"],
                        scale_factor=4, quantize="dynamic", device="cpu")
    httpd, port = serve_background(service)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        img = _rgb(33, 10, 12)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        conn.request("POST", "/upscale", body=buf.getvalue(),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200, body
        got = np.asarray(Image.open(io.BytesIO(body)))
        want = upscale(img, "VDSR", served["VDSR"], quantize="dynamic",
                       fused=True, device="cpu")
        assert got.shape == (40, 48, 3)
        np.testing.assert_array_equal(got, want)
    finally:
        httpd.shutdown()
        httpd.server_close()


# --------------------------------------------------------------- eval ----

@pytest.mark.parametrize("on_dev", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("name", MODELS)
def test_evaluate_pre_upsample_matches_jax(name, on_dev):
    """``evaluate(pre_upsample=True)`` with the same model in both packages
    (the net on the exact host bicubic upscale, Y metrics), host and device
    metrics: within 1e-3 dB and 1e-5 SSIM, the bicubic baseline exactly."""
    jm, v, tm = pair(name, seed=40)
    ds = SyntheticDataset(num_images=2, size=(64, 56), channels=3, seed=8)
    kw = dict(scale_factor=4, channels=1, color_space="ycbcr",
              pre_upsample=True)
    want = jax_evaluate(jax.jit(lambda x: jm.apply(v, x)), ds, **kw)
    with torch.no_grad():
        got = evaluate(tm, ds, device="cpu", on_device_metrics=on_dev, **kw)
    for a, b in zip(got.images, want.images, strict=True):
        assert abs(a.psnr_sr - b.psnr_sr) <= 1e-3, (a.psnr_sr, b.psnr_sr)
        assert a.psnr_bicubic == b.psnr_bicubic
        assert abs(a.ssim_sr - b.ssim_sr) <= 1e-5, (a.ssim_sr, b.ssim_sr)
    assert np.isfinite(want.avg_psnr_sr)
