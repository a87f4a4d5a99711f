"""sr_torch serves and evaluates SRResNet and SRGAN ×4 against the JAX
package: ``d2s_conv`` and the folded tail (the 9×9 output conv folded
through the last shuffle, the last stage's PReLU before it), the folded
int8 tail with shared scales bit for bit and with each package's own
calibration within int8 noise, the route each serving variant takes, the
int8 sites of a forward, ``upscale`` on RGB images (float and int8, whole
and in halo tiles), the HTTP service on an SRGAN ``.npz`` with its batch
statistics, and ``evaluate`` through ``Trainer.make_predict_fn``.

Small models (2 resblocks × 16 filters) for the fold and int8 checks;
``upscale`` builds the repo's full width (16 × 64, 9×9 head and output
convs), so its params do too. Weights come from a JAX ``init``, redrawn
(``lively``); everything runs on the CPU.
"""

import functools
import http.client
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr.quant as jax_quant
import sr_torch.quant as quant
from sr.eval.runner import evaluate as jax_evaluate
from sr.infer import upscale as jax_upscale
from sr.kernels import fused_tail as jax_fused_tail
from sr.kernels import shuffle_fold as jax_fold
from sr.models.srresnet import Net as FlaxNet
from sr.utils.checkpoint import save_params as jax_save_params
from sr_torch import infer
from sr_torch.data.datasets import SyntheticDataset
from sr_torch.eval.runner import evaluate
from sr_torch.infer import make_serving_predict, tail_kind, upscale
from sr_torch.kernels import shuffle_fold
from sr_torch.kernels.depth_to_space import depth_to_space
from sr_torch.models import edsr, espcn, srresnet
from sr_torch.serve import SRService, serve_background
from sr_torch.train.trainer import Trainer
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params
from test_torch_srresnet_models import _init, _x, lively

torch.set_num_threads(1)


def _image_like(params):
    """Each block's second conv ×0.1 (a small residual) and the out conv
    ×0.1 with +0.5 bias, so outputs spread over [0, 1] like an image's."""
    for name, p in params.items():
        if name.startswith("blocks_"):
            p["Conv_1"]["kernel"] *= 0.1
    params["out_conv"]["kernel"] *= 0.1
    params["out_conv"]["bias"] += 0.5
    return params


def _small(scale=4, seed=0):
    """A flax SRResNet at 2 × 16 and the port's on the same lively,
    image-like params and statistics, both in eval mode; a [0, 1]
    input."""
    x = _x((2, 8, 7, 3), seed, lo=0.0)
    jm = FlaxNet(3, 16, 2, scale)
    params, bs = _init(jm, x, seed + 1)
    _image_like(params)
    var = {"params": params, "batch_stats": bs}
    tm = from_jax_params(srresnet.Net(3, 16, 2, scale), params, bs).eval()
    return jm, var, tm, x


# ---------------------------------------------------------------- fold ----

@pytest.mark.parametrize("k", [3, 9])
def test_d2s_conv_matches_jax_and_the_composition(k):
    """conv(depth_to_space(x, 2), W) + b computed before the shuffle:
    within 1e-5 of the JAX package's ``d2s_conv`` and of the composition
    it replaces, borders included."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 5, 6, 4 * 4)).astype(np.float32)
    w = (rng.standard_normal((k, k, 4, 3)) / k).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    want = np.asarray(jax_fold.d2s_conv(jnp.asarray(x), w, 2, b))
    got = shuffle_fold.d2s_conv(torch.from_numpy(x), torch.from_numpy(w), 2,
                                torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2, 10, 12, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    comp = shuffle_fold.conv_nhwc(depth_to_space(torch.from_numpy(x), 2),
                                  torch.from_numpy(w), torch.from_numpy(b),
                                  (k // 2, k // 2)).numpy()
    np.testing.assert_allclose(got, comp, rtol=0, atol=1e-5)


@pytest.mark.parametrize("scale", [2, 4])
def test_folded_tail_matches_jax_and_the_exact_graph(scale):
    """The folded tail (PReLU stages, a bare 9×9 out conv folded to 5×5 over
    16·4 channels): within 1e-5 of the JAX package's folded tail and of the
    port's exact graph (float32 summation order), borders included."""
    jm, var, tm, x = _small(scale, seed=scale)
    want = np.asarray(jax_fold.make_folded_tail_predict(jm, var)(
        jnp.asarray(x)))
    got = shuffle_fold.make_folded_tail_predict(tm)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with torch.no_grad():
        exact = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-5)
    assert 0 < exact.min() and exact.max() < 1.2


@pytest.fixture
def shared_scales(monkeypatch):
    """Both packages' calibration replaced by one set of scales (the JAX
    package's, per channel), so the int8 grids are the same."""
    jm, var, tm, x = _small(seed=7)
    scales = jax_quant.calibrate_scales_batches(jm, var, [jnp.asarray(x)],
                                                train=False)
    monkeypatch.setattr(jax_quant, "calibrate_scales_batches",
                        lambda *a, **k: scales)
    monkeypatch.setattr(quant, "calibrate_scales_batches",
                        lambda *a, **k: scales)
    return jm, var, tm, x


@pytest.mark.parametrize("output_u8", [False, True])
def test_folded_int8_tail_with_shared_scales_equals_jax(shared_scales,
                                                        output_u8):
    """Given the same scales, the folded int8 tail equals the JAX package's
    bit for bit when JAX runs op by op (``jax.disable_jit``): the int8
    sites, the batch norms, PReLUs and shuffles between them match op for
    op. Jitted, XLA contracts the batch norms' multiply-adds into FMAs, and
    the float output, in [0, 1], stays within two float32 ulps of 1
    (2.4e-7; u8: 1 level)."""
    jm, var, tm, x = shared_scales
    got = shuffle_fold.make_folded_tail_predict_quant(
        tm, output_u8=output_u8)(torch.from_numpy(x)).numpy()
    fn = jax_fold.make_folded_tail_predict_quant(jm, var,
                                                 output_u8=output_u8)
    with jax.disable_jit():
        want = np.asarray(fn(jnp.asarray(x)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    jitted = np.asarray(jax_fold.make_folded_tail_predict_quant(
        jm, var, output_u8=output_u8)(jnp.asarray(x)))
    d = np.abs(got.astype(np.float64) - jitted)
    assert d.max() <= (1 if output_u8 else 2.4e-7), d.max()


def test_folded_int8_tail_with_own_calibration_close_to_jax():
    """Each package calibrates on its own float graph (scales differ in the
    last bits): u8 outputs within EDSR's int8 bound, max 16 and mean 2
    levels; and within 16 levels of the float folded tail."""
    jm, var, tm, x = _small(seed=9)
    want = np.asarray(jax_fold.make_folded_tail_predict_quant(
        jm, var, output_u8=True)(jnp.asarray(x))).astype(np.int32)
    fn = shuffle_fold.make_folded_tail_predict_quant(tm, output_u8=True)
    got = fn(torch.from_numpy(x)).numpy().astype(np.int32)
    d = np.abs(got - want)
    assert d.max() <= 16 and d.mean() <= 2, (d.max(), d.mean())
    fl = quant.to_u8(shuffle_fold.make_folded_tail_predict(tm)(
        torch.from_numpy(x))).numpy().astype(np.int32)
    assert np.abs(got - fl).max() <= 16
    # calibrated once: a second call reuses the first call's scales
    fn.calibrate([torch.zeros_like(torch.from_numpy(x))])
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), got)


def test_folded_int8_tail_runs_every_conv_through_the_int8_entry(
        monkeypatch):
    """One forward: head, 2·2 block convs, body conv, 2 stage convs and the
    folded out conv (5×5, 64 → 12 at this width; 256 → 12 at full width),
    each one launch of ``conv_int8_fused``; the exact static graph runs the
    9×9 out conv at full output size instead."""
    seen = []
    real = quant.conv_int8_fused

    def tally(x, q_w, *args, **kw):
        seen.append((q_w.shape[0], x.shape[-1], q_w.shape[-1]))
        return real(x, q_w, *args, **kw)

    monkeypatch.setattr(quant, "conv_int8_fused", tally)
    _, _, tm, x = _small(seed=3)
    fn = shuffle_fold.make_folded_tail_predict_quant(tm)
    fn(torch.from_numpy(x))  # calibrates (a float forward) and runs
    assert seen == [(9, 3, 16)] + [(3, 16, 16)] * 5 + [(3, 16, 64)] * 2 + [
        (5, 64, 12)]
    seen.clear()
    quant.make_quantized_predict(tm, "static")(torch.from_numpy(x))
    assert seen[-1] == (9, 16, 3) and len(seen) == 9


def test_serving_routes_are_the_jax_packages(monkeypatch):
    """``fused`` folds SRResNet's tail (the JAX package's affine collapse
    refuses its PReLU stages), collapses EDSR's, and leaves a model
    without a tail on the exact graph; static int8 composes the same way,
    dynamic int8 always runs the exact graph."""
    jm, var, tm, x = _small(seed=11)
    with pytest.raises(ValueError):
        jax_fused_tail.make_fused_tail_predict(jm, var)
    assert tail_kind(tm) == "folded"
    assert tail_kind(edsr.Net(3, 16, 1, 4)) == "affine"
    assert tail_kind(espcn.Net(1, 16, 4)) is None
    calls = []

    def recorder(name, real):
        return lambda *a, **k: calls.append(name) or real(*a, **k)

    for name in ("make_folded_tail_predict", "make_folded_tail_predict_quant",
                 "make_fused_tail_predict", "make_fused_tail_predict_quant",
                 "make_quantized_predict"):
        monkeypatch.setattr(infer, name, recorder(name, getattr(infer, name)))
    for model, fused, quantize, want in (
            (tm, True, False, ["make_folded_tail_predict"]),
            (tm, True, "static", ["make_folded_tail_predict_quant"]),
            (tm, True, "dynamic", ["make_quantized_predict"]),
            (tm, False, "static", ["make_quantized_predict"]),
            (tm, False, False, []),
            (edsr.Net(3, 16, 1, 4), True, "static",
             ["make_fused_tail_predict_quant"])):
        calls.clear()
        make_serving_predict(model, fused, quantize)
        assert calls == want, (fused, quantize)


@pytest.mark.parametrize("fused,quantize", [
    (False, False), (True, False), (True, "static"), (False, "static"),
    (False, "dynamic")])
def test_every_route_serves_a_train_mode_model_in_eval_mode(fused, quantize):
    """A model left in train mode (just trained) is served with its running
    statistics on every route, as the JAX package's ``train=False``: the
    output equals that of the same route on an eval-mode copy, bit for
    bit, and neither serving nor calibration moves the running
    statistics."""
    import copy

    _, _, tm, x = _small(seed=13)
    ref = copy.deepcopy(tm)
    tm.train()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    fn = make_serving_predict(tm, fused, quantize)
    with torch.no_grad():
        got = fn(torch.from_numpy(x))
        want = make_serving_predict(ref, fused, quantize)(torch.from_numpy(x))
        train_mode = copy.deepcopy(tm).train()(torch.from_numpy(x))
    assert not tm.training
    assert torch.equal(got, want)
    assert not torch.allclose(train_mode, want, atol=1e-3)  # BN matters here
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------------- upscale ----

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Full-width SRResNet ×4 params and statistics in the JAX package's
    ``.npz`` (lively, each block's second conv ×0.1 so the residual stays
    small, the out conv ×0.1 with +0.5 bias so outputs spread over
    [0, 1]), saved under both model names."""
    jm = FlaxNet()
    v = jm.init(jax.random.key(20), jnp.zeros((1, 8, 8, 3)))
    params = _image_like(lively(jax.tree.map(np.asarray, v["params"]), 20))
    bs = lively(jax.tree.map(np.asarray, v["batch_stats"]), 21)
    path = str(tmp_path_factory.mktemp("srresnet") / "params.npz")
    jax_save_params(path, params, bs)
    return path


def _rgb(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("name", ["SRResNet", "SRGAN"])
@pytest.mark.parametrize("fused", [False, True])
def test_upscale_matches_jax(served, name, fused):
    """f32 on both sides, the exact graph and the folded tail, the port
    whole and in halo tiles (tile 16 at the model's 44-pixel halo) against
    JAX whole: max 1 u8 level (a .5 straddled by float rounding), mean
    0.01."""
    img = _rgb(30, 20, 18)
    want = jax_upscale(img, name, served, dtype="float32", tile=None,
                       fused=fused)
    assert want.shape == (80, 72, 3) and 10 < want.mean() < 245
    for tile in (None, 16):
        got = upscale(img, name, served, dtype="float32", tile=tile,
                      fused=fused, device="cpu")
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(np.int32) - want)
        assert d.max() <= 1 and d.mean() <= 0.01, (tile, d.max(), d.mean())


@pytest.mark.parametrize("quantize,fused", [("static", True),
                                            ("static", False),
                                            ("dynamic", True)])
def test_upscale_int8_close_to_jax(served, quantize, fused):
    """Each package calibrates on its own float graph: int8 noise of a few
    levels (max 16, mean 2, the EDSR and ESPCN bound) on the folded int8
    tail, the exact static graph and the dynamic one."""
    img = _rgb(32, 12, 10)
    want = jax_upscale(img, "SRResNet", served, quantize=quantize,
                       fused=fused)
    got = upscale(img, "SRResNet", served, quantize=quantize, fused=fused,
                  device="cpu")
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() <= 16 and d.mean() <= 2, (d.max(), d.mean())


def test_service_serves_an_srgan_npz(served):
    from PIL import Image

    service = SRService(model_name="SRGAN", params=served, scale_factor=4,
                        quantize="static", device="cpu")
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
        want = upscale(img, "SRGAN", served, quantize="static", fused=True,
                       device="cpu")
        assert got.shape == (40, 48, 3)
        np.testing.assert_array_equal(got, want)
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------- eval ----

@pytest.mark.parametrize("on_dev", [False, True], ids=["host", "device"])
def test_evaluate_matches_jax_through_the_trainers_predict(on_dev):
    """``evaluate`` on RGB test images through ``Trainer.make_predict_fn``
    (batch norms in eval mode) against the JAX harness on the same model:
    within 1e-3 dB and 1e-5 SSIM, the bicubic baseline exactly."""
    jm, var, tm, _ = _small(seed=40)
    tr = Trainer(SRConfig(model_name="SRResNet", num_channels=3,
                          num_resblocks=2, base_filter=16,
                          dtype="float32"), device="cpu")
    tm.train()  # make_predict_fn switches it to eval mode
    ds = SyntheticDataset(num_images=2, size=(64, 56), channels=3, seed=8)
    kw = dict(scale_factor=4, channels=3, color_space="rgb")
    want = jax_evaluate(jax.jit(lambda x: jm.apply(var, x, train=False)),
                        ds, **kw)
    got = evaluate(functools.partial(tr.make_predict_fn(), tm), ds,
                   device="cpu", on_device_metrics=on_dev, **kw)
    assert not tm.training
    for a, b in zip(got.images, want.images, strict=True):
        assert abs(a.psnr_sr - b.psnr_sr) <= 1e-3, (a.psnr_sr, b.psnr_sr)
        assert a.psnr_bicubic == b.psnr_bicubic
        assert abs(a.ssim_sr - b.ssim_sr) <= 1e-5, (a.ssim_sr, b.ssim_sr)
    assert np.isfinite(want.avg_psnr_sr)
