"""sr_torch ESPCN ×4 on Y against the JAX package: the model (forward,
pre-shuffle forward, flax's param names), the train step, the 1-channel
patch pipeline, Y-channel serving through ``upscale`` and the HTTP server,
int8 with shared scales and ``evaluate(channels=1)``.

Weights come from a JAX ``init`` (every bias then drawn from a seeded
normal, so a bias the shuffle drops or adds twice shows) and cross with
``from_jax_params``; inputs come from ``np.random.default_rng``. Everything
runs on the CPU, where the port's kernels take their plain versions; the
kernels at ESPCN's shapes are held on the card by
``tests/test_torch_espcn_cuda.py``.
"""

import dataclasses
import http.client
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.data.pipeline import PatchPipeline as JaxPatchPipeline
from sr.eval.runner import evaluate as jax_evaluate
from sr.infer import upscale as jax_upscale
from sr.models.espcn import Net as FlaxESPCN
from sr.quant import calibrate_scales as jax_calibrate
from sr.quant import quantized_apply as jax_quantized_apply
from sr.train.trainer import Trainer as JaxTrainer
from sr.utils.checkpoint import save_params as jax_save_params
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.data.datasets import SyntheticDataset
from sr_torch.data.native import resize_bicubic_u8
from sr_torch.data.pipeline import RANDOM_SCALES, PatchPipeline
from sr_torch.eval.runner import evaluate
from sr_torch.infer import make_serving_predict, upscale
from sr_torch.kernels.depth_to_space import depth_to_space_plain
from sr_torch.models.espcn import Net
from sr_torch.models.registry import get_spec
from sr_torch.quant import make_quantized_predict, quantized_apply
from sr_torch.serve import SRService, serve_background
from sr_torch.train.trainer import Trainer
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import flax_path, from_jax_params, to_jax_params
from test_torch_port_d2s_bias import with_random_biases
from test_torch_train_data import _jax_draws

torch.set_num_threads(1)


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(scale=4, filters=64, dtype=jnp.float32, tdtype=torch.float32,
          seed=0):
    """A flax ESPCN and the port's, on the same params (nonzero biases)."""
    jm = FlaxESPCN(1, filters, scale, False, dtype)
    v = jm.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 1)))
    params = with_random_biases(jax.tree.map(np.asarray, v["params"]), seed,
                                std=0.05)
    tm = from_jax_params(Net(1, filters, scale, dtype=tdtype), params).eval()
    return jm, {"params": params}, tm


def _x(seed, shape=(2, 13, 11, 1)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# ---------------------------------------------------------------- model ----

@pytest.mark.parametrize("scale", [2, 3, 4])
def test_forward_matches_flax_f32(scale):
    jm, v, tm = _pair(scale)
    x = _x(scale)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 13 * scale, 11 * scale, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_forward_matches_flax_bf16(scale):
    """bf16 rounds at other places in the two packages (flax rounds the
    last conv's output before its bf16 bias add; the shuffle adds the bias
    in f32 and rounds once): max 3e-2, mean 3e-3, as EDSR's bf16 bound."""
    jm, v, tm = _pair(scale, dtype=jnp.bfloat16, tdtype=torch.bfloat16)
    x = _x(10 + scale)
    want = np.asarray(jm.apply(v, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    assert d.max() <= 3e-2 and d.mean() <= 3e-3, (d.max(), d.mean())


@pytest.mark.parametrize("scale", [2, 4])
def test_preshuffle_forward_matches_flax(scale):
    jm, v, tm = _pair(scale)
    x = _x(20 + scale)
    want = np.asarray(jm.apply(v, jnp.asarray(x), preshuffle=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), preshuffle=True).numpy()
        full = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 13, 11, scale * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        depth_to_space_plain(torch.from_numpy(got), scale).numpy(),
        full.numpy())


def test_params_carry_flax_names_both_ways():
    """``from_jax_params`` loads flax's tree with no special case, and
    ``to_jax_params`` gives it back unchanged."""
    _, v, tm = _pair(4, filters=16)
    names = {flax_path(n.rsplit(".", 1)[0]) for n, _ in tm.named_parameters()}
    assert names == {("ConvBlock_0", "Conv_0"), ("ConvBlock_1", "Conv_0"),
                     ("Conv_0",)}
    back = to_jax_params(tm)
    for path in names:
        a, b = back, v["params"]
        for p in path:
            a, b = a[p], b[p]
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(a[leaf], b[leaf])


def test_registry_sees_every_port_model():
    spec = get_spec("espcn")
    assert (spec.name, spec.default_channels, spec.default_lr,
            spec.pre_upsample) == ("ESPCN", 1, 1e-3, False)
    assert get_spec("EDSR").name == "EDSR"
    cfg = SRConfig(model_name="ESPCN", base_filter=16)
    model = spec.make_model(cfg)
    apply_fn, r = spec.preshuffle_train(model)
    assert r == 4
    assert get_spec("SRResNet").name == "SRResNet"  # since its slice
    assert get_spec("LapSRN").multi_scale_out  # since its slice


# ----------------------------------------------------------- training ----

_SMALL = dict(model_name="ESPCN", num_channels=1, scale_factor=4,
              base_filter=16, crop_size=32, batch_size=8)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"lr": rng.uniform(0, 1, (8, 8, 8, 1)).astype(np.float32),
            "hr": rng.uniform(0, 1, (8, 32, 32, 1)).astype(np.float32)}


@pytest.mark.parametrize("mode", [False, "last"], ids=["off", "last"])
def test_train_step_matches_jax_f32(mode):
    """One f32 step from the same params and batch: the loss within 1e-5
    relative, every gradient within 1e-3 of its largest entry (float32
    summation order), and the recipe: MSE, Adam at 1e-3."""
    jtr = JaxTrainer(JaxSRConfig(**_SMALL, dtype="float32",
                                 preshuffle_loss=mode, mesh_shape=(1,)))
    tr = Trainer(SRConfig(**_SMALL, dtype="float32", preshuffle_loss=mode),
                 device="cpu")
    jstate = jtr.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 1)))
    params = with_random_biases(jax.tree.map(np.asarray, jstate.params), 1,
                                std=0.05)
    b = _batch()
    lr, hr = jnp.asarray(b["lr"]), jnp.asarray(b["hr"])

    def jloss(p):
        if jtr._preshuffle is not None:
            apply_pre, target_fn = jtr._preshuffle
            out, tgt = apply_pre({"params": p}, lr, train=True), target_fn(hr)
        else:
            out, tgt = jtr.model.apply({"params": p}, lr, train=True), hr
        return jtr.spec.loss(out, {"hr": tgt}, {})[0]

    want_loss, want_g = jax.value_and_grad(jloss)(params)
    state = tr.init_state(0)
    from_jax_params(state.model, params)
    loss, _ = tr.loss_fn(state.model, {k: torch.from_numpy(a)
                                       for k, a in b.items()}, 0)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got_g = {}
    for name, p in state.model.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        got_g[flax_path(mod) + (leaf,)] = p.grad
    for path in got_g:
        node = want_g
        for k in path[:-1]:
            node = node[k]
        if path[-1] == "weight":
            want, got = node["kernel"], got_g[path].permute(2, 3, 1, 0)
        else:
            want, got = node["bias"], got_g[path]
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-3, path
    assert state.tx.schedule(0) == pytest.approx(1e-3)
    assert isinstance(state.optimizer, torch.optim.Adam)


def test_trainer_refusal_names_espcn_last():
    spec = dataclasses.replace(get_spec("ESPCN"), preshuffle_train=None)
    with pytest.raises(ValueError, match="ESPCN 'last', EDSR 'last'/'full'"):
        Trainer(SRConfig(**_SMALL, preshuffle_loss="last"), spec=spec,
                device="cpu")
    with pytest.raises(ValueError, match="full-tail fold"):
        Trainer(SRConfig(**_SMALL, preshuffle_loss="full"), device="cpu")


def test_patch_pipeline_one_channel_matches_jax():
    """``PatchPipeline(channels=1)`` takes the Y plane, and its transform
    on JAX's own draws equals the JAX batch within 1e-5 (float32 resize
    products)."""
    ds = SyntheticDataset(num_images=5, size=(72, 88), channels=3, seed=3)
    images = [ds[i] for i in range(len(ds))]
    kw = dict(crop_size=32, scale_factor=4, batch_size=8, channels=1)
    ref = JaxPatchPipeline(images, **kw)
    port = PatchPipeline(images, **kw, device="cpu")
    assert tuple(port.bank.shape) == (5, 72, 88, 1)
    np.testing.assert_array_equal(port.bank.numpy(),
                                  np.stack(images)[..., :1])
    n, h, w = port.bank.shape[:3]
    sizes = [min(int(round(32 / s)), min(h, w)) for s in RANDOM_SCALES]
    for seed in range(3):
        key = jax.random.key(seed)
        want = ref(key)
        got = port.transform(port.bank, _jax_draws(key, "matrix", n, h, w,
                                                   sizes, True))
        for name in ("hr", "lr"):
            assert got[name].shape[-1] == 1
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), rtol=0,
                                       atol=1e-5, err_msg=name)


def test_k_steps_train_espcn_and_the_loss_falls():
    tr = Trainer(SRConfig(**_SMALL, dtype="float32"), device="cpu")
    ds = SyntheticDataset(num_images=4, size=(64, 72), seed=1)
    pipe = PatchPipeline([ds[i] for i in range(len(ds))], crop_size=32,
                         batch_size=8, channels=1, device="cpu")
    state = tr.init_state(1)
    multi = tr.make_multi_step(pipe, 10)
    first = float(multi(state)["loss"])
    for _ in range(3):
        last = float(multi(state)["loss"])
    assert state.step == 40 and last < first


# ------------------------------------------------------------ serving ----

@pytest.fixture(scope="module")
def espcn_params(tmp_path_factory):
    """Full-width ESPCN ×4 (what ``upscale`` builds), a JAX init with
    seeded biases and a mid-grey output bias, so outputs spread over [0, 1]."""
    jm = FlaxESPCN(1, 64, 4)
    v = jm.init(jax.random.key(3), jnp.zeros((1, 8, 8, 1)))
    params = with_random_biases(jax.tree.map(np.asarray, v["params"]), 3,
                                std=0.02)
    params["Conv_0"]["bias"] += 0.5
    path = str(tmp_path_factory.mktemp("espcn") / "ESPCN_params.npz")
    jax_save_params(path, params)
    return path


def _rgb(seed, h=14, w=11):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def test_upscale_rgb_matches_jax(espcn_params):
    """An RGB image: Y through the net, bicubic chroma, back to RGB. f32 on
    both sides; a u8 rounding of the model's Y may flip where float
    rounding straddles a .5 level: max 1 level, mean 0.01."""
    img = _rgb(0)
    want = jax_upscale(img, "ESPCN", espcn_params, dtype="float32")
    got = upscale(img, "ESPCN", espcn_params, dtype="float32", device="cpu")
    assert got.shape == want.shape == (56, 44, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() <= 1 and d.mean() <= 0.01, (d.max(), d.mean())
    assert 10 < want.mean() < 245


def test_upscale_ycbcr_chroma_is_bicubic_bit_for_bit(espcn_params):
    """A YCbCr image keeps its encoding: the chroma planes are one
    full-image bicubic upscale, bit for bit with ``resize_bicubic_u8`` and
    the JAX package; Y within 1 level of JAX's."""
    img = _rgb(1, 17, 12)
    kw = dict(dtype="float32", color_space="ycbcr")
    want = jax_upscale(img, "ESPCN", espcn_params, **kw)
    got = upscale(img, "ESPCN", espcn_params, device="cpu", **kw)
    bc = resize_bicubic_u8(img, (68, 48))
    np.testing.assert_array_equal(got[..., 1:], bc[..., 1:])
    np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
    assert np.abs(got[..., 0].astype(np.int32) - want[..., 0]).max() <= 1


@pytest.mark.parametrize("shape", [(13, 10), (13, 10, 1)])
def test_upscale_gray_image_serves_one_channel(espcn_params, shape):
    img = np.random.default_rng(2).integers(0, 256, shape, np.uint8)
    want = jax_upscale(img, "ESPCN", espcn_params, dtype="float32")
    got = upscale(img, "ESPCN", espcn_params, dtype="float32", device="cpu")
    assert got.shape == want.shape == (52, 40, 1)
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_upscale_tiles_at_espcns_halo(espcn_params):
    """A tiled upscale (halo = ESPCN's receptive field, 5) equals the
    full-image one; the float output path rounds on the host alike."""
    img = _rgb(4, 40, 34)
    full = upscale(img, "ESPCN", espcn_params, tile=None, dtype="float32",
                   device="cpu")
    tiled = upscale(img, "ESPCN", espcn_params, tile=12, dtype="float32",
                    device="cpu")
    host = upscale(img, "ESPCN", espcn_params, tile=None, dtype="float32",
                   output_u8=False, device="cpu")
    for other in (tiled, host):
        assert np.abs(other.astype(np.int32) - full).max() <= 1


def test_fused_without_a_tail_serves_the_exact_graph():
    """ESPCN has no affine tail: ``fused`` runs the exact graph, and static
    int8 with ``fused`` the exact-graph static int8 (as ``sr/infer.py``
    does for models without ``tail``)."""
    _, _, tm = _pair(4, filters=16)
    x = torch.from_numpy(_x(30, (1, 9, 7, 1)))
    with torch.no_grad():
        exact = tm(x)
        fused = make_serving_predict(tm, fused=True)(x)
    assert torch.equal(fused, exact)
    got = make_serving_predict(tm, fused=True, quantize="static")(x)
    want = make_quantized_predict(tm, "static")(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["per_channel", "per_tensor", "dynamic"])
def test_int8_with_shared_scales_equals_jax_bit_for_bit(mode):
    """Given the JAX package's scales, the port's int8 forward equals
    ``sr.quant.quantized_apply`` exactly: the 5×5 conv over one input
    channel, 64→32 and 32→16, the last conv's bias added in the int8 store
    and none by the shuffle."""
    jm, v, tm = _pair(4)
    x = _x(40, (2, 12, 9, 1))
    scales = None
    if mode != "dynamic":
        scales = jax_calibrate(jm, v, x, per_channel=mode == "per_channel")
    want = np.asarray(jax_quantized_apply(jm, v, x, scales=scales))
    got = quantized_apply(tm, torch.from_numpy(x), scales=scales)
    np.testing.assert_array_equal(got.numpy(), want)


def test_upscale_int8_static_close_to_jax(espcn_params):
    """End to end, each package calibrates on its own float graph, so the
    scales differ in the last bits: int8 noise of a few levels."""
    img = _rgb(5, 20, 18)
    for quantize in ("static", "dynamic"):
        want = jax_upscale(img, "ESPCN", espcn_params, quantize=quantize,
                           fused=True)
        got = upscale(img, "ESPCN", espcn_params, quantize=quantize,
                      fused=True, device="cpu")
        d = np.abs(got.astype(np.int32) - want)
        assert d.max() <= 16 and d.mean() <= 2, (quantize, d.max(), d.mean())


def test_service_answers_rgb_png_like_upscale(espcn_params):
    from PIL import Image

    service = SRService(model_name="ESPCN", params=espcn_params,
                        scale_factor=4, device="cpu")
    httpd, port = serve_background(service)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        img = _rgb(6, 12, 16)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        conn.request("POST", "/upscale", body=buf.getvalue(),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200, body
        got = np.asarray(Image.open(io.BytesIO(body)))
        want = upscale(img, "ESPCN", espcn_params, fused=True, device="cpu")
        assert got.shape == (48, 64, 3)
        np.testing.assert_array_equal(got, want)
    finally:
        httpd.shutdown()
        httpd.server_close()


# --------------------------------------------------------------- eval ----

@pytest.mark.parametrize("on_dev", [False, True])
def test_evaluate_one_channel_matches_jax(on_dev):
    """``evaluate(channels=1)`` with the same ESPCN in both packages, host
    and device metrics: within 1e-2 dB and 1e-4 SSIM (f32 model outputs a
    few ulps apart can flip a u8 level), the bicubic baseline exactly."""
    jm, v, tm = _pair(4, filters=16, seed=5)
    ds = SyntheticDataset(num_images=2, size=(64, 56), channels=3, seed=8)
    kw = dict(scale_factor=4, channels=1, color_space="ycbcr")
    want = jax_evaluate(jax.jit(lambda x: jm.apply(v, x)), ds, **kw)
    with torch.no_grad():
        got = evaluate(tm, ds, device="cpu", on_device_metrics=on_dev, **kw)
    for a, b in zip(got.images, want.images, strict=True):
        assert abs(a.psnr_sr - b.psnr_sr) <= 1e-2
        assert a.psnr_bicubic == b.psnr_bicubic
        assert abs(a.ssim_sr - b.ssim_sr) <= 1e-4
    assert np.isfinite(want.avg_psnr_sr)
