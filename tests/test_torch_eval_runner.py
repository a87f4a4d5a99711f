"""sr_torch's eval harness against the JAX package: ``tiled_predict`` with
``fixed_chunk``, and ``evaluate`` on the host and device metric paths, 1 and
3 channels, RGB and YCbCr sets, pre-upsampled inputs, kept images and the
shape-bucketed static route over a mixed-size folder.

The harness alone runs a shared deterministic predict function (nearest
neighbour ×r, or a small offset on a pre-upsampled input) in both
packages; a small EDSR (2 resblocks × 16 filters, f32, weights carried over
by ``from_jax_params``) runs the harness end to end. Everything runs on the
CPU (``device="cpu"``), where the port's kernels take their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sr.data.datasets import FolderDataset as JaxFolderDataset
from sr.eval.runner import evaluate as jax_evaluate
from sr.eval.tiling import tiled_predict as jax_tiled_predict
from sr.models.edsr import Net as FlaxEDSR
from sr_torch.data.datasets import FolderDataset, SyntheticDataset
from sr_torch.data.decode import list_images
from sr_torch.eval.runner import (
    _pad_plan, eval_model_inputs, evaluate)
from sr_torch.eval.tiling import tiled_predict
from sr_torch.models.edsr import Net
from sr_torch.utils.interop import from_jax_params

torch.set_num_threads(1)


def _small_edsr(scale: int, seed: int):
    x = np.zeros((1, 8, 8, 3), np.float32)
    jm = FlaxEDSR(3, 16, 2, scale, 1.0, jnp.float32)
    v = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed)
    # nonzero biases; a mid-grey output bias keeps outputs inside [0, 1]
    v = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(a.shape)
                     .astype(np.float32), jax.tree.map(np.asarray, v))
    v["params"]["out_conv"]["Conv_0"]["bias"] += 0.5
    tm = from_jax_params(Net(3, 16, 2, scale), v["params"]).eval()
    return jm, v, tm


# ---------------------------------------------------------- fixed chunk ----

def test_tiled_predict_fixed_chunk_carries_full_calls():
    """Every call carries exactly ``max_tiles_per_call`` tiles (9 tiles in
    calls of 4, or one call of 16, padded with the final tile); the
    stitched result equals the JAX function's and the full forward within
    1e-5."""
    jm, v, tm = _small_edsr(2, seed=1)
    x = np.random.default_rng(1).uniform(0, 1, (1, 40, 34, 3))
    x = x.astype(np.float32)
    batches = []

    def port_fn(t):
        batches.append(t.shape[0])
        return tm(t)

    with torch.no_grad():
        got = tiled_predict(port_fn, torch.from_numpy(x), 2, tile=16, halo=8,
                            max_tiles_per_call=4, fixed_chunk=True)
        full = tm(torch.from_numpy(x))
    assert batches == [4, 4, 4]
    want = np.asarray(jax_tiled_predict(
        lambda a: jm.apply(v, a, train=False), jnp.asarray(x), 2, tile=16,
        halo=8, max_tiles_per_call=4, fixed_chunk=True))
    assert got.shape == (1, 80, 68, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=1e-5)
    # fewer tiles than a call holds: padded to 16, or one call of 9 without
    for fixed, want_batches in ((True, [16]), (False, [9])):
        batches.clear()
        with torch.no_grad():
            again = tiled_predict(port_fn, torch.from_numpy(x), 2, tile=16,
                                  halo=8, fixed_chunk=fixed)
        assert batches == want_batches
        np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0,
                                   atol=1e-6)


def test_tiled_predict_fixed_chunk_runs_one_window_whole():
    """An image inside one window runs whole at batch 1, as in JAX."""
    batches = []

    def fn(t):
        batches.append(tuple(t.shape))
        return t.repeat_interleave(2, 1).repeat_interleave(2, 2)

    x = torch.rand((1, 20, 24, 3), generator=torch.Generator().manual_seed(2))
    out = tiled_predict(fn, x, 2, tile=16, halo=4, max_tiles_per_call=8,
                        fixed_chunk=True)
    assert batches == [(1, 20, 24, 3)] and out.shape == (1, 40, 48, 3)


# -------------------------------------------------------- harness alone ----

def _nearest(r):
    def jax_fn(x):
        return np.asarray(x).repeat(r, axis=1).repeat(r, axis=2)

    def port_fn(x):
        return x.repeat_interleave(r, 1).repeat_interleave(r, 2)

    return jax_fn, port_fn


def _offset():
    """An imperfect identity for pre-upsampled inputs: PSNR stays finite."""
    def jax_fn(x):
        return np.clip(np.asarray(x) + 0.01, 0.0, 1.0)

    def port_fn(x):
        return torch.clamp(x + 0.01, 0.0, 1.0)

    return jax_fn, port_fn


def _assert_same(got, want, psnr_tol, ssim_tol):
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        assert a.name == b.name
        assert abs(a.psnr_sr - b.psnr_sr) <= psnr_tol, (a, b)
        assert a.psnr_bicubic == b.psnr_bicubic
        if b.ssim_sr is None:
            assert a.ssim_sr is None and a.ssim_bicubic is None
        else:
            assert abs(a.ssim_sr - b.ssim_sr) <= ssim_tol, (a, b)
            assert abs(a.ssim_bicubic - b.ssim_bicubic) <= 1e-12


CASES = [  # (dataset channels, model channels, color_space, pre_upsample)
    (3, 3, "rgb", False),
    (3, 3, "ycbcr", False),
    (3, 1, "ycbcr", False),
    (1, 1, "ycbcr", False),
    (3, 1, "ycbcr", True),
    (3, 3, "rgb", True),
]


@pytest.mark.parametrize("ds_ch,channels,color_space,pre_upsample", CASES)
def test_evaluate_equals_jax(ds_ch, channels, color_space, pre_upsample):
    """Host metrics equal the JAX package's (≤ 1e-9); device metrics
    within 1e-4 dB and 1e-5 SSIM; the bicubic baseline exactly."""
    r = 4
    ds = SyntheticDataset(num_images=2, size=(66, 61), channels=ds_ch,
                          seed=3)
    jax_fn, port_fn = _offset() if pre_upsample else _nearest(r)
    kw = dict(scale_factor=r, channels=channels, pre_upsample=pre_upsample,
              color_space=color_space, dataset_name="probe")
    want = jax_evaluate(jax_fn, ds, **kw)
    got = evaluate(port_fn, ds, device="cpu", **kw)
    _assert_same(got, want, 1e-9, 1e-9)
    assert got.summary() == want.summary()
    dev = evaluate(port_fn, ds, device="cpu", on_device_metrics=True, **kw)
    _assert_same(dev, want, 1e-4, 1e-5)
    assert dev.images[0].sr is None


@pytest.mark.parametrize("ds_ch,channels", [(3, 1), (3, 3), (1, 1)])
def test_evaluate_keep_images_equals_jax(ds_ch, channels):
    """Kept images (SR with bicubic chroma for a 1-channel model on an RGB
    set, the bicubic baseline, the cropped HR) equal the JAX package's;
    ``keep_images`` wins over ``on_device_metrics``."""
    ds = SyntheticDataset(num_images=1, size=(35, 42), channels=ds_ch, seed=4)
    jax_fn, port_fn = _nearest(2)
    kw = dict(scale_factor=2, channels=channels, keep_images=True)
    want = jax_evaluate(jax_fn, ds, **kw).images[0]
    for on_dev in (False, True):
        got = evaluate(port_fn, ds, device="cpu", on_device_metrics=on_dev,
                       **kw).images[0]
        for name in ("sr", "bicubic", "hr"):
            assert getattr(got, name).dtype == np.uint8
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert got.psnr_sr == want.psnr_sr


def test_evaluate_takes_uint8_predictions():
    """A predict that emits uint8 (the port's ``to_u8`` serving output)
    scores like its float twin, on both metric paths."""
    ds = SyntheticDataset(num_images=1, size=(48, 40), seed=5)
    _, port_fn = _nearest(4)
    ref = evaluate(port_fn, ds, 4, channels=3, color_space="rgb",
                   device="cpu")

    def u8_fn(x):
        return torch.clamp(torch.round(port_fn(x) * 255), 0, 255).to(
            torch.uint8)

    for on_dev in (False, True):
        got = evaluate(u8_fn, ds, 4, channels=3, color_space="rgb",
                       device="cpu", on_device_metrics=on_dev)
        _assert_same(got, ref, 1e-4 if on_dev else 0.0,
                     1e-5 if on_dev else 0.0)


@pytest.fixture(scope="module")
def mixed_folder(tmp_path_factory):
    """PNGs at four sizes for ×2 with EDSR's 40-px halo and tile 16 (window
    96): one tiles in both dims, one tiles in H and pads W, one pads both,
    one falls back to a native-size forward."""
    d = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(6)
    for name, (h, w) in (("a_tiled", (200, 212)), ("b_tall", (230, 150)),
                         ("c_small", (120, 110)), ("d_tiny", (60, 50))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(d / f"{name}.png")
    return str(d)


def test_static_shapes_equals_jax_and_direct(mixed_folder, capsys):
    """The static route: every call at one of the bucketed shapes, the
    metrics equal the JAX static route's (≤ 1e-9) and, on the metric
    region, the direct route's (nearest neighbour has no receptive field,
    so they agree exactly)."""
    paths = list_images(mixed_folder)
    kw = dict(scale_factor=2, channels=3, color_space="rgb",
              static_shapes=True, tile=16, model_name="EDSR")
    win = 16 + 2 * 40
    assert [_pad_plan(h // 2, w // 2, win, 40) for h, w in
            ((200, 212), (230, 150), (120, 110), (60, 50))] == [
        (False, False, False), (False, True, False), (True, True, False),
        (False, False, True)]
    jax_fn, port_fn = _nearest(2)
    shapes = []

    def recorded(x):
        shapes.append(tuple(x.shape))
        return port_fn(x)

    want = jax_evaluate(jax_fn, JaxFolderDataset(paths, "rgb"), **kw)
    got = evaluate(recorded, FolderDataset(paths, "rgb"), device="cpu", **kw)
    _assert_same(got, want, 1e-9, 1e-9)
    assert set(shapes) == {(8, win, win, 3), (1, win, win, 3),
                           (1, 30, 25, 3)}
    assert "1 distinct input shape(s) were too small" in capsys.readouterr().out
    dev = evaluate(port_fn, FolderDataset(paths, "rgb"), device="cpu",
                   on_device_metrics=True, **kw)
    _assert_same(dev, want, 1e-4, 1e-5)
    direct = evaluate(port_fn, FolderDataset(paths, "rgb"), 2, channels=3,
                      color_space="rgb", device="cpu", keep_images=True)
    static = evaluate(port_fn, FolderDataset(paths, "rgb"), device="cpu",
                      keep_images=True, **kw)
    for a, b in zip(static.images, direct.images):
        np.testing.assert_array_equal(a.sr, b.sr)


def test_eval_model_inputs_and_the_default_device():
    ds = SyntheticDataset(num_images=2, size=(32, 36), seed=7)
    xs = list(eval_model_inputs(ds, 4, 3, False, device="cpu"))
    assert [tuple(x.shape) for x in xs] == [(1, 8, 9, 3)] * 2
    assert xs[0].dtype == torch.float32 and xs[0].device.type == "cpu"
    if not torch.cuda.is_available():  # the default is the card, no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            evaluate(lambda x: x, ds, 4)
        with pytest.raises(RuntimeError, match="cuda"):
            next(eval_model_inputs(ds, 4, 3, False))


# ------------------------------------------------------------- with EDSR ----

def test_evaluate_small_edsr_equals_jax():
    """EDSR ×4 (2 × 16, f32) through both harnesses: per-image PSNR within
    1e-2 dB and SSIM within 1e-4 (measured: 0.0 and 0.0 on the host path,
    5.2e-7 dB and 2.3e-8 on the device path)."""
    jm, v, tm = _small_edsr(4, seed=8)
    ds = SyntheticDataset(num_images=2, size=(64, 56), seed=8)
    kw = dict(scale_factor=4, channels=3, color_space="rgb")
    jax_fn = jax.jit(lambda x: jm.apply(v, x, train=False))
    want = jax_evaluate(jax_fn, ds, **kw)
    for on_dev in (False, True):
        got = evaluate(tm, ds, device="cpu", on_device_metrics=on_dev, **kw)
        _assert_same(got, want, 1e-2, 1e-4)
    assert np.isfinite(want.avg_psnr_sr)
