"""sr_torch's eval metrics and exact degradation against the JAX package:
Pillow's uint8 bicubic (numpy and the native library), modulo crop, shave,
PSNR, SSIM on the host and on the device, and the YCbCr conversions.

The same numpy inputs, made with ``np.random.default_rng``, go through the
``sr`` function and its port. Everything runs on the CPU.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from sr.eval import metrics as jax_metrics
from sr.kernels.bicubic import pil_resize_exact_u8 as jax_pil_resize
from sr_torch.data import native
from sr_torch.eval import metrics
from sr_torch.kernels.bicubic import pil_resize_exact_u8

torch.set_num_threads(1)


def _pil_resize(img: np.ndarray, out_hw) -> np.ndarray:
    mode = "L" if img.ndim == 2 else "RGB"
    return np.asarray(Image.fromarray(img, mode).resize(
        (out_hw[1], out_hw[0]), Image.BICUBIC))


def _image(rng, hw, channels):
    shape = hw if channels == 1 else (*hw, channels)
    return rng.integers(0, 256, shape, dtype=np.uint8)


# --------------------------------------------------- exact degradation ----

@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("factor", [2, 3, 4, 8])
def test_pil_resize_exact_bit_for_bit(factor, direction, channels):
    """Against ``sr.kernels.bicubic`` and Pillow itself, odd sizes; the
    native library and its numpy twin give the same bits."""
    rng = np.random.default_rng(100 * factor + channels)
    if direction == "down":
        hw = (5 * factor + 3, 7 * factor + 1)
        out = (hw[0] // factor, hw[1] // factor)
    else:
        hw = (7, 5) if factor == 8 else (11, 13)
        out = (hw[0] * factor, hw[1] * factor)
    img = _image(rng, hw, channels)
    got = pil_resize_exact_u8(img, out)
    assert got.dtype == np.uint8 and got.shape == _pil_resize(img, out).shape
    np.testing.assert_array_equal(got, jax_pil_resize(img, out))
    np.testing.assert_array_equal(got, _pil_resize(img, out))
    np.testing.assert_array_equal(native.resize_bicubic_u8(img, out), got)


def test_pil_resize_exact_single_axis_identity_and_refusal():
    rng = np.random.default_rng(1)
    img = _image(rng, (37, 29), 3)
    for out in ((37, 29), (37, 16), (16, 29), (53, 71)):
        want = _pil_resize(img, out)
        np.testing.assert_array_equal(pil_resize_exact_u8(img, out), want)
        np.testing.assert_array_equal(native.resize_bicubic_u8(img, out),
                                      want)
    with pytest.raises(TypeError, match="uint8"):
        pil_resize_exact_u8(img.astype(np.float32), (10, 10))
    with pytest.raises(TypeError, match="uint8"):
        native.resize_bicubic_u8(img.astype(np.float32), (10, 10))


@pytest.fixture
def native_lib():
    if not native.available():
        pytest.skip("no C++ compiler: the numpy path runs")
    return native.load()


def test_native_library_builds_here(native_lib):
    assert native.BUILD_DIR.name == "sr_torch_native"
    assert any(p.suffix == ".so" for p in native.BUILD_DIR.iterdir())


def test_native_psnr_equals_numpy(native_lib):
    """Bit for bit with the numpy PSNR (the port's and the JAX package's) on
    many plane pairs: the library's MSE is exact and numpy finishes it."""
    rng = np.random.default_rng(2)
    for k in range(200):
        hw = (int(rng.integers(12, 70)), int(rng.integers(12, 70)))
        a = _image(rng, hw, 1)
        spread = k % 40 + 1
        noise = rng.integers(-spread, spread + 1, hw)
        b = np.clip(a.astype(np.int64) + noise, 0, 255).astype(np.uint8)
        border = int(rng.integers(0, 5))
        want = metrics.psnr(a.astype(np.float64), b.astype(np.float64),
                            border=border)
        assert native.psnr_y_u8(a, b, border) == want
        assert want == jax_metrics.psnr(a.astype(np.float64),
                                        b.astype(np.float64), border=border)
    assert native.psnr_y_u8(a, a) == float("inf")
    with pytest.raises(ValueError, match="planes"):
        native.psnr_y_u8(a, b[:-1])


def test_numpy_fallback_gives_the_same_answers(monkeypatch):
    """With no library the module runs numpy, with the same results."""
    rng = np.random.default_rng(3)
    img = _image(rng, (33, 29), 3)
    a, b = _image(rng, (40, 30), 1), _image(rng, (40, 30), 1)
    with_lib = (native.resize_bicubic_u8(img, (66, 58)),
                native.psnr_y_u8(a, b, 2))
    monkeypatch.setattr(native, "load", lambda: None)
    assert not native.available()
    np.testing.assert_array_equal(native.resize_bicubic_u8(img, (66, 58)),
                                  with_lib[0])
    assert native.psnr_y_u8(a, b, 2) == with_lib[1]


# ------------------------------------------------- crop, shave, PSNR ----

def test_modulo_crop_and_shave_equal_jax():
    rng = np.random.default_rng(4)
    for shape in ((67, 61), (67, 61, 3), (64, 64, 1)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for r in (2, 3, 4, 8):
            np.testing.assert_array_equal(metrics.modulo_crop(img, r),
                                          jax_metrics.modulo_crop(img, r))
    assert metrics.calculate_valid_crop_size(67, 4) == 64
    for shape in ((20, 18), (20, 18, 3), (2, 20, 18, 3)):
        img = rng.uniform(0, 255, shape)
        for border in (0, 4):
            np.testing.assert_array_equal(metrics.shave(img, border),
                                          jax_metrics.shave(img, border))
        assert torch.equal(metrics.shave(torch.from_numpy(img), 3),
                           torch.from_numpy(jax_metrics.shave(img, 3)))
    with pytest.raises(ValueError):
        metrics.shave(np.zeros((2, 2, 2, 2, 2)), 1)


def test_psnr_equals_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 255, (40, 36))
    b = np.clip(a + rng.normal(0, 5, a.shape), 0, 255)
    for border in (0, 4):
        assert metrics.psnr(a, b, border=border) == jax_metrics.psnr(
            a, b, border=border)
    assert metrics.psnr(a, a) == float("inf")


# ------------------------------------------------------------- SSIM ----

def _pair(seed, shape=(40, 44)):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 255, shape)
    p = np.clip(t + rng.normal(0, 12, shape), 0, 255)
    return p, t


@pytest.mark.parametrize("shape,border", [((40, 44), 0), ((40, 44), 4),
                                          ((32, 30, 3), 2)])
def test_ssim_host_equals_jax(shape, border):
    p, t = _pair(6, shape)
    got = metrics.ssim(p, t, border=border)
    assert abs(got - jax_metrics.ssim(p, t, border=border)) <= 1e-12
    assert metrics.ssim(t, t) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("shape,border", [((40, 44), 0), ((40, 44), 4),
                                          ((32, 30, 3), 2)])
def test_ssim_device_equals_jax_and_host(shape, border):
    """float32 on the tensor's device: ≤ 1e-6 against
    ``sr.eval.metrics.ssim_device`` and ≤ 1e-5 against the float64 host
    SSIM."""
    p, t = _pair(7, shape)
    got = metrics.ssim_device(torch.from_numpy(p), torch.from_numpy(t),
                              border=border)
    assert got.dtype == torch.float32 and got.dim() == 0
    want = float(jax_metrics.ssim_device(p, t, border=border))
    assert abs(float(got) - want) <= 1e-6
    assert abs(float(got) - metrics.ssim(p, t, border=border)) <= 1e-5


def test_ssim_window_refusals_are_the_same():
    p, t = _pair(8, (10, 40))
    for fn in (metrics.ssim, jax_metrics.ssim):
        with pytest.raises(ValueError, match="11x11"):
            fn(p, t)
    with pytest.raises(ValueError, match="11x11"):
        metrics.ssim(*_pair(8, (30, 30)), border=10)
    with pytest.raises(ValueError, match="11x11"):
        metrics.ssim_device(torch.from_numpy(p), torch.from_numpy(t))


# ------------------------------------------------------------ YCbCr ----

@pytest.mark.parametrize("unit_range", [False, True])
def test_ycbcr_equal_jax(unit_range):
    """≤ 1e-4 on the 0–255 range (scaled for [0, 1])."""
    rng = np.random.default_rng(9)
    scale = 255.0 if unit_range else 1.0
    rgb = rng.uniform(0, 255, (16, 12, 3)).astype(np.float32) / scale
    ycc = metrics.rgb_to_ycbcr(torch.from_numpy(rgb), unit_range)
    assert ycc.dtype == torch.float32
    want = np.asarray(jax_metrics.rgb_to_ycbcr(rgb, unit_range))
    np.testing.assert_allclose(ycc.numpy() * scale, want * scale, rtol=0,
                               atol=1e-4)
    back = metrics.ycbcr_to_rgb(ycc, unit_range).numpy()
    want_back = np.asarray(jax_metrics.ycbcr_to_rgb(want, unit_range))
    np.testing.assert_allclose(back * scale, want_back * scale, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(back * scale, rgb * scale, rtol=0, atol=1e-3)


def test_ycbcr_matches_pil_conversion():
    rng = np.random.default_rng(10)
    rgb = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    pil = np.asarray(Image.fromarray(rgb).convert("YCbCr"), np.float32)
    ycc = metrics.rgb_to_ycbcr(rgb.astype(np.float32)).numpy()
    assert np.abs(ycc - pil).max() <= 1.0
