"""sr_torch's D4 self-ensemble against the JAX package's
(``sr/eval/ensemble.py``): the transforms, the wrapper over a real model
(float and u8 members, a pre-upsample model at r = 1), and
``upscale(self_ensemble=True)`` with its tiling and its static-int8
calibration on all 8 members.

Weights come from a JAX ``init`` with seeded nonzero biases and cross with
``from_jax_params``; inputs from ``np.random.default_rng``. The port runs
on the CPU, where its kernels take their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.eval.ensemble import inverse as jax_inverse
from sr.eval.ensemble import make_self_ensemble_predict as jax_ensemble
from sr.eval.ensemble import transform as jax_transform
from sr.infer import upscale as jax_upscale
from sr.models.registry import get_spec as jax_get_spec
from sr.quant import to_u8 as jax_to_u8
from sr.utils.checkpoint import save_params as jax_save_params
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch import quant
from sr_torch.eval import TRANSFORMS, inverse, make_self_ensemble_predict
from sr_torch.eval import transform
from sr_torch.infer import upscale
from sr_torch.models.registry import get_spec
from sr_torch.quant import to_u8
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params
from test_torch_port_d2s_bias import with_random_biases

torch.set_num_threads(1)


def _pair(name, channels=1, scale=4, **cfg_kw):
    """(jax fn, port fn, params) of one model at f32 on the same weights:
    NHWC in, NHWC out, eval mode."""
    jcfg = JaxSRConfig(model_name=name, num_channels=channels,
                       scale_factor=scale, dtype="float32", **cfg_kw)
    jm = jax_get_spec(name).make_model(jcfg)
    v = jm.init(jax.random.key(0), jnp.zeros((1, 8, 8, channels)),
                train=False)
    params = with_random_biases(jax.tree.map(np.asarray, v["params"]), 1,
                                std=0.05)
    tm = get_spec(name).make_model(SRConfig(
        model_name=name, num_channels=channels, scale_factor=scale,
        dtype="float32", **cfg_kw))
    from_jax_params(tm, params)
    tm.eval()

    def jfn(x):
        return jm.apply({"params": params}, x, train=False)

    def tfn(x):
        with torch.no_grad():
            return tm(x)

    return jfn, tfn, params


def _x(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("flip,k", TRANSFORMS)
def test_transform_and_inverse_equal_jax_bit_for_bit(flip, k):
    """Odd H ≠ W, so a rotation that swapped the wrong axes or an
    off-by-one flip shows."""
    x = _x(flip * 4 + k, (2, 5, 7, 3))
    got = transform(torch.from_numpy(x), flip, k)
    want = np.asarray(jax_transform(jnp.asarray(x), flip, k))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    y = _x(10 + k, (2, 9, 11, 3))
    np.testing.assert_array_equal(
        inverse(torch.from_numpy(y), flip, k).numpy(),
        np.asarray(jax_inverse(jnp.asarray(y), flip, k)))
    np.testing.assert_array_equal(inverse(got, flip, k).numpy(), x)


def test_transforms_are_the_eight_of_d4():
    assert len(TRANSFORMS) == len(set(TRANSFORMS)) == 8
    assert TRANSFORMS[0] == (False, 0)


def test_equivariant_fn_is_a_fixed_point():
    """Nearest ×2 commutes with every D4 element: the 8 members are equal
    and their f32 average rounds like the JAX package's (rtol 3e-7)."""
    def nearest2x(x):
        return x.repeat_interleave(2, 1).repeat_interleave(2, 2)

    x = torch.from_numpy(_x(3, (1, 6, 9, 1)))
    np.testing.assert_allclose(make_self_ensemble_predict(nearest2x)(x),
                               nearest2x(x), rtol=3e-7, atol=0)


@pytest.mark.parametrize("name,channels,shape", [
    ("ESPCN", 1, (2, 10, 14, 1)),       # sub-pixel tail, r = 4
    ("EDSR", 3, (1, 9, 12, 3)),          # RGB, two ×2 stages
    ("SRCNN", 1, (1, 17, 13, 1)),        # pre-upsample: r = 1
], ids=["espcn", "edsr", "srcnn-r1"])
def test_ensemble_matches_jax_f32(name, channels, shape):
    """f32 members, f32 average: within 1e-5 of the JAX package's."""
    kw = dict(num_resblocks=2, base_filter=16) if name == "EDSR" else {}
    jfn, tfn, _ = _pair(name, channels, **kw)
    x = _x(5, shape)
    want = np.asarray(jax_ensemble(jfn)(jnp.asarray(x)))
    got = make_self_ensemble_predict(tfn)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_ensemble_of_u8_members_matches_jax():
    """A u8-emitting base fn: members de-quantized by /255, averaged in
    f32, quantized once; within 1 u8 level of the JAX package (a member
    whose f32 output straddles a .5 level may round apart)."""
    jfn, tfn, _ = _pair("ESPCN")
    x = _x(6, (2, 11, 8, 1))
    want = np.asarray(jax_ensemble(lambda v: jax_to_u8(jfn(v)),
                                   output_u8=True)(jnp.asarray(x)))
    got = make_self_ensemble_predict(lambda v: to_u8(tfn(v)),
                                     output_u8=True)(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    # float members with u8 output: also within one level
    want = np.asarray(jax_ensemble(jfn, output_u8=True)(jnp.asarray(x)))
    got = make_self_ensemble_predict(tfn, output_u8=True)(
        torch.from_numpy(x))
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def espcn_npz(tmp_path_factory):
    """ESPCN ×4 (the registry's default 64/32 widths, which ``upscale``
    builds) with seeded nonzero biases, in the JAX package's .npz."""
    _, _, params = _pair("ESPCN")
    path = str(tmp_path_factory.mktemp("ensemble") / "ESPCN_params.npz")
    jax_save_params(path, params)
    return path


def _img(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def test_upscale_self_ensemble_matches_jax(espcn_npz):
    """RGB in, the ensemble on Y, f32 on both sides: within 1 level."""
    img = _img(0, 13, 10)
    want = jax_upscale(img, "ESPCN", espcn_npz, dtype="float32",
                       self_ensemble=True)
    got = upscale(img, "ESPCN", espcn_npz, dtype="float32",
                  self_ensemble=True, device="cpu")
    assert got.shape == want.shape == (52, 40, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    plain = upscale(img, "ESPCN", espcn_npz, dtype="float32", device="cpu")
    assert (plain != got).any()  # the average is another image


def test_upscale_self_ensemble_tiled_equals_whole(espcn_npz):
    """The ensemble composes below the tiling (halo = ESPCN's receptive
    field): tiled and whole within 1 level (f32 sums of other shapes)."""
    img = _img(1, 30, 26)
    whole = upscale(img, "ESPCN", espcn_npz, dtype="float32", tile=None,
                    self_ensemble=True, device="cpu")
    tiled = upscale(img, "ESPCN", espcn_npz, dtype="float32", tile=12,
                    self_ensemble=True, device="cpu")
    assert np.abs(tiled.astype(int) - whole.astype(int)).max() <= 1


@pytest.mark.parametrize("tile", [None, 12], ids=["whole", "tiled"])
def test_static_int8_calibrates_on_the_eight_members(espcn_npz, tmp_path,
                                                     monkeypatch, tile):
    """A static int8 ensemble calibrates once, up front, on the 8 D4
    variants of the image (of a tile-sized centre crop when tiled), and
    later members never recalibrate."""
    import shutil

    # a fresh path: upscale caches its predicts by path
    path = str(tmp_path / f"ESPCN_{tile}.npz")
    shutil.copy(espcn_npz, path)
    seen = []
    real = quant.calibrate_scales_batches

    def spy(model, batches, headroom=1.0):
        batches = list(batches)
        seen.append([tuple(b.shape) for b in batches])
        return real(model, batches, headroom)

    monkeypatch.setattr(quant, "calibrate_scales_batches", spy)
    img = _img(2, 30, 22)
    out = upscale(img, "ESPCN", path, dtype="float32", quantize="static",
                  self_ensemble=True, tile=tile, device="cpu")
    assert out.shape == (120, 88, 3)
    side = (30, 22) if tile is None else (12, 12)
    members = {tuple(s) for s in
               [(1, *side, 1), (1, side[1], side[0], 1)]}
    assert len(seen) == 1 and len(seen[0]) == 8
    assert set(seen[0]) == members
    # the calibration's members are the transforms of the same crop
    img2 = _img(3, 30, 22)
    upscale(img2, "ESPCN", path, dtype="float32", quantize="static",
            self_ensemble=True, tile=tile, device="cpu")
    assert len(seen) == 1  # calibrated once
