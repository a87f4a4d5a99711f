"""The rest of the block menu against flax: ``Upsample2xBlock`` in its three
modes and ``norm="instance"`` (flax's ``GroupNorm`` with one channel a
group) in every block type.

Each case builds the flax block, initializes it from a seed, replaces every
bias and norm scale with seeded numpy values (so the norm's affine part is
not the identity), carries the weights across with ``from_jax_params`` and
runs both on the same numpy input, f32, on the CPU. Tolerance: 1e-5
absolute on outputs of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.nn import blocks as fb
from sr_torch.nn import blocks as tb
from sr_torch.utils.interop import from_jax_params, to_jax_params

torch.set_num_threads(1)

TOL = 1e-5
CIN, COUT = 6, 4


def _randomize(tree, rng):
    """Seeded values for every bias (std 0.05) and norm scale (1 ± 0.2),
    the rest as it is. Both packages take the variance as E[x²] − E[x]², so
    a conv bias that dwarfs the spread of its channel would cost digits in
    either; trained biases stay small."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("bias", "scale"):
            base, std = (1.0, 0.2) if k == "scale" else (0.0, 0.05)
            out[k] = (base + std * rng.standard_normal(np.shape(v))
                      ).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _pair(flax_block, torch_block, x, seed):
    v = flax_block.init(jax.random.key(seed), jnp.asarray(x))
    assert "batch_stats" not in v
    params = _randomize(jax.tree.map(np.asarray, v["params"]),
                        np.random.default_rng(seed))
    want = np.asarray(flax_block.apply({"params": params}, jnp.asarray(x)))
    from_jax_params(torch_block, params)
    with torch.no_grad():
        got = torch_block(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want, params


def _x(seed, c=CIN, hw=(7, 9)):
    return np.random.default_rng(100 + seed).uniform(
        -1, 1, (2, *hw, c)).astype(np.float32)


@pytest.mark.parametrize("norm", [None, "instance"])
@pytest.mark.parametrize("act", ["relu", "prelu"])
@pytest.mark.parametrize("mode", ["deconv", "ps", "rnc"])
def test_upsample2x_block_matches_flax(mode, act, norm):
    x = _x(1)
    got, want, params = _pair(
        fb.Upsample2xBlock(COUT, upsample=mode, act=act, norm=norm),
        tb.Upsample2xBlock(CIN, COUT, upsample=mode, act=act, norm=norm),
        x, seed=3)
    assert got.shape == want.shape == (2, 14, 18, COUT)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_upsample2x_block_names_and_refusal():
    blk = tb.Upsample2xBlock(CIN, COUT, upsample="ps", norm="instance")
    params = to_jax_params(blk)
    assert set(params) == {"PSBlock_0"}
    assert set(params["PSBlock_0"]["_NormAct_0"]["GroupNorm_0"]) == {
        "scale", "bias"}
    with pytest.raises(ValueError, match="unknown upsample mode"):
        tb.Upsample2xBlock(CIN, COUT, upsample="bilinear")


def _instance_cases():
    return {
        "conv": (fb.ConvBlock(COUT, 3, norm="instance", act="lrelu"),
                 tb.ConvBlock(CIN, COUT, 3, norm="instance", act="lrelu"),
                 CIN, (2, 7, 9, COUT)),
        "conv stride 2": (
            fb.ConvBlock(COUT, 3, 2, norm="instance", act=None),
            tb.ConvBlock(CIN, COUT, 3, 2, norm="instance", act=None),
            CIN, (2, 4, 5, COUT)),
        "deconv": (fb.DeconvBlock(COUT, 4, 2, norm="instance", act="prelu"),
                   tb.DeconvBlock(CIN, COUT, 4, 2, norm="instance",
                                  act="prelu"),
                   CIN, (2, 14, 18, COUT)),
        "resnet": (fb.ResnetBlock(CIN, norm="instance", act="relu"),
                   tb.ResnetBlock(CIN, norm="instance", act="relu"),
                   CIN, (2, 7, 9, CIN)),
        "resnet prelu": (fb.ResnetBlock(CIN, norm="instance", act="prelu"),
                         tb.ResnetBlock(CIN, norm="instance", act="prelu"),
                         CIN, (2, 7, 9, CIN)),
        "ps": (fb.PSBlock(COUT, 2, norm="instance", act="relu"),
               tb.PSBlock(CIN, COUT, 2, norm="instance", act="relu"),
               CIN, (2, 14, 18, COUT)),
    }


@pytest.mark.parametrize("case", list(_instance_cases()))
def test_instance_norm_matches_flax(case):
    fblk, tblk, c, shape = _instance_cases()[case]
    got, want, _ = _pair(fblk, tblk, _x(2, c), seed=5)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_instance_norm_keeps_the_block_dtype_and_skips_the_fused_kernel():
    blk = tb.ResnetBlock(8, norm="instance", dtype=torch.bfloat16)
    assert not blk.fused and blk.packed() is None
    y = blk(torch.randn(1, 8, 5, 5, generator=torch.Generator().manual_seed(0)
                        ).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    norm = tb.InstanceNorm(3)
    assert norm.epsilon == 1e-6  # flax GroupNorm's default
    assert not list(norm.buffers())  # no running statistics
