"""The pixel shuffle carries the PS conv's bias: sr_torch against the JAX
package with nonzero biases.

``PSBlock`` runs its conv without the bias and hands the bias to
``depth_to_space``, which adds it as it shuffles (flax's arithmetic: the
conv in its dtype, then ``+ bias`` in the same dtype). Flax's init zeroes
every bias, so each test here gives the biases seeded nonzero values first:
a dropped or doubled bias fails them. Everything runs on the CPU, where the
shuffle takes its plain version; the CUDA kernel is held to that plain
version on a card, in tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sr.kernels.depth_to_space import depth_to_space as jax_d2s
from sr.models.edsr import Net as FlaxEDSR
from sr.nn.blocks import PSBlock as FlaxPSBlock
from sr_torch.kernels.depth_to_space import (
    depth_to_space, depth_to_space_plain)
from sr_torch.models.edsr import Net
from sr_torch.nn import blocks
from sr_torch.nn.blocks import PSBlock
from sr_torch.nn.intercept import intercept_convs
from sr_torch.utils.interop import from_jax_params

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def with_random_biases(params, seed, std=0.1):
    """A copy of a flax params tree whose every ``bias`` leaf is drawn from
    a seeded normal (flax's init leaves them all zero)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    (rng.normal(0.0, std, np.shape(v)).astype(np.float32)
                     if k == "bias" else np.array(v)))
                for k, v in tree.items()}

    return walk(params)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).to(torch.float32).numpy()


# ------------------------------------------------ the shuffle's bias ----

@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_depth_to_space_bias_matches_pallas_interpret(r, dtype, act):
    """Bit for bit: ``x + bias`` in the same dtype, then the Pallas kernel
    in interpret mode; the wrapper on a CPU tensor and the plain version
    both."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(30 + r)
    x = rng.standard_normal((2, 5, 7, 3 * r * r)).astype(np.float32)
    bias = rng.standard_normal(3 * r * r).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_d2s(jnp.asarray(x, jdt) + jnp.asarray(bias, jdt), r,
                       use_pallas=True, act=act)
    want = np.asarray(want.astype(jnp.float32))
    xt, bt = torch.from_numpy(x).to(tdt), torch.from_numpy(bias).to(tdt)
    for fn in (depth_to_space_plain, depth_to_space):
        got = fn(xt, r, act, bt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


def test_depth_to_space_refuses_a_bad_bias():
    x = torch.zeros((1, 2, 2, 8))
    for fn in (depth_to_space_plain, depth_to_space):
        with pytest.raises(ValueError, match="no bias for uint8"):
            fn(x.to(torch.uint8), 2, bias=torch.zeros(8, dtype=torch.uint8))
        with pytest.raises(ValueError, match="bias must be"):
            fn(x, 2, bias=torch.zeros(2))  # (C,), not (C·r²,)
        with pytest.raises(ValueError, match="bias must be"):
            fn(x, 2, bias=torch.zeros(8, dtype=torch.bfloat16))


# ------------------------------------------------------------ PSBlock ----

def _ps_pair(r, act, seed, jdtype=jnp.float32, tdtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal((2, 6, 7, 8))
    x = x.astype(np.float32)
    flax_blk = FlaxPSBlock(4, r, act=act, dtype=jdtype)
    v = flax_blk.init(jax.random.key(seed), jnp.asarray(x), train=False)
    params = with_random_biases(jax.tree.map(np.array, v["params"]), seed)
    blk = from_jax_params(PSBlock(8, 4, r, act=act, dtype=tdtype), params)
    return flax_blk, params, blk, x


@pytest.mark.parametrize("r,act", [(2, None), (3, None), (2, "relu"),
                                   (4, "relu")])
def test_ps_block_with_random_biases_matches_flax(r, act):
    flax_blk, params, blk, x = _ps_pair(r, act, seed=40 + r)
    assert np.abs(params["Conv_0"]["bias"]).min() > 0
    want = np.asarray(flax_blk.apply({"params": params}, x))
    with torch.no_grad():
        got = _nhwc(blk(_nchw(x)))
    assert got.shape == (2, 6 * r, 7 * r, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("r,act", [(2, None), (3, "relu")])
def test_ps_block_bf16_with_random_biases_matches_flax(r, act):
    """bf16: both round the conv to bf16, then add the bf16 bias and round
    once. Where the two bf16 convs agree (the same block with zero biases
    gives their shuffled conv outputs) the outputs are equal bit for bit;
    elsewhere the convs differ by a bf16 ulp or two (summation order), and
    so do the outputs: at most 2 ulps of 2^-7 relative."""
    flax_blk, params, blk, x = _ps_pair(r, act, seed=50 + r,
                                        jdtype=jnp.bfloat16,
                                        tdtype=torch.bfloat16)
    zero = with_random_biases(params, 0, std=0.0)  # the same kernel
    blk0 = from_jax_params(PSBlock(8, 4, r, act=None, dtype=torch.bfloat16),
                           zero)
    conv_flax = np.asarray(FlaxPSBlock(4, r, act=None, dtype=jnp.bfloat16)
                           .apply({"params": zero}, x), np.float32)
    want = np.asarray(flax_blk.apply({"params": params}, x), np.float32)
    with torch.no_grad():
        got = _nhwc(blk(_nchw(x)))
        conv_port = _nhwc(blk0(_nchw(x)))
    agree = conv_port == conv_flax
    assert agree.mean() > 0.9, agree.mean()
    np.testing.assert_array_equal(got[agree], want[agree])
    tol = 2 * 2.0 ** -7 * np.maximum(np.abs(want), 1.0)
    assert (np.abs(got - want) <= tol).all()


def test_ps_block_hands_its_bias_to_the_shuffle_exactly_once(monkeypatch):
    """The conv runs without its bias and the shuffle gets it; under an
    interceptor that runs the conv (int8 serving), the conv keeps its bias
    and the shuffle gets none; under one that only looks (calibration), the
    shuffle gets it again."""
    _, params, blk, x = _ps_pair(2, None, seed=60)
    seen = []
    real = blocks.depth_to_space

    def spy(y, r, act=None, bias=None):
        seen.append(bias)
        return real(y, r, act, bias)

    monkeypatch.setattr(blocks, "depth_to_space", spy)
    conv = blk.Conv_0
    xt = _nchw(x)
    with torch.no_grad():
        plain = blk(xt)
        assert torch.equal(seen[-1], conv.bias)

        def runs_it(c, inp):
            return torch.nn.functional.conv2d(inp, c.weight, c.bias,
                                              padding=1)

        with intercept_convs(runs_it):
            intercepted = blk(xt)
        assert seen[-1] is None
        with intercept_convs(lambda c, inp: None):
            looked_at = blk(xt)
        assert torch.equal(seen[-1], conv.bias)
    np.testing.assert_allclose(intercepted.numpy(), plain.numpy(), atol=1e-5)
    assert torch.equal(looked_at, plain)


# -------------------------------------------------------------- EDSR ----

@pytest.mark.parametrize("scale", [2, 3, 4])
def test_edsr_exact_graph_with_random_biases_matches_flax_f32(scale):
    """4 blocks × 16 filters; every conv's bias nonzero. 1e-4, as the
    zero-bias graph is held."""
    rng = np.random.default_rng(70 + scale)
    x = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    jm = FlaxEDSR(3, 16, 4, scale, 1.0, jnp.float32)
    v = jm.init(jax.random.key(scale), jnp.asarray(x), train=False)
    params = with_random_biases(jax.tree.map(np.array, v["params"]),
                                70 + scale)
    assert all(np.abs(params[f"upsample_{j}"]["Conv_0"]["bias"]).min() > 0
               for j in range({2: 1, 3: 1, 4: 2}[scale]))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               train=False))
    tm = from_jax_params(Net(3, 16, 4, scale), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 12 * scale, 10 * scale, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_fused_tail_with_random_biases_matches_jax_and_exact():
    """The fused tail hands its composite bias to the shuffle; with every
    bias nonzero the composite bias is too. Interior within 1e-4 of the
    JAX package's fused tail and of the exact graph, as the zero-bias tail
    is held."""
    from sr.kernels.fused_tail import make_fused_tail_predict as jax_fused
    from sr_torch.kernels.fused_tail import make_fused_tail_predict

    rng = np.random.default_rng(80)
    x = rng.uniform(0, 1, (1, 24, 20, 3)).astype(np.float32)
    jm = FlaxEDSR(3, 16, 4, 4, 1.0, jnp.float32)
    v = jm.init(jax.random.key(80), jnp.asarray(x), train=False)
    v = {"params": with_random_biases(jax.tree.map(np.array, v["params"]),
                                      80)}
    tm = from_jax_params(Net(3, 16, 4, 4), v["params"])
    want = np.asarray(jax_fused(jm, v)(jnp.asarray(x)))
    with torch.no_grad():
        got = make_fused_tail_predict(tm)(torch.from_numpy(x)).numpy()
        exact = tm(torch.from_numpy(x)).numpy()
    m = 3 * 4  # border band: support // 2 LR px × r
    inner = (slice(None), slice(m, -m), slice(m, -m))
    np.testing.assert_allclose(got[inner], want[inner], atol=1e-4)
    np.testing.assert_allclose(got[inner], exact[inner], atol=1e-4)
