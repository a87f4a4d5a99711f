"""sr_torch kernels against the JAX package: pixel shuffle, fused resblock.

On the CPU each wrapper runs its plain PyTorch version, which is held to the
JAX reference (XLA path, and the Pallas kernel in interpret mode). The CUDA
kernels themselves are held to the plain versions on a card, in
tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sr.kernels.depth_to_space import depth_to_space as jax_d2s
from sr.kernels.depth_to_space import space_to_depth as jax_s2d
from sr.kernels.fused_resblock import fused_resblock as jax_resblock
from sr.kernels.fused_resblock import pack_weights as jax_pack
from sr.nn.blocks import ResnetBlock as FlaxResnetBlock
from sr_torch.kernels import _build
from sr_torch.kernels.depth_to_space import (
    depth_to_space, depth_to_space_plain, space_to_depth)
from sr_torch.kernels.fused_resblock import (
    fused_resblock, fused_resblock_plain, pack_wgmma_weights, pack_weights)

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _as_f32(t):
    return t.to(torch.float32).numpy()


# ---------------------------------------------------------------- d2s ----

@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_depth_to_space_plain_matches_jax_ref(r, dtype, act):
    """Exact: a shuffle moves values, it does not compute them."""
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(r).standard_normal((2, 5, 7, 3 * r * r))
    x = x.astype(np.float32)
    want = jax_d2s(jnp.asarray(x, jdt), r, act=act)
    got = depth_to_space_plain(torch.from_numpy(x).to(tdt), r, act)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_as_f32(got),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("r", [2, 4])
def test_depth_to_space_matches_pallas_interpret(r, act):
    x = np.random.default_rng(10 + r).standard_normal((2, 4, 8, 5 * r * r))
    x = x.astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_d2s(x, r, use_pallas=True, act=act))
    got = depth_to_space(torch.from_numpy(x), r, act)  # CPU tensor: plain
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r", [2, 3, 4])
def test_space_to_depth_round_trip_and_jax(r):
    x = np.random.default_rng(20 + r).standard_normal((2, 3, 5, 2 * r * r))
    x = torch.from_numpy(x.astype(np.float32))
    y = depth_to_space(x, r)
    assert torch.equal(space_to_depth(y, r), x)
    np.testing.assert_array_equal(
        space_to_depth(y, r).numpy(),
        np.asarray(jax_s2d(jnp.asarray(y.numpy()), r)))


def test_depth_to_space_rejects_bad_input():
    x = torch.zeros((1, 2, 2, 8))
    with pytest.raises(ValueError, match="activation"):
        depth_to_space(x, 2, act="tanh")
    with pytest.raises(ValueError, match="divide"):
        depth_to_space(x, 3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        depth_to_space(torch.empty((1, 2, 2, 8), device="meta"), 2)


# ----------------------------------------------------------- resblock ----

def _flax_resblock(c, h, w, b, res_scale, seed):
    blk = FlaxResnetBlock(c, 3, act="relu", norm=None, res_scale=res_scale)
    x = np.random.default_rng(seed).uniform(0, 1, (b, h, w, c))
    x = x.astype(np.float32)
    variables = blk.init(jax.random.key(seed), jnp.asarray(x), train=False)
    p = jax.tree.map(np.array, variables["params"])  # writable copies
    return blk, variables, p, x


def _port_pack(p):
    """Flax HWIO kernels → torch OIHW → the port's pack_weights."""
    def oihw(k):
        return torch.from_numpy(k).permute(3, 2, 0, 1)
    return pack_weights(oihw(p["Conv_0"]["kernel"]),
                        torch.from_numpy(p["Conv_0"]["bias"]),
                        oihw(p["Conv_1"]["kernel"]),
                        torch.from_numpy(p["Conv_1"]["bias"]))


def test_pack_weights_matches_jax_layout():
    _, _, p, _ = _flax_resblock(16, 8, 8, 1, 1.0, seed=1)
    got = _port_pack(p)
    want = jax_pack(p["Conv_0"]["kernel"], p["Conv_0"]["bias"],
                    p["Conv_1"]["kernel"], p["Conv_1"]["bias"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.float32 and got[3].dtype == torch.float32


@pytest.mark.parametrize("c", [16, 48, 64])
def test_pack_wgmma_weights_layout(c):
    """The bf16 kernel's operand: per tap a 64 × 64 K-major matrix (row n =
    output channel n, its input channels along the row), zero past C, with
    16-byte chunk j of row n stored at chunk j ^ (n % 8) — wgmma's 128-byte
    swizzle."""
    _, _, p, _ = _flax_resblock(c, 8, 8, 1, 1.0, seed=c)
    w1, _, w2, _ = (t.to(torch.bfloat16) if t.dim() == 2 else t
                    for t in _port_pack(p))
    for w in (w1, w2):
        got = pack_wgmma_weights(w)
        assert got.shape == (9, 64, 64) and got.dtype == torch.bfloat16
        taps = w.reshape(9, c, c)  # [tap][ci][n]
        for n in range(64):
            for j in range(8):
                chunk = got[:, n, 8 * (j ^ (n % 8)):8 * (j ^ (n % 8)) + 8]
                if n < c and 8 * j < c:
                    assert torch.equal(chunk, taps[:, 8 * j:8 * j + 8, n])
                else:
                    assert not chunk.float().any()


@pytest.mark.parametrize("res_scale", [1.0, 0.1])
@pytest.mark.parametrize("hw", [(16, 16), (16, 8), (24, 40)])
def test_fused_resblock_plain_matches_pallas_and_flax(hw, res_scale):
    """f32: both sides sum 576 products in float32 — rtol/atol 1e-5, the
    bar tests/test_fused_resblock.py holds the Pallas kernel to."""
    h, w = hw
    blk, variables, p, x = _flax_resblock(16, h, w, 2, res_scale,
                                          seed=h + w)
    ws = _port_pack(p)
    got = fused_resblock_plain(torch.from_numpy(x), *ws,
                               res_scale=res_scale).numpy()
    jw = jax_pack(p["Conv_0"]["kernel"], p["Conv_0"]["bias"],
                  p["Conv_1"]["kernel"], p["Conv_1"]["bias"])
    pallas = np.asarray(jax_resblock(
        jnp.asarray(x), *jw, row_tile=8, res_scale=res_scale,
        interpret=True))
    flax_out = np.asarray(blk.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, flax_out, rtol=1e-5, atol=1e-5)


def test_fused_resblock_cpu_tensor_takes_plain_version():
    _, _, p, x = _flax_resblock(16, 8, 8, 1, 0.1, seed=3)
    ws = _port_pack(p)
    before = fused_resblock.launches
    got = fused_resblock(torch.from_numpy(x), *ws, res_scale=0.1)
    want = fused_resblock_plain(torch.from_numpy(x), *ws, res_scale=0.1)
    assert torch.equal(got, want)
    assert fused_resblock.launches == before  # no kernel on the CPU


def test_fused_resblock_bf16_plain_rounds_like_the_kernel():
    """bf16: intermediate cast to bf16, f32 bias before the casts —
    the Pallas kernel's arithmetic, in interpret mode (one bf16 ulp at
    outputs below 2: 2^-7)."""
    _, _, p, x = _flax_resblock(16, 8, 16, 1, 1.0, seed=4)
    ws = _port_pack(p)
    wb = (ws[0].to(torch.bfloat16), ws[1], ws[2].to(torch.bfloat16), ws[3])
    got = fused_resblock_plain(torch.from_numpy(x).to(torch.bfloat16), *wb)
    jw = jax_pack(p["Conv_0"]["kernel"].astype(jnp.bfloat16),
                  p["Conv_0"]["bias"],
                  p["Conv_1"]["kernel"].astype(jnp.bfloat16),
                  p["Conv_1"]["bias"])
    want = jax_resblock(jnp.asarray(x, jnp.bfloat16), *jw, row_tile=8,
                        interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_as_f32(got), np.asarray(want, np.float32),
                               atol=2 ** -7, rtol=0)


def test_library_path_tracks_source_and_flags():
    path = _build.library_path("fused_resblock")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("fused_resblock-") and path.suffix == ".so"
    assert path == _build.library_path("fused_resblock")
    assert path != _build.library_path("depth_to_space")
