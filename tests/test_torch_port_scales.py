"""sr_torch EDSR at the scales beyond ×4 that the other port tests leave out:
the ×8 exact graph, the fused affine tail at ×2/×3/×4/×8, the folded tail
at ×3/×8 and the 'last'/'full' pre-shuffle forwards at ×2/×3/×8, each
against the JAX package on the same weights.

EDSR at 2 resblocks × 16 filters, float32, every conv with a seeded nonzero
bias (so a dropped or doubled bias shows). Weights come from a JAX ``init``
and cross with ``from_jax_params``; inputs come from
``np.random.default_rng``. Everything runs on the CPU, where the port's
kernels take their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.kernels import shuffle_fold as jax_fold
from sr.kernels.fused_tail import (
    make_fused_tail_predict as jax_make_fused_tail_predict)
from sr.models.edsr import Net as FlaxEDSR
from sr.models.registry import get_spec as jax_get_spec
from sr_torch.kernels import shuffle_fold
from sr_torch.kernels.depth_to_space import space_to_depth
from sr_torch.kernels.fused_tail import make_fused_tail_predict
from sr_torch.models.edsr import Net
from sr_torch.models.registry import get_spec
from sr_torch.utils.interop import from_jax_params

torch.set_num_threads(1)


def _edsr(scale: int, seed: int, hw=(10, 12)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    jm = FlaxEDSR(3, 16, 2, scale, 1.0, jnp.float32)
    v = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    v = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(a.shape)
                     .astype(np.float32), jax.tree.map(np.asarray, v))
    tm = from_jax_params(Net(3, 16, 2, scale), v["params"])
    return jm, v, tm, x


def test_edsr_x8_exact_graph_matches_flax():
    """Three ×2 shuffle stages. Measured 0.0 on the CPU; held at the
    ×2/×3/×4 test's 1e-4 (tests/test_torch_port_edsr.py)."""
    jm, v, tm, x = _edsr(8, seed=20)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 80, 96, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("scale", [2, 3, 4, 8])
def test_fused_tail_matches_jax_at_every_scale(scale):
    """The collapsed affine tail against ``sr.kernels.fused_tail``'s on the
    whole output, borders included: ≤ 2.9e-6 measured on these inputs
    (6.2e-6 on an earlier probe), held at 1e-5."""
    jm, v, tm, _ = _edsr(scale, seed=21 + scale)
    x = np.random.default_rng(scale).uniform(0, 1, (1, 20, 18, 3))
    x = x.astype(np.float32)
    want = np.asarray(jax_make_fused_tail_predict(jm, v)(jnp.asarray(x)))
    with torch.no_grad():
        got = make_fused_tail_predict(tm)(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 20 * scale, 18 * scale, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("scale", [3, 8])
def test_folded_tail_matches_flax_exact_graph(scale):
    """The output conv folded through the last shuffle against flax's exact
    graph and the JAX fold, borders included: ≤ 1.9e-6 measured on these
    inputs (2.9e-6 on an earlier probe), held at 1e-5."""
    jm, v, tm, x = _edsr(scale, seed=30 + scale)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    jax_folded = np.asarray(jax_fold.make_folded_tail_predict(jm, v)(x))
    got = shuffle_fold.make_folded_tail_predict(tm)(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jax_folded, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["last", "full"])
@pytest.mark.parametrize("scale", [2, 3, 8])
def test_preshuffle_forwards_match_jax_at_every_scale(scale, mode):
    """EDSR's pre-shuffle training forwards against ``sr.models.edsr``'s:
    ≤ 2.1e-6 measured on these inputs (3.3e-6 on an earlier probe), held
    at 1e-5; each is the space_to_depth chain of the port's exact forward."""
    jm, v, tm, x = _edsr(scale, seed=40 + scale)
    jspec, spec = jax_get_spec("EDSR"), get_spec("EDSR")
    if mode == "last":
        japply, r_last = jspec.preshuffle_train(jm)
        apply_fn, r = spec.preshuffle_train(tm)
        assert r == r_last == (3 if scale == 3 else 2)
        target = lambda y: space_to_depth(y, r)  # noqa: E731
    else:
        japply, _ = jspec.preshuffle_train_full(jm)
        apply_fn, target = spec.preshuffle_train_full(tm)
    want = np.asarray(japply(v, jnp.asarray(x), train=True))
    with torch.no_grad():
        got = apply_fn(torch.from_numpy(x))
        full = target(tm(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=1e-5)
