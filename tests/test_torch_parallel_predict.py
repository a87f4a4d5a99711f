"""sr_torch's ``sharded_predict`` over two gloo processes on the CPU
against the whole-image forward and against ``sr.eval.tiling``'s
``sharded_predict`` on a ``(1, 2)`` ``("data", "spatial")`` mesh of the
8-device CPU mesh, the JAX package's own test case (``tests/
test_tiling.py``): ESPCN ×2 on one channel, f32, 96 × 80, each process a
band of 48 rows with a halo of ESPCN's receptive field, by the f32 route
and the static int8 route with the scales the JAX package calibrated (the
port's int8 graph equals JAX's bit for bit given the scales). Tolerances
are ``tests/test_tiling.py``'s: f32 within 1e-5, int8 within 1e-6 of the
JAX package; against the port's own whole-image forward the int8 route is
bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_parallel_worker as worker
from sr.eval.tiling import sharded_predict as jax_sharded_predict
from sr.models.registry import get_spec as jax_get_spec
from sr.parallel.mesh import make_mesh as jax_make_mesh
from sr.quant import calibrate_scales, quantized_apply as jax_quantized_apply
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.eval.tiling import RECEPTIVE_FIELD, row_bands
from sr_torch.models.registry import get_spec
from sr_torch.quant import quantized_apply
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params

torch.set_num_threads(1)

_CFG = dict(model_name="ESPCN", scale_factor=2, num_channels=1,
            dtype="float32")


def test_row_bands_cover_the_image_once():
    bands = row_bands(96, 2, 5)
    assert bands == [(0, 48, 0, 53), (48, 96, 43, 96)]
    for n in (1, 3, 7):
        got = row_bands(50, n, 4)
        assert [b[0] for b in got] + [50] == sorted(
            {b[0] for b in got} | {50})
        assert all(b[1] == c[0] for b, c in zip(got, got[1:]))
        assert all(sy == max(y0 - 4, 0) and ey == min(y1 + 4, 50)
                   for y0, y1, sy, ey in got)
    with pytest.raises(ValueError, match="3 rows cannot split into 4"):
        row_bands(3, 4, 1)


def test_sharded_predict_without_a_group_is_the_forward():
    from sr_torch.eval.tiling import sharded_predict

    x = torch.randn(1, 10, 6, 1)
    assert torch.equal(sharded_predict(lambda z: 2 * z, x), 2 * x)


def test_two_process_sharded_predict_matches_whole_and_jax(tmp_path):
    jmodel = jax_get_spec("ESPCN").make_model(JaxSRConfig(**_CFG))
    x = jax.random.uniform(jax.random.key(0), (1, 96, 80, 1))
    variables = jmodel.init(jax.random.key(1), x[:, :8, :8], train=False)
    scales = calibrate_scales(jmodel, variables, x, train=False)
    jmesh = jax_make_mesh((1, 2), ("data", "spatial"))
    want = {
        "exact": np.asarray(jax_sharded_predict(jax.jit(
            lambda z: jmodel.apply(variables, z, train=False)), x, jmesh)),
        "static": np.asarray(jax_sharded_predict(jax.jit(
            lambda z: jax_quantized_apply(jmodel, variables, z,
                                          scales=scales, train=False)),
            x, jmesh)),
    }
    params = jax.tree.map(np.asarray, variables["params"])
    xn = np.array(x)  # a writable copy
    model = get_spec("ESPCN").make_model(SRConfig(**_CFG)).eval()
    from_jax_params(model, params)
    with torch.no_grad():
        xt = torch.from_numpy(xn)
        whole = {"exact": model(xt).numpy(),
                 "static": quantized_apply(model, xt, scales).numpy()}

    outs = worker.run("sharded", {"cfg": _CFG, "params": params, "x": xn,
                                  "scales": scales,
                                  "halo": RECEPTIVE_FIELD["espcn"]},
                      tmp_path)
    for out in outs:
        assert set(out) == {(r, m) for r in ("exact", "static")
                            for m in ("data_spatial", "default")}
        for (route, _), got in out.items():
            assert got.shape == (1, 192, 160, 1)
            tol = 1e-5 if route == "exact" else 1e-6
            np.testing.assert_allclose(got, want[route], rtol=tol, atol=tol)
            if route == "exact":
                np.testing.assert_allclose(got, whole[route], rtol=1e-5,
                                           atol=1e-5)
            else:
                np.testing.assert_array_equal(got, whole[route])
    for key in outs[0]:  # every process holds the whole output
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
