"""The port's reference-style wrappers (``sr_torch/compat.py``) against the
JAX package's (``sr/compat.py``), on the CPU.

All nine wrappers exist with ``sr.compat``'s names and methods. The SRCNN
reference flow (train → test → the reference's files) runs; ``test()``
refuses without weights with JAX's message. ``load_model`` reads a
``.npz`` written by ``sr.utils.checkpoint.save_params`` and a ``.pkl``
written by ``sr.utils.torch_interop.export_reference_checkpoint`` (no
``.npz`` beside it), each giving a model equal, parameter for parameter
(tolerance 0), to ``from_jax_params`` of the same weights. A port-written
``.npz`` loads in ``sr.compat``. SRGAN trains in its two phases at a small
width. Every run directory lies under ``tmp_path``; nothing is wider than
SRCNN or EDSR 2×16.
"""

import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr.compat as jax_compat
from sr.models.registry import get_spec as jax_get_spec
from sr.utils.checkpoint import save_params as jax_save_params
from sr.utils.config import SRConfig as JaxSRConfig
from sr.utils.torch_interop import (
    export_reference_checkpoint as jax_export_reference_checkpoint)
from sr_torch import compat
from sr_torch.models.registry import get_spec
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params, to_jax_params
from test_torch_refckpt import numpy_variables

torch.set_num_threads(1)

WRAPPERS = ("SRCNN", "VDSR", "DRCN", "ESPCN", "FSRCNN", "EDSR", "SRResNet",
            "LapSRN", "SRGAN")


def _args(tmp_path, **kw):
    base = dict(
        train_dataset="synthetic", test_dataset="synthetic",
        save_dir=str(tmp_path), data_dir=str(tmp_path / "data"),
        num_epochs=1, steps_per_epoch=2, batch_size=2, crop_size=32,
        scale_factor=4, dtype="float32", device="cpu",
    )
    base.update(kw)
    return types.SimpleNamespace(**{**{k: None for k in (
        "num_channels", "lr", "save_epochs", "test_batch_size",
        "num_threads", "seed",
    )}, **base})


def _params_equal(model, params):
    got = to_jax_params(model)

    def walk(a, b, path):
        assert set(a) == set(b), path
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]),
                                              f"{path}/{k}")

    walk(got, params, "")


def test_all_reference_wrappers_exist_with_jax_methods():
    methods = ("load_dataset", "train", "test", "save_model", "load_model")
    for name in WRAPPERS:
        cls, jcls = getattr(compat, name), getattr(jax_compat, name)
        assert cls.MODEL_NAME == jcls.MODEL_NAME == name
        assert issubclass(cls, compat.ModelWrapper)
        for m in methods:
            assert callable(getattr(cls, m)), (name, m)
            assert (list(inspect.signature(getattr(cls, m)).parameters)
                    == list(inspect.signature(getattr(jcls, m)).parameters))


def test_srcnn_reference_flow(tmp_path):
    model = compat.SRCNN(_args(tmp_path))
    assert model.device == torch.device("cpu")
    losses = model.train()
    assert losses and all(np.isfinite(losses))
    res = model.test()
    assert len(res.images) == 5
    assert np.isfinite(res.avg_psnr_sr)
    run = tmp_path / "SRCNN_x4"
    assert (run / "SRCNN_params.npz").exists()
    assert (run / "loss.png").exists()
    assert len(list((run / "panels").iterdir())) == 5
    assert len(list((run / "images").iterdir())) == 5
    # the reference's resume: a second wrapper continues the checkpoint
    again = compat.SRCNN(_args(tmp_path, num_epochs=2))
    again.train()
    assert again.state.step == 4


def test_test_refuses_without_weights_as_jax(tmp_path):
    with pytest.raises(RuntimeError) as want:
        jax_compat.VDSR(_args(tmp_path / "jax")).test()
    with pytest.raises(RuntimeError) as got:
        compat.VDSR(_args(tmp_path / "port")).test()
    assert str(got.value) == str(want.value).replace(
        str(tmp_path / "jax"), str(tmp_path / "port"))
    with pytest.raises(RuntimeError, match="nothing to save"):
        compat.VDSR(_args(tmp_path)).save_model()


def _jax_weights(name, channels, **cfg_kw):
    cfg = JaxSRConfig(model_name=name, num_channels=channels,
                      dtype="float32", **cfg_kw)
    jm = jax_get_spec(name).make_model(cfg)
    params, _ = numpy_variables(jm, jnp.zeros((1, 16, 16, channels)), 2,
                                train=False)
    return jm, params


@pytest.mark.parametrize("name,channels,cfg_kw", [
    ("ESPCN", 1, {}),
    ("EDSR", 3, {"num_resblocks": 2, "base_filter": 16}),
])
def test_load_model_reads_jax_npz_and_reference_pkl(name, channels, cfg_kw,
                                                    tmp_path):
    jm, params = _jax_weights(name, channels, **cfg_kw)
    cfg = SRConfig(model_name=name, num_channels=channels, dtype="float32",
                   crop_size=32, **cfg_kw)
    want = from_jax_params(get_spec(name).make_model(cfg), params)

    npz_dir, pkl_dir = tmp_path / "npz", tmp_path / "pkl"
    for d in (npz_dir, pkl_dir):
        (d / f"{name}_x4").mkdir(parents=True)
    jax_save_params(str(npz_dir / f"{name}_x4" / f"{name}_params.npz"),
                    params)
    jax_export_reference_checkpoint(
        name, jm, {"params": params},
        str(pkl_dir / f"{name}_x4" / f"{name}_param.pkl"))

    for d in (npz_dir, pkl_dir):
        w = getattr(compat, name)(cfg.replace(save_dir=str(d)),
                                  device="cpu")
        assert w.load_model() is True
        _params_equal(w.state.model, params)
        x = torch.rand((1, 8, 8, channels),
                       generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            assert torch.equal(w.state.model.eval()(x), want.eval()(x))
    assert not (pkl_dir / f"{name}_x4" / f"{name}_params.npz").exists()


def test_port_npz_loads_in_the_jax_wrapper(tmp_path):
    m = compat.ESPCN(_args(tmp_path))
    m.train()
    jm = jax_compat.ESPCN(_args(tmp_path))
    assert jm.load_model() is True
    x = np.random.default_rng(4).uniform(0, 1, (1, 8, 8, 1)).astype(
        np.float32)
    want = np.asarray(jm.trainer.make_predict_fn()(*jm._params, x))
    with torch.no_grad():
        got = m.state.model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_srgan_trains_in_two_phases(tmp_path):
    cfg = SRConfig(model_name="SRGAN", num_channels=3, base_filter=8,
                   num_resblocks=2, crop_size=32, batch_size=2,
                   num_epochs=2, pretrain_epochs=1, steps_per_epoch=2,
                   save_epochs=1, dtype="float32", save_dir=str(tmp_path),
                   train_dataset="synthetic", test_dataset="synthetic",
                   data_dir=str(tmp_path / "data"))
    w = compat.SRGAN(cfg, device="cpu")
    losses = w.train()
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert w.state.step == 4
    run = tmp_path / "SRGAN_x4"
    assert (run / "ckpt_d" / "run_meta.json").exists()
    assert (run / "SRGAN_params.npz").exists()
    assert np.isfinite(w.test().avg_psnr_sr)
