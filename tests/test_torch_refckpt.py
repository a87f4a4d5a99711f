"""Reference-format ``<Model>_param.pkl``: the port's
``sr_torch/utils/refckpt.py`` against the JAX package's
``sr/utils/torch_interop.py``.

For all nine models at small widths (and SRGAN's discriminator), the same
flax weights (every leaf drawn from a seeded numpy generator at the shapes
the flax init gives, batch-norm running statistics included) go into the
JAX package's
``export_reference_checkpoint`` (the discriminator through
``discriminator_plan`` and ``transplant``) and, through
``from_jax_params``, into the port model. The port's reference state dict
must equal the JAX package's: the same keys in the same order, the same
shapes and dtypes, and equal values bit for bit (tolerance 0). Loading the
JAX package's file into a fresh port model must give back the same
weights, bit for bit, and export after load must round-trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.models.registry import get_spec as jax_get_spec
from sr.utils.config import SRConfig as JaxSRConfig
from sr.utils.torch_interop import (
    discriminator_plan as jax_discriminator_plan,
    export_reference_checkpoint as jax_export_reference_checkpoint,
    transplant,
)
from sr.utils.torch_refnets import TorchDiscriminator
from sr_torch.models.registry import get_spec
from sr_torch.utils import refckpt
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params, to_jax_batch_stats, to_jax_params

torch.set_num_threads(1)

MODELS = {  # name: (channels, small config)
    "SRCNN": (1, {"base_filter": 16}),
    "VDSR": (1, {"base_filter": 8}),
    "DRCN": (1, {"base_filter": 8, "num_recursions": 3}),
    "ESPCN": (1, {"base_filter": 16}),
    "FSRCNN": (1, {}),
    "EDSR": (3, {"base_filter": 16, "num_resblocks": 2}),
    "SRResNet": (3, {"base_filter": 8, "num_resblocks": 2}),
    "SRGAN": (3, {"base_filter": 8, "num_resblocks": 2}),
    "LapSRN": (1, {"base_filter": 8, "num_pyramid_convs": 2}),
}


def numpy_variables(module, x, seed, **init_kw):
    """A flax module's variables drawn from ``np.random.default_rng(seed)``
    at the shapes ``jax.eval_shape`` of its init gives (no init runs):
    kernels normal with std 1/sqrt(fan-in), biases normal (std 0.05), norm
    scales 1 ± 0.2, running means normal (std 0.3), running variances
    uniform in [0.5, 2], every other leaf (PReLU slopes, DRCN's recursion
    weights) uniform in [0.1, 1]. Returns (params, batch_stats or None)."""
    shapes = jax.eval_shape(
        lambda a: module.init(jax.random.key(0), a, **init_kw), x)
    rng = np.random.default_rng(seed)

    def draw(k, shape):
        if k == "kernel":
            return rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        if k == "bias":
            return rng.normal(0.0, 0.05, shape)
        if k == "scale":
            return rng.normal(1.0, 0.2, shape)
        if k == "mean":
            return rng.normal(0.0, 0.3, shape)
        if k == "var":
            return rng.uniform(0.5, 2.0, shape)
        return rng.uniform(0.1, 1.0, shape)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else draw(k, v.shape).astype(np.float32)
                for k, v in t.items()}

    return walk(shapes["params"]), (
        walk(shapes["batch_stats"]) if "batch_stats" in shapes else None)


def _flax_variables(name, channels, cfg_kw, seed=0):
    cfg = JaxSRConfig(model_name=name, num_channels=channels, scale_factor=4,
                      dtype="float32", **cfg_kw)
    jm = jax_get_spec(name).make_model(cfg)
    params, stats = numpy_variables(jm, jnp.zeros((1, 8, 8, channels)), seed,
                                    train=False)
    return jm, params, stats


def _port_model(name, channels, cfg_kw, params=None, stats=None):
    m = get_spec(name).make_model(SRConfig(
        model_name=name, num_channels=channels, scale_factor=4,
        dtype="float32", **cfg_kw))
    if params is not None:
        from_jax_params(m, params, stats)
    return m


def _assert_state_dicts_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), f"{path}/{k}")


@pytest.fixture(scope="module", params=list(MODELS))
def exported(request, tmp_path_factory):
    """(name, channels, cfg, flax params, stats, JAX-written .pkl path)."""
    name = request.param
    channels, cfg_kw = MODELS[name]
    jm, params, stats = _flax_variables(name, channels, cfg_kw)
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    path = str(tmp_path_factory.mktemp("refckpt") / f"{name}_param.pkl")
    jax_export_reference_checkpoint(name, jm, variables, path)
    return name, channels, cfg_kw, params, stats, path


def test_state_dict_equals_the_jax_export(exported):
    name, channels, cfg_kw, params, stats, path = exported
    want = torch.load(path, map_location="cpu", weights_only=True)
    got = refckpt.reference_state_dict(
        name, _port_model(name, channels, cfg_kw, params, stats))
    _assert_state_dicts_equal(got, want)


def test_load_then_export_round_trips(exported, tmp_path):
    name, channels, cfg_kw, params, stats, path = exported
    m = refckpt.load_reference_checkpoint(
        name, _port_model(name, channels, cfg_kw), path)
    _assert_trees_equal(to_jax_params(m), params)
    if stats is not None:
        _assert_trees_equal(to_jax_batch_stats(m), stats)
    out = refckpt.export_reference_checkpoint(name, m,
                                              str(tmp_path / "again.pkl"))
    _assert_state_dicts_equal(
        torch.load(out, map_location="cpu", weights_only=True),
        torch.load(path, map_location="cpu", weights_only=True))


def test_discriminator_matches_discriminator_plan():
    cfg_kw, hr = {"base_filter": 8}, 32
    jd = jax_get_spec("SRGAN").make_discriminator(JaxSRConfig(
        model_name="SRGAN", num_channels=3, dtype="float32", **cfg_kw))
    params, stats = numpy_variables(jd, jnp.zeros((1, hr, hr, 3)), 3,
                                    train=False)
    tnet = TorchDiscriminator(3, 8, hr_size=hr)
    transplant(params, stats, jax_discriminator_plan(hr, 8), tnet)
    want = tnet.state_dict()
    d = get_spec("SRGAN").make_discriminator(SRConfig(
        model_name="SRGAN", num_channels=3, dtype="float32", crop_size=hr,
        **cfg_kw))
    from_jax_params(d, params, stats)
    got = refckpt.reference_state_dict("discriminator", d)
    _assert_state_dicts_equal(got, want)
    fresh = get_spec("SRGAN").make_discriminator(SRConfig(
        model_name="SRGAN", num_channels=3, dtype="float32", crop_size=hr,
        **cfg_kw))
    refckpt.load_reference_state_dict("discriminator", fresh, want)
    _assert_trees_equal(to_jax_params(fresh), params)
    # the NHWC / NCHW flatten: the same logits from both nets
    x = np.random.default_rng(6).uniform(0, 1, (2, hr, hr, 3)).astype(
        np.float32)
    tnet.eval()
    fresh.eval()
    with torch.no_grad():
        np.testing.assert_allclose(
            fresh(torch.from_numpy(x)).numpy(),
            tnet(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(),
            rtol=0, atol=1e-4)


def test_refusals_name_the_atom(exported, tmp_path):
    name, channels, cfg_kw, params, stats, path = exported
    sd = torch.load(path, map_location="cpu", weights_only=True)
    last = list(sd)[-1].rpartition(".")[0]  # drop the last whole atom
    short = {k: v for k, v in sd.items() if not k.startswith(last + ".")}
    with pytest.raises(ValueError, match="atoms"):
        refckpt.load_reference_state_dict(
            name, _port_model(name, channels, cfg_kw), short)
    first = next(k for k in sd if k.endswith("weight") or "." not in k)
    bad = dict(sd)
    bad[first] = torch.zeros(tuple(bad[first].shape) + (1,))
    with pytest.raises(ValueError, match=first.rpartition(".")[0] or first):
        refckpt.load_reference_state_dict(
            name, _port_model(name, channels, cfg_kw), bad)
