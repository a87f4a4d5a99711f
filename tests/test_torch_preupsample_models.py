"""sr_torch's pre-upsample models, SRCNN, VDSR and DRCN ×4 on Y, against the
JAX package: the forward in f32 and bf16 (DRCN's training-mode
per-recursion outputs too), flax's parameter tree both ways (DRCN's bare
``recursion_weights`` and its round-2 layout included), the kernel
initializers and the registry specs.

Weights come from a JAX ``init`` whose kernels and biases are then redrawn
from a seeded normal (He-scaled kernels, so that SRCNN's ``normal_001``
init does not leave every output at its bias) and cross with
``from_jax_params``; inputs come from ``np.random.default_rng``. Sizes are
small: SRCNN at its widths (9-5-5, 64/32) on 24² inputs, VDSR with 4
layers of 16, DRCN with 3 recursions of 8 filters. Everything runs on the
CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.models.drcn import Net as FlaxDRCN
from sr.models.drcn import migrate_params_r2 as jax_migrate_params_r2
from sr.models.registry import get_spec as jax_get_spec
from sr.models.srcnn import Net as FlaxSRCNN
from sr.models.vdsr import Net as FlaxVDSR
from sr.utils.checkpoint import load_params as jax_load_params
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.models import drcn, srcnn, vdsr
from sr_torch.models.registry import get_spec
from sr_torch.nn.blocks import ConvBlock
from sr_torch.nn.init import get_kernel_init
from sr_torch.utils.checkpoint import load_params, save_params
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import flax_path, from_jax_params, to_jax_params

torch.set_num_threads(1)

MODELS = ("SRCNN", "VDSR", "DRCN")
_HW = {"SRCNN": (24, 24), "VDSR": (20, 18), "DRCN": (20, 18)}


def _flax(name, dtype=jnp.float32):
    return {"SRCNN": lambda: FlaxSRCNN(1, 64, dtype),
            "VDSR": lambda: FlaxVDSR(1, 16, 4, dtype),
            "DRCN": lambda: FlaxDRCN(1, 8, 3, dtype)}[name]()


def _port(name, dtype=torch.float32):
    return {"SRCNN": lambda: srcnn.Net(1, 64, dtype),
            "VDSR": lambda: vdsr.Net(1, 16, 4, dtype),
            "DRCN": lambda: drcn.Net(1, 8, 3, dtype)}[name]()


def lively(params, seed, bias_std=0.05):
    """A copy of a flax params tree with every kernel redrawn from
    N(0, 2 / fan_in), every bias from N(0, bias_std²) and DRCN's
    recursion weights from U(0.5, 1.5), so that none sums to one."""
    rng = np.random.default_rng(seed)

    def leaf(k, v):
        if k == "kernel":
            fan_in = math.prod(v.shape[:3])
            return rng.normal(0, math.sqrt(2 / fan_in),
                              v.shape).astype(np.float32)
        if k == "bias":
            return rng.normal(0, bias_std, v.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, np.asarray(v))
                for k, v in tree.items()}

    return walk(params)


def pair(name, dtype=jnp.float32, tdtype=torch.float32, seed=0):
    """A flax model and the port's on the same lively params."""
    jm = _flax(name, dtype)
    v = jm.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 1)))
    params = lively(jax.tree.map(np.asarray, v["params"]), seed)
    tm = from_jax_params(_port(name, tdtype), params).eval()
    return jm, {"params": params}, tm


def _x(name, seed, b=2):
    h, w = _HW[name]
    return np.random.default_rng(seed).uniform(
        0, 1, (b, h, w, 1)).astype(np.float32)


# ------------------------------------------------------------ forward ----

@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_flax_f32(name):
    """f32, eval mode: within 1e-4 of flax (float32 summation order)."""
    jm, v, tm = pair(name)
    x = _x(name, 1)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert 0.05 < np.abs(want).max() < 50  # a live output, not the bias
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_drcn_training_forward_matches_flax():
    """DRCN in training mode returns (final, ys): the ensemble and the
    (D, B, H, W, 1) per-recursion predictions, each within 1e-4."""
    jm, v, tm = pair("DRCN", seed=2)
    x = _x("DRCN", 3)
    want_final, want_ys = jm.apply(v, jnp.asarray(x), train=True)
    tm.train()
    with torch.no_grad():
        final, ys = tm(torch.from_numpy(x))
    assert ys.shape == want_ys.shape == (3, *x.shape)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys), rtol=0,
                               atol=1e-4)
    # the ensemble is the normalized-weight sum of the recursions
    rw = v["params"]["recursion_weights"]
    w = rw / rw.sum()
    np.testing.assert_allclose(final.numpy(),
                               np.tensordot(w, ys.numpy(), axes=1),
                               rtol=0, atol=1e-5)
    tm.eval()
    with torch.no_grad():
        assert torch.equal(tm(torch.from_numpy(x)), final)


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_flax_bf16(name):
    """bf16 rounds at other places in the two packages (flax rounds each
    conv's output before its bias add): max 3e-2 and mean 3e-3 against
    flax's bf16 forward, EDSR's serving bound, which DRCN's three
    recursions meet too (8.2e-3 max, 1.9e-3 mean at these weights)."""
    jm, v, tm = pair(name, jnp.bfloat16, torch.bfloat16, seed=4)
    x = _x(name, 5)
    want = np.asarray(jm.apply(v, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == (torch.bfloat16 if name == "SRCNN"
                         else torch.float32)  # + the f32 input
    d = np.abs(got.float().numpy() - want)
    assert d.max() <= 3e-2 and d.mean() <= 3e-3, (d.max(), d.mean())


# ------------------------------------------------------------- params ----

def _tree_equal(a, b) -> None:
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", MODELS)
def test_params_cross_both_ways_with_flax_names(name):
    """``to_jax_params(from_jax_params(p)) == p``, bit for bit: flax's tree
    as it is, VDSR without biases, DRCN with its bare recursion weights."""
    _, v, tm = pair(name, seed=6)
    _tree_equal(to_jax_params(tm), v["params"])
    names = {flax_path(n) for n, _ in tm.named_parameters()}
    if name == "VDSR":
        assert all(p.bias is None for p in tm.modules()
                   if isinstance(p, torch.nn.Conv2d))
        assert len(names) == 4
    if name == "DRCN":
        assert ("recursion_weights",) in names
        assert {"ConvBlock_0", "ConvBlock_1", "recursion_weights",
                "Scan_RecBlock_0"} == set(v["params"])
        assert set(v["params"]["Scan_RecBlock_0"]) == {
            "Conv_0", "ConvBlock_0", "Conv_1"}
    assert not hasattr(tm, "tail")  # make_serving_predict keys on it


def test_bare_param_of_the_wrong_shape_is_refused():
    _, v, _ = pair("DRCN", seed=7)
    params = dict(v["params"], recursion_weights=np.ones(4, np.float32))
    with pytest.raises(ValueError, match="recursion_weights"):
        from_jax_params(drcn.Net(1, 8, 3), params)


def _round2(params: dict) -> dict:
    """The round-2 DRCN export layout of a current params tree."""
    p = dict(params)
    rec = p.pop("Scan_RecBlock_0")
    p["Scan_RecStep_0"] = {"Conv_0": rec["Conv_0"]}
    p["ConvBlock_2"] = rec["ConvBlock_0"]
    p["Conv_0"] = rec["Conv_1"]
    return p


def test_round2_drcn_layout_loads(tmp_path):
    """A round-2 DRCN ``.npz`` loads through ``load_params`` into today's
    tree, as the JAX package's ``load_params`` migrates it, and serves the
    same forward."""
    jm, v, tm = pair("DRCN", seed=8)
    old = _round2(v["params"])
    _tree_equal(drcn.migrate_params_r2(old), jax_migrate_params_r2(old))
    path = str(tmp_path / "DRCN_r2.npz")
    save_params(path, old)
    got, stats = load_params(path)
    assert stats is None
    _tree_equal(got, v["params"])
    _tree_equal(got, jax_load_params(path)[0])
    x = torch.from_numpy(_x("DRCN", 9))
    with torch.no_grad():
        assert torch.equal(from_jax_params(drcn.Net(1, 8, 3), got).eval()(x),
                           tm(x))
    assert drcn.migrate_params_r2(v["params"]) is v["params"]


# -------------------------------------------------------------- inits ----

@pytest.mark.parametrize("init,std,bound", [
    ("normal_001", 0.001, None),
    ("normal_002", 0.02, None),
    ("kaiming", math.sqrt(2 / (64 * 9)), 2 * math.sqrt(2 / (64 * 9))
     / 0.87962566103423978),
    (None, math.sqrt(1 / (64 * 9)), 2 * math.sqrt(1 / (64 * 9))
     / 0.87962566103423978),
])
def test_kernel_inits_match_the_jax_menu(init, std, bound):
    """Each initializer's draw has the JAX menu's standard deviation
    (within 3% over 147k values); the truncated ones stay inside ±2 of
    their pre-truncation std. Drawn from the given generator: the same seed
    gives the same weights."""
    blocks = [ConvBlock(64, 256, 3, kernel_init=init,
                        generator=torch.Generator().manual_seed(3))
              for _ in range(2)]
    w = blocks[0].Conv_0.weight.detach()
    assert torch.equal(w, blocks[1].Conv_0.weight)
    assert abs(float(w.std()) / std - 1) < 0.03
    assert abs(float(w.mean())) < 0.01 * std
    if bound is not None:
        assert float(w.abs().max()) <= bound
    assert float(blocks[0].Conv_0.bias.detach().abs().max()) == 0.0
    assert get_kernel_init(init) is get_kernel_init(init or "default")


def test_convblock_without_bias():
    blk = ConvBlock(1, 8, 3, use_bias=False, kernel_init="kaiming",
                    generator=torch.Generator().manual_seed(0))
    assert blk.Conv_0.bias is None
    x = torch.rand(1, 1, 5, 5)
    with torch.no_grad():
        want = torch.relu(torch.nn.functional.conv2d(
            x, blk.Conv_0.weight, padding=1))
        assert torch.equal(blk(x), want)


# ----------------------------------------------------------- registry ----

@pytest.mark.parametrize("name", MODELS)
def test_registry_specs_match_jax(name):
    """The port's spec: pre-upsample ('bc' input), one channel, the JAX
    package's default lr; ``make_model`` builds the repo's full widths
    (SRCNN 64/32, VDSR 20 × 64 without biases, DRCN 64 filters and 16
    recursions)."""
    spec, ref = get_spec(name), jax_get_spec(name)
    assert (spec.name, spec.pre_upsample, spec.default_channels,
            spec.default_lr, spec.input_key()) == (
        ref.name, True, ref.default_channels, ref.default_lr, "bc")
    model = spec.make_model(SRConfig(model_name=name, dtype="float32"),
                            torch.Generator().manual_seed(0))
    n_port = sum(p.numel() for p in model.parameters())
    jm = ref.make_model(JaxSRConfig(model_name=name, dtype="float32"))
    v = jm.init(jax.random.key(0), jnp.zeros((1, 8, 8, 1)))
    assert n_port == sum(int(np.size(a)) for a in jax.tree.leaves(v))
    assert model.ConvBlock_0.Conv_0.weight.shape[0] == 64
    if name == "VDSR":
        assert model.num_layers == 20
    if name == "DRCN":
        assert model.num_recursions == 16
        assert tuple(model.recursion_weights.shape) == (16,)

