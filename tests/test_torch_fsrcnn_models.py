"""sr_torch's transposed-conv models against the JAX package: ``DeconvBlock``
against flax's ``ConvTranspose`` at FSRCNN's and LapSRN's geometries, the
transposed kernel's flip both ways, its fan-in for the initializers, FSRCNN
×2/×4 and LapSRN ×2/×4/×8 forwards (LapSRN's whole tuple of levels), flax's
call-order names, the bf16 forwards, the registry specs and the conv FLOP
count.

Weights come from a JAX ``init`` whose leaves are then redrawn from a
seeded normal (biases and PReLU slopes included, none zero), and cross with
``from_jax_params``; inputs come from ``np.random.default_rng`` at odd H ≠ W,
so a wrong flip or a transposed axis cannot pass. Sizes are small (FSRCNN
d=16 s=8 m=2, LapSRN 16 filters × 2 convs a level); everything runs on the
CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.models.fsrcnn import Net as FlaxFSRCNN
from sr.models.lapsrn import Net as FlaxLapSRN
from sr.models.registry import get_spec as jax_get_spec
from sr.nn import blocks as jb
from sr.utils.flops import conv_forward_flops as jax_flops
from sr_torch.models import fsrcnn, lapsrn
from sr_torch.models.registry import get_spec
from sr_torch.nn import blocks, init
from sr_torch.utils.config import SRConfig
from sr_torch.utils.flops import conv_forward_flops
from sr_torch.utils.interop import from_jax_params, to_jax_params

torch.set_num_threads(1)

F32 = 1e-5  # float32 forwards: summation order only


def lively(tree, seed):
    """A copy of a flax params tree with every leaf redrawn: kernels
    N(0, 2 / fan_in) (fan_in = kh·kw·in of the HWIO kernel), biases
    N(0, 0.05²), PReLU slopes U(0.1, 0.4)."""
    rng = np.random.default_rng(seed)

    def leaf(k, v):
        if k == "kernel":
            return rng.normal(0, math.sqrt(2 / math.prod(v.shape[:-1])),
                              v.shape)
        if k == "slope":
            return rng.uniform(0.1, 0.4, v.shape)
        return rng.normal(0, 0.05, v.shape)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else leaf(k, np.asarray(v)).astype(np.float32)
                for k, v in t.items()}

    return walk(tree)


def _init(module, x, seed):
    v = module.init(jax.random.key(seed), jnp.asarray(x))
    return lively(jax.tree.map(np.asarray, v["params"]), seed)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


# --------------------------------------------------------- DeconvBlock ----

#: (k, s, C_in, N): LapSRN's feature and image deconvs, FSRCNN's tail
_DECONVS = ((4, 2, 6, 5), (4, 2, 1, 1), (9, 4, 7, 1), (9, 2, 3, 4))


@pytest.mark.parametrize("k,s,cin,n", _DECONVS)
@pytest.mark.parametrize("act", [None, "lrelu"])
def test_deconv_block_matches_flax(k, s, cin, n, act):
    """f32 on an odd 7×9 input with a seeded non-symmetric kernel and a
    nonzero bias: the output is exactly s·H × s·W and within 1e-5 of flax's
    ``ConvTranspose`` with DeconvBlock's explicit padding pair."""
    x = np.random.default_rng(k * 10 + s).normal(0, 1, (2, 7, 9, cin)
                                                 ).astype(np.float32)
    jm = jb.DeconvBlock(n, k, s, act=act)
    params = _init(jm, x, k + s)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = blocks.DeconvBlock(cin, n, k, s, act=act)
    from_jax_params(tm, params)
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 7 * s, 9 * s, n)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=F32)


def test_deconv_padding_is_exact_times_stride():
    assert blocks.deconv_padding(4, 2) == (1, 0)
    assert blocks.deconv_padding(9, 4) == (3, 1)
    d = blocks.DeconvBlock(3, 2, 9, 4).ConvTranspose_0
    assert (d.padding, d.output_padding, d.stride) == ((3, 3), (1, 1),
                                                       (4, 4))
    with pytest.raises(ValueError, match="exact"):
        blocks.DeconvBlock(3, 2, 2, 4)


def test_transposed_kernel_flips_both_ways_bit_for_bit():
    """flax's unflipped HWIO deconv kernel → torch's (in, out, kh, kw)
    flipped in space, and back: exact."""
    jm = jb.DeconvBlock(5, 4, 2, act=None)
    params = _init(jm, np.zeros((1, 3, 3, 3), np.float32), 3)
    tm = blocks.DeconvBlock(3, 5, 4, 2, act=None)
    from_jax_params(tm, params)
    kernel = params["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(
        tm.ConvTranspose_0.weight.detach().numpy(),
        kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    back = to_jax_params(tm)
    for path, v in _leaves(params):
        node = back
        for p in path:
            node = node[p]
        np.testing.assert_array_equal(node, v)


@pytest.mark.parametrize("name,want_std", [(None, 1.0), ("kaiming", 2.0)])
def test_transposed_init_reads_flax_fan_in(name, want_std):
    """A (in=64, out=2, 4, 4) deconv weight draws at variance
    scale / (4·4·64), flax's fan-in of its HWIO kernel, not torch's
    out·k·k = 32; ``normal_001`` reads no fan."""
    w = torch.empty(64, 2, 4, 4)
    assert init.fan_in(w, transposed=True) == 1024
    assert init.fan_in(w) == 32
    init.get_kernel_init(name)(w, torch.Generator().manual_seed(0),
                               transposed=True)
    std = float(w.std())
    assert abs(std - math.sqrt(want_std / 1024)) <= 0.08 * math.sqrt(
        want_std / 1024)
    d = blocks.DeconvBlock(64, 2, 4, 2, kernel_init="normal_001",
                           generator=torch.Generator().manual_seed(1))
    weight, bias = d.ConvTranspose_0.weight.detach(), d.ConvTranspose_0.bias
    assert abs(float(weight.std()) - 1e-3) <= 1e-4
    assert float(bias.detach().abs().max()) == 0.0


# ------------------------------------------------------------- models ----

def _fsrcnn_pair(r, dtype="float32"):
    jm = FlaxFSRCNN(num_channels=1, d=16, s=8, m=2, scale_factor=r,
                    dtype=jnp.dtype(dtype))
    tm = fsrcnn.Net(1, 16, 8, 2, r, getattr(torch, dtype)).eval()
    return jm, tm


def _lapsrn_pair(r, dtype="float32"):
    jm = FlaxLapSRN(1, 16, 2, r, jnp.dtype(dtype))
    tm = lapsrn.Net(1, 16, 2, r, getattr(torch, dtype)).eval()
    return jm, tm


def _param_paths(tm):
    return {path for path, _ in _leaves(to_jax_params(tm))}


def _assert_round_trip(tm, params):
    """``to_jax_params`` gives back the loaded tree bit for bit."""
    back = dict(_leaves(to_jax_params(tm)))
    for path, v in _leaves(params):
        np.testing.assert_array_equal(back[path], v, err_msg="/".join(path))


@pytest.mark.parametrize("r", [2, 4])
def test_fsrcnn_forward_matches_flax(r):
    jm, tm = _fsrcnn_pair(r)
    x = _x((2, 11, 7, 1), r)
    params = _init(jm, x, r)
    assert _param_paths(tm) == {p for p, _ in _leaves(params)}
    from_jax_params(tm, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 11 * r, 7 * r, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=F32)
    _assert_round_trip(tm, params)


@pytest.mark.parametrize("r", [2, 4, 8])
def test_lapsrn_forward_matches_flax_every_level(r):
    """The whole tuple of levels with ``all_scales`` and in train mode;
    the last level alone in eval mode."""
    jm, tm = _lapsrn_pair(r)
    x = _x((2, 7, 9, 1), r)
    params = _init(jm, x, r)
    assert _param_paths(tm) == {p for p, _ in _leaves(params)}
    from_jax_params(tm, params)
    want = jm.apply({"params": params}, jnp.asarray(x), all_scales=True)
    levels = int(math.log2(r))
    assert len(want) == levels
    got = tm(torch.from_numpy(x), all_scales=True)
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (2, 7 * 2 ** (lvl + 1), 9 * 2 ** (lvl + 1), 1)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=F32, err_msg=f"level {lvl}")
    last = tm(torch.from_numpy(x))
    assert torch.equal(last, got[-1])
    np.testing.assert_allclose(
        last.detach().numpy(),
        np.asarray(jm.apply({"params": params}, jnp.asarray(x))), rtol=0,
        atol=F32)
    tm.train()
    assert isinstance(tm(torch.from_numpy(x)), tuple)
    _assert_round_trip(tm, params)


def test_lapsrn_names_interleave_in_call_order():
    """flax numbers ConvBlock and DeconvBlock each in call order: per level
    the feature convs, the feature deconv (64→64), the residual conv
    (64→1), the image deconv (1→1). The shapes at each name equal the
    JAX tree's, read off ``jax.eval_shape`` of the init."""
    jm, tm = _lapsrn_pair(4)
    want = jax.eval_shape(jm.init, jax.random.key(0),
                          jnp.zeros((1, 8, 8, 1)))["params"]
    got = to_jax_params(tm)
    for path, v in _leaves(got):
        node = want
        for p in path:
            node = node[p]
        assert tuple(node.shape) == v.shape, path
    # 2 feature convs a level: the head, then per level ConvBlock 1-2,
    # DeconvBlock 2j, the residual ConvBlock 3 (then 6), DeconvBlock 2j+1
    assert got["ConvBlock_3"]["Conv_0"]["kernel"].shape == (3, 3, 16, 1)
    assert got["ConvBlock_6"]["Conv_0"]["kernel"].shape == (3, 3, 16, 1)
    assert got["DeconvBlock_0"]["ConvTranspose_0"]["kernel"].shape == (
        4, 4, 16, 16)
    assert got["DeconvBlock_1"]["ConvTranspose_0"]["kernel"].shape == (
        4, 4, 1, 1)
    assert len(got) == 7 + 4


@pytest.mark.parametrize("model", ["FSRCNN", "LapSRN"])
def test_bf16_forward_within_jax_own_bf16_error(model):
    """bf16 compute, f32 params: within 1.5× the JAX package's own bf16
    error against its f32 forward (flax rounds each conv and deconv to bf16
    before the bias; the port's cuDNN-style conv adds the bias first)."""
    pair = _fsrcnn_pair if model == "FSRCNN" else _lapsrn_pair
    j32, _ = pair(4)
    jbf, tbf = pair(4, "bfloat16")
    x = _x((2, 9, 11, 1), 5)
    params = _init(j32, x, 5)
    from_jax_params(tbf, params)
    ref = np.asarray(j32.apply({"params": params}, jnp.asarray(x)))
    jax_bf = np.asarray(jbf.apply({"params": params}, jnp.asarray(x)),
                        np.float32)
    got = tbf(torch.from_numpy(x)).float().detach().numpy()
    own = np.abs(jax_bf - ref).max()
    assert own > 0
    assert np.abs(got - ref).max() <= 1.5 * own


# ----------------------------------------------------- registry, flops ----

def test_registry_specs_match_jax():
    for name in ("FSRCNN", "LapSRN"):
        spec, jspec = get_spec(name), jax_get_spec(name)
        assert (spec.name, spec.default_channels, spec.default_lr,
                spec.pre_upsample, spec.multi_scale_out) == (
            jspec.name, jspec.default_channels, jspec.default_lr,
            jspec.pre_upsample, jspec.multi_scale_out)
        model = spec.make_model(SRConfig(model_name=name, num_channels=1))
        assert next(model.parameters()).dtype == torch.float32
    assert get_spec("lapsrn").multi_scale_out
    assert not get_spec("FSRCNN").multi_scale_out


def test_fsrcnn_labels_deconv_tail_structurally():
    model = get_spec("FSRCNN").make_model(SRConfig(model_name="FSRCNN"))
    labels = fsrcnn._label_lr_groups(model)
    assert labels == {**{f"ConvBlock_{i}": "base" for i in range(7)},
                      "DeconvBlock_0": "deconv"}


@pytest.mark.parametrize("name,r,hw", [("FSRCNN", 4, (20, 14)),
                                       ("FSRCNN", 2, (9, 13)),
                                       ("LapSRN", 4, (12, 10)),
                                       ("LapSRN", 8, (6, 7))])
def test_conv_flops_match_jax(name, r, hw):
    """Deconvs counted over their input pixels, every level of the
    pyramid; full width."""
    cfg = SRConfig(model_name=name, num_channels=1, scale_factor=r)
    jspec = jax_get_spec(name)
    from sr.utils.config import SRConfig as JaxSRConfig

    jm = jspec.make_model(JaxSRConfig(model_name=name, num_channels=1,
                                      scale_factor=r))
    shape = (3, *hw, 1)
    variables = jm.init(jax.random.key(0), jnp.zeros((1, 8, 8, 1)))
    want = jax_flops(jm, variables, shape)
    got = conv_forward_flops(get_spec(name).make_model(cfg), shape)
    assert got == want > 0
