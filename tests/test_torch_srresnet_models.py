"""sr_torch's SRResNet and SRGAN modules against the JAX package: the block
menu (PReLU, flax's BatchNorm in train and eval mode with its running
statistics, lrelu/tanh/sigmoid, the BN+PReLU ResnetBlock, PSBlock with
PReLU), SRResNet ×2/×4 and the discriminator forwards, flax's parameter and
batch-statistics trees both ways, the .npz export, the registry specs,
``bce_with_logits`` and the VGG19 feature tower through a shared
torchvision-format ``.pth``.

Weights come from a JAX ``init`` whose leaves are then redrawn from a
seeded normal (scales, biases, slopes and running statistics included, so
that no batch norm is the identity) and cross with ``from_jax_params``;
inputs come from ``np.random.default_rng``. Sizes are small: 2 resblocks ×
16 filters, the discriminator at base 8 on a 32² HR crop. Everything runs
on the CPU.
"""

import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.models.registry import get_spec as jax_get_spec
from sr.models.srresnet import Discriminator as FlaxD
from sr.models.srresnet import Net as FlaxNet
from sr.nn import blocks as jb
from sr.train import losses as jax_losses
from sr.train import vgg as jax_vgg
from sr.utils.checkpoint import load_params as jax_load_params
from sr.utils.checkpoint import save_params as jax_save_params
from sr_torch.models import srresnet
from sr_torch.models.registry import get_spec
from sr_torch.nn import blocks
from sr_torch.train.losses import bce_with_logits
from sr_torch.train.vgg import VGG19Features, layer_names, load_vgg
from sr_torch.utils.checkpoint import load_params, save_params
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import (
    from_jax_params, to_jax_batch_stats, to_jax_params)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32 = 1e-4  # float32 forwards: summation order only


def lively(tree, seed):
    """A copy of a flax params or batch_stats tree with every leaf redrawn:
    kernels N(0, 2 / fan_in), biases N(0, 0.05²), BN scales and running
    variances 1 + U(-0.3, 0.3)... made positive, running means N(0, 0.1²),
    PReLU slopes U(0.1, 0.4)."""
    rng = np.random.default_rng(seed)

    def leaf(k, v):
        if k == "kernel":
            fan_in = math.prod(v.shape[:-1])
            return rng.normal(0, math.sqrt(2 / fan_in), v.shape)
        if k in ("scale", "var"):
            return rng.uniform(0.7, 1.3, v.shape)
        if k == "slope":
            return rng.uniform(0.1, 0.4, v.shape)
        if k == "mean":
            return rng.normal(0, 0.1, v.shape)
        return rng.normal(0, 0.05, v.shape)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else leaf(k, np.asarray(v)).astype(np.float32)
                for k, v in t.items()}

    return walk(tree)


def _init(module, x, seed):
    v = jax.tree.map(np.asarray, module.init(jax.random.key(seed),
                                             jnp.asarray(x)))
    return lively(v["params"], seed), (
        lively(v["batch_stats"], seed + 100) if "batch_stats" in v else None)


def _apply(module, params, bs, x, train):
    """flax forward: (out, new batch_stats)."""
    var = {"params": params}
    if bs is not None:
        var["batch_stats"] = bs
    if train and bs is not None:
        out, mut = module.apply(var, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        return np.asarray(out), jax.tree.map(np.asarray, mut["batch_stats"])
    return np.asarray(module.apply(var, jnp.asarray(x), train=train)), bs


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_close(got, want, atol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg="/".join(path))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


def _x(shape, seed, lo=-1.0):
    return np.random.default_rng(seed).uniform(lo, 1, shape).astype(
        np.float32)


# -------------------------------------------------------------- blocks ----

def test_prelu_matches_flax_and_its_slope_gradient():
    x = _x((2, 5, 5, 4), 0)
    jm = jb.PReLU()
    v = {"params": {"slope": np.float32(0.3)}}
    tm = blocks.PReLU()
    assert float(tm.slope.detach()) == 0.25
    assert tm.slope.dtype == torch.float32
    with torch.no_grad():
        tm.slope.fill_(0.3)
    xt = _nchw(x).requires_grad_()
    y = tm(xt)
    np.testing.assert_array_equal(_nhwc(y), np.asarray(jm.apply(v, x)))
    y.sum().backward()
    g = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, x)))(v["params"])
    np.testing.assert_allclose(float(tm.slope.grad), float(g["slope"]),
                               rtol=1e-6)
    # bf16 input: the slope is cast to x's dtype
    xb = _nchw(x).bfloat16()
    want = np.asarray(jm.apply(v, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        got = tm(xb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got.float()), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_flax_in_train_and_eval(dtype):
    """flax's BatchNorm(momentum=0.9): f32 statistics whatever the input's
    dtype, E[x²] − E[x]², the biased variance into the running one, output
    in the block's dtype. Outputs within 1e-5 (f32) or one bf16 rounding
    (bf16); updated running statistics within 1e-6."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    x = _x((3, 6, 7, 5), 1) * 3 + 0.5
    jm = jb.nn.BatchNorm(use_running_average=None, momentum=0.9, dtype=jdt)
    v = jm.init(jax.random.key(0), x, use_running_average=True)
    params = lively(jax.tree.map(np.asarray, v["params"]), 1)
    bs = lively(jax.tree.map(np.asarray, v["batch_stats"]), 2)
    tm = blocks.BatchNorm(5, dtype=tdt)
    with torch.no_grad():
        tm.scale.copy_(torch.from_numpy(params["scale"]))
        tm.bias.copy_(torch.from_numpy(params["bias"]))
        tm.mean.copy_(torch.from_numpy(bs["mean"]))
        tm.var.copy_(torch.from_numpy(bs["var"]))
    xt = _nchw(x).to(tdt)
    xj = jnp.asarray(x, jdt)
    atol = 1e-5 if dtype == "float32" else 2e-2
    # eval: the running statistics, nothing updated
    tm.eval()
    want = jm.apply({"params": params, "batch_stats": bs}, xj,
                    use_running_average=True)
    with torch.no_grad():
        got = tm(xt)
    assert got.dtype == tdt
    np.testing.assert_allclose(_nhwc(got.float()),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(tm.mean.numpy(), bs["mean"])
    # train: the batch's statistics, the running ones advanced once
    tm.train()
    want, mut = jm.apply({"params": params, "batch_stats": bs}, xj,
                         use_running_average=False, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(xt)
    np.testing.assert_allclose(_nhwc(got.float()),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(mut["batch_stats"][k]),
                                   rtol=0, atol=1e-6)
    # the biased batch variance: torch's BatchNorm2d would use n/(n-1)·var
    n = 3 * 6 * 7
    batch_var = xt.float().permute(0, 2, 3, 1).reshape(-1, 5).numpy().var(
        axis=0)
    np.testing.assert_allclose(
        tm.var.numpy(), 0.9 * bs["var"] + 0.1 * batch_var, rtol=1e-5)
    assert not np.allclose(batch_var * n / (n - 1), batch_var, rtol=1e-3)


def test_frozen_batch_stats_normalizes_but_keeps_the_running_stats():
    tm = blocks.BatchNorm(4).train()
    x = _nchw(_x((2, 3, 3, 4), 2) + 2)
    with torch.no_grad(), blocks.frozen_batch_stats():
        frozen = tm(x)
    assert torch.equal(tm.mean, torch.zeros(4))
    assert torch.equal(tm.var, torch.ones(4))
    with torch.no_grad():
        live = tm(x)
    assert torch.equal(frozen, live)
    assert not torch.equal(tm.mean, torch.zeros(4))


@pytest.mark.parametrize("act", ["lrelu", "tanh", "sigmoid", "prelu"])
@pytest.mark.parametrize("norm", [None, "batch"])
@pytest.mark.parametrize("stride", [1, 2])
def test_convblock_menu_matches_flax(act, norm, stride):
    """ConvBlock conv → [BN] → act with flax's explicit (k//2, k//2)
    padding, also at stride 2 (the discriminator's), in train mode: output
    within 1e-5 and the running statistics within 1e-6."""
    x = _x((2, 9, 8, 3), 3)
    jm = jb.ConvBlock(6, 3, stride, act=act, norm=norm)
    params, bs = _init(jm, x, 4)
    tm = from_jax_params(blocks.ConvBlock(3, 6, 3, stride, act=act,
                                          norm=norm), params, bs).train()
    want, new_bs = _apply(jm, params, bs, x, True)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if norm:
        _assert_trees_close(to_jax_batch_stats(tm), new_bs, 1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_bn_prelu_resnet_block_matches_flax(train):
    """SRResNet's block, conv-BN-PReLU-conv-BN + x: the output, its
    gradients (params and input) and in train mode the updated running
    statistics, within 1e-5 relative. It never takes the fused kernel,
    whose function is conv → ReLU → conv."""
    x = _x((2, 6, 6, 8), 5)
    jm = jb.ResnetBlock(8, 3, act="prelu", norm="batch",
                        kernel_init="normal_002")
    params, bs = _init(jm, x, 6)
    tm = from_jax_params(blocks.ResnetBlock(8, 3, act="prelu", norm="batch",
                                            kernel_init="normal_002"),
                         params, bs).train(train)
    assert not tm.fused and tm.packed() is None
    probe = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        var = {"params": p, "batch_stats": bs}
        if train:
            out, _ = jm.apply(var, xx, train=True, mutable=["batch_stats"])
        else:
            out = jm.apply(var, xx, train=False)
        return jnp.sum(out * probe)

    want, new_bs = _apply(jm, params, bs, x, train)
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    y = tm(xt)
    np.testing.assert_allclose(_nhwc(y), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    (y.permute(0, 2, 3, 1) * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gx)).max())
    got_grads = {}
    for name, p in tm.named_parameters():
        got_grads[name] = p.grad
    want_g = dict(_leaves(jax.tree.map(np.asarray, gp)))
    assert len(want_g) == len(got_grads) == 9
    top = max(np.abs(g).max() for g in want_g.values())
    for path, g in want_g.items():
        mod = ".".join(path[:-1])
        leaf = {"kernel": "weight"}.get(path[-1], path[-1])
        t = got_grads[f"{mod}.{leaf}" if mod else leaf].numpy()
        if path[-1] == "kernel":
            t = t.transpose(2, 3, 1, 0)
        if train and path in (("Conv_0", "bias"), ("Conv_1", "bias")):
            # a train-mode BN subtracts the batch mean, so the bias before
            # it gets no gradient: both packages' are rounding noise
            assert max(np.abs(t).max(), np.abs(g).max()) <= 1e-5 * top
            continue
        np.testing.assert_allclose(t, g, rtol=0,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-30),
                                   err_msg="/".join(path))
    if train:
        _assert_trees_close(to_jax_batch_stats(tm), new_bs, 1e-6)
    else:
        _assert_trees_close(to_jax_batch_stats(tm), bs, 0)


def test_psblock_prelu_matches_flax_and_its_preshuffle_form():
    """PSBlock(act='prelu'): conv, the shuffle with the conv's bias, then
    PReLU, as flax orders it; ``preshuffle`` (conv + bias, then PReLU) is
    its output before the shuffle, which a shuffle turns into the block's
    output bit for bit."""
    from sr_torch.kernels.depth_to_space import depth_to_space

    x = _x((2, 5, 6, 8), 8)
    jm = jb.PSBlock(8, 2, act="prelu", kernel_init="normal_002")
    params, _ = _init(jm, x, 9)
    tm = from_jax_params(blocks.PSBlock(8, 8, 2, act="prelu",
                                        kernel_init="normal_002"), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_nchw(x))
        pre = tm.preshuffle(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)
    assert torch.equal(depth_to_space(pre.permute(0, 2, 3, 1).contiguous(),
                                      2), got.permute(0, 2, 3, 1))


def test_instance_norm_and_unknown_menus_are_refused():
    # instance norm builds since the CLI slice
    # (tests/test_torch_blocks_menu.py); an unknown norm is refused
    assert hasattr(blocks.PSBlock(8, 8, 2, norm="instance")._NormAct_0,
                   "GroupNorm_0")
    with pytest.raises(ValueError, match="unknown norm"):
        blocks.PSBlock(8, 8, 2, norm="layer")
    with pytest.raises(ValueError, match="unknown activation"):
        blocks.ConvBlock(3, 8, act="gelu")
    with pytest.raises(ValueError, match="pre-shuffle form"):
        blocks.PSBlock(8, 8, 2, norm="batch").preshuffle(torch.zeros(1, 8, 2,
                                                                      2))


# -------------------------------------------------------------- models ----

def _net_pair(scale, seed, dtype=jnp.float32, tdtype=torch.float32):
    x = _x((2, 8, 8, 3), seed, lo=0.0)
    jm = FlaxNet(3, 16, 2, scale, dtype)
    params, bs = _init(FlaxNet(3, 16, 2, scale), x, seed)
    tm = from_jax_params(srresnet.Net(3, 16, 2, scale, tdtype), params, bs)
    return jm, params, bs, tm, x


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("train", [False, True])
def test_srresnet_forward_matches_flax_f32(scale, train):
    """SRResNet ×2/×4 in f32, eval (running statistics) and train mode
    (batch statistics, every running statistic updated): within 1e-4 of
    flax, statistics within 1e-5."""
    jm, params, bs, tm, x = _net_pair(scale, scale + 10 * train)
    want, new_bs = _apply(jm, params, bs, x, train)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8 * scale, 8 * scale, 3)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=F32)
    _assert_trees_close(to_jax_batch_stats(tm), new_bs, 1e-5)
    var = {"params": params, "batch_stats": new_bs}
    for method in ("body", "tail"):
        h = (np.asarray(jm.apply(var, jnp.asarray(x), train=False,
                                 method="body"))
             if method == "tail" else x)
        tm.eval()
        w = np.asarray(jm.apply(var, jnp.asarray(h), train=False,
                                method=method))
        with torch.no_grad():
            g = getattr(tm, method)(torch.from_numpy(h.copy())).numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=F32)


def test_srresnet_forward_matches_flax_bf16():
    """bf16 rounds at other places in the two packages (flax rounds each
    conv's output before its bias add), and these eval-mode outputs reach
    |14|, so the bound is relative to the JAX package's own bf16 error:
    the port's bf16 forward no further from flax's f32 forward than 1.5 ×
    flax's bf16 forward is, in max and in mean (0.124 / 0.0225 against
    0.130 / 0.0245 at these weights)."""
    jm, params, bs, tm, x = _net_pair(4, 3, jnp.bfloat16, torch.bfloat16)
    want, _ = _apply(jm, params, bs, x, False)
    ref, _ = _apply(FlaxNet(3, 16, 2, 4), params, bs, x, False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    d_port = np.abs(got.float().numpy() - ref)
    d_jax = np.abs(np.asarray(want, np.float32) - ref)
    assert d_port.max() <= 1.5 * d_jax.max(), (d_port.max(), d_jax.max())
    assert d_port.mean() <= 1.5 * d_jax.mean(), (d_port.mean(),
                                                  d_jax.mean())


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_flax_f32(train):
    """The 8-conv tower, NHWC flatten and two dense layers (logits) at base
    8 on 32² inputs: within 1e-4 (train mode: batch statistics through
    seven batch norms), the running statistics within 1e-5."""
    hr = _x((3, 32, 32, 3), 12, lo=0.0)
    jm = FlaxD(8)
    params, bs = _init(jm, hr, 13)
    assert params["Dense_0"]["kernel"].shape == (2 * 2 * 64, 1024)
    tm = from_jax_params(srresnet.Discriminator(3, 8, 32), params, bs)
    want, new_bs = _apply(jm, params, bs, hr, train)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(hr)).numpy()
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32)
    _assert_trees_close(to_jax_batch_stats(tm), new_bs, 1e-5)
    with pytest.raises(ValueError, match="divide by 16"):
        srresnet.Discriminator(3, 8, 40)


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_params_and_batch_stats_cross_both_ways(which, tmp_path):
    """flax's trees load into the port and come back unchanged (conv and
    dense kernels transposed both ways), through either package's .npz."""
    if which == "generator":
        x = _x((1, 8, 8, 3), 0, lo=0.0)
        params, bs = _init(FlaxNet(3, 16, 2, 4), x, 14)
        tm = from_jax_params(srresnet.Net(3, 16, 2, 4), params, bs)
    else:
        x = _x((1, 32, 32, 3), 0, lo=0.0)
        params, bs = _init(FlaxD(8), x, 15)
        tm = from_jax_params(srresnet.Discriminator(3, 8, 32), params, bs)
    _assert_trees_close(to_jax_params(tm), params, 0)
    _assert_trees_close(to_jax_batch_stats(tm), bs, 0)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_params(ours, to_jax_params(tm), to_jax_batch_stats(tm))
    jax_save_params(theirs, params, bs)
    for path in (ours, theirs):
        for load in (load_params, jax_load_params):
            p, b = load(path)
            _assert_trees_close(p, params, 0)
            _assert_trees_close(b, bs, 0)
    with pytest.raises(ValueError, match="batch_stats must be given"):
        from_jax_params(srresnet.Net(3, 16, 2, 4), params)
    bad = jax.tree.map(lambda a: a, bs)
    first = next(iter(bad))
    bad[first]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="batch_stats the model has no"):
        from_jax_params(tm, params, bad)


@pytest.mark.parametrize("name", ["SRResNet", "SRGAN"])
def test_registry_specs_match_jax(name):
    ours, theirs = get_spec(name), jax_get_spec(name)
    for field in ("name", "pre_upsample", "default_channels", "default_lr",
                  "is_gan", "has_batchnorm"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert (ours.make_discriminator is None) == (
        theirs.make_discriminator is None)
    cfg = SRConfig(model_name=name, num_channels=3, num_resblocks=2,
                   base_filter=16, crop_size=32)
    g = ours.make_model(cfg, torch.Generator().manual_seed(0))
    assert isinstance(g, srresnet.Net) and len(g.blocks) == 2
    assert float(g.head_act.slope.detach()) == 0.25
    # normal(0.02) kernels, as flax's kernel_init="normal_002"
    std = float(g.blocks[0].Conv_0.weight.std())
    assert 0.015 < std < 0.025
    if ours.is_gan:
        d = ours.make_discriminator(cfg, torch.Generator().manual_seed(1))
        assert d.Dense_0.weight.shape == (1024, 2 * 2 * 128)


# -------------------------------------------------------------- losses ----

def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(16)
    z = (rng.standard_normal((64, 1)) * 30).astype(np.float32)
    y = rng.integers(0, 2, (64, 1)).astype(np.float32)
    want = float(jax_losses.bce_with_logits(jnp.asarray(z), jnp.asarray(y)))
    got = bce_with_logits(torch.from_numpy(z).bfloat16(),
                          torch.from_numpy(y))
    assert got.dtype == torch.float32
    zb = np.asarray(jnp.asarray(z, jnp.bfloat16).astype(jnp.float32))
    want_b = float(jax_losses.bce_with_logits(jnp.asarray(zb),
                                              jnp.asarray(y)))
    assert float(got) == pytest.approx(want_b, rel=1e-6)
    got32 = float(bce_with_logits(torch.from_numpy(z), torch.from_numpy(y)))
    assert got32 == pytest.approx(want, rel=1e-6)
    # stable at extreme logits
    big = torch.tensor([[200.0], [-200.0]])
    assert torch.isfinite(bce_with_logits(big, torch.tensor([[0.0], [1.0]])))


# ----------------------------------------------------------------- VGG ----

@pytest.fixture(scope="module")
def vgg_pth(tmp_path_factory):
    """One synthetic torchvision-format vgg19 file, written by the repo's
    script, shared by the two packages."""
    out = tmp_path_factory.mktemp("vgg") / "vgg19_synthetic.pth"
    subprocess.run([sys.executable, str(ROOT / "scripts" /
                                        "make_synthetic_vgg.py"), str(out)],
                   check=True, capture_output=True, timeout=300)
    return str(out)


@pytest.mark.parametrize("layer", ["relu1_2", "pool1", "relu2_2"])
def test_vgg_features_match_jax_through_one_pth(vgg_pth, layer):
    """The tower up to ``layer`` with the same torchvision weights: within
    1e-4 relative of flax's, and the gradient reaches the input only."""
    x = _x((2, 20, 20, 3), 17, lo=0.0)
    jm, jp = jax_vgg.load_vgg(vgg_pth, output_layer=layer)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(x)))
    tm = load_vgg(vgg_pth, output_layer=layer)
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    got.sum().backward()
    assert xt.grad is not None
    assert all(p.grad is None and not p.requires_grad
               for p in tm.parameters())


def test_vgg_menu_and_random_tower():
    assert layer_names() == jax_vgg.layer_names()
    assert load_vgg(None) is None
    a, b = load_vgg("random", "relu2_2"), load_vgg("random", "relu2_2")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert [n for n, _ in a.named_parameters()][-1] == "conv2_2.bias"
    assert len(list(VGG19Features("relu5_4").parameters())) == 32
    with pytest.raises(ValueError, match="unknown output_layer"):
        VGG19Features("relu6_1")


def test_gan_modules_load_no_jax():
    code = ("import sys, sr_torch.train.gan, sr_torch.train.vgg, "
            "sr_torch.models.srresnet, sr_torch.models.srgan; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('sr', 'jax', 'flax', 'optax', 'orbax')]; print(bad); "
            "sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
