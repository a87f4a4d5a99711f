"""sr_torch EDSR against the JAX package: blocks, model, weights, fused tail,
tiling, to_u8, config and checkpoints.

Weights come from a JAX ``init`` and cross with ``from_jax_params``; inputs
come from ``np.random.default_rng``. Everything runs on the CPU, where the
port's kernels take their plain PyTorch versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sr.eval.tiling import tiled_predict as jax_tiled_predict
from sr.kernels.fused_tail import (
    make_fused_tail_predict as jax_make_fused_tail_predict)
from sr.models.edsr import Net as FlaxEDSR
from sr.nn.blocks import ConvBlock as FlaxConvBlock
from sr.nn.blocks import PSBlock as FlaxPSBlock
from sr.nn.blocks import ResnetBlock as FlaxResnetBlock
from sr.quant import to_u8 as jax_to_u8
from sr.utils import checkpoint as jax_ckpt
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.eval.tiling import tiled_predict
from sr_torch.kernels.depth_to_space import depth_to_space_plain
from sr_torch.kernels.fused_tail import (
    extract_affine_conv, make_fused_tail_predict)
from sr_torch.models.edsr import Net
from sr_torch.models.registry import get_spec
from sr_torch.nn.blocks import ConvBlock, PSBlock, ResnetBlock
from sr_torch.nn.init import lecun_normal_
from sr_torch.quant import to_u8
from sr_torch.utils import checkpoint
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params, to_jax_params

torch.set_num_threads(1)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).to(torch.float32).numpy()


def _init(flax_module, x, seed):
    v = flax_module.init(jax.random.key(seed), jnp.asarray(x), train=False)
    return v, jax.tree.map(np.array, v["params"])


def _edsr_pair(scale, seed=0, blocks=4, filters=16, hw=(12, 10), batch=2,
               jdtype=jnp.float32, tdtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, *hw, 3)).astype(np.float32)
    jm = FlaxEDSR(3, filters, blocks, scale, 1.0, jdtype)
    v, params = _init(jm, x, seed)
    tm = from_jax_params(Net(3, filters, blocks, scale, dtype=tdtype), params)
    return jm, v, params, tm, x


# -------------------------------------------------------------- blocks ----

@pytest.mark.parametrize("act", [None, "relu"])
def test_conv_block_matches_flax(act):
    x = np.random.default_rng(1).standard_normal((2, 9, 11, 5))
    x = x.astype(np.float32)
    v, params = _init(FlaxConvBlock(8, 3, act=act), x, 1)
    want = np.asarray(FlaxConvBlock(8, 3, act=act).apply(v, x))
    blk = from_jax_params(ConvBlock(5, 8, 3, act=act), params)
    with torch.no_grad():
        got = _nhwc(blk(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("r,act", [(2, None), (3, None), (2, "relu")])
def test_ps_block_matches_flax(r, act):
    x = np.random.default_rng(2).standard_normal((2, 6, 7, 8))
    x = x.astype(np.float32)
    flax_blk = FlaxPSBlock(4, r, act=act)
    v, params = _init(flax_blk, x, 2)
    want = np.asarray(flax_blk.apply(v, x))
    blk = from_jax_params(PSBlock(8, 4, r, act=act), params)
    with torch.no_grad():
        got = _nhwc(blk(_nchw(x)))
    assert got.shape == (2, 6 * r, 7 * r, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("res_scale", [1.0, 0.1])
def test_resnet_block_matches_flax(res_scale):
    x = np.random.default_rng(3).uniform(0, 1, (2, 10, 13, 16))
    x = x.astype(np.float32)
    flax_blk = FlaxResnetBlock(16, 3, act="relu", norm=None,
                               res_scale=res_scale)
    v, params = _init(flax_blk, x, 3)
    want = np.asarray(flax_blk.apply(v, x))
    blk = from_jax_params(ResnetBlock(16, res_scale=res_scale), params)
    with torch.no_grad():
        got = _nhwc(blk(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_resnet_block_refuses_autograd(monkeypatch):
    """The fused kernel has no backward (nor had the TPU kernel), so the
    block refuses it under autograd: with grad on it never calls
    ``fused_resblock``; without grad it calls it once."""
    import sr_torch.nn.blocks as blocks

    calls, fused = [], blocks.fused_resblock

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return fused(*args, **kwargs)

    monkeypatch.setattr(blocks, "fused_resblock", counted)
    blk = ResnetBlock(16, generator=torch.Generator().manual_seed(0))
    x = _nchw(np.random.default_rng(4).uniform(0, 1, (1, 6, 6, 16))
              .astype(np.float32))
    blk(x)
    assert calls == []
    with torch.no_grad():
        assert blk(x).shape == x.shape
    assert calls == [False]


def test_resnet_block_trains_unfused_under_autograd():
    """With grad on, the block runs its two convs one by one and the result
    carries a gradient; without grad it takes the fused path. Both compute
    the same block (≤ 1e-5, f32)."""
    blk = ResnetBlock(16, generator=torch.Generator().manual_seed(0))
    x = _nchw(np.random.default_rng(4).uniform(0, 1, (1, 6, 6, 16))
              .astype(np.float32))
    trained = blk(x)
    assert trained.grad_fn is not None
    with torch.no_grad():
        fused = blk(x)
    assert fused.shape == x.shape and fused.grad_fn is None
    np.testing.assert_allclose(_nhwc(trained.detach()), _nhwc(fused),
                               atol=1e-5)


def test_resnet_block_repacks_after_weight_change():
    blk = ResnetBlock(16, generator=torch.Generator().manual_seed(0))
    first = blk.packed()
    assert blk.packed() is first  # cached
    with torch.no_grad():
        blk.Conv_0.weight.mul_(2.0)
    again = blk.packed()
    assert again is not first
    assert torch.equal(again[0], first[0] * 2.0)


def test_blocks_refuse_what_a_later_slice_brings():
    # PReLU and batch norm serve since SRResNet
    # (tests/test_torch_srresnet_models.py), instance norm since the CLI
    # slice (tests/test_torch_blocks_menu.py): the menu is whole, and what
    # is still refused is a norm that the JAX package does not have
    assert hasattr(ConvBlock(3, 8, norm="instance")._NormAct_0, "GroupNorm_0")
    assert not ResnetBlock(16, norm="instance").fused
    with pytest.raises(ValueError, match="unknown norm"):
        ConvBlock(3, 8, norm="layer")
    with pytest.raises(ValueError, match="unknown norm"):
        ResnetBlock(16, norm="layer")


# --------------------------------------------------------------- model ----

@pytest.mark.parametrize("scale", [2, 3, 4])
def test_edsr_exact_graph_matches_flax_f32(scale):
    jm, v, _, tm, x = _edsr_pair(scale, seed=scale)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 12 * scale, 10 * scale, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_edsr_bf16_matches_flax():
    """bf16: flax rounds each conv's output to bf16 before adding its bias
    and keeps the bias in bf16; the port's resblocks add the f32 bias
    before one rounding. Outputs differ by a few bf16 ulps at magnitude ~1
    (2^-7 each): max 3e-2, mean 3e-3."""
    jm, v, _, tm, x = _edsr_pair(4, seed=7, jdtype=jnp.bfloat16,
                                 tdtype=torch.bfloat16)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False), np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 3e-2, err.max()
    assert err.mean() <= 3e-3, err.mean()


def test_body_and_tail_compose_to_forward():
    _, _, _, tm, x = _edsr_pair(4, seed=8)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        assert torch.equal(tm.tail(tm.body(xt)), tm(xt))


def test_clone_sets_the_compute_dtype_everywhere():
    net = Net(3, 16, 2, 4)
    bf = net.clone(torch.bfloat16)
    assert all(m.dtype == torch.bfloat16 for m in bf.modules()
               if hasattr(m, "dtype"))
    assert net.dtype == torch.float32 and net.blocks[0].dtype == torch.float32


def test_params_round_trip_and_checks():
    _, _, params, tm, _ = _edsr_pair(2, seed=9)
    back = to_jax_params(tm)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    extra = dict(params, stray={"kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="stray"):
        from_jax_params(Net(3, 16, 4, 2), extra)
    missing = {k: v for k, v in params.items() if k != "out_conv"}
    with pytest.raises(KeyError):
        from_jax_params(Net(3, 16, 4, 2), missing)


def test_checkpoint_npz_crosses_both_ways(tmp_path):
    _, _, params, tm, _ = _edsr_pair(4, seed=10)
    jax_path = str(tmp_path / "jax.npz")
    jax_ckpt.save_params(jax_path, params)
    got, stats = checkpoint.load_params(jax_path)
    assert stats is None
    port_path = str(tmp_path / "port.npz")
    checkpoint.save_params(port_path, to_jax_params(tm))
    back, _ = jax_ckpt.load_params(port_path)
    for a, b, c in zip(jax.tree.leaves(params), jax.tree.leaves(got),
                       jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_seeded_init_is_flax_lecun_normal():
    w = torch.empty(64, 64, 3, 3)
    lecun_normal_(w, torch.Generator().manual_seed(0))
    std = (1.0 / 576) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    a = Net(3, 16, 2, 4, generator=torch.Generator().manual_seed(5))
    b = Net(3, 16, 2, 4, generator=torch.Generator().manual_seed(5))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert all(not m.bias.detach().any() for m in a.modules()
               if isinstance(m, torch.nn.Conv2d))


# ---------------------------------------------------------- fused tail ----

def test_fused_tail_interior_matches_jax_and_exact():
    jm, v, _, tm, _ = _edsr_pair(4, seed=11)
    x = np.random.default_rng(11).uniform(0, 1, (1, 24, 20, 3))
    x = x.astype(np.float32)
    want = np.asarray(jax_make_fused_tail_predict(jm, v)(jnp.asarray(x)))
    fused = make_fused_tail_predict(tm)
    with torch.no_grad():
        got = fused(torch.from_numpy(x)).numpy()
        exact = tm(torch.from_numpy(x)).numpy()
    m = 3 * 4  # border band: support // 2 LR px × r
    inner = (slice(None), slice(m, -m), slice(m, -m))
    np.testing.assert_allclose(got[inner], want[inner], atol=1e-4)
    np.testing.assert_allclose(got[inner], exact[inner], atol=1e-4)


def test_extract_affine_conv_rejects_an_activation():
    g = torch.Generator().manual_seed(12)
    w = torch.randn(16, 4, 3, 3, generator=g)

    def tail(y):
        z = torch.relu(F.conv2d(y.permute(0, 3, 1, 2), w, padding=1))
        return depth_to_space_plain(z.permute(0, 2, 3, 1), 2)

    with pytest.raises(ValueError, match="not affine"):
        extract_affine_conv(tail, 4, 2)


# -------------------------------------------------------------- tiling ----

@pytest.mark.parametrize("max_tiles", [16, 3])
def test_tiled_predict_matches_full_forward(max_tiles):
    """rtol/atol 1e-5, as tests/test_tiling.py holds the JAX version."""
    _, _, _, tm, _ = _edsr_pair(2, seed=13)
    x = np.random.default_rng(13).uniform(0, 1, (1, 40, 34, 3))
    x = torch.from_numpy(x.astype(np.float32))
    with torch.no_grad():
        full = tm(x)
        tiled = tiled_predict(tm, x, 2, tile=16, halo=16,
                              max_tiles_per_call=max_tiles)
    assert tiled.shape == full.shape
    np.testing.assert_allclose(tiled.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_tiled_predict_same_geometry_as_jax():
    """Both packages cut the same windows: stitching an identity 'model'
    (nearest ×2) gives the same image."""
    x = np.random.default_rng(14).uniform(0, 1, (1, 37, 29, 3))
    x = x.astype(np.float32)

    def up_t(t):
        return t.repeat_interleave(2, 1).repeat_interleave(2, 2)

    def up_j(a):
        return jnp.repeat(jnp.repeat(a, 2, 1), 2, 2)

    got = tiled_predict(up_t, torch.from_numpy(x), 2, tile=8, halo=4)
    want = np.asarray(jax_tiled_predict(up_j, jnp.asarray(x), 2, tile=8,
                                        halo=4))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- to_u8 ----

def test_to_u8_matches_jax_bit_for_bit_including_ties():
    n = np.arange(255)
    centers = ((2 * n + 1) / 510).astype(np.float32)
    cand = np.concatenate([centers, np.nextafter(centers, np.float32(0)),
                           np.nextafter(centers, np.float32(1)),
                           np.float32([0.5, -0.2, 0.0, 1.0, 1.3])])
    ties = cand * np.float32(255) % 1 == 0.5
    assert ties.sum() > 10  # exact .5 products: half-to-even decides them
    rng = np.random.default_rng(15)
    y = np.concatenate([cand, rng.uniform(-0.1, 1.1, 1000)
                        .astype(np.float32)])
    got = to_u8(torch.from_numpy(y)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(jax_to_u8(jnp.asarray(y))))


# ------------------------------------------------- config and registry ----

def test_config_mirrors_the_jax_dataclass():
    ours = {f.name: f.default for f in dataclasses.fields(SRConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxSRConfig)}
    assert ours == ref
    cfg = SRConfig(model_name="EDSR")
    assert cfg.effective_lr == 1e-4
    assert cfg.replace(lr=3e-4).effective_lr == 3e-4


def test_registry_serves_edsr_only_for_now():
    spec = get_spec("edsr")
    assert spec.name == "EDSR" and spec.default_channels == 3
    assert not spec.pre_upsample
    model = spec.make_model(SRConfig(model_name="EDSR", num_channels=3,
                                     num_resblocks=2, base_filter=16,
                                     dtype="float32"))
    assert isinstance(model, Net) and len(model.blocks) == 2
    # every zoo model registers since FSRCNN and LapSRN's slice
    # (tests/test_torch_fsrcnn_models.py)
    assert get_spec("FSRCNN").name == "FSRCNN"
