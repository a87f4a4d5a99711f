"""sr_torch's training data against the JAX package: the bicubic matrices,
the synthetic corpus and the on-device patch sampler.

The sampler's transform is held against ``sr.data.pipeline.PatchPipeline``
on JAX's own draws: the test recomputes them from the key with
``jax.random``, following the key splits of the JAX sampler, and feeds
them to the port's :meth:`PatchPipeline.transform`. Everything runs on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.data.datasets import SyntheticDataset as JaxSyntheticDataset
from sr.data.pipeline import PatchPipeline as JaxPatchPipeline
from sr.data.pipeline import build_patch_pipeline as jax_build_patch_pipeline
from sr.data.pipeline import stack_corpus as jax_stack_corpus
from sr.kernels import bicubic as jax_bicubic
from sr.models.registry import get_spec as jax_get_spec
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.data.datasets import SyntheticDataset, get_training_set
from sr_torch.data.pipeline import (
    RANDOM_SCALES, PatchPipeline, build_patch_pipeline, stack_corpus)
from sr_torch.kernels import bicubic
from sr_torch.models.registry import get_spec
from sr_torch.utils.config import SRConfig

torch.set_num_threads(1)


# ------------------------------------------------------------ bicubic ----

@pytest.mark.parametrize("filt", ["bicubic", "bilinear", "box"])
@pytest.mark.parametrize("n_in,n_out", [(64, 16), (53, 32), (17, 40),
                                        (33, 33)])
def test_resize_matrix_equals_jax(filt, n_in, n_out):
    np.testing.assert_array_equal(
        bicubic.resize_matrix(n_in, n_out, filt),
        jax_bicubic.resize_matrix(n_in, n_out, filt))


@pytest.mark.parametrize("shape,out_hw", [((2, 40, 36, 3), (10, 9)),
                                          ((13, 11, 3), (39, 33)),
                                          ((24, 20), (8, 5))])
def test_resize2d_matches_jax(shape, out_hw):
    """f32 on [0, 255]: ≤ 1e-4 (summation order of the two products)."""
    x = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jax_bicubic.resize2d(jnp.asarray(x), out_hw))
    got = bicubic.resize2d(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ------------------------------------------------------------- corpus ----

def test_synthetic_dataset_bit_for_bit():
    for kw in (dict(num_images=3, size=(40, 56), seed=100),
               dict(num_images=2, size=(24, 24), channels=1, seed=0)):
        port, ref = SyntheticDataset(**kw), JaxSyntheticDataset(**kw)
        assert len(port) == len(ref) and port.names == ref.names
        for i in range(len(ref)):
            np.testing.assert_array_equal(port[i], ref[i])


def test_get_training_set_synthetic_only(tmp_path):
    ds = get_training_set("./data", "synthetic")
    assert (len(ds), ds.size, ds.seed) == (32, (160, 160), 0)
    np.testing.assert_array_equal(ds[3], JaxSyntheticDataset(32, (160, 160),
                                                             seed=0)[3])
    # the folder and procedural corpora serve since FSRCNN and LapSRN's
    # slice (tests/test_torch_lapsrn_train.py); 'synthetic' stands alone,
    # and BSDS300 is never downloaded
    with pytest.raises(ValueError, match="standalone"):
        get_training_set("./data", ["synthetic", "bsds300"])
    with pytest.raises(RuntimeError, match="never downloads"):
        get_training_set(str(tmp_path), "bsds300")


def test_stack_corpus_equals_jax():
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8)
            for s in ((50, 40, 3), (40, 60, 3), (45, 70, 1), (44, 52))]
    for c in (1, 3):
        np.testing.assert_array_equal(stack_corpus(imgs, c),
                                      jax_stack_corpus(imgs, c))


# ------------------------------------------------------------ sampler ----

_B, _CROP, _R = 8, 32, 4


@pytest.fixture(scope="module")
def images():
    ds = JaxSyntheticDataset(num_images=5, size=(72, 88), seed=3)
    return [ds[i] for i in range(len(ds))]


def _jax_draws(key, mode, n, h, w, sizes, augment):
    """The JAX sampler's random numbers for ``key``: its splits in
    ``sample`` (batch key, scale key) and in ``one`` (six per sample:
    index, -, corner, rot, flip, -), with the corner drawn over the
    unpadded extent for the drawn scale's patch size."""
    key, ks_key = jax.random.split(key)
    keys = jax.random.split(key, _B)
    if mode == "batch":
        s_all = [int(jax.random.randint(ks_key, (), 0, len(sizes)))] * _B
    else:
        s_all = [int(s) for s in
                 jax.random.randint(ks_key, (_B,), 0, len(sizes))]
    out = {k: [] for k in ("index", "scale", "top", "left", "rot", "flip")}
    for b in range(_B):
        ks = jax.random.split(keys[b], 6)
        ky, kx = jax.random.split(ks[2])
        p = sizes[s_all[b]]
        out["index"].append(int(jax.random.randint(ks[0], (), 0, n)))
        out["scale"].append(s_all[b])
        out["top"].append(int(jax.random.randint(ky, (), 0, h - p + 1)))
        out["left"].append(int(jax.random.randint(kx, (), 0, w - p + 1)))
        out["rot"].append(int(jax.random.randint(ks[3], (), 0, 4))
                          if augment else 0)
        out["flip"].append(int(jax.random.bernoulli(ks[4]))
                           if augment else 0)
    return {k: torch.tensor(v) for k, v in out.items()}


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("mode,random_scale", [
    ("matrix", True), ("item", True), ("batch", True), ("matrix", False)])
def test_transform_matches_jax_pipeline(images, mode, random_scale, augment):
    """Given JAX's draws, the port's transform equals the JAX batch: ≤ 1e-5
    on [0, 1] (float32, summation order of the resize products). Several
    keys, so every mode sees mixed scales, rotations and flips."""
    kw = dict(crop_size=_CROP, scale_factor=_R, batch_size=_B, channels=3,
              augment=augment, random_scale=random_scale,
              random_scale_mode=mode)
    ref = JaxPatchPipeline(images, **kw)
    port = PatchPipeline(images, **kw, device="cpu")
    n, h, w = port.bank.shape[:3]
    assert (n, h, w) == (5, 72, 88)
    scales = RANDOM_SCALES if random_scale else (1.0,)
    sizes = [min(int(round(_CROP / s)), min(h, w)) for s in scales]
    seen = set()
    for seed in range(4):
        key = jax.random.key(seed)
        want = ref(key)
        draws = _jax_draws(key, mode, n, h, w, sizes, augment)
        seen |= set(zip(draws["scale"].tolist(), draws["rot"].tolist()))
        got = port.transform(port.bank, draws)
        for name in ("hr", "lr"):
            assert got[name].dtype == torch.float32
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), rtol=0,
                                       atol=1e-5, err_msg=name)
    if random_scale and mode != "batch" and augment:
        assert len({s for s, _ in seen}) > 2 and len({k for _, k in seen}) == 4


@pytest.mark.parametrize("mode", ["matrix", "item", "batch"])
def test_draws_stay_in_range(images, mode):
    pipe = PatchPipeline(images, crop_size=_CROP, scale_factor=_R,
                         batch_size=64, random_scale_mode=mode, device="cpu")
    n, h, w = pipe.bank.shape[:3]
    gen = torch.Generator().manual_seed(0)
    sizes = torch.tensor([min(int(round(_CROP / s)), min(h, w))
                          for s in RANDOM_SCALES])
    for _ in range(5):
        d = pipe.draw(gen)
        assert all(v.shape == (64,) and v.dtype == torch.int64
                   for v in d.values())
        p = sizes[d["scale"]]
        assert 0 <= d["index"].min() and d["index"].max() < n
        assert 0 <= d["scale"].min() and d["scale"].max() < len(RANDOM_SCALES)
        assert (d["top"] >= 0).all() and (d["top"] <= h - p).all()
        assert (d["left"] >= 0).all() and (d["left"] <= w - p).all()
        assert set(d["rot"].tolist()) <= {0, 1, 2, 3}
        assert set(d["flip"].tolist()) <= {0, 1}
        if mode == "batch":
            assert len(set(d["scale"].tolist())) == 1
        else:
            assert len(set(d["scale"].tolist())) > 1


def test_sampler_batches_are_deterministic_and_advance(images):
    pipe = PatchPipeline(images, crop_size=_CROP, scale_factor=_R,
                         batch_size=4, device="cpu")
    a, b = (pipe(torch.Generator().manual_seed(7)) for _ in range(2))
    for k in ("hr", "lr"):
        assert torch.equal(a[k], b[k])
        assert a[k].min() >= 0 and a[k].max() <= 1
    assert a["hr"].shape == (4, _CROP, _CROP, 3)
    assert a["lr"].shape == (4, _CROP // _R, _CROP // _R, 3)
    gen = torch.Generator().manual_seed(7)
    first, second = pipe.batches(gen, 2)
    assert torch.equal(first["hr"], a["hr"])
    assert not torch.equal(second["hr"], a["hr"])
    bf16 = PatchPipeline(images, crop_size=_CROP, scale_factor=_R,
                         batch_size=4, dtype=torch.bfloat16, device="cpu")
    c = bf16(torch.Generator().manual_seed(7))
    assert c["hr"].dtype == torch.bfloat16
    assert torch.equal(c["hr"], a["hr"].to(torch.bfloat16))


def test_pipeline_refusals(images):
    kw = dict(scale_factor=_R, device="cpu")
    with pytest.raises(ValueError, match="random_scale"):
        PatchPipeline(images, crop_size=48, **kw)  # 96 px > 72
    with pytest.raises(ValueError, match="exceeds the corpus"):
        PatchPipeline(images, crop_size=80, random_scale=False, **kw)
    with pytest.raises(ValueError, match="divide"):
        PatchPipeline(images, crop_size=30, **kw)
    with pytest.raises(ValueError, match="random_scale_mode"):
        PatchPipeline(images, crop_size=_CROP, random_scale_mode="x", **kw)
    # pre_upsample serves since slice 9; per-sample scale factors still
    # need it (only the bicubic-upscaled input keeps one shape)
    with pytest.raises(ValueError, match="pre_upsample=True"):
        PatchPipeline(images, crop_size=_CROP, scale_factors=(2, 4), **kw)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            PatchPipeline(images, crop_size=_CROP, scale_factor=_R)


def test_build_patch_pipeline_matches_jax(images):
    for crop in (32, 40, 80):
        kw = dict(model_name="EDSR", num_channels=3, scale_factor=_R,
                  crop_size=crop, batch_size=4)
        ref = jax_build_patch_pipeline(JaxSRConfig(**kw),
                                       jax_get_spec("EDSR"), images)
        port = build_patch_pipeline(SRConfig(**kw), get_spec("EDSR"), images,
                                    device="cpu")
        assert (port.crop_size, port.random_scale, port.random_scale_mode) \
            == (ref.crop_size, ref.random_scale, ref.random_scale_mode)
