"""sr_torch trains FSRCNN and LapSRN ×4 on Y against the JAX package: one
f32 train step of each against ``sr.train.trainer.Trainer``'s loss and
``jax.value_and_grad`` (LapSRN's per-level Charbonnier terms with
bicubic-downscaled targets), FSRCNN's two learning rates against
``optax.multi_transform``, K-step dispatch with the level losses in the
metrics, a two-group optimizer state through a checkpoint, ``run_meta``'s
refusals, and the training corpora (``get_training_set`` for a PNG
folder, the procedural split's images and cache name).

Weights and batches come from a JAX ``init`` redrawn from a seeded normal,
or from ``np.random.default_rng``; everything runs on the CPU at small
sizes (FSRCNN at full width, LapSRN 16 filters × 2 convs a level).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from sr.data import datasets as jax_datasets
from sr.data.procedural import GEN_VERSION as JAX_GEN_VERSION
from sr.data.procedural import ProceduralDataset as JaxProceduralDataset
from sr.models.registry import get_spec as jax_get_spec
from sr.train.trainer import Trainer as JaxTrainer
from sr.utils.checkpoint import run_meta as jax_run_meta
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.data import datasets
from sr_torch.data.procedural import ProceduralDataset
from sr_torch.models.registry import get_spec
from sr_torch.train.trainer import Trainer
from sr_torch.utils.checkpoint import Checkpointer, run_meta
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params, to_jax_params
from test_torch_fsrcnn_models import _leaves, lively

torch.set_num_threads(1)

MODELS = ("FSRCNN", "LapSRN")


def _cfg(name, **kw):
    base = dict(model_name=name, num_channels=1, scale_factor=4,
                base_filter=16, num_pyramid_convs=2, crop_size=32,
                batch_size=4, dtype="float32", num_epochs=2,
                steps_per_epoch=6)
    base.update(kw)
    return base


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"lr": rng.uniform(0, 1, (4, 8, 8, 1)).astype(np.float32),
            "hr": rng.uniform(0, 1, (4, 32, 32, 1)).astype(np.float32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _grads_flax(model):
    """The model's gradients in flax's layout (HWIO kernels, deconv
    kernels unflipped), by the same mapping as its params."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad)
    return to_jax_params(g)


def _jax_state(name):
    jtr = JaxTrainer(JaxSRConfig(**_cfg(name), mesh_shape=(1,)))
    jstate = jtr.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 1)))
    return jtr, lively(jax.tree.map(np.asarray, jstate.params), 1)


@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax_f32(name):
    """One f32 step from the same params and batch: the loss and LapSRN's
    ``loss_x2`` / ``loss_x4`` within 1e-5 relative, every gradient leaf
    within 1e-4 of its largest entry of ``jax.value_and_grad``'s (float32
    summation order; deconv kernels compared unflipped)."""
    jtr, params = _jax_state(name)
    b = _batch()
    lr_, hr = jnp.asarray(b["lr"]), jnp.asarray(b["hr"])

    def jloss(p):
        out = jtr.model.apply({"params": p}, lr_, train=True)
        return jtr.spec.loss(out, {"hr": hr}, {})

    (want_loss, want_m), want_g = jax.value_and_grad(
        jloss, has_aux=True)(params)
    tr = Trainer(SRConfig(**_cfg(name)), device="cpu")
    state = tr.init_state(0)
    from_jax_params(state.model, params)
    state.model.train()
    loss, metrics = tr.loss_fn(state.model, _torch_batch(b), 0)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * float(
        want_loss)
    assert set(metrics) == set(want_m) == (
        {"loss_x2", "loss_x4"} if name == "LapSRN" else set())
    for k in metrics:
        got_k = float(metrics[k].detach())
        assert abs(got_k - float(want_m[k])) <= 1e-5 * float(want_m[k])
    got_g = dict(_leaves(_grads_flax(state.model)))
    want_g = dict(_leaves(jax.tree.map(np.asarray, want_g)))
    assert set(got_g) == set(want_g)
    for path, w in want_g.items():
        err = np.abs(got_g[path] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-4, path


def test_lapsrn_loss_targets_match_jax_at_the_edges():
    """The ×2 target is the HR batch bicubic-downscaled with no clamp in
    the passes, then clamped to [0, 1] (values at 0 and 1 overshoot at the
    edges); each level's Charbonnier within 1e-5 relative of the JAX
    loss's (float32 summation order)."""
    rng = np.random.default_rng(3)
    hr = (rng.uniform(0, 1, (2, 24, 20, 1)) > 0.5).astype(np.float32)
    out = (rng.uniform(0, 1, (2, 12, 10, 1)).astype(np.float32),
           hr + rng.normal(0, 0.05, hr.shape).astype(np.float32))
    want, want_m = jax_get_spec("LapSRN").loss(
        tuple(jnp.asarray(o) for o in out), {"hr": jnp.asarray(hr)}, {})
    got, got_m = get_spec("LapSRN").loss(
        tuple(torch.from_numpy(o) for o in out), {"hr": torch.from_numpy(hr)},
        {})
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)
    for k in ("loss_x2", "loss_x4"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= 1e-5 * float(
            want_m[k])


def test_fsrcnn_two_lr_groups_match_optax_multi_transform():
    """Three Adam updates of FSRCNN's recipe (base 1e-3, the deconv tail at
    1e-4) against the JAX package's ``optax.multi_transform`` on the same
    gradients: every parameter within 1e-6 relative of optax's; the first
    update of every deconv entry with a gradient is 1e-4 in size, of every
    base entry 1e-3 (Adam's first step is ±lr)."""
    name = "FSRCNN"
    cfg = SRConfig(**_cfg(name))
    jcfg = JaxSRConfig(**_cfg(name))
    _, params = _jax_state(name)
    model = get_spec(name).make_model(cfg)
    from_jax_params(model, params)
    recipe = get_spec(name).make_tx(cfg)
    opt = recipe.init(model)
    assert sorted((g["group"], g["lr"]) for g in opt.param_groups) == [
        ("base", 1e-3), ("deconv", 1e-4)]
    tx = jax_get_spec(name).make_tx(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    rng = np.random.default_rng(4)
    for count in range(3):
        grads = jax.tree.map(
            lambda v: rng.normal(0, 1, v.shape).astype(np.float32), params)
        u, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, u)
        gmodel = copy.deepcopy(model)
        from_jax_params(gmodel, grads)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        for p, g in zip(model.parameters(), gmodel.parameters()):
            p.grad = g.detach().clone()
        recipe.step(opt, count)
        if count == 0:
            for n, p in model.named_parameters():
                step = (p.detach() - before[n]).abs()
                lr = 1e-4 if n.startswith("DeconvBlock") else 1e-3
                assert torch.allclose(step, torch.full_like(step, lr),
                                      rtol=1e-2, atol=0), n
    got = dict(_leaves(to_jax_params(model)))
    for path, w in _leaves(jax.tree.map(np.asarray, jp)):
        err = np.abs(got[path] - w).max() / np.abs(w).max()
        assert err <= 1e-6, path


def test_recipe_groups_need_the_model():
    recipe = get_spec("FSRCNN").make_tx(SRConfig(**_cfg("FSRCNN")))
    model = get_spec("FSRCNN").make_model(SRConfig(**_cfg("FSRCNN")))
    with pytest.raises(TypeError, match="pass the module"):
        recipe.init(model.parameters())
    # a recipe without groups takes either, at one rate
    plain = get_spec("LapSRN").make_tx(SRConfig(**_cfg("LapSRN")))
    for arg in (model, model.parameters()):
        opt = plain.init(arg)
        assert [g["lr_mult"] for g in opt.param_groups] == [1.0]


@pytest.mark.parametrize("name", MODELS)
def test_k_step_dispatch_and_predict(name):
    """K=3 steps in one dispatch equal 3 single steps from the same state
    and generator; the averaged metrics carry the level losses; ``predict``
    (eval mode) returns the last level at ×4."""
    from sr_torch.data.pipeline import PatchPipeline

    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (72, 80, 1), dtype=np.uint8)
              for _ in range(3)]
    pipe = PatchPipeline(images, crop_size=32, scale_factor=4, batch_size=4,
                         channels=1, device="cpu")
    tr = Trainer(SRConfig(**_cfg(name)), device="cpu")
    a, b = tr.init_state(7), tr.init_state(7)
    m = tr.make_multi_step(pipe, 3)(a)
    singles = [tr.train_step(b, pipe(b.generator))[1] for _ in range(3)]
    assert a.step == b.step == 3
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    want = {"loss"} | ({"loss_x2", "loss_x4"} if name == "LapSRN" else set())
    assert set(m) == want
    for k in want:
        assert abs(float(m[k]) - float(torch.stack(
            [s[k] for s in singles]).mean())) <= 1e-7
    out = tr.predict(a, torch.zeros((2, 9, 7, 1)))
    assert out.shape == (2, 36, 28, 1) and out.grad_fn is None


def test_two_group_checkpoint_restores_exactly(tmp_path):
    """FSRCNN's two-group Adam state, its rates and the sampler restore
    exactly, and the next step from the restored state equals the
    original's."""
    tr = Trainer(SRConfig(**_cfg("FSRCNN")), device="cpu")
    state = tr.init_state(3)
    batch = _torch_batch(_batch(1))
    for _ in range(2):
        tr.train_step(state, batch)
    ck = Checkpointer(str(tmp_path), meta=run_meta(tr.cfg))
    ck.save(state)
    restored = ck.restore(tr.init_state(99))
    assert restored.step == 2
    assert [(g["group"], g["lr_mult"]) for g in
            restored.optimizer.param_groups] == [("base", 1.0),
                                                 ("deconv", 0.1)]
    sa, sb = (s.optimizer.state_dict()["state"] for s in (state, restored))
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k])
    tr.train_step(state, batch)
    tr.train_step(restored, batch)
    for p, q in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("name", MODELS)
def test_run_meta_refuses_what_jax_refuses(name, tmp_path):
    cfg = SRConfig(**_cfg(name))
    assert run_meta(cfg) == jax_run_meta(JaxSRConfig(**_cfg(name)))
    tr = Trainer(cfg, device="cpu")
    Checkpointer(str(tmp_path), meta=run_meta(cfg)).save(tr.init_state(0))
    with pytest.raises(ValueError, match="scale_factor"):
        Checkpointer(str(tmp_path),
                     meta=run_meta(cfg.replace(scale_factor=2)))
    with pytest.raises(ValueError, match="steps_per_epoch"):
        Checkpointer(str(tmp_path),
                     meta=run_meta(cfg.replace(steps_per_epoch=7)))


# ----------------------------------------------------------- corpora ----

def _png_folder(root, name, seed):
    """Three RGB PNGs of different sizes under ``root/train/<name>``."""
    folder = os.path.join(root, "train", name)
    os.makedirs(folder)
    rng = np.random.default_rng(seed)
    for i, hw in enumerate(((40, 56), (33, 31), (48, 48))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"img_{i}.png"))


@pytest.mark.parametrize("color_space", ["ycbcr", "rgb"])
def test_get_training_set_folders_match_jax(tmp_path, color_space):
    """One folder name and two concatenated, decoded like the JAX
    package's (YCbCr by default)."""
    root = str(tmp_path)
    _png_folder(root, "a", 1)
    _png_folder(root, "b", 2)
    for names in ("a", ["a", "b"]):
        got = datasets.get_training_set(root, names, color_space)
        want = jax_datasets.get_training_set(root, names, color_space)
        assert isinstance(got, datasets.FolderDataset)
        assert len(got) == len(want) == (3 if names == "a" else 6)
        assert got.names == want.names
        for i in range(len(want)):
            np.testing.assert_array_equal(got[i], want[i])


def test_get_training_set_refusals(tmp_path):
    root = str(tmp_path)
    _png_folder(root, "a", 1)
    for names in (["synthetic", "a"], ["a", "procedural"]):
        with pytest.raises(ValueError, match="standalone"):
            datasets.get_training_set(root, names)
        with pytest.raises(ValueError, match="standalone"):
            jax_datasets.get_training_set(root, names)
    # the port never downloads BSDS300 (the JAX package would)
    with pytest.raises(RuntimeError, match="never downloads"):
        datasets.get_training_set(root, "bsds300")
    assert not os.path.exists(os.path.join(root, "BSDS300"))
    os.makedirs(os.path.join(root, "train", "empty"))
    with pytest.raises(RuntimeError, match="no training images"):
        datasets.get_training_set(root, "empty")


def test_procedural_train_split_images_and_cache_name(tmp_path):
    """The first images of the 512-image train split equal the JAX
    package's; a cache file under the JAX package's name (which a JAX run
    writes) is what ``get_training_set('procedural')`` loads, so the
    corpus is never generated twice. The corpus itself is not generated
    here: the cache holds three stand-in images."""
    port = ProceduralDataset(num_images=512, size=(384, 384), seed=0,
                             split="train")
    ref = JaxProceduralDataset(num_images=512, size=(384, 384), seed=0,
                               split="train")
    for i in (0, 1):
        np.testing.assert_array_equal(port[i], ref[i])
    name = (f"procedural_v{JAX_GEN_VERSION}_train_s0_384x384_ycbcr_n512"
            ".npz")
    cache = tmp_path / "procedural_cache"
    cache.mkdir()
    stand_in = np.random.default_rng(6).integers(0, 256, (3, 384, 384, 3),
                                                 dtype=np.uint8)
    np.savez(cache / name, images=stand_in)
    got = datasets.get_training_set(str(tmp_path), "procedural")
    assert isinstance(got, ProceduralDataset)
    assert (len(got), got.split, got.seed, got.size) == (
        512, "train", 0, (384, 384))
    for i in range(3):
        np.testing.assert_array_equal(got[i], stand_in[i])
    assert sorted(os.listdir(cache)) == [name]
