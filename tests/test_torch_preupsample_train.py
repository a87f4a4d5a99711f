"""sr_torch trains the pre-upsample models, SRCNN, VDSR and DRCN ×4 on Y,
against the JAX package: the bicubic upscale of [0, 1] images, DRCN's
recursive supervision and its α, VDSR's clipped SGD and DRCN's L2 Adam
against their optax chains, one f32 train step of each model against
``sr.train.trainer.Trainer``, the pre-upsample patch pipeline (with and
without per-sample scale factors) on JAX's own draws, the corpus-aware
crop reduction, K-step training and exact resume.

Inputs, gradients and weights come from ``np.random.default_rng`` or a
JAX ``init``; everything runs on the CPU at small sizes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sr.data.datasets import SyntheticDataset as JaxSyntheticDataset
from sr.data.pipeline import PatchPipeline as JaxPatchPipeline
from sr.data.pipeline import build_patch_pipeline as jax_build_patch_pipeline
from sr.kernels import bicubic as jax_bicubic
from sr.models.drcn import _schedule as jax_drcn_schedule
from sr.models.registry import get_spec as jax_get_spec
from sr.train import optim as jax_optim
from sr.train.losses import recursive_supervision_loss as jax_rs_loss
from sr.train.trainer import Trainer as JaxTrainer
from sr.utils.checkpoint import run_meta as jax_run_meta
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.data.datasets import SyntheticDataset
from sr_torch.data.pipeline import (
    RANDOM_SCALES, PatchPipeline, build_patch_pipeline)
from sr_torch.kernels import bicubic
from sr_torch.models.registry import get_spec
from sr_torch.train import optim
from sr_torch.train.losses import recursive_supervision_loss
from sr_torch.train.trainer import Trainer
from sr_torch.utils.checkpoint import Checkpointer, run_meta
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import flax_path, from_jax_params
from test_torch_preupsample_models import MODELS, lively

torch.set_num_threads(1)


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ bicubic ----

@pytest.mark.parametrize("shape,r", [((2, 9, 7, 1), 4), ((11, 6, 3), 3),
                                     ((8, 10), 2)])
def test_img_interp_matches_jax(shape, r):
    """[0, 1] images, NHWC, HWC and HW: within 1e-6, clamped to [0, 1]."""
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    x.flat[:4] = (0.0, 1.0, 0.0, 1.0)  # overshoot to clamp
    want = np.asarray(jax_bicubic.img_interp(jnp.asarray(x), r))
    got = bicubic.img_interp(torch.from_numpy(x), r).numpy()
    assert got.shape == want.shape
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("out_hw", [(5, 4), (31, 17)])
def test_resize2d_unit_matches_jax(out_hw):
    x = np.random.default_rng(1).uniform(0, 1, (2, 13, 11, 1)).astype(
        np.float32)
    want = np.asarray(jax_bicubic.resize2d_unit(jnp.asarray(x), out_hw))
    got = bicubic.resize2d_unit(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --------------------------------------------------------- DRCN's loss ----

@pytest.mark.parametrize("alpha", [1.0, 0.7312, 0.0])
def test_recursive_supervision_loss_matches_jax(alpha):
    rng = np.random.default_rng(2)
    ys = rng.uniform(0, 1, (4, 2, 9, 7, 1)).astype(np.float32)
    final = rng.uniform(0, 1, (2, 9, 7, 1)).astype(np.float32)
    hr = rng.uniform(0, 1, (2, 9, 7, 1)).astype(np.float32)
    want, want_m = jax_rs_loss(jnp.asarray(ys), jnp.asarray(final),
                               jnp.asarray(hr), alpha)
    got, got_m = recursive_supervision_loss(
        torch.from_numpy(ys), torch.from_numpy(final), torch.from_numpy(hr),
        alpha)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    for k in ("loss_rec", "loss_final"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= 1e-6 * float(
            want_m[k])


def test_drcn_alpha_schedule_matches_jax():
    """α = clip(1 − step / total, 0, 1), float32, at the run's start,
    middle, end and past it."""
    cfg = SRConfig(model_name="DRCN", num_epochs=3, steps_per_epoch=7)
    jcfg = JaxSRConfig(model_name="DRCN", num_epochs=3, steps_per_epoch=7)
    spec = get_spec("DRCN")
    for step in (0, 1, 5, 10, 20, 21, 30):
        got = spec.schedule(cfg, step)["alpha"]
        want = float(jax_drcn_schedule(jcfg, jnp.int32(step))["alpha"])
        assert abs(float(got) - want) <= 1e-6, step
    assert float(spec.schedule(cfg, 0)["alpha"]) == 1.0
    assert float(spec.schedule(cfg, 40)["alpha"]) == 0.0


# ---------------------------------------------------------- optimizers ----

def _params(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(0, 1, (3, 3, 4, 8)).astype(np.float32),
            "b": rng.normal(0, 1, (8,)).astype(np.float32)}


def _grads(seed, steps, big):
    """Per step a gradient tree: norm about 30 on the steps in ``big``
    (the clip binds at θ/lr), else about 0.03 (it does not)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        g = {k: rng.normal(0, 1, v.shape).astype(np.float32)
             for k, v in _params(0).items()}
        norm = np.sqrt(sum(float((v * v).sum()) for v in g.values()))
        f = (30.0 if i in big else 0.03) / norm
        out.append({k: v * np.float32(f) for k, v in g.items()})
    return out


def _run_optax(tx, params, grads):
    state = tx.init(params)
    p = jax.tree.map(jnp.asarray, params)
    for g in grads:
        u, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, u)
    return jax.tree.map(np.asarray, p)


def _run_recipe(recipe, params, grads):
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = recipe.init(list(ps.values()))
    scales = []
    for count, g in enumerate(grads):
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k].copy())
        scales.append(recipe.step(opt, count))
    return {k: p.detach().numpy() for k, p in ps.items()}, scales


@pytest.mark.parametrize("theta", [0.05, 0.4])
def test_vdsr_sgd_matches_optax(theta):
    """20 updates of VDSR's recipe (clip to θ/lr, then weight decay, then
    SGD with momentum 0.9, lr 0.1 ×0.1 every 2 epochs of 3 steps, so three
    decay boundaries are crossed) against ``sr.train.optim.vdsr_sgd``:
    params within 1e-6 relative. The clip binds on some steps and not on
    others; its reported scale is min(1, θ / (lr · norm))."""
    params = _params(1)
    big = {0, 1, 4, 7, 13, 19}
    grads = _grads(2, 20, big)
    kw = dict(steps_per_epoch=3, decay_epochs=2, clip_theta=theta)
    want = _run_optax(jax_optim.vdsr_sgd(0.1, **kw), params, grads)
    got, scales = _run_recipe(optim.vdsr_sgd(0.1, **kw), params, grads)
    for k in params:
        assert _rel(got[k], want[k]) <= 1e-6, k
        assert np.abs(got[k] - params[k]).max() > 1e-3  # they moved
    for i, (g, s) in enumerate(zip(grads, scales)):
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                           for v in g.values()))
        lr = 0.1 * 0.1 ** (i // 6)
        want_s = min(1.0, theta / lr / norm)
        assert abs(float(s) - want_s) <= 1e-6 * want_s, i
    binds = [float(s) < 1 for s in scales]
    assert any(binds) and not all(binds)


def test_drcn_l2_adam_matches_optax():
    """DRCN's recipe, ``add_decayed_weights(1e-4)`` then Adam: 20 updates
    within 1e-6 relative of the optax chain; not decoupled (AdamW) decay."""
    params = _params(3)
    grads = _grads(4, 20, {2, 3})
    tx = optax.chain(optax.add_decayed_weights(1e-4), optax.adam(1e-3))
    want = _run_optax(tx, params, grads)
    recipe = get_spec("DRCN").make_tx(SRConfig(model_name="DRCN", lr=1e-3))
    got, scales = _run_recipe(recipe, params, grads)
    assert scales == [None] * 20
    adamw = _run_optax(optax.adamw(1e-3, weight_decay=1e-4), params, grads)
    for k in params:
        assert _rel(got[k], want[k]) <= 1e-6, k
        assert _rel(adamw[k], want[k]) > 1e-5  # the two decays differ


# --------------------------------------------------------- train step ----

def _cfg(name, **kw):
    base = dict(model_name=name, num_channels=1, scale_factor=4,
                base_filter={"SRCNN": 64, "VDSR": 8, "DRCN": 8}[name],
                num_recursions=3, crop_size=24, batch_size=4,
                dtype="float32", num_epochs=2, steps_per_epoch=10)
    base.update(kw)
    return base


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"bc": rng.uniform(0, 1, (4, 24, 24, 1)).astype(np.float32),
            "hr": rng.uniform(0, 1, (4, 24, 24, 1)).astype(np.float32)}


@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax_f32(name):
    """One f32 step on the bicubic input from the same params and batch at
    step 5 (DRCN's α 0.75): the loss within 1e-5 relative and every
    gradient within 1e-3 of its largest entry (float32 summation order);
    DRCN's recursive and final terms too."""
    step = 5
    jtr = JaxTrainer(JaxSRConfig(**_cfg(name), mesh_shape=(1,)))
    tr = Trainer(SRConfig(**_cfg(name)), device="cpu")
    jstate = jtr.init_state(jax.random.key(0), jnp.zeros((1, 24, 24, 1)))
    params = lively(jax.tree.map(np.asarray, jstate.params), 1)
    b = _batch()
    bc, hr = jnp.asarray(b["bc"]), jnp.asarray(b["hr"])

    def jloss(p):
        out = jtr.model.apply({"params": p}, bc, train=True)
        return jtr.spec.loss(out, {"hr": hr}, jtr.spec.schedule(
            jtr.cfg, jnp.int32(step)))

    (want_loss, want_m), want_g = jax.value_and_grad(
        jloss, has_aux=True)(params)
    state = tr.init_state(0)
    from_jax_params(state.model, params)
    state.model.train()
    loss, metrics = tr.loss_fn(state.model, {k: torch.from_numpy(a)
                                             for k, a in b.items()}, step)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * float(
        want_loss)
    assert set(metrics) == set(want_m)
    for k in metrics:
        assert abs(float(metrics[k]) - float(want_m[k])) <= 1e-5 * float(
            want_m[k])
    for pname, p in state.model.named_parameters():
        node = want_g
        path = flax_path(pname.rsplit(".", 1)[0]) if "." in pname else ()
        for k in path:
            node = node[k]
        leaf = pname.rsplit(".", 1)[-1]
        if leaf == "weight":
            want, got = node["kernel"], p.grad.permute(2, 3, 1, 0)
        else:
            want, got = node[leaf], p.grad
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-3, pname


# ------------------------------------------------------------ sampler ----

_B, _CROP = 8, 24


@pytest.fixture(scope="module")
def images():
    ds = JaxSyntheticDataset(num_images=5, size=(72, 88), seed=3)
    return [ds[i] for i in range(len(ds))]


def _jax_draws(key, mode, n, h, w, sizes, factors):
    """The JAX sampler's random numbers for ``key`` (its splits in
    ``sample`` and six per sample in ``one``: index, -, corner, rot, flip,
    the scale factor), the corner over the unpadded extent."""
    key, ks_key = jax.random.split(key)
    keys = jax.random.split(key, _B)
    s_all = [int(s) for s in jax.random.randint(ks_key, (_B,), 0, len(sizes))]
    out = {k: [] for k in ("index", "scale", "top", "left", "rot", "flip")}
    if factors:
        out["factor"] = []
    for b in range(_B):
        ks = jax.random.split(keys[b], 6)
        ky, kx = jax.random.split(ks[2])
        p = sizes[s_all[b]]
        out["index"].append(int(jax.random.randint(ks[0], (), 0, n)))
        out["scale"].append(s_all[b])
        out["top"].append(int(jax.random.randint(ky, (), 0, h - p + 1)))
        out["left"].append(int(jax.random.randint(kx, (), 0, w - p + 1)))
        out["rot"].append(int(jax.random.randint(ks[3], (), 0, 4)))
        out["flip"].append(int(jax.random.bernoulli(ks[4])))
        if factors:
            out["factor"].append(int(jax.random.randint(
                ks[5], (), 0, len(factors))))
    return {k: torch.tensor(v) for k, v in out.items()}


@pytest.mark.parametrize("mode,random_scale,factors", [
    ("matrix", True, ()), ("item", True, ()), ("matrix", False, ()),
    ("matrix", True, (2, 3, 4)), ("item", True, (3, 4))])
def test_pre_upsample_transform_matches_jax_pipeline(images, mode,
                                                     random_scale, factors):
    """Given JAX's draws, the port's pre-upsample batch equals the JAX
    batch within 1e-5 on [0, 1] (float32 resize products): ``hr``, ``lr``
    and ``bc``, or with per-sample scale factors ``hr`` and ``bc`` only."""
    kw = dict(crop_size=_CROP, scale_factor=4, batch_size=_B, channels=1,
              random_scale=random_scale, random_scale_mode=mode,
              pre_upsample=True, scale_factors=factors)
    ref = JaxPatchPipeline(images, **kw)
    port = PatchPipeline(images, **kw, device="cpu")
    n, h, w = port.bank.shape[:3]
    scales = RANDOM_SCALES if random_scale else (1.0,)
    sizes = [min(int(round(_CROP / s)), min(h, w)) for s in scales]
    seen = set()
    for seed in range(3):
        key = jax.random.key(seed)
        want = ref(key)
        draws = _jax_draws(key, mode, n, h, w, sizes, factors)
        if factors:
            seen |= set(draws["factor"].tolist())
        got = port.transform(port.bank, draws)
        assert set(got) == set(want) == (
            {"hr", "bc"} if factors else {"hr", "lr", "bc"})
        for name in got:
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), rtol=0,
                                       atol=1e-5, err_msg=name)
    assert len(seen) == len(factors)
    batch = port(torch.Generator().manual_seed(0))
    assert batch["bc"].shape == batch["hr"].shape == (_B, _CROP, _CROP, 1)
    if factors:
        assert port.draw(torch.Generator().manual_seed(0))["factor"].max() \
            < len(factors)


def test_scale_factors_refusals(images):
    kw = dict(crop_size=_CROP, scale_factor=4, device="cpu")
    with pytest.raises(ValueError, match="pre_upsample=True"):
        PatchPipeline(images, scale_factors=(2, 4), **kw)
    with pytest.raises(ValueError, match="divide by scale 5"):
        PatchPipeline(images, pre_upsample=True, scale_factors=(2, 5), **kw)


@pytest.mark.parametrize("name,crop,factors", [
    ("VDSR", 40, (2, 3)), ("DRCN", 72, (3,)), ("SRCNN", 40, ()),
    ("ESPCN", 40, (2, 3))])
def test_build_patch_pipeline_matches_jax(images, name, crop, factors):
    """The corpus-aware construction: the crop reduced to a multiple of
    every factor in play and the config's own (lcm), random scale off when
    the 0.5× patch does not fit, factors dropped for a model that is not
    pre-upsample; as the JAX package does."""
    kw = dict(model_name=name, num_channels=1, scale_factor=4,
              crop_size=crop, batch_size=4, scale_factors=factors)
    ref = jax_build_patch_pipeline(JaxSRConfig(**kw), jax_get_spec(name),
                                   images)
    port = build_patch_pipeline(SRConfig(**kw), get_spec(name), images,
                                device="cpu")
    assert (port.crop_size, port.random_scale, tuple(port.scale_factors),
            port.pre_upsample) == (ref.crop_size, ref.random_scale,
                                   tuple(ref.scale_factors),
                                   ref.pre_upsample)
    if factors and name != "ESPCN":
        assert port.crop_size % int(np.lcm.reduce(factors + (4,))) == 0


# ------------------------------------------------------ K-step training ----

@pytest.fixture(scope="module")
def y_images():
    ds = SyntheticDataset(num_images=4, size=(64, 72), seed=1)
    return [ds[i][..., :1] for i in range(len(ds))]


@pytest.mark.parametrize("name", MODELS)
def test_k_steps_train_and_the_loss_falls(y_images, name):
    """K-step dispatches from the bicubic input: the loss falls; VDSR
    reports its clip scale (in (0, 1]); DRCN's schedule sees each inner
    step's own count, so α falls step by step as in the JAX scan."""
    cfg = SRConfig(**_cfg(name, batch_size=8, lr={"SRCNN": 1e-3,
                                                 "VDSR": 0.1,
                                                 "DRCN": 1e-3}[name]))
    seen = []
    spec = get_spec(name)

    def schedule(c, step):
        seen.append(step)
        return spec.schedule(c, step)

    tr = Trainer(cfg, spec=dataclasses.replace(spec, schedule=schedule),
                 device="cpu")
    pipe = PatchPipeline(y_images, crop_size=24, batch_size=8, channels=1,
                         pre_upsample=True, device="cpu")
    state = tr.init_state(1)
    multi = tr.make_multi_step(pipe, 5)
    first = multi(state)
    for _ in range(3):
        last = multi(state)
    assert state.step == 20 and seen == list(range(20))
    assert float(last["loss"]) < float(first["loss"])
    if name == "VDSR":
        assert 0 < float(last["clip_scale"]) <= 1
    if name == "DRCN":
        assert set(last) == {"loss", "loss_rec", "loss_final"}
        alphas = [float(spec.schedule(cfg, s)["alpha"]) for s in seen]
        assert alphas[0] == 1.0 and alphas == sorted(alphas, reverse=True)


@pytest.mark.parametrize("name", ["VDSR", "DRCN"])
def test_checkpoint_resumes_exactly(y_images, tmp_path, name):
    """Save after 3 steps, run 2 more; a fresh state restored from the
    checkpoint runs the same 2 steps to the same bits (the optimizer's
    momentum and moments, the step count behind the lr, clip and α, and
    the sampler's generator). ``run_meta`` carries ``num_recursions``."""
    cfg = SRConfig(**_cfg(name, batch_size=4))
    assert run_meta(cfg) == jax_run_meta(JaxSRConfig(**_cfg(name)))
    tr = Trainer(cfg, device="cpu")
    pipe = PatchPipeline(y_images, crop_size=24, batch_size=4, channels=1,
                         pre_upsample=True, device="cpu")
    state = tr.init_state(2)
    for _ in range(3):
        tr.train_step(state, pipe(state.generator))
    ckpt = Checkpointer(str(tmp_path), meta=run_meta(cfg))
    ckpt.save(state)
    for _ in range(2):
        tr.train_step(state, pipe(state.generator))
    resumed = ckpt.restore(tr.init_state(9))
    assert resumed.step == 3
    for _ in range(2):
        tr.train_step(resumed, pipe(resumed.generator))
    for p, q in zip(resumed.model.parameters(), state.model.parameters(),
                    strict=True):
        assert torch.equal(p, q)
