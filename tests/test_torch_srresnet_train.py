"""sr_torch's Trainer on SRResNet (and on SRGAN's generator) against the JAX
package's Trainer: one train step and a K=3 dispatch in float32 — the loss,
the parameters after the Adam updates and the batch statistics that the
train-mode forwards advanced — plus the eval-mode predict, exact resume
with the batch statistics, and the JAX trainer's refusal of the
pre-shuffle loss for batch-norm models.

SRResNet ×4 at 2 resblocks × 16 filters, crop 32, batch 4. Weights come
from a JAX ``init`` and cross with ``from_jax_params``; batches from
``np.random.default_rng``. The JAX trainer runs on a one-device mesh.
Everything runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.train.trainer import Trainer as JaxTrainer
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.data.datasets import SyntheticDataset
from sr_torch.data.pipeline import PatchPipeline
from sr_torch.train.trainer import Trainer
from sr_torch.utils.checkpoint import Checkpointer, run_meta
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import flax_path, from_jax_params

torch.set_num_threads(1)

_SMALL = dict(model_name="SRResNet", num_channels=3, scale_factor=4,
              num_resblocks=2, base_filter=16, crop_size=32, batch_size=4,
              dtype="float32")
LR = 1e-4  # SRResNet's Adam


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"lr": rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32),
             "hr": rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)}
            for _ in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _params(model):
    """{flax path: array} of the model's parameters (HWIO kernels)."""
    out = {}
    for name, p in model.named_parameters():
        mod, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        path = flax_path(mod) if mod else ()
        if leaf == "weight":
            out[path + ("kernel",)] = p.detach().permute(2, 3, 1, 0).numpy()
        else:
            out[path + (leaf,)] = p.detach().numpy()
    return out


def _close(got, want, rel, steps) -> bool:
    """Within ``rel`` relative, or within 2e-2·lr a step absolute: each Adam
    update is lr·m̂/(√v̂ + ε), and where a gradient entry is near ε (1e-8)
    its rounding in the last digits moves the update by up to about 1 % of
    lr (0.87 % measured, on the head kernel)."""
    err = np.abs(np.asarray(got, np.float64) - want).max()
    return err <= max(rel * np.abs(want).max(), 2e-2 * LR * steps)


def _pre_bn_bias(path) -> bool:
    """A conv bias that a batch norm in train mode follows: its gradient is
    zero up to rounding, so Adam moves it by about ±lr a step in a
    direction the rounding picks, differently in the two packages."""
    return path[-1] == "bias" and (
        path[0] == "body_conv" or path[-2] in ("Conv_0", "Conv_1")
        and path[0].startswith("blocks_"))


@pytest.fixture(scope="module")
def runs():
    """The JAX trainer and the port's from the same params: after one
    step, and after three (the port's as one K=3 dispatch)."""
    jtr = JaxTrainer(JaxSRConfig(**_SMALL, mesh_shape=(1,)))
    jstate = jtr.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    params = jax.tree.map(np.asarray, jstate.params)
    bs = jax.tree.map(np.asarray, jstate.batch_stats)
    batches = _batches(3)
    out = {"params0": params, "bs0": bs, "losses": {}}
    for b in batches:
        jstate, m = jtr.train_step(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        out["losses"].setdefault("jax", []).append(float(m["loss"]))
        if "jax1" not in out:
            out["jax1"] = (dict(_leaves(jax.tree.map(np.asarray,
                                                     jstate.params))),
                           dict(_leaves(jax.tree.map(
                               np.asarray, jstate.batch_stats))))
    out["jax3"] = (dict(_leaves(jax.tree.map(np.asarray, jstate.params))),
                   dict(_leaves(jax.tree.map(np.asarray,
                                             jstate.batch_stats))))
    out["jax_predict"] = np.asarray(jtr.predict(
        jstate, jnp.asarray(batches[0]["lr"])))
    tr = Trainer(SRConfig(**_SMALL), device="cpu")
    for name in ("one", "k3"):
        state = tr.init_state(0)
        from_jax_params(state.model, params, bs)
        if name == "one":
            _, m = tr.train_step(state, _torch_batch(batches[0]))
            out["losses"]["port"] = [float(m["loss"])]
        else:
            replay = iter(_torch_batch(b) for b in batches)
            m = tr.make_multi_step(lambda gen: next(replay), 3)(state)
            out["k3_loss"] = float(m["loss"])
            out["port_predict"] = tr.predict(
                state, torch.from_numpy(batches[0]["lr"])).numpy()
        out[name] = (_params(state.model), dict(_leaves(state.batch_stats)),
                     state.step)
    return out


def test_one_step_matches_jax_f32(runs):
    """Loss within 1e-5 relative; every parameter after the Adam update
    within 1e-5 relative of JAX's (or 2e-2·lr absolute, see ``_close``),
    except the conv biases a train-mode BN follows (zero gradient: both
    packages move them by at most lr); every running statistic within
    1e-6."""
    assert runs["losses"]["port"][0] == pytest.approx(
        runs["losses"]["jax"][0], rel=1e-5)
    got_p, got_bs, step = runs["one"]
    want_p, want_bs = runs["jax1"]
    assert step == 1 and set(got_p) == set(want_p)
    assert set(got_bs) == set(want_bs) and len(want_bs) == 2 * 5
    p0 = dict(_leaves(runs["params0"]))
    for path, w in want_p.items():
        if _pre_bn_bias(path):
            for arr in (got_p[path], w):
                assert np.abs(arr - p0[path]).max() <= LR * 1.001
        else:
            assert _close(got_p[path], w, 1e-5, 1), path
    for path, w in want_bs.items():
        np.testing.assert_allclose(got_bs[path], w, rtol=0, atol=1e-6,
                                   err_msg="/".join(path))


def test_gradients_match_jax_grad(runs):
    """The port's gradients against ``jax.value_and_grad`` of the JAX
    trainer's loss (the train-mode forward with mutable batch statistics),
    on the first batch from the same params: each leaf within 1e-4 of its
    largest entry, a check that Adam's update, blind to a constant scale
    on the gradient, cannot make. The conv biases a train-mode BN follows
    have a zero gradient up to rounding: both packages' stay within 1e-7
    of the largest gradient entry of the model. Measured: 3.3e-6 (the
    PReLU slope) and 1.5e-9."""
    from sr.train.trainer import _apply

    jtr = JaxTrainer(JaxSRConfig(**_SMALL, mesh_shape=(1,)))
    params, bs = runs["params0"], runs["bs0"]
    b = _batches(1)[0]

    def jloss(p):
        out, _ = _apply(jtr.model, p, bs, jnp.asarray(b["lr"]), True)
        return jtr.spec.loss(out, {"hr": jnp.asarray(b["hr"])},
                             jtr.spec.schedule(jtr.cfg, jnp.int32(0)))

    (want_loss, _), want_g = jax.value_and_grad(jloss, has_aux=True)(params)
    want_g = dict(_leaves(jax.tree.map(np.asarray, want_g)))
    tr = Trainer(SRConfig(**_SMALL), device="cpu")
    state = tr.init_state(0)
    from_jax_params(state.model, params, bs)
    state.model.train()
    loss, _ = tr.loss_fn(state.model, _torch_batch(b), 0)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got_g = {}
    for name, p in state.model.named_parameters():
        mod, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        path = flax_path(mod) if mod else ()
        g = p.grad.permute(2, 3, 1, 0) if leaf == "weight" else p.grad
        got_g[path + ("kernel" if leaf == "weight" else leaf,)] = g.numpy()
    assert set(got_g) == set(want_g)
    top = max(np.abs(w).max() for w in want_g.values())
    for path, w in want_g.items():
        if _pre_bn_bias(path):
            for g in (got_g[path], w):
                assert np.abs(g).max() <= 1e-7 * top, path
        else:
            err = np.abs(got_g[path] - w).max()
            assert err <= 1e-4 * np.abs(w).max(), (path, err)


def test_k3_dispatch_matches_three_jax_steps(runs):
    """A K=3 dispatch (three batches replayed into the port's sampler slot)
    against the JAX trainer's three steps: the mean loss within 1e-5
    relative; parameters within 1e-4 relative (or 6e-2·lr), the pre-BN
    conv biases within 3·lr of their start in both; running variances within 1e-5 and
    running means within 1e-4, since the second and third forwards see
    those biases, which shift a BN input's mean and not its output."""
    assert runs["k3_loss"] == pytest.approx(np.mean(runs["losses"]["jax"]),
                                            rel=1e-5)
    got_p, got_bs, step = runs["k3"]
    want_p, want_bs = runs["jax3"]
    assert step == 3
    p0 = dict(_leaves(runs["params0"]))
    for path, w in want_p.items():
        if _pre_bn_bias(path):
            for arr in (got_p[path], w):
                assert np.abs(arr - p0[path]).max() <= 3 * LR * 1.001
        else:
            assert _close(got_p[path], w, 1e-4, 3), path
    for path, w in want_bs.items():
        np.testing.assert_allclose(got_bs[path], w, rtol=0,
                                   atol=1e-4 if path[-1] == "mean" else 1e-5,
                                   err_msg="/".join(path))


def test_predict_uses_the_running_statistics(runs):
    """After the three steps, the eval-mode predict of both packages agree
    within 1e-4 (their running statistics after three train steps)."""
    np.testing.assert_allclose(runs["port_predict"], runs["jax_predict"],
                               rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def corpus():
    ds = SyntheticDataset(num_images=4, size=(48, 48), channels=3, seed=3)
    return [ds[i] for i in range(len(ds))]


def _fit_setup(corpus, name="SRResNet", **kw):
    cfg = SRConfig(**{**_SMALL, "model_name": name}, steps_per_epoch=2,
                   **kw)
    pipe = PatchPipeline(corpus, crop_size=32, scale_factor=4, batch_size=4,
                         random_scale=False, device="cpu")
    tr = Trainer(cfg, device="cpu")
    return tr, tr.init_state(1), pipe


def _same_state(a, b):
    for (name, t), u in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(t, u), name
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("k", [1, 2])
def test_resume_restores_batch_stats_exactly(corpus, tmp_path, k):
    """2 steps + save + restore + 2 steps == 4 steps, bit for bit:
    parameters, running statistics, step and the sampler's generator."""
    tr, whole, pipe = _fit_setup(corpus, steps_per_dispatch=k)
    whole = tr.fit(whole, pipe, num_epochs=2)
    _, first, _ = _fit_setup(corpus, steps_per_dispatch=k)
    ckpt = Checkpointer(str(tmp_path), meta=run_meta(tr.cfg))
    tr.fit(first, pipe, num_epochs=1, checkpointer=ckpt)
    resumed = ckpt.restore(tr.init_state(99))
    assert resumed.step == 2
    resumed = tr.fit(resumed, pipe, num_epochs=2)
    _same_state(whole, resumed)
    assert not torch.equal(whole.model.body_bn.mean, torch.zeros(16))


def test_srgan_spec_trains_its_generator_like_srresnet(corpus):
    """The shared Trainer on the SRGAN spec trains the generator on the
    content loss, as the JAX Trainer does: the same steps as SRResNet's."""
    tr_a, a, pipe = _fit_setup(corpus)
    tr_b, b, _ = _fit_setup(corpus, name="SRGAN")
    assert tr_b.spec.is_gan
    for _ in range(2):
        ma = tr_a.train_step(a, pipe(a.generator))[1]
        mb = tr_b.train_step(b, pipe(b.generator))[1]
        assert torch.equal(ma["loss"], mb["loss"])
    _same_state(a, b)


def test_batchnorm_models_refuse_the_preshuffle_loss():
    for mode in ("last", "full", True):
        with pytest.raises(ValueError):
            Trainer(SRConfig(**_SMALL, preshuffle_loss=mode), device="cpu")
