"""sr_torch's GANTrainer (SRGAN) against the JAX package's: the pretrain
step, the adversarial step (D update, then the G update with MSE content,
the VGG19 perceptual term from one shared torchvision-format ``.pth`` at
relu2_2, and the adversarial BCE against the just-updated D in eval or
train mode), the running statistics of both networks after it, K steps a
dispatch, the two-phase ``fit`` and its exact resume of G and D.

SRGAN ×4 at 2 resblocks × 8 filters (the discriminator at base 8) on a 32²
HR crop, batch 4. Weights come from the JAX trainer's ``init_states`` and
cross with ``from_jax_params``; batches from ``np.random.default_rng``.
The tolerances are those the JAX package's own entry point holds its
sharded adversarial step to (``__graft_entry__.py``): d_loss and g_loss
within 1e-4 relative, G's post-step function within 3e-4. Everything runs
on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.train.gan import GANTrainer as JaxGANTrainer
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.data.datasets import SyntheticDataset
from sr_torch.data.pipeline import PatchPipeline
from sr_torch.train.gan import GANTrainer
from sr_torch.train.trainer import Trainer
from sr_torch.utils.checkpoint import Checkpointer, run_meta
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_SMALL = dict(model_name="SRGAN", num_channels=3, scale_factor=4,
              num_resblocks=2, base_filter=8, crop_size=32, batch_size=4,
              dtype="float32", vgg_output_layer="relu2_2")


@pytest.fixture(scope="module")
def vgg_pth(tmp_path_factory):
    out = tmp_path_factory.mktemp("vgg") / "vgg19_synthetic.pth"
    subprocess.run([sys.executable, str(ROOT / "scripts" /
                                        "make_synthetic_vgg.py"), str(out)],
                   check=True, capture_output=True, timeout=300)
    return str(out)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"lr": rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32),
             "hr": rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)}
            for _ in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_trees_close(got, want, atol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want) and want
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg="/".join(path))


def _run(vgg, d_train_mode):
    """One pretrain step, then one adversarial step, in both packages from
    the same weights; the metrics, G's eval-mode output on a probe after
    each, and both networks' running statistics at the end."""
    kw = dict(_SMALL, vgg_weights_path=vgg, adv_d_train_mode=d_train_mode)
    jtr = JaxGANTrainer(JaxSRConfig(**kw, mesh_shape=(1,)))
    b0, b1 = _batches(2)
    probe = np.random.default_rng(5).uniform(0, 1, (2, 8, 8, 3)).astype(
        np.float32)
    g, d = jtr.init_states(jax.random.key(1), jnp.asarray(b0["lr"][:1]),
                           jnp.asarray(b0["hr"][:1]))
    tr = GANTrainer(SRConfig(**kw), device="cpu")
    tg, td = tr.init_states(0)
    from_jax_params(tg.model, _np(g.params), _np(g.batch_stats))
    from_jax_params(td.model, _np(d.params), _np(d.batch_stats))
    out = {}
    g, m = jtr.pretrain_step(g, {k: jnp.asarray(v) for k, v in b0.items()})
    _, tm = tr.pretrain_step(tg, _torch_batch(b0))
    out["pretrain"] = (float(tm["g_content_loss"]),
                       float(m["g_content_loss"]))
    out["pretrain_fn"] = (tr.predict(tg, torch.from_numpy(probe)).numpy(),
                          np.asarray(jtr.predict(g, jnp.asarray(probe))))
    g, d, m = jtr.adversarial_step(g, d, {k: jnp.asarray(v)
                                          for k, v in b1.items()})
    _, _, tm = tr.adversarial_step(tg, td, _torch_batch(b1))
    out["metrics"] = ({k: float(v) for k, v in tm.items()},
                      {k: float(v) for k, v in m.items()})
    out["fn"] = (tr.predict(tg, torch.from_numpy(probe)).numpy(),
                 np.asarray(jtr.predict(g, jnp.asarray(probe))))
    out["g_bs"] = (tg.batch_stats, _np(g.batch_stats))
    out["d_bs"] = (td.batch_stats, _np(d.batch_stats))
    out["steps"] = (tg.step, td.step, int(g.step), int(d.step))
    return out


@pytest.fixture(scope="module", params=[False, True],
                ids=["D-eval", "D-train"])
def gan_run(request, vgg_pth):
    return _run(vgg_pth, request.param)


def test_pretrain_step_matches_jax(gan_run):
    got, want = gan_run["pretrain"]
    assert got == pytest.approx(want, rel=1e-5)
    got, want = gan_run["pretrain_fn"]
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)


def test_adversarial_step_losses_match_jax(gan_run):
    """d_loss and g_loss within 1e-4 relative; each term of g_loss
    (content, VGG, adversarial) within 1e-4 relative too."""
    got, want = gan_run["metrics"]
    assert set(got) == set(want) == {"d_loss", "g_loss", "g_content_loss",
                                     "g_vgg_loss", "g_adv_loss"}
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-4), k
    assert want["g_vgg_loss"] > 0


def test_adversarial_step_g_function_and_stats_match_jax(gan_run):
    """G's eval-mode function after both steps within 3e-4; both
    networks' running statistics within 1e-5: G's advanced once a step
    (the detached fake's updates discarded), D's by the real pass then the
    fake pass."""
    got, want = gan_run["fn"]
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)
    _assert_trees_close(*gan_run["g_bs"], 1e-5)
    _assert_trees_close(*gan_run["d_bs"], 1e-5)
    assert gan_run["steps"] == (2, 1, 2, 1)


def test_no_vgg_drops_the_perceptual_term():
    tr = GANTrainer(SRConfig(**_SMALL), device="cpu")
    assert tr.vgg is None
    g, d = tr.init_states(0)
    _, _, m = tr.adversarial_step(g, d, _torch_batch(_batches(1)[0]))
    assert "g_vgg_loss" not in m
    assert float(m["g_loss"]) == pytest.approx(
        float(m["g_content_loss"]) + 1e-3 * float(m["g_adv_loss"]),
        rel=1e-6)


@pytest.fixture(scope="module")
def corpus():
    ds = SyntheticDataset(num_images=4, size=(48, 48), channels=3, seed=3)
    return [ds[i] for i in range(len(ds))]


def _setup(corpus, **kw):
    cfg = SRConfig(**{**_SMALL, "steps_per_epoch": 2, **kw})
    pipe = PatchPipeline(corpus, crop_size=32, scale_factor=4, batch_size=4,
                         random_scale=False, device="cpu")
    tr = GANTrainer(cfg, device="cpu")
    return tr, *tr.init_states(3), pipe


def _same(a, b):
    for (name, t), u in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(t, u), name
    assert a.step == b.step
    for sa, sb in zip(a.optimizer.state_dict()["state"].values(),
                      b.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    if a.generator is not None:
        assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("phase", ["pretrain", "adversarial"])
def test_multi_step_equals_single_steps(corpus, phase):
    """K=3 steps of a phase in one dispatch == 3 single steps on 3 batches
    drawn from the same generator, bit for bit; metrics are the means."""
    tr, g, d, pipe = _setup(corpus)
    _, g2, d2, _ = _setup(corpus)
    fn = tr.make_multi_step(pipe, 3, phase)
    m = fn(g) if phase == "pretrain" else fn(g, d)
    singles = []
    for _ in range(3):
        batch = pipe(g2.generator)
        if phase == "pretrain":
            singles.append(tr.pretrain_step(g2, batch)[1])
        else:
            singles.append(tr.adversarial_step(g2, d2, batch)[2])
    _same(g, g2)
    _same(d, d2)
    for k, v in m.items():
        assert float(v) == pytest.approx(
            np.mean([float(s[k]) for s in singles]), rel=1e-6)
    with pytest.raises(ValueError, match="unknown phase"):
        tr.make_multi_step(pipe, 3, "both")


@pytest.mark.parametrize("k", [1, 2])
def test_fit_runs_both_phases_and_resumes_g_and_d_exactly(corpus, tmp_path,
                                                          k):
    """One pretrain epoch and two adversarial epochs of 2 steps; stopping
    after the second epoch and restoring G and D (D keyed by G's step)
    continues bit for bit: parameters, running statistics, both Adams'
    moments, steps and the sampler's generator."""
    tr, g, d, pipe = _setup(corpus, steps_per_dispatch=k, pretrain_epochs=1)
    logs = []
    g, d = tr.fit(g, d, pipe, num_epochs=3, log_cb=logs.append)
    assert (g.step, d.step) == (6, 4)
    assert [r["phase"] for r in logs][0] == "pretrain"
    assert logs[-1]["phase"] == "adversarial" and "d_loss" in logs[-1]
    _, g1, d1, _ = _setup(corpus, steps_per_dispatch=k, pretrain_epochs=1)
    gck = Checkpointer(str(tmp_path / "g"), meta=run_meta(tr.cfg))
    dck = Checkpointer(str(tmp_path / "d"))
    tr.fit(g1, d1, pipe, num_epochs=2, checkpointer=gck, d_checkpointer=dck)
    assert gck.latest_step() == dck.latest_step() == 4
    _, g2, d2, _ = _setup(corpus)
    g2, d2 = gck.restore(g2), dck.restore(d2)
    assert (g2.step, d2.step) == (4, 2) and d2.generator is None
    g2, d2 = tr.fit(g2, d2, pipe, num_epochs=3)
    _same(g, g2)
    _same(d, d2)


def test_gan_trainer_refusals():
    with pytest.raises(ValueError, match="no GAN spec"):
        GANTrainer(SRConfig(**{**_SMALL, "model_name": "SRResNet"}),
                   device="cpu")
    # a mesh the processes present do not fill: refused with the hint
    with pytest.raises(ValueError, match="needs 2 processes, 1 present"
                                         ".*SR_COORDINATOR"):
        GANTrainer(SRConfig(**_SMALL, mesh_shape=(2,)), device="cpu")
    # the shared Trainer takes the GAN spec too: its generator alone
    assert Trainer(SRConfig(**_SMALL), device="cpu").spec.name == "SRGAN"
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            GANTrainer(SRConfig(**_SMALL))
