"""sr_torch's data-parallel training over processes against the JAX
package: two gloo processes on the CPU (``tests/test_torch_parallel_worker.py``)
train on the global batch, each on its half, as the JAX trainers do on a
mesh; the result must equal ``sr``'s step on a one-device mesh and the
port's own one-process step.

EDSR at 2 resblocks × 16 filters, VDSR at 8 filters, SRGAN at 1 × 8 and
ESPCN, all float32, on inputs from ``np.random.default_rng``. The
tolerances are ``__graft_entry__.py:dryrun_multichip``'s: a Trainer
step's loss within 1e-5 relative and its params within 1e-4 of the
port's one-process run (the largest |a − b| / (|b| + 1e-6)) and, against
JAX, within the port's parity tests' 1e-5 (the largest |a − b| over the
largest |b|, per tensor: the frameworks' convs sum in other orders, and
Adam's first update of a near-zero gradient magnifies that); the GAN's d_loss and g_loss within 1e-4 relative,
G's post-step function within 3e-4, and the running statistics within
``tests/test_torch_gan.py``'s 1e-5 absolute. Kill and resume ends bit-equal to an unkilled run. Each child joins
through a ``file://`` rendezvous under the test's own directory, with a
60 s collective timeout; each launch waits at most 240 s and kills its
children on failure.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_worker as worker
from sr.train.gan import GANTrainer as JaxGANTrainer
from sr.train.trainer import Trainer as JaxTrainer
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.train.trainer import Trainer
from sr_torch.utils.checkpoint import Checkpointer, run_meta
from sr_torch.utils.config import SRConfig

torch.set_num_threads(1)

_EDSR = dict(model_name="EDSR", num_channels=3, scale_factor=4,
             num_resblocks=2, base_filter=16, crop_size=32, batch_size=8,
             dtype="float32", lr_halve_steps=2)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float64)


def _max_reldiff(a, b, skip=()) -> float:
    """``dryrun_multichip``'s measure: max over leaves of |a − b| /
    (|b| + 1e-6); leaves whose path holds a name in ``skip`` left out."""
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert set(a) == set(b) and b
    return max(float(np.max(np.abs(a[p] - b[p]) / (np.abs(b[p]) + 1e-6)))
               for p in b if not set(p) & set(skip))


def _rel(got, want) -> float:
    return abs(got - want) / abs(want)


def _tensor_rel(a, b) -> float:
    """max over leaves of max |a − b| / max |b|: the port's parity tests'
    measure after several Adam steps, where a parameter whose gradient is
    near zero moves by reduction-order noise amplified by Adam's
    1/(√v + ε) in either package."""
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert set(a) == set(b) and b
    return max(float(np.abs(a[p] - b[p]).max() / np.abs(b[p]).max())
               for p in b)


def _max_absdiff(a, b) -> float:
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert set(a) == set(b) and b
    return max(float(np.abs(a[p] - b[p]).max()) for p in b)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(n, b, lr, hr, c=3, seed=0, key="lr"):
    rng = np.random.default_rng(seed)
    return [{key: rng.uniform(0, 1, (b, lr, lr, c)).astype(np.float32),
             "hr": rng.uniform(0, 1, (b, hr, hr, c)).astype(np.float32)}
            for _ in range(n)]


# ------------------------------------------------------------ Trainer ----

def test_two_process_trainer_steps_match_jax_and_one_process(tmp_path):
    """Three steps on global batches of 8 (4 rows a process), and a K=3
    dispatch on batches drawn from the state's generator: the loss is the
    global batch's and the params match ``sr``'s one-device steps and the
    port's one-process steps; the generators stay equal."""
    jtr = JaxTrainer(JaxSRConfig(**_EDSR, mesh_shape=(1,)))
    jstate = jtr.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    params = _np(jstate.params)
    batches = _batches(3, 8, 8, 32)
    want, want_1 = [], None
    for b in batches:
        jstate, m = jtr.train_step(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        want.append(float(m["loss"]))
        want_1 = want_1 or _np(jstate.params)
    corpus = np.random.default_rng(1).integers(0, 256, (4, 48, 48, 3),
                                               np.uint8)
    inp = {"cfg": _EDSR, "params": params, "batches": batches,
           "corpus": corpus, "k": 3}
    two = worker.run("trainer", inp, tmp_path)
    (one,) = worker.run("trainer", inp, tmp_path, world=0)

    for out in two:
        got = [s["loss"] for s in out["steps"]]
        assert max(_rel(g, w) for g, w in zip(got, want)) <= 1e-5, (got, want)
        assert out["step"] == 3
        # against JAX: the port's parity measure (the two frameworks' convs
        # sum in other orders); against the port's own one-process run:
        # dryrun_multichip's, as the JAX package holds its mesh
        assert _tensor_rel(out["params_1"], want_1) <= 1e-5
        assert _tensor_rel(out["params"], _np(jstate.params)) <= 1e-5
        assert _max_reldiff(out["params_1"], one["params_1"]) <= 1e-4
        assert _max_reldiff(out["params"], one["params"]) <= 1e-4
        assert _rel(out["multi"]["metrics"]["loss"],
                    one["multi"]["metrics"]["loss"]) <= 1e-5
        assert _max_reldiff(out["multi"]["params"],
                            one["multi"]["params"]) <= 1e-4
        assert out["multi"]["step"] == 3
        assert torch.equal(out["multi"]["generator"],
                           one["multi"]["generator"])
    # the processes hold one replica: bit-equal params and metrics
    assert two[0]["steps"] == two[1]["steps"]
    for (p, a), (_, b) in zip(_leaves(two[0]["params"]),
                              _leaves(two[1]["params"])):
        assert np.array_equal(a, b), p


def test_two_process_vdsr_clip_scale_matches_jax(tmp_path):
    """VDSR's recipe clips the gradients that DDP averaged: the clip scale
    and the step equal ``sr``'s on the global batch."""
    cfg = dict(model_name="VDSR", num_channels=1, scale_factor=4,
               base_filter=8, crop_size=24, batch_size=4, dtype="float32",
               vdsr_clip_theta=1e-4)
    jtr = JaxTrainer(JaxSRConfig(**cfg, mesh_shape=(1,)))
    jstate = jtr.init_state(jax.random.key(0), jnp.zeros((1, 24, 24, 1)))
    params = _np(jstate.params)
    batches = _batches(2, 4, 24, 24, c=1, key="bc")
    want = []
    for b in batches:
        jstate, m = jtr.train_step(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        want.append({k: float(v) for k, v in m.items()})
    inp = {"cfg": cfg, "params": params, "batches": batches}
    two = worker.run("trainer", inp, tmp_path)
    (one,) = worker.run("trainer", inp, tmp_path, world=0)
    for out in two:
        for got, w, o in zip(out["steps"], want, one["steps"]):
            assert set(got) == set(w) | {"clip_scale"} == set(o)
            assert 0 < got["clip_scale"] < 1  # the clip acts
            assert _rel(got["clip_scale"], o["clip_scale"]) <= 1e-5
            for k in w:
                assert _rel(got[k], w[k]) <= 1e-5, (k, got[k], w[k])
        assert _tensor_rel(out["params"], _np(jstate.params)) <= 1e-5


# --------------------------------------------------------- GANTrainer ----

@pytest.mark.parametrize("d_train_mode", [False, True],
                         ids=["D-eval", "D-train"])
def test_two_process_gan_steps_match_jax(d_train_mode, tmp_path):
    """A pretrain step and an adversarial step of SRGAN on global batches
    of 8 (4 a process), with batch statistics over the group: the losses,
    G's function after each step and both networks' running statistics
    equal ``sr``'s on a one-device mesh."""
    cfg = dict(model_name="SRGAN", num_channels=3, scale_factor=4,
               num_resblocks=1, base_filter=8, crop_size=32, batch_size=8,
               dtype="float32", adv_d_train_mode=d_train_mode)
    jtr = JaxGANTrainer(JaxSRConfig(**cfg, mesh_shape=(1,)))
    b0, b1 = _batches(2, 8, 8, 32)
    probe = np.random.default_rng(5).uniform(0, 1, (2, 8, 8, 3)).astype(
        np.float32)
    g, d = jtr.init_states(jax.random.key(1), jnp.asarray(b0["lr"][:1]),
                           jnp.asarray(b0["hr"][:1]))
    inp = {"cfg": cfg, "g_params": _np(g.params), "g_stats": _np(g.batch_stats),
           "d_params": _np(d.params), "d_stats": _np(d.batch_stats),
           "probe": probe, "batches": (b0, b1)}
    g, m0 = jtr.pretrain_step(g, {k: jnp.asarray(v) for k, v in b0.items()})
    fn0 = np.asarray(jtr.predict(g, jnp.asarray(probe)))
    g, d, m1 = jtr.adversarial_step(g, d, {k: jnp.asarray(v)
                                           for k, v in b1.items()})
    fn1 = np.asarray(jtr.predict(g, jnp.asarray(probe)))
    two = worker.run("gan", inp, tmp_path)
    for out in two:
        assert _rel(out["pretrain"]["g_content_loss"],
                    float(m0["g_content_loss"])) <= 1e-4
        np.testing.assert_allclose(out["pretrain_fn"], fn0, rtol=0,
                                   atol=3e-4)
        got = out["adversarial"]
        assert set(got) == {k for k in m1}
        for k in ("d_loss", "g_loss", "g_content_loss", "g_adv_loss"):
            assert _rel(got[k], float(m1[k])) <= 1e-4, (k, got[k])
        np.testing.assert_allclose(out["fn"], fn1, rtol=0, atol=3e-4)
        assert _max_absdiff(out["g_stats"], _np(g.batch_stats)) <= 1e-5
        assert _max_absdiff(out["d_stats"], _np(d.batch_stats)) <= 1e-5
        assert out["steps"] == (2, 1)
    # the running statistics agree on the processes: no buffer broadcast
    for key in ("g_stats", "d_stats"):
        for (p, a), (_, b) in zip(_leaves(two[0][key]),
                                  _leaves(two[1][key])):
            assert np.array_equal(a, b), (key, p)


# ----------------------------------------------------- kill and resume ----

_ESPCN = dict(model_name="ESPCN", num_channels=1, scale_factor=4,
              crop_size=32, batch_size=8, dtype="float32", num_epochs=4,
              steps_per_epoch=4, save_epochs=1, steps_per_dispatch=2)


def test_two_process_kill_and_resume(tmp_path):
    """ESPCN, 4 epochs of 4 steps over two processes. Process 1 SIGKILLs
    itself after the epoch-3 save; the survivor is reaped; a fresh group
    resumes from the checkpoint and ends bit-equal to an unkilled run.
    A checkpoint holds no topology: the two-process one restores in one
    process, which finishes the schedule within the Trainer tolerance,
    and saved again by one process it restores in two, which end
    bit-equal to the unkilled run."""
    corpus = np.random.default_rng(3).integers(0, 256, (4, 48, 48, 1),
                                               np.uint8)

    def inp(ckpt, **kw):
        return {"cfg": _ESPCN, "corpus": corpus, "ckpt": str(ckpt), **kw}

    full = worker.run("fit", inp(tmp_path / "ckpt_full"), tmp_path)
    assert full[0]["step"] == 16 and not full[0]["restored"]

    ckpt = tmp_path / "ckpt_ft"
    runs = worker.start("fit", inp(ckpt, kill_after=2), tmp_path)
    victim, survivor = runs[1][0], runs[0][0]
    assert victim.wait(timeout=240) == -9
    try:  # the survivor fails its next collective, or is reaped
        survivor.wait(timeout=5)
    except subprocess.TimeoutExpired:
        pass
    worker.finish(runs, timeout=30)
    assert Checkpointer(str(ckpt)).latest_step() == 12
    assert not [f for f in os.listdir(ckpt) if f.endswith(".tmp")]

    resumed = worker.run("fit", inp(ckpt), tmp_path)
    for out in resumed:
        assert out["restored"] and out["step"] == 16
        for (p, a), (_, b) in zip(_leaves(out["params"]),
                                  _leaves(full[0]["params"])):
            assert np.array_equal(a, b), p

    # the two-process checkpoint at step 12, saved again by one process:
    # two processes resume it bit-equal to the unkilled run, one process
    # finishes it within the Trainer tolerance
    tr = Trainer(SRConfig(**_ESPCN), device="cpu")
    state = tr.init_state(0)
    Checkpointer(str(tmp_path / "ckpt_full")).restore(state, step=12)
    for name in ("ckpt_one", "ckpt_one_two"):
        Checkpointer(str(tmp_path / name), meta=run_meta(tr.cfg)).save(state)
    (one,) = worker.run("fit", inp(tmp_path / "ckpt_one"), tmp_path,
                        world=0)
    assert one["restored"] and one["step"] == 16
    assert _max_reldiff(one["params"], full[0]["params"]) <= 1e-4
    for out in worker.run("fit", inp(tmp_path / "ckpt_one_two"), tmp_path):
        assert out["restored"] and out["step"] == 16
        for (p, a), (_, b) in zip(_leaves(out["params"]),
                                  _leaves(full[0]["params"])):
            assert np.array_equal(a, b), p


# --------------------------------------------------------- checkpoints ----

_META_WRITER = r"""
import sys
from sr_torch.utils.checkpoint import Checkpointer
meta = {"model_name": "ESPCN", "steps_per_epoch": int(sys.argv[2])}
for _ in range(200):
    Checkpointer(sys.argv[1], meta=meta, resume=False)
"""


def test_two_processes_construct_checkpointers_on_one_directory(tmp_path):
    """Two processes (no group, so each is its own coordinator) construct
    Checkpointers on one directory at once, 200 times each: every write
    of ``run_meta.json`` goes through a temporary name of its own process,
    so the meta always reads back whole and no temporary file is left."""
    env = {**os.environ, "PYTHONPATH": str(worker.ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", _META_WRITER,
                               str(tmp_path), str(n)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for n in (7, 9)]
    reads = []
    try:
        deadline = time.monotonic() + 120
        while any(p.poll() is None for p in procs):
            assert time.monotonic() < deadline
            if (tmp_path / "run_meta.json").exists():
                with open(tmp_path / "run_meta.json") as f:
                    reads.append(json.load(f)["steps_per_epoch"])
        errs = [p.communicate(timeout=60)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], errs
    assert set(reads) <= {7, 9}
    assert os.listdir(tmp_path) == ["run_meta.json"]
