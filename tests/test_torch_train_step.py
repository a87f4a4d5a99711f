"""sr_torch's training step against the JAX package: losses, Adam with step
halving, the pixel shuffle's backward, the shuffle fold, EDSR's pre-shuffle
forwards and the trainer's step, K-step dispatch and resume.

EDSR ×4 at 2 resblocks × 16 filters, crop 32, batch 8. Weights come from a
JAX ``init`` and cross with ``from_jax_params``; inputs come from
``np.random.default_rng``. The JAX trainer runs on a one-device mesh (the
test run has 8 virtual CPU devices). Everything runs on the CPU, where
the port's kernels take their plain versions.
"""

import ast
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sr.kernels import shuffle_fold as jax_fold
from sr.models.edsr import Net as FlaxEDSR
from sr.models.registry import get_spec as jax_get_spec
from sr.nn.blocks import ResnetBlock as FlaxResnetBlock
from sr.train import losses as jax_losses
from sr.train.optim import adam_with_step_halving as jax_adam_halving
from sr.train.trainer import Trainer as JaxTrainer
from sr.utils.checkpoint import run_meta as jax_run_meta
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.data.datasets import SyntheticDataset
from sr_torch.data.pipeline import PatchPipeline
from sr_torch.kernels import shuffle_fold
from sr_torch.kernels.depth_to_space import (
    depth_to_space, depth_to_space_plain, space_to_depth)
from sr_torch.models.edsr import Net
from sr_torch.models.registry import get_spec
from sr_torch.nn.blocks import ResnetBlock
from sr_torch.train import losses
from sr_torch.train.optim import adam_with_step_halving, step_decay_schedule
from sr_torch.train.trainer import Trainer
from sr_torch.utils.checkpoint import Checkpointer, run_meta
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import flax_path, from_jax_params, to_jax_params

torch.set_num_threads(1)

_SMALL = dict(model_name="EDSR", num_channels=3, scale_factor=4,
              num_resblocks=2, base_filter=16, crop_size=32, batch_size=8,
              lr_halve_steps=2)


def _rel(got, want) -> float:
    """max |got - want| over max |want|: the tests' relative error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _as_flax(model, attr):
    """{flax path: array} of every parameter's ``attr`` ('data' or 'grad'),
    conv weights as HWIO kernels."""
    out = {}
    for name, p in model.named_parameters():
        t = getattr(p, attr)
        assert t is not None, f"{name} has no {attr}"
        mod, leaf = name.rsplit(".", 1)
        if leaf == "weight":
            out[flax_path(mod) + ("kernel",)] = t.permute(2, 3, 1, 0).numpy()
        else:
            out[flax_path(mod) + ("bias",)] = t.numpy()
    return out


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"lr": rng.uniform(0, 1, (8, 8, 8, 3)).astype(np.float32),
             "hr": rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)}
            for _ in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# -------------------------------------------------------------- losses ----

@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "charbonnier_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    b = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    want = float(getattr(jax_losses, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(losses, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    # bf16 inputs are cast to f32 before the difference
    got16 = getattr(losses, name)(torch.from_numpy(a).bfloat16(),
                                  torch.from_numpy(b))
    want16 = float(getattr(jax_losses, name)(
        jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b)))
    assert abs(float(got16) - want16) <= 1e-6 * abs(want16)


# ---------------------------------------------------------------- Adam ----

@pytest.mark.parametrize("halve_steps", [2, 0, -1])
def test_adam_with_step_halving_matches_optax(halve_steps):
    """optax evaluates the schedule at the count before the update, so with
    halve_steps=2 updates 0-4 run at 1, 1, 1/2, 1/2, 1/4 of the base lr;
    halve_steps <= 0 keeps it constant. Params after 5 updates ≤ 1e-6
    relative to optax's (float32 rounding: torch updates the moments with
    lerp and folds the bias corrections in another order)."""
    sched = step_decay_schedule(1e-2, 1, halve_steps, 0.5)
    want_lr = ([1e-2, 1e-2, 5e-3, 5e-3, 2.5e-3] if halve_steps > 0
               else [1e-2] * 5)
    assert [sched(c) for c in range(5)] == pytest.approx(want_lr, rel=1e-12)
    rng = np.random.default_rng(halve_steps + 5)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = rng.standard_normal((5, 64)).astype(np.float32)
    tx = jax_adam_halving(1e-2, halve_steps)
    jp, opt = jnp.asarray(p0), None
    opt = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    recipe = adam_with_step_halving(1e-2, halve_steps)
    optimizer = recipe.init([param])
    lrs = []
    for count, g in enumerate(grads):
        upd, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = torch.from_numpy(g.copy())
        recipe.step(optimizer, count)
        lrs.append(optimizer.param_groups[0]["lr"])
    assert lrs == pytest.approx(want_lr, rel=1e-12)
    assert _rel(param.detach().numpy(), np.asarray(jp)) <= 1e-6


# ------------------------------------------------- the shuffle's backward ----

@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_depth_to_space_gradcheck(act, with_bias):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 4, 8), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    bias = (torch.randn(8, generator=gen, dtype=torch.float64,
                        requires_grad=True) if with_bias else None)
    inputs = (x,) if bias is None else (x, bias)
    assert torch.autograd.gradcheck(
        lambda *t: depth_to_space(t[0], 2, act, t[1] if bias is not None
                                  else None), inputs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "relu"])
def test_depth_to_space_backward_equals_autograd_of_plain(dtype, act):
    """Bit for bit: the Function's forward and its gradients for x and the
    bias against autograd through the plain reshape-permute."""
    gen = torch.Generator().manual_seed(1)
    x0 = torch.randn((4, 8, 8, 64), generator=gen).to(dtype)
    b0 = torch.randn(64, generator=gen).to(dtype)
    g = torch.randn((4, 16, 16, 16), generator=gen).to(dtype)
    outs = []
    for fn in (depth_to_space, depth_to_space_plain):
        x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
        y = fn(x, 2, act, b)
        y.backward(g)
        outs.append((y.detach(), x.grad, b.grad))
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_depth_to_space_without_grad_saves_nothing():
    x = torch.randn((1, 2, 2, 4), requires_grad=True)
    with torch.no_grad():
        assert depth_to_space(x, 2).grad_fn is None
    with torch.inference_mode():
        assert depth_to_space(x.detach(), 2, "relu").grad_fn is None
    assert depth_to_space(x.detach(), 2).grad_fn is None  # nothing to grad
    assert depth_to_space(x, 2).grad_fn is not None


# ------------------------------------------------------------ the fold ----

_FOLDS = [(2, 3, None), (3, 3, None), (2, 5, None), (4, 3, None),
          (2, 3, 0), (2, 3, 2), (4, 5, 1), (2, 2, 1), (8, 3, 1)]


@pytest.mark.parametrize("r,k,pad", _FOLDS)
def test_fold_numpy_equals_jax(r, k, pad):
    w = np.random.default_rng(r * 100 + k).standard_normal(
        (k, k, 3, 2)).astype(np.float32)
    got, dmin = shuffle_fold.fold_shuffle_conv_kernel(w, r, pad)
    want, want_dmin = jax_fold.fold_shuffle_conv_kernel(w, r, pad)
    assert dmin == want_dmin
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(shuffle_fold.fold_bias(w[0, 0, 0], r),
                                  jax_fold.fold_bias(w[0, 0, 0], r))


@pytest.mark.parametrize("r,k,pad", _FOLDS)
def test_fold_twin_value_and_grad_match_jax(r, k, pad):
    """The differentiable twin: exact against the numpy fold; its value and
    the gradient of a random linear functional ≤ 1e-6 against
    ``fold_shuffle_conv_kernel_jnp``."""
    rng = np.random.default_rng(r * 10 + k)
    w = rng.standard_normal((k, k, 3, 2)).astype(np.float32)
    want, dmin = jax_fold.fold_shuffle_conv_kernel_jnp(jnp.asarray(w), r, pad)
    probe = rng.standard_normal(want.shape).astype(np.float32)
    wt = torch.from_numpy(w).requires_grad_()
    got, got_dmin = shuffle_fold.fold_shuffle_conv_kernel_torch(wt, r, pad)
    assert got_dmin == dmin
    np.testing.assert_array_equal(
        got.detach().numpy(),
        shuffle_fold.fold_shuffle_conv_kernel(w, r, pad)[0])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    (got * torch.from_numpy(probe)).sum().backward()
    want_g = jax.grad(lambda v: jnp.sum(
        jax_fold.fold_shuffle_conv_kernel_jnp(v, r, pad)[0] * probe))(
            jnp.asarray(w))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def edsr_x4():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 10, 12, 3)).astype(np.float32)
    jm = FlaxEDSR(3, 16, 2, 4, 1.0, jnp.float32)
    v = jm.init(jax.random.key(3), jnp.asarray(x), train=False)
    # nonzero biases, so a dropped or doubled bias shows
    v = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(a.shape)
                     .astype(np.float32), jax.tree.map(np.asarray, v))
    tm = from_jax_params(Net(3, 16, 2, 4), v["params"])
    return jm, v, tm, x


def test_folded_tail_predict_matches_jax(edsr_x4):
    """``make_folded_tail_predict`` against the JAX one and the exact graph:
    ≤ 1e-5 (f32), borders included."""
    jm, v, tm, x = edsr_x4
    want = np.asarray(jax_fold.make_folded_tail_predict(jm, v)(x))
    got = shuffle_fold.make_folded_tail_predict(tm)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with torch.no_grad():
        exact = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["last", "full"])
def test_preshuffle_forwards_match_jax(edsr_x4, mode):
    """EDSR's pre-shuffle training forwards against the JAX ones (≤ 1e-5,
    f32), and each is the space_to_depth chain of the exact forward."""
    jm, v, tm, x = edsr_x4
    jspec, spec = jax_get_spec("EDSR"), get_spec("EDSR")
    if mode == "last":
        japply, r_last = jspec.preshuffle_train(jm)
        apply_fn, r = spec.preshuffle_train(tm)
        assert r == r_last == 2
        target = lambda y: space_to_depth(y, r)  # noqa: E731
    else:
        japply, _ = jspec.preshuffle_train_full(jm)
        apply_fn, target = spec.preshuffle_train_full(tm)
    want = np.asarray(japply(v, jnp.asarray(x), train=True))
    with torch.no_grad():
        got = apply_fn(torch.from_numpy(x))
        full = target(tm(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=1e-5)


def test_resnet_block_trains_like_flax():
    """With grad on the block runs its convs one by one: value and input /
    weight gradients ≤ 1e-5 relative to flax's (f32, res_scale 0.1)."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 6, 7, 16)).astype(np.float32)
    fb = FlaxResnetBlock(16, 3, act="relu", norm=None, res_scale=0.1)
    v = jax.tree.map(np.asarray, fb.init(jax.random.key(4), x))
    probe = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(params, xx):
        return jnp.sum(fb.apply({"params": params}, xx) * probe)

    want_val = np.asarray(fb.apply(v, x))
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(v["params"], x)
    blk = from_jax_params(ResnetBlock(16, res_scale=0.1), v["params"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = blk(xt)
    assert y.grad_fn is not None
    (y.permute(0, 2, 3, 1) * torch.from_numpy(probe)).sum().backward()
    assert _rel(y.detach().permute(0, 2, 3, 1).numpy(), want_val) <= 1e-5
    assert _rel(xt.grad.permute(0, 2, 3, 1).numpy(), want_gx) <= 1e-5
    got = _as_flax(blk, "grad")
    for path, g in _leaves(jax.tree.map(np.asarray, want_gp)):
        assert _rel(got[path], g) <= 1e-5, path
    with torch.no_grad():  # the fused path (plain version on the CPU)
        fused = blk(xt).permute(0, 2, 3, 1).numpy()
    assert _rel(fused, want_val) <= 1e-5


# ------------------------------------------------------ the train step ----

def _trainers(dtype, mode):
    jtr = JaxTrainer(JaxSRConfig(**_SMALL, dtype=dtype, preshuffle_loss=mode,
                                 mesh_shape=(1,)))
    tr = Trainer(SRConfig(**_SMALL, dtype=dtype, preshuffle_loss=mode),
                 device="cpu")
    return jtr, tr


def _jax_loss(jtr, params, batch):
    """The JAX trainer's loss of one step (its ``_step_core`` loss_fn)."""
    lr, hr = jnp.asarray(batch["lr"]), jnp.asarray(batch["hr"])
    if jtr._preshuffle is not None:
        apply_pre, target_fn = jtr._preshuffle
        out = apply_pre({"params": params}, lr, train=True)
        hr = target_fn(hr)
    else:
        out = jtr.model.apply({"params": params}, lr, train=True)
    return jtr.spec.loss(out, {"hr": hr}, {})[0]


@pytest.fixture(scope="module", params=[
    ("float32", False), ("float32", "last"), ("float32", "full"),
    ("bfloat16", False), ("bfloat16", "last"), ("bfloat16", "full")],
    ids=lambda p: f"{p[0]}-{p[1] or 'off'}")
def step_run(request):
    """One JAX and one port run of 3 train steps from the same params and
    batches: the first step's loss and gradients, and the params after
    the 3rd Adam update (lr halved every 2 steps)."""
    return _step_run(*request.param)


@functools.cache
def _step_run(dtype, mode):
    jtr, tr = _trainers(dtype, mode)
    jstate = jtr.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    params = jax.tree.map(np.asarray, jstate.params)
    batches = _batches(3)
    jloss, jgrads = jax.value_and_grad(
        lambda p: _jax_loss(jtr, p, batches[0]))(params)
    for b in batches:
        jstate, _ = jtr.train_step(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
    state = tr.init_state(0)
    from_jax_params(state.model, params)
    loss, _ = tr.loss_fn(state.model, _torch_batch(batches[0]), 0)
    loss.backward()
    loss = loss.detach()
    grads = _as_flax(state.model, "grad")
    losses_seen = []
    for b in batches:
        state, m = tr.train_step(state, _torch_batch(b))
        losses_seen.append(float(m["loss"]))
    return dict(dtype=dtype, mode=mode, loss=(float(loss), float(jloss)),
                grads=(grads, dict(_leaves(jax.tree.map(np.asarray, jgrads)))),
                params=(_as_flax(state.model, "data"),
                        dict(_leaves(jax.tree.map(np.asarray,
                                                  jstate.params)))),
                first_step_loss=losses_seen[0], step=state.step)


# Tolerances. float32: summation order only, ≤ 1e-5 relative (max error
# over max entry, per tensor). bfloat16: the two frameworks round at other
# places (flax rounds each conv's output before a bf16 bias add; oneDNN and
# cuDNN add the bias before one rounding), and L1's gradient is a sign, so
# an output one bf16 ulp apart flips it where |out - hr| is below an ulp.
# A bias gradient sums such signs with cancellation, so it may differ by
# many times its own size between the two bf16 runs (the out conv's bias,
# 13× in the run that set these bounds). So the bf16 bounds hold the port to
# the JAX package's own bf16 error against its float32 step: per gradient,
# max |port - f32| ≤ 1.5 · max |JAX - f32| + 1e-3 · max |f32|; the params
# after 3 Adam updates no further from JAX's than JAX's bf16 params are
# from its float32 ones; the loss within 1e-4 relative.
_F32_TOL = 1e-5


def test_train_step_loss_matches_jax(step_run):
    got, want = step_run["loss"]
    tol = _F32_TOL if step_run["dtype"] == "float32" else 1e-4
    assert abs(got - want) <= tol * abs(want)
    assert step_run["first_step_loss"] == got
    assert step_run["step"] == 3


def test_train_step_grads_match_jax(step_run):
    """Every parameter gets a gradient — head, body, PS convs and their
    biases, out conv — equal to flax's within the stated tolerance."""
    got, want = step_run["grads"]
    assert set(got) == set(want)
    assert all(np.abs(g).max() > 0 for g in got.values())
    if step_run["dtype"] == "float32":
        bad = {"/".join(p): _rel(got[p], w) for p, w in want.items()
               if _rel(got[p], w) > _F32_TOL}
    else:
        ref = _step_run("float32", step_run["mode"])["grads"][1]
        bad = {}
        for p, w in ref.items():
            e_port, e_jax = (np.abs(g[p] - w).max() for g in (got, want))
            if e_port > 1.5 * e_jax + 1e-3 * np.abs(w).max():
                bad["/".join(p)] = (e_port, e_jax)
    assert not bad, bad


def test_train_step_params_after_3_adam_steps_match_jax(step_run):
    got, want = step_run["params"]
    if step_run["dtype"] == "float32":
        bad = {"/".join(p): _rel(got[p], w) for p, w in want.items()
               if _rel(got[p], w) > _F32_TOL}
        assert not bad, bad
    else:
        ref = _step_run("float32", step_run["mode"])["params"][1]
        port_vs_jax = max(np.abs(got[p] - want[p]).max() for p in ref)
        jax_vs_f32 = max(np.abs(want[p] - ref[p]).max() for p in ref)
        assert port_vs_jax <= jax_vs_f32, (port_vs_jax, jax_vs_f32)


@pytest.mark.parametrize("mode", [False, "last", "full"],
                         ids=lambda m: m or "off")
def test_bf16_step_computes_in_bfloat16(mode):
    """The bf16 bounds above would also pass a port that computed the bf16
    config in float32. So: the output the bf16 loss is taken of is
    bfloat16 (float32 under the float32 config), and the bf16 step's
    gradients differ from the port's own float32 step's by more than
    float32 summation order could (> 1e-3 relative for some parameter,
    against the 1e-5 that f32 against JAX shows)."""
    seen = {}
    for dtype in ("bfloat16", "float32"):
        tr = _trainers(dtype, mode)[1]
        loss_fn = tr.spec.loss

        def capture(out, batch, ctx, dtype=dtype):
            seen[dtype] = out.dtype
            return loss_fn(out, batch, ctx)

        tr.spec = dataclasses.replace(tr.spec, loss=capture)
        state = tr.init_state(0)
        loss, _ = tr.loss_fn(state.model, _torch_batch(_batches(1)[0]), 0)
        assert loss.dtype == torch.float32
    assert seen == {"bfloat16": torch.bfloat16, "float32": torch.float32}
    b16 = _step_run("bfloat16", mode)["grads"][0]
    f32 = _step_run("float32", mode)["grads"][0]
    assert max(_rel(b16[p], g) for p, g in f32.items()) > 1e-3


# --------------------------------------------- dispatch, fit and resume ----

@pytest.fixture(scope="module")
def corpus():
    ds = SyntheticDataset(num_images=4, size=(64, 72), seed=1)
    return [ds[i] for i in range(len(ds))]


def _fit_setup(corpus, **kw):
    cfg = SRConfig(**{**_SMALL, "dtype": "float32", "steps_per_epoch": 4,
                      **kw})
    pipe = PatchPipeline(corpus, crop_size=32, scale_factor=4, batch_size=8,
                         device="cpu")
    tr = Trainer(cfg, device="cpu")
    return tr, tr.init_state(1), pipe


def _same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_multi_step_equals_single_steps(corpus):
    """make_multi_step(K=3) == 3 train_steps on 3 batches drawn from the
    same generator, bit for bit on the CPU; its metrics are the mean."""
    tr, a, pipe = _fit_setup(corpus)
    _, b, _ = _fit_setup(corpus)
    m = tr.make_multi_step(pipe, 3)(a)
    singles = [float(tr.train_step(b, pipe(b.generator))[1]["loss"])
               for _ in range(3)]
    _same_state(a, b)
    assert float(m["loss"]) == pytest.approx(np.mean(singles), rel=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_resume_equals_uninterrupted_run(corpus, tmp_path, k):
    """2 steps + save + restore into a fresh state + 2 steps == 4 steps,
    bit for bit (params, Adam moments through the updates, step and the
    sampler's generator), with one and two steps per dispatch."""
    tr, whole, pipe = _fit_setup(corpus, steps_per_epoch=2,
                                 steps_per_dispatch=k)
    whole = tr.fit(whole, pipe, num_epochs=2)
    assert whole.step == 4
    _, first, _ = _fit_setup(corpus, steps_per_epoch=2, steps_per_dispatch=k)
    ckpt = Checkpointer(str(tmp_path), meta=run_meta(tr.cfg))
    tr.fit(first, pipe, num_epochs=1, checkpointer=ckpt)
    assert ckpt.latest_step() == 2
    fresh = tr.init_state(99)
    resumed = ckpt.restore(fresh)
    assert resumed is fresh and resumed.step == 2
    resumed = tr.fit(resumed, pipe, num_epochs=2, checkpointer=ckpt)
    _same_state(whole, resumed)
    assert ckpt.steps() == [2, 4]


def test_checkpointer_keeps_last_k_and_checks_run_meta(corpus, tmp_path):
    tr, state, pipe = _fit_setup(corpus)
    cfg = tr.cfg
    ckpt = Checkpointer(str(tmp_path), keep=2, meta=run_meta(cfg))
    assert ckpt.restore(state) is None
    for step in (3, 5, 9):
        ckpt.save(state, step=step)
    assert ckpt.steps() == [5, 9] and ckpt.latest_step() == 9
    assert not [f for f in tmp_path.iterdir() if f.name.endswith(".tmp")]
    # the JAX package's keys and refusals
    assert run_meta(cfg) == jax_run_meta(JaxSRConfig(**_SMALL,
                                                     steps_per_epoch=4))
    for change in (dict(steps_per_epoch=5), dict(lr_halve_steps=7),
                   dict(num_resblocks=3)):
        with pytest.raises(ValueError, match="resume-consistency"):
            Checkpointer(str(tmp_path), meta=run_meta(cfg.replace(**change)))
    # resume=False starts afresh and records the new constants
    Checkpointer(str(tmp_path), meta=run_meta(cfg.replace(steps_per_epoch=5)),
                 resume=False)
    Checkpointer(str(tmp_path), meta=run_meta(cfg.replace(steps_per_epoch=5)))


def test_fit_runs_remaining_steps_and_logs(corpus):
    """A state restored mid-epoch runs only the remaining steps; logging
    fires once per K-step dispatch and at the epoch's end."""
    tr, state, pipe = _fit_setup(corpus, steps_per_dispatch=3, log_every=2)
    tr.train_step(state, pipe(state.generator))
    logs = []
    state = tr.fit(state, pipe, num_epochs=2, steps_per_epoch=4,
                   log_cb=logs.append)
    assert state.step == 8
    assert [r["step"] for r in logs] == [4, 7, 8]
    assert all(np.isfinite(r["loss"]) for r in logs)


def test_loss_falls_and_predict_runs_without_grad(corpus):
    tr, state, pipe = _fit_setup(corpus, lr=1e-3, lr_halve_steps=0)
    batch = pipe(torch.Generator().manual_seed(0))
    first = float(tr.train_step(state, batch)[1]["loss"])
    for _ in range(15):
        last = float(tr.train_step(state, batch)[1]["loss"])
    assert last < first
    out = tr.predict(state, batch["lr"])
    assert out.shape == batch["hr"].shape and out.grad_fn is None
    assert tr.num_params(state) == sum(
        p.size for _, p in _leaves(to_jax_params(state.model)))


def test_trainer_refusals():
    cfg = SRConfig(**_SMALL, dtype="float32")
    # a mesh the processes present do not fill: refused with the hint
    with pytest.raises(ValueError, match="needs 2 processes, 1 present"
                                         ".*SR_COORDINATOR"):
        Trainer(cfg.replace(mesh_shape=(2,)), device="cpu")
    spec = get_spec("EDSR")
    none = dataclasses.replace(spec, preshuffle_train=None,
                               preshuffle_train_full=None)
    with pytest.raises(ValueError, match="no pre-shuffle fold"):
        Trainer(cfg.replace(preshuffle_loss="last"), spec=none, device="cpu")
    last_only = dataclasses.replace(spec, preshuffle_train_full=None)
    with pytest.raises(ValueError, match="full-tail fold"):
        Trainer(cfg.replace(preshuffle_loss="full"), spec=last_only,
                device="cpu")
    bn = dataclasses.replace(spec, has_batchnorm=True)
    with pytest.raises(ValueError, match="batchnorm"):
        Trainer(cfg.replace(preshuffle_loss="last"), spec=bn, device="cpu")
    # a GAN spec trains its generator on the content loss, as the JAX
    # Trainer does (sr_torch.train.gan runs the adversarial recipe)
    gan = dataclasses.replace(spec, is_gan=True)
    assert Trainer(cfg, spec=gan, device="cpu").spec.is_gan
    Trainer(cfg.replace(preshuffle_loss=True), device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            Trainer(cfg)


# ------------------------------------------------------------- imports ----

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = {"sr", "jax", "flax", "optax", "orbax"}


@pytest.mark.parametrize(
    "path", sorted((ROOT / "sr_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_package_nor_orbax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")


def test_importing_the_trainer_loads_no_jax():
    code = ("import sys, sr_torch.train.trainer, sr_torch.data.pipeline, "
            "sr_torch.utils.checkpoint, sr_torch.kernels.shuffle_fold; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(_FORBIDDEN)!r}]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
