"""SRGAN's adversarial trainer: two Adams, D strictly before G.

Port of ``sr/train/gan.py``. Two phases (``fit``):
generator-only MSE pre-training for ``cfg.pretrain_epochs``, then per step

1. the fake: the generator's train-mode forward on the LR batch, without
   grad (detached), with its batch-norm running-statistic updates
   discarded (:func:`sr_torch.nn.blocks.frozen_batch_stats`), so the
   generator's running statistics advance once a step, in the G update's
   forward;
2. the D update: BCE(D(hr), 1) + BCE(D(fake), 0), D in train mode, its
   running statistics advanced by the real pass, then the fake pass;
3. the G update: MSE content + ``vgg_loss_weight`` · MSE of VGG19 features
   (``sr_torch/train/vgg.py``; none without ``cfg.vgg_weights_path``) +
   ``adv_loss_weight`` · BCE(D(G(lr)), 1) against the just-updated D, in
   eval mode unless ``cfg.adv_d_train_mode`` (train mode with its
   statistic updates discarded); the gradient reaches G's parameters only.

Each network has its own Adam (``spec.make_tx``). Where the JAX trainer
jits the whole step, the port queues it eagerly; K steps per dispatch draw
their batches on the device from the G state's generator, so a dispatch
waits for the host only when its metrics are read. G's step counts both
phases; D's state saves beside it keyed by G's step, and a run restored
from both continues exactly.

Over processes (``cfg.mesh_shape``, ``sr_torch/parallel``) each step is
the global batch's, as the JAX trainer's under GSPMD: every process draws
the global batch and keeps its ``data`` rows; G and D each run under
``DistributedDataParallel`` with their batch norms' statistics over the
group, the D update through D's replica (both passes in one forward), the
pretrain and G updates through G's; the detached fake and the adversarial
D pass, which update no parameter of their network, call the modules
themselves. The frozen VGG needs no replica. The metrics are the global
batch's means.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import numpy as np
import torch

from sr_torch.models.registry import ModelSpec, get_spec
from sr_torch.nn.blocks import frozen_batch_stats
from sr_torch.parallel.mesh import Mesh, batch_slice, make_mesh, replicate
from sr_torch.parallel.multihost import global_means
from sr_torch.train.loop import dispatch_epoch
from sr_torch.train.losses import bce_with_logits, mse_loss
from sr_torch.train.state import TrainState
from sr_torch.train.vgg import load_vgg
from sr_torch.utils.config import SRConfig
from sr_torch.utils.device import resolve_device


def _update(state: TrainState, loss: torch.Tensor, params) -> None:
    """Backpropagate ``loss`` into ``params`` (the state's model's) and
    apply the state's recipe at its step."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward(inputs=params)
    state.tx.step(state.optimizer, state.step)
    state.step += 1


def _pair(d, real, fake):
    """D's two passes of its update, real then fake, as one forward."""
    return d(real), d(fake)


class GANTrainer:
    """Two-phase SRGAN training (pretrain → adversarial), on one device or
    data parallel over the processes of ``mesh`` (default:
    ``cfg.mesh_shape`` over the processes present)."""

    def __init__(self, cfg: SRConfig, spec: ModelSpec | None = None,
                 device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        self.cfg = cfg
        self.spec = spec or get_spec(cfg.model_name)
        if not self.spec.is_gan:
            raise ValueError(f"{self.spec.name} is no GAN spec; use Trainer")
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape,
                                                            cfg.mesh_axes)
        self.device = resolve_device(device)
        self.vgg = load_vgg(cfg.vgg_weights_path, cfg.vgg_output_layer)
        if self.vgg is not None:
            self.vgg = self.vgg.to(self.device)

    # -- state ------------------------------------------------------------

    def init_states(self, seed: int) -> tuple[TrainState, TrainState]:
        """Fresh G and D states on the trainer's device: weights drawn from
        ``seed`` (flax's initializers; the numbers differ from JAX's), an
        Adam each, step 0, and the sampler's generator in G's state. D is
        built for the HR crop ``cfg.crop_size``. In a process group each
        state holds its network's DDP replica."""
        g_seed, d_seed, s_seed = np.random.SeedSequence(seed).generate_state(3)
        g = self.spec.make_model(
            self.cfg, torch.Generator().manual_seed(int(g_seed)))
        d = self.spec.make_discriminator(
            self.cfg, torch.Generator().manual_seed(int(d_seed)))
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(s_seed))
        states = []
        for model, gen, fn in ((g, generator, None), (d, None, _pair)):
            model = model.to(self.device)
            tx = self.spec.make_tx(self.cfg)
            states.append(TrainState(
                model=model, optimizer=tx.init(model), tx=tx, generator=gen,
                replica=(replicate(model, fn) if self.mesh.distributed
                         else None)))
        return states[0], states[1]

    # -- steps -------------------------------------------------------------

    def pretrain_step(self, g_state: TrainState, batch: dict
                      ) -> tuple[TrainState, dict]:
        """One MSE update of G on the global ``batch`` (in place, and
        returned)."""
        batch = batch_slice(batch, self.mesh)
        g = g_state.model
        g.train()
        with torch.enable_grad():
            loss = mse_loss((g_state.replica or g)(batch["lr"]), batch["hr"])
            _update(g_state, loss, list(g.parameters()))
        return g_state, global_means({"g_content_loss": loss.detach()})

    def adversarial_step(self, g_state: TrainState, d_state: TrainState,
                         batch: dict
                         ) -> tuple[TrainState, TrainState, dict]:
        """One D update, then one G update, on the global ``batch`` (both
        states in place, and returned); the metrics are device tensors."""
        batch = batch_slice(batch, self.mesh)
        cfg = self.cfg
        g, d = g_state.model, d_state.model
        g.train()
        d.train()
        lr, hr = batch["lr"], batch["hr"]
        # (a) the fake is the TRAIN-mode G forward, detached, and that
        # forward's running-statistic updates are discarded: the reference
        # computes G(lr) once per iteration (one running-stat update, in
        # the G update below), and D must classify the batch-stat
        # normalized fakes that the G update optimizes
        with torch.no_grad(), frozen_batch_stats():
            fake = g(lr)
        with torch.enable_grad():
            # ---- D update: real, then fake; D's stats advance twice
            real_logits, fake_logits = (d_state.replica
                                        or functools.partial(_pair, d))(
                hr, fake)
            d_loss = (bce_with_logits(real_logits,
                                      torch.ones_like(real_logits))
                      + bce_with_logits(fake_logits,
                                        torch.zeros_like(fake_logits)))
            _update(d_state, d_loss, list(d.parameters()))
            # ---- G update
            sr = (g_state.replica or g)(lr)
            content = mse_loss(sr, hr)
            loss = content
            metrics = {"g_content_loss": content.detach()}
            if self.vgg is not None:
                with torch.no_grad():
                    feat_hr = self.vgg(hr)
                perceptual = mse_loss(self.vgg(sr), feat_hr)
                loss = loss + cfg.vgg_loss_weight * perceptual
                metrics["g_vgg_loss"] = perceptual.detach()
            # (b) the adversarial term uses the JUST-updated D; (c) D in
            # eval mode (running statistics) unless cfg.adv_d_train_mode,
            # and its statistic updates discarded either way
            d.train(cfg.adv_d_train_mode)
            with frozen_batch_stats():
                logits = d(sr)
            adv = bce_with_logits(logits, torch.ones_like(logits))
            loss = loss + cfg.adv_loss_weight * adv
            metrics["g_adv_loss"] = adv.detach()
            _update(g_state, loss, list(g.parameters()))
        d.train()
        return g_state, d_state, global_means(
            {"d_loss": d_loss.detach(), "g_loss": loss.detach(), **metrics})

    def make_multi_step(self, pipeline, k: int, phase: str) -> Callable:
        """K steps of one phase in one dispatch, each batch drawn on the
        device with ``pipeline(g_state.generator)``; the metrics averaged
        over the K steps. ``phase='pretrain'``: ``fn(g_state) ->
        metrics``; ``'adversarial'``: ``fn(g_state, d_state) -> metrics``;
        the states are updated in place."""
        if phase not in ("pretrain", "adversarial"):
            raise ValueError(f"unknown phase {phase!r}")

        def mean(logs):
            return {name: torch.stack([m[name] for m in logs]).mean()
                    for name in logs[0]}

        if phase == "pretrain":
            return lambda g_state: mean([self.pretrain_step(
                g_state, pipeline(g_state.generator))[1] for _ in range(k)])
        return lambda g_state, d_state: mean([self.adversarial_step(
            g_state, d_state, pipeline(g_state.generator))[2]
            for _ in range(k)])

    @torch.no_grad()
    def predict(self, g_state: TrainState, x: torch.Tensor) -> torch.Tensor:
        """G's eval-mode forward (running statistics), without grad."""
        g_state.model.eval()
        return g_state.model(x)

    # -- fit ---------------------------------------------------------------

    def fit(self, g_state: TrainState, d_state: TrainState, pipeline,
            num_epochs: int | None = None,
            steps_per_epoch: int | None = None,
            pretrain_epochs: int | None = None, checkpointer=None,
            d_checkpointer=None, log_cb=None, epoch_hook=None
            ) -> tuple[TrainState, TrainState]:
        """Pretrain epochs, then adversarial epochs. G's step counts both,
        so a restored G state (and D's, keyed by G's step) resumes in its
        phase and mid-epoch runs only the epoch's remaining steps."""
        cfg = self.cfg
        num_epochs = num_epochs if num_epochs is not None else cfg.num_epochs
        spe = steps_per_epoch or cfg.steps_per_epoch
        pre = (pretrain_epochs if pretrain_epochs is not None
               else cfg.pretrain_epochs)
        t0 = time.time()
        k = max(1, min(cfg.steps_per_dispatch, spe))
        multi = ({phase: self.make_multi_step(pipeline, k, phase)
                  for phase in ("pretrain", "adversarial")} if k > 1 else {})
        start_step = g_state.step
        for epoch in range(start_step // spe, num_epochs):
            done = start_step % spe if epoch == start_step // spe else 0
            phase = "pretrain" if epoch < pre else "adversarial"
            agg: dict = {}

            def _log(metrics, epoch=epoch, phase=phase):
                agg.clear()
                agg.update({k_: float(v) for k_, v in metrics.items()})
                if log_cb:
                    log_cb({"epoch": epoch, "phase": phase,
                            "step": g_state.step,
                            "wall_s": round(time.time() - t0, 2), **agg})

            if phase == "pretrain":
                def single():
                    return self.pretrain_step(
                        g_state, pipeline(g_state.generator))[1]
                many = multi and (lambda: multi["pretrain"](g_state))
            else:
                def single():
                    return self.adversarial_step(
                        g_state, d_state, pipeline(g_state.generator))[2]
                many = multi and (lambda: multi["adversarial"](g_state,
                                                               d_state))
            dispatch_epoch(spe - done, k, cfg.log_every, single,
                           many or None, _log)
            print(f"epoch {epoch + 1}/{num_epochs} [{phase}] {agg}")
            if checkpointer is not None and (
                    (epoch + 1) % cfg.save_epochs == 0
                    or epoch + 1 == num_epochs):
                checkpointer.save(g_state)
                if d_checkpointer is not None:
                    # D's snapshots are keyed by G's step (D takes no step
                    # in the pretrain phase)
                    d_checkpointer.save(d_state, step=g_state.step)
            if epoch_hook is not None:
                epoch_hook(g_state, epoch)
        return g_state, d_state
