"""One shared trainer for the port's models.

Port of ``sr/train/trainer.py``. A :class:`Trainer` reads a
``ModelSpec`` (``sr_torch/models/registry.py``) and runs any model (for a
GAN spec, SRGAN, it trains the generator on the spec's content loss, as
the JAX ``Trainer`` does; ``sr_torch/train/gan.py`` runs the adversarial
recipe): the train step (forward, loss in float32, backward, the recipe's
optimizer update at its per-step learning rate, each parameter group's
scaled by its multiplier: the recipe labels the model it is handed, as
FSRCNN's puts its deconv tail at 0.1×), K steps per dispatch with
the batches drawn on the device, an eval-mode predict, and the epoch loop
with full-state checkpoints and exact resume.

Where the JAX trainer compiles K steps into one ``lax.scan`` program, the
port queues them eagerly: nothing in a step waits for the device (the
sampler draws from a generator on the device, the learning rate is a host
function of the host's step count, the metrics stay device tensors), so
the host runs ahead and reads the averaged metrics once per dispatch.

Training runs the convs through cuDNN and the pixel shuffle through its
kernel (with the plain backward of ``sr_torch/kernels/depth_to_space.py``);
``predict`` runs without grad in eval mode, so EDSR's body takes the fused
resblock kernel, DRCN and LapSRN return their last output only (in
training, the tuple that their losses take: DRCN's recursions, LapSRN's
levels, whose losses appear in the metrics as ``loss_x2``, ``loss_x4``) and
batch norms (SRResNet) use their running statistics. A train step's forward runs in
train mode: batch norms normalize with the batch's statistics and update
their running ones, once a step. A recipe's gradient clip (VDSR) reports
its scale as the ``clip_scale`` metric. Entry points run on
``device="cuda"`` unless the caller asks for the CPU.

Data parallelism over processes (``cfg.mesh_shape``, one process per card,
``sr_torch/parallel``) has the JAX trainer's semantics, a step on the
global batch: every process draws the same global batch from its
generator and keeps its rows along the mesh's ``data`` axis (a ``(D, S)``
mesh of D·S processes splits the batch D ways), the model runs under
``DistributedDataParallel`` (its gradients, and so VDSR's clip, averaged
over the group; batch norms' statistics over the global batch), and the
metrics are the global batch's means. The sampler's generator then stays
equal on every process, and a checkpoint restores in any number of
processes.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import numpy as np
import torch

from sr_torch.kernels.depth_to_space import space_to_depth
from sr_torch.models.registry import ModelSpec, get_spec
from sr_torch.parallel.mesh import Mesh, batch_slice, make_mesh, replicate
from sr_torch.parallel.multihost import global_means
from sr_torch.train.loop import dispatch_epoch
from sr_torch.train.state import TrainState
from sr_torch.utils.config import SRConfig
from sr_torch.utils.device import resolve_device


class Trainer:
    """Shared train/eval runner for one ModelSpec, on one device or data
    parallel over the processes of ``mesh`` (default: ``cfg.mesh_shape``
    over the processes present, which it must match)."""

    def __init__(self, cfg: SRConfig, spec: ModelSpec | None = None,
                 device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        self.cfg = cfg
        self.spec = spec or get_spec(cfg.model_name)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape,
                                                            cfg.mesh_axes)
        self.device = resolve_device(device)
        self._in_key = self.spec.input_key()
        # pre-shuffle loss (cfg.preshuffle_loss): the same refusals as the
        # JAX trainer, so an A/B never records a silent fallback
        mode = cfg.preshuffle_loss
        has_any = (self.spec.preshuffle_train is not None
                   or self.spec.preshuffle_train_full is not None)
        if mode and not has_any:
            raise ValueError(
                f"{self.spec.name}: preshuffle_loss requested but the spec "
                "defines no pre-shuffle fold (only tail-shuffle models "
                "support it — ESPCN 'last', EDSR 'last'/'full')")
        if mode and self.spec.has_batchnorm:
            raise ValueError(
                f"{self.spec.name}: preshuffle_loss does not support "
                "batchnorm models (batch stats would not advance)")
        if mode == "full" and self.spec.preshuffle_train_full is None:
            raise ValueError(
                f"{self.spec.name}: preshuffle_loss='full' requested but the "
                "spec defines no full-tail fold (preshuffle_train_full); use "
                "preshuffle_loss='last'")
        if mode and mode != "full" and self.spec.preshuffle_train is None:
            raise ValueError(
                f"{self.spec.name}: preshuffle_loss={mode!r} requested but "
                "the spec defines no last-stage fold (preshuffle_train)")
        self._preshuffle = "full" if mode == "full" else ("last" if mode
                                                          else None)

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int) -> TrainState:
        """A fresh state on the trainer's device: the model's weights drawn
        from ``seed`` (flax's initializers; the numbers differ from JAX's),
        the recipe's optimizer, step 0, and the sampler's generator on the
        device, seeded from an independent stream of ``seed``. In a
        process group, the model's DDP replica too: every process draws
        the same weights and generator from ``seed``."""
        w_seed, g_seed = np.random.SeedSequence(seed).generate_state(2)
        model = self.spec.make_model(
            self.cfg, torch.Generator().manual_seed(int(w_seed)))
        model = model.to(self.device)
        tx = self.spec.make_tx(self.cfg)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(g_seed))
        return TrainState(model=model, optimizer=tx.init(model),
                          tx=tx, generator=generator,
                          replica=(replicate(model, self._output)
                                   if self.mesh.distributed else None))

    def num_params(self, state: TrainState) -> int:
        return sum(p.numel() for p in state.model.parameters())

    # -- the step -----------------------------------------------------------

    def _output(self, model, x: torch.Tensor):
        """The train-mode output the loss reads: the model's, or in a
        pre-shuffle mode its fold's, in pre-shuffle space."""
        if self._preshuffle == "full":
            return self.spec.preshuffle_train_full(model)[0](x)
        if self._preshuffle == "last":
            return self.spec.preshuffle_train(model)[0](x)
        return model(x)

    def loss_fn(self, model, batch: dict, step: int, replica=None
                ) -> tuple[torch.Tensor, dict]:
        """The differentiable loss of ``model`` on ``batch`` at ``step``:
        ``(loss, metrics)``. The model reads the spec's input (``bc`` for a
        pre-upsample model) and its output, a tuple for DRCN in training
        mode, goes to the spec's loss with the schedule context at
        ``step``. In a pre-shuffle mode the output stays in pre-shuffle
        space and ``hr`` moves there instead. ``replica``: the model's DDP
        replica, which then computes the output."""
        x = batch[self._in_key]
        out = (replica or functools.partial(self._output, model))(x)
        if self._preshuffle == "full":
            target_fn = self.spec.preshuffle_train_full(model)[1]
            batch = {**batch, "hr": target_fn(batch["hr"])}
        elif self._preshuffle == "last":
            r_last = self.spec.preshuffle_train(model)[1]
            batch = {**batch, "hr": space_to_depth(batch["hr"], r_last)}
        return self.spec.loss(out, batch, self.spec.schedule(self.cfg, step))

    def train_step(self, state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        """One update of ``state`` (in place, and returned) on the global
        ``batch`` (this process's rows of it in a process group); the
        metrics are device tensors, the global batch's."""
        batch = batch_slice(batch, self.mesh)
        state.model.train()
        with torch.enable_grad():
            loss, metrics = self.loss_fn(state.model, batch, state.step,
                                         state.replica)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        clip_scale = state.tx.step(state.optimizer, state.step)
        state.step += 1
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in metrics.items()}}
        metrics = global_means(metrics)
        if clip_scale is not None:  # the recipe's gradient clip (VDSR);
            # read from the averaged gradients, so already the global one
            metrics["clip_scale"] = clip_scale
        return state, metrics

    def make_multi_step(self, pipeline, k: int) -> Callable:
        """K train steps in one dispatch, each batch drawn on the device
        with ``pipeline(state.generator)``: ``fn(state) -> metrics``, the
        state updated in place and the metrics averaged over the K steps.
        Equal to K single steps on K batches drawn from the same
        generator."""

        def run(state):
            logs = [self.train_step(state, pipeline(state.generator))[1]
                    for _ in range(k)]
            return {name: torch.stack([m[name] for m in logs]).mean()
                    for name in logs[0]}

        return run

    # -- inference ----------------------------------------------------------

    def predict(self, state: TrainState, x: torch.Tensor) -> torch.Tensor:
        return self.make_predict_fn()(state.model, x)

    def make_predict_fn(self) -> Callable:
        """Eval-mode forward without grad: ``fn(model, x) -> sr``."""

        @torch.no_grad()
        def fn(model, x):
            model.eval()
            return model(x)

        return fn

    # -- the fit loop ---------------------------------------------------------

    def fit(
        self,
        state: TrainState,
        pipeline,
        num_epochs: int | None = None,
        steps_per_epoch: int | None = None,
        checkpointer=None,
        eval_hook: Callable[[TrainState, int], dict] | None = None,
        log_cb: Callable[[dict], None] | None = None,
    ) -> TrainState:
        """Epoch loop: sample → step → log → checkpoint → eval.

        ``pipeline`` makes a batch from a generator
        (``sr_torch/data/pipeline.py``); batches come from the state's
        generator, so a run restored from a checkpoint continues the
        stream. The host reads metrics back only at log points.
        """
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_epochs
        spe = steps_per_epoch or cfg.steps_per_epoch
        t0 = time.time()
        k = max(1, min(cfg.steps_per_dispatch, spe))
        multi = self.make_multi_step(pipeline, k) if k > 1 else None

        # Resume arithmetic: a restored state may land mid-epoch; the first
        # resumed epoch then runs only the remaining steps, so the run ends
        # at exactly num_epochs·spe. The batch stream continues exactly:
        # both paths draw one batch per step from the state's generator.
        start_step = state.step
        for epoch in range(start_step // spe, num_epochs):
            done = start_step % spe if epoch == start_step // spe else 0
            losses = []

            def _log(metrics):
                losses.append(float(metrics["loss"]))
                if log_cb:
                    log_cb({"epoch": epoch, "step": state.step,
                            "wall_s": round(time.time() - t0, 2),
                            **{k_: float(v) for k_, v in metrics.items()}})

            dispatch_epoch(
                spe - done, k, cfg.log_every,
                lambda: self.train_step(state, pipeline(state.generator))[1],
                (lambda: multi(state)) if multi is not None else None, _log)
            avg = sum(losses) / max(len(losses), 1)
            print(f"epoch {epoch + 1}/{num_epochs} avg_loss={avg:.6f}")
            if checkpointer is not None and (
                    (epoch + 1) % cfg.save_epochs == 0
                    or epoch + 1 == num_epochs):
                checkpointer.save(state)
            if eval_hook is not None:
                eval_hook(state, epoch)
        return state
