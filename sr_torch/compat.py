"""Reference-style per-model wrapper classes.

Port of ``sr/compat.py``. The reference exposes one wrapper class per model
(``SRCNN(args)``, ``VDSR(args)``, …), each with ``load_dataset() /
train() / test() / save_model() / load_model()`` (reference: every model
file's wrapper, e.g. srcnn.py:SRCNN). Users of the reference keep that
calling convention; underneath, everything delegates to the port's shared
trainer, its on-device patch pipeline and the eval harness.

``args`` is anything attribute-shaped (an ``argparse.Namespace``, an
``SRConfig``, or a plain object) carrying the reference's flag names;
missing attributes fall back to the model's defaults. The device is
``args.device`` or the ``device`` keyword, ``cuda`` unless the caller asks
for the CPU.
"""

from __future__ import annotations

import os
from typing import Any

from sr_torch.data.datasets import get_test_set
from sr_torch.data.pipeline import PatchPipeline
from sr_torch.eval.panels import plot_loss
from sr_torch.eval.runner import EvalResult
from sr_torch.main import build_pipeline, evaluate_and_render
from sr_torch.models.registry import get_spec
from sr_torch.train.trainer import Trainer
from sr_torch.utils.checkpoint import (
    Checkpointer, load_params, run_meta, save_params)
from sr_torch.utils.config import SRConfig
from sr_torch.utils.device import deterministic_cudnn, resolve_device
from sr_torch.utils.interop import (
    from_jax_params, to_jax_batch_stats, to_jax_params)


def _cfg_from_args(model_name: str, args: Any) -> SRConfig:
    spec = get_spec(model_name)
    cfg = SRConfig(model_name=model_name)
    kw = {}
    for f in (
        "num_channels scale_factor crop_size num_epochs save_epochs "
        "batch_size test_batch_size lr data_dir save_dir train_dataset "
        "test_dataset num_threads dtype steps_per_epoch seed"
    ).split():
        if hasattr(args, f) and getattr(args, f) is not None:
            kw[f] = getattr(args, f)
    kw.setdefault("num_channels", spec.default_channels)
    return cfg.replace(**kw)


class ModelWrapper:
    """Reference-shaped train/test wrapper around the shared trainer."""

    MODEL_NAME: str = ""

    def __init__(self, args: Any = None, device: str | None = None):
        args = args if args is not None else SRConfig(
            model_name=self.MODEL_NAME)
        self.cfg = (
            args if isinstance(args, SRConfig)
            else _cfg_from_args(self.MODEL_NAME, args)
        ).replace(model_name=self.MODEL_NAME)
        self.device = resolve_device(
            device or getattr(args, "device", None) or "cuda")
        self.spec = get_spec(self.MODEL_NAME)
        self.trainer = Trainer(self.cfg, device=self.device)
        self.state = None
        self.train_losses: list[float] = []

    # -- reference API ---------------------------------------------------

    def load_dataset(self, dataset: str = "train"):
        """(reference: wrapper.load_dataset) → pipeline or test set."""
        cfg = self.cfg
        if dataset == "train":
            return build_pipeline(cfg, self.spec, self.device)
        return get_test_set(cfg.data_dir, cfg.test_dataset,
                            "rgb" if cfg.num_channels == 3 else "ycbcr")

    @deterministic_cudnn()
    def train(self) -> list[float]:
        """Full training run (resume-capable). Returns per-log losses."""
        cfg = self.cfg
        pipe: PatchPipeline = self.load_dataset("train")
        state = self.trainer.init_state(cfg.seed)
        ck = Checkpointer(self._ckpt_dir(), keep=cfg.keep_checkpoints,
                          meta=run_meta(cfg), resume=cfg.resume)
        if cfg.resume:
            ck.restore(state)
        losses = []

        def log_cb(rec):
            losses.append(rec["loss"])

        state = self.trainer.fit(state, pipe, checkpointer=ck, log_cb=log_cb)
        self.state = state
        self.train_losses = losses
        self.save_model()
        plot_loss(losses, os.path.join(self._run_dir(), "loss.png"),
                  title=f"{self.MODEL_NAME} x{cfg.scale_factor}")
        return losses

    def test(self) -> EvalResult:
        """PSNR eval + rendered panels. Requires a trained/loaded model.

        (reference: wrapper.test — refuses to run without a checkpoint.)
        """
        if self.state is None and not self.load_model():
            raise RuntimeError(
                f"no trained parameters for {self.MODEL_NAME}; run train() "
                f"or place {self._params_path()}"
            )
        predict_fn = self.trainer.make_predict_fn()
        model = self.state.model
        # the reference wrappers tile every set but the synthetic one
        return evaluate_and_render(
            self.cfg, self.spec, lambda x: predict_fn(model, x),
            self._run_dir(), device=self.device,
            static_shapes=self.cfg.test_dataset.lower() != "synthetic")

    def save_model(self) -> str:
        """(reference: wrapper.save_model) The params in the JAX package's
        ``<Model>_params.npz``; ``sr_torch.utils.refckpt`` writes the
        reference's own ``<Model>_param.pkl``."""
        if self.state is None:
            raise RuntimeError(f"nothing to save: {self.MODEL_NAME} has "
                               "neither trained nor loaded")
        path = self._params_path()
        model = self.state.model
        save_params(path, to_jax_params(model), to_jax_batch_stats(model))
        return path

    def load_model(self) -> bool:
        """(reference: wrapper.load_model → bool)

        Looks for ``<Model>_params.npz`` (either package's) first, then for
        a reference-style ``<Model>_param.pkl`` (``torch.save(state_dict)``
        — reference: wrapper.save_model), which
        ``sr_torch.utils.refckpt.load_reference_checkpoint`` imports
        weight for weight, so checkpoints trained with the reference
        collection load directly.
        """
        path = self._params_path()
        pkl = os.path.join(self._run_dir(), f"{self.MODEL_NAME}_param.pkl")
        if not os.path.exists(path) and not os.path.exists(pkl):
            return False
        state = self.trainer.init_state(self.cfg.seed)
        if os.path.exists(path):
            params, bs = load_params(path)
            from_jax_params(state.model, params, bs)
        else:
            from sr_torch.utils.refckpt import load_reference_checkpoint

            load_reference_checkpoint(self.MODEL_NAME, state.model, pkl)
        self.state = state
        return True

    # -- internals ---------------------------------------------------------

    def _run_dir(self) -> str:
        d = os.path.join(
            self.cfg.save_dir, f"{self.MODEL_NAME}_x{self.cfg.scale_factor}"
        )
        os.makedirs(d, exist_ok=True)
        return d

    def _ckpt_dir(self) -> str:
        return os.path.join(self._run_dir(), "ckpt")

    def _params_path(self) -> str:
        return os.path.join(self._run_dir(), f"{self.MODEL_NAME}_params.npz")


class SRCNN(ModelWrapper):
    MODEL_NAME = "SRCNN"


class VDSR(ModelWrapper):
    MODEL_NAME = "VDSR"


class DRCN(ModelWrapper):
    MODEL_NAME = "DRCN"


class ESPCN(ModelWrapper):
    MODEL_NAME = "ESPCN"


class FSRCNN(ModelWrapper):
    MODEL_NAME = "FSRCNN"


class EDSR(ModelWrapper):
    MODEL_NAME = "EDSR"


class SRResNet(ModelWrapper):
    MODEL_NAME = "SRResNet"


class LapSRN(ModelWrapper):
    MODEL_NAME = "LapSRN"


class SRGAN(ModelWrapper):
    """GAN wrapper: train() runs the two-phase GANTrainer; test() and
    load_model() go through the generator, which is the model the shared
    Trainer builds for SRGAN."""

    MODEL_NAME = "SRGAN"

    def __init__(self, args: Any = None, device: str | None = None):
        super().__init__(args, device)
        from sr_torch.train.gan import GANTrainer

        self.gan = GANTrainer(self.cfg, device=self.device)

    @deterministic_cudnn()
    def train(self) -> list[float]:
        cfg = self.cfg
        pipe = self.load_dataset("train")
        g, d = self.gan.init_states(cfg.seed)
        ck = Checkpointer(self._ckpt_dir(), keep=cfg.keep_checkpoints,
                          meta=run_meta(cfg), resume=cfg.resume)
        # as sr_torch/main.py: D has its own checkpointer, so a resumed run
        # continues against the trained discriminator, not a fresh one
        ck_d = Checkpointer(self._ckpt_dir() + "_d",
                            keep=cfg.keep_checkpoints, meta=run_meta(cfg),
                            resume=cfg.resume)
        if cfg.resume and ck.restore(g) is not None:
            ck_d.restore(d)
        losses = []
        g, d = self.gan.fit(
            g, d, pipe, checkpointer=ck, d_checkpointer=ck_d,
            log_cb=lambda rec: losses.append(
                rec.get("g_loss", rec.get("g_content_loss"))),
        )
        self.state = g
        self.save_model()
        return losses
