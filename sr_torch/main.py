"""The command line: ``python -m sr_torch.main --model_name SRCNN ...``

Port of ``sr/main.py``. The reference's flags (--model_name --num_channels
--scale_factor --crop_size --num_epochs --save_epochs --batch_size
--test_batch_size --lr --data_dir --save_dir --train_dataset --test_dataset
--num_threads) and the JAX package's later ones (--dtype --steps_per_epoch
--seed --mesh --no_resume --eval_only --vgg_weights_path --pretrain_epochs
--multi_scale --steps_per_dispatch --vdsr_clip_theta --random_scale_mode
--preshuffle_loss --self_ensemble --fast_eval --export --export_torch)
build the same ``SRConfig`` as ``sr.main.parse_args``. ``--use_pallas`` is
not taken: the port runs its kernels by device. ``--device`` (default
``cuda``) picks the device.

Flow, as the JAX package's: build the config → train with resumable
checkpoints (``<run_dir>/ckpt``, and ``ckpt_d`` for SRGAN's discriminator,
the port's own format with the JAX package's meta checks), logging to
``metrics.jsonl`` and TensorBoard where it imports, a sample render each
``save_epochs`` and ``loss.png`` → write ``<Model>_params.npz`` from the
live weights in the JAX package's format → evaluate with panels and SR
PNGs (optionally the D4 self-ensemble) → ``--export`` writes the serving
artifact ``<Model>_x<r>.pt2`` (``sr_torch.export``), ``--export_torch`` the
reference checkpoint ``<Model>_param.pkl`` (``sr_torch.utils.refckpt``).

cuDNN runs its deterministic algorithms for the whole of ``main``
(``sr_torch.utils.device.deterministic_cudnn``), so a resumed run ends with
the uninterrupted run's weights bit for bit on the card.

Several processes, one per card: start each with ``SR_COORDINATOR``
(``host:port`` or ``file:///shared/path``), ``SR_NUM_PROCESSES`` and
``SR_PROCESS_ID``, or through torchrun with ``SR_MULTIHOST=auto``; ``main``
brings the group up first (``sr_torch.parallel.multihost``, NCCL, or gloo
with ``--device cpu``), prints ``[multihost] process i/n`` as the JAX
package does, and drives ``cuda:<local card>``. ``--mesh`` (default: every
process on the ``data`` axis) reaches the trainers, which train on the
global batch over the group. Only the coordinator writes the run
directory: logs, sample renders, ``loss.png``, the params, the eval's
panels and images, the exports (checkpoints through the ``Checkpointer``);
the other processes wait at a barrier.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from sr_torch.data.datasets import get_test_set, get_training_set
from sr_torch.data.pipeline import PatchPipeline, build_patch_pipeline
from sr_torch.eval.panels import plot_loss, plot_test_result, save_img
from sr_torch.eval.runner import evaluate
from sr_torch.models.registry import available_models, get_spec
from sr_torch.parallel.multihost import (
    barrier, initialize_multihost, is_coordinator, process_count,
    process_index)
from sr_torch.utils.checkpoint import Checkpointer, run_meta, save_params
from sr_torch.utils.config import SRConfig
from sr_torch.utils.device import deterministic_cudnn, resolve_device
from sr_torch.utils.interop import to_jax_batch_stats, to_jax_params
from sr_torch.utils.logging import JSONLLogger, TensorBoardLogger


def parse_args(argv=None):
    """``(SRConfig, (eval_only, fast_eval, export, export_torch,
    self_ensemble, device))``: the JAX package's config and flags, and the
    device."""
    d = SRConfig()
    p = argparse.ArgumentParser(
        description="super-resolution on PyTorch and CUDA")
    p.add_argument("--model_name", default=d.model_name,
                   help=f"one of {available_models()}")
    p.add_argument("--num_channels", type=int, default=None,
                   help="1 (Y of YCbCr) or 3 (RGB); default per model")
    p.add_argument("--scale_factor", type=int, default=d.scale_factor)
    p.add_argument("--crop_size", type=int, default=d.crop_size)
    p.add_argument("--num_epochs", type=int, default=d.num_epochs)
    p.add_argument("--save_epochs", type=int, default=d.save_epochs)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--test_batch_size", type=int, default=d.test_batch_size)
    p.add_argument("--lr", type=float, default=None, help="default per model")
    p.add_argument("--data_dir", default=d.data_dir)
    p.add_argument("--save_dir", default=d.save_dir)
    p.add_argument("--train_dataset", default=d.train_dataset)
    p.add_argument("--test_dataset", default=d.test_dataset)
    p.add_argument("--num_threads", type=int, default=d.num_threads)
    p.add_argument("--dtype", default=d.dtype, choices=["float32", "bfloat16"])
    p.add_argument("--steps_per_epoch", type=int, default=d.steps_per_epoch)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--mesh", type=int, nargs="*", default=None,
                   help="mesh shape over the processes, e.g. --mesh 8 for "
                        "8-way data parallel (one process per card)")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--vgg_weights_path", default=None)
    p.add_argument("--pretrain_epochs", type=int, default=d.pretrain_epochs)
    p.add_argument("--multi_scale", type=int, nargs="*", default=None,
                   help="train one net on mixed factors, e.g. "
                        "--multi_scale 2 3 4 (VDSR/DRCN)")
    p.add_argument("--steps_per_dispatch", type=int,
                   default=d.steps_per_dispatch,
                   help=">1 queues K steps, with their batches drawn on the "
                        "device, before the host reads a metric")
    p.add_argument("--vdsr_clip_theta", type=float, default=d.vdsr_clip_theta,
                   help="VDSR adjustable-clip θ (0.4 = the reference recipe)")
    p.add_argument("--random_scale_mode", default=d.random_scale_mode,
                   choices=["item", "batch", "matrix"],
                   help="the sampler's scale draw (per sample by resize "
                        "matrices, per sample by branches, or per batch)")
    p.add_argument("--preshuffle_loss", nargs="?", const="last",
                   default=False, choices=["last", "full"],
                   help="train tail-shuffle models (ESPCN/EDSR) in "
                        "pre-shuffle space: the same loss and gradients; "
                        "'last' folds the final shuffle, 'full' every tail "
                        "conv through every shuffle (EDSR)")
    p.add_argument("--self_ensemble", action="store_true",
                   help="geometric self-ensemble at eval: average the 8 D4 "
                        "flip/rotation variants (8 forwards per image)")
    p.add_argument("--fast_eval", action="store_true",
                   help="on-device PSNR/SSIM, no image transfer or panels")
    p.add_argument("--export", action="store_true",
                   help="after train/eval, write a torch.export serving "
                        "artifact (<run_dir>/<Model>_x<r>.pt2)")
    p.add_argument("--export_torch", action="store_true",
                   help="after train/eval, also write a reference-format "
                        "checkpoint (<run_dir>/<Model>_param.pkl)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch "
                        "versions of the kernels")
    a = p.parse_args(argv)

    spec = get_spec(a.model_name)
    cfg = SRConfig(
        model_name=a.model_name,
        num_channels=(a.num_channels if a.num_channels is not None
                      else spec.default_channels),
        scale_factor=a.scale_factor, crop_size=a.crop_size,
        num_epochs=a.num_epochs, save_epochs=a.save_epochs,
        batch_size=a.batch_size, test_batch_size=a.test_batch_size,
        lr=a.lr, data_dir=a.data_dir, save_dir=a.save_dir,
        train_dataset=a.train_dataset, test_dataset=a.test_dataset,
        num_threads=a.num_threads, dtype=a.dtype,
        steps_per_epoch=a.steps_per_epoch, seed=a.seed,
        mesh_shape=tuple(a.mesh) if a.mesh else (),
        mesh_axes=("data", "spatial")[: len(a.mesh)] if a.mesh else ("data",),
        resume=not a.no_resume,
        vgg_weights_path=a.vgg_weights_path,
        pretrain_epochs=a.pretrain_epochs,
        scale_factors=tuple(a.multi_scale) if a.multi_scale else (),
        steps_per_dispatch=a.steps_per_dispatch,
        random_scale_mode=a.random_scale_mode,
        vdsr_clip_theta=a.vdsr_clip_theta,
        preshuffle_loss=a.preshuffle_loss,
    )
    return check_args(cfg), (a.eval_only, a.fast_eval, a.export,
                             a.export_torch, a.self_ensemble, a.device)


def check_args(cfg: SRConfig) -> SRConfig:
    """Validate + create save dirs. (reference: main.py:check_args)"""
    if cfg.crop_size % cfg.scale_factor:
        raise SystemExit("--crop_size must be divisible by --scale_factor")
    if cfg.num_epochs < 1 or cfg.batch_size < 1:
        raise SystemExit("--num_epochs and --batch_size must be ≥1")
    os.makedirs(_run_dir(cfg), exist_ok=True)
    return cfg


def _run_dir(cfg: SRConfig) -> str:
    return os.path.join(cfg.save_dir, f"{cfg.model_name}_x{cfg.scale_factor}")


def _color(cfg: SRConfig) -> str:
    return "rgb" if cfg.num_channels == 3 else "ycbcr"


def build_pipeline(cfg: SRConfig, spec, device="cuda") -> PatchPipeline:
    train_set = get_training_set(cfg.data_dir, cfg.train_dataset, _color(cfg))
    images = [train_set[i] for i in range(len(train_set))]
    return build_patch_pipeline(cfg, spec, images, device=device)


def evaluate_and_render(cfg: SRConfig, spec, predict_fn, out_dir: str,
                        fast: bool = False, device="cuda",
                        static_shapes: bool | None = None):
    """Evaluate ``predict_fn`` on the config's test set and, unless
    ``fast``, write each SR image (``images/<name>_sr.png``) and panel
    (``panels/<name>.png``). ``static_shapes`` defaults to the CLI's
    choice: one static tiled shape for folders, whose images differ in
    size, and a direct forward for the fixed-size synthetic and procedural
    sets. Returns the ``EvalResult``."""
    test_set = get_test_set(cfg.data_dir, cfg.test_dataset, _color(cfg))
    if static_shapes is None:
        static_shapes = cfg.test_dataset.lower() not in ("synthetic",
                                                         "procedural")
    # the synthetic set is RGB whatever the model's color space
    cs = "rgb" if cfg.test_dataset.lower() == "synthetic" else _color(cfg)
    res = evaluate(
        predict_fn, test_set, cfg.scale_factor, channels=cfg.num_channels,
        pre_upsample=spec.pre_upsample, dataset_name=cfg.test_dataset,
        keep_images=not fast, on_device_metrics=fast, color_space=cs,
        static_shapes=static_shapes, model_name=cfg.model_name,
        device=device,
    )
    for r in res.images:
        if r.sr is None:
            continue  # fast mode: metrics only
        save_img(r.sr, os.path.join(out_dir, "images", f"{r.name}_sr.png"), cs)
        plot_test_result(
            r.bicubic, r.sr, r.hr,
            os.path.join(out_dir, "panels", f"{r.name}.png"),
            psnr_bicubic=r.psnr_bicubic, psnr_sr=r.psnr_sr, color_space=cs,
        )
    return res


def run_eval(cfg: SRConfig, spec, predict_fn, out_dir: str, log=print,
             fast: bool = False, device="cuda") -> dict:
    """:func:`evaluate_and_render`, then log the summary line and return
    the summary."""
    s = evaluate_and_render(cfg, spec, predict_fn, out_dir, fast,
                            device).summary()
    log(f"[eval] {cfg.test_dataset} x{cfg.scale_factor}: "
        f"SR {s['psnr_sr']:.2f} dB vs bicubic {s['psnr_bicubic']:.2f} dB")
    return s


def _make_sample_hook(cfg: SRConfig, run_dir: str, predict, batch):
    """Per-epoch sample render (reference: each wrapper's train loop saves
    a test-image reconstruction every epoch)."""
    spec = get_spec(cfg.model_name)
    x = batch[spec.input_key()][:1]

    def hook(state, epoch):
        if (epoch + 1) % cfg.save_epochs:
            return
        sr = predict(state, x)[0].float().cpu().numpy()
        img = np.clip(np.round(sr * 255.0), 0, 255).astype(np.uint8)
        cs = _color(cfg)
        if img.shape[-1] == 1:
            cs = "rgb"
            img = np.repeat(img, 3, axis=-1)
        save_img(img, os.path.join(run_dir, "samples",
                                   f"epoch_{epoch + 1:04d}.png"), cs)

    return hook


class _NoLog:
    """The loggers of a process that writes nothing (not the
    coordinator)."""

    active = False

    def __call__(self, record: dict) -> None:
        pass

    def close(self) -> None:
        pass


def _device_flag(argv) -> str:
    """``--device`` alone, before the group is up (``parse_args`` makes the
    run directory)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    return pre.parse_known_args(argv)[0].device


@deterministic_cudnn()
def main(argv=None) -> int:
    # multi-process bootstrap (no-op unless SR_COORDINATOR/SR_MULTIHOST is
    # set — see sr_torch/parallel/multihost.py), before anything else
    cpu = torch.device(_device_flag(argv)).type == "cpu"
    group = initialize_multihost(backend="gloo" if cpu else None)
    if group:
        print(f"[multihost] process {process_index()}/{process_count()}")
    try:
        return _main(argv, group)
    finally:
        if group:
            dist.destroy_process_group()


def _main(argv, group: bool) -> int:
    cfg, (eval_only, fast_eval, export, export_torch, self_ensemble,
          device) = parse_args(argv)
    if group and torch.device(device).type == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    device = resolve_device(device)
    spec = get_spec(cfg.model_name)
    run_dir = _run_dir(cfg)
    writer = is_coordinator()
    if writer:
        jsonl = JSONLLogger(os.path.join(run_dir, "metrics.jsonl"))
        tb = TensorBoardLogger(os.path.join(run_dir, "logs"))
    else:
        jsonl = tb = _NoLog()
    print(f"model={cfg.model_name} scale=x{cfg.scale_factor} "
          f"device={device} dtype={cfg.dtype}")

    ck = Checkpointer(os.path.join(run_dir, "ckpt"),
                      keep=cfg.keep_checkpoints, meta=run_meta(cfg),
                      resume=cfg.resume)
    # the sample render's input: the first batch of a stream of its own,
    # so the training stream (the state's generator) is untouched
    sample_gen = torch.Generator(device=device).manual_seed(cfg.seed)

    if spec.is_gan:
        from sr_torch.train.gan import GANTrainer

        tr = GANTrainer(cfg, device=device)
        pipe = build_pipeline(cfg, spec, device)
        b0 = pipe(sample_gen)
        g_state, d_state = tr.init_states(cfg.seed)
        ck_d = Checkpointer(os.path.join(run_dir, "ckpt_d"),
                            keep=cfg.keep_checkpoints, meta=run_meta(cfg),
                            resume=cfg.resume)
        restored = None
        if cfg.resume:
            restored = ck.restore(g_state)
            if restored is not None:
                print(f"[resume] generator step {g_state.step}")
                ck_d.restore(d_state)
        if eval_only and restored is None:
            raise SystemExit(
                "--eval_only needs a trained checkpoint in "
                f"{os.path.join(run_dir, 'ckpt')}"
            )
        if not eval_only:
            g_state, d_state = tr.fit(
                g_state, d_state, pipe, checkpointer=ck,
                d_checkpointer=ck_d, log_cb=jsonl,
                epoch_hook=_make_sample_hook(
                    cfg, run_dir, lambda s, x: tr.predict(s, x), b0
                ) if writer else None,
            )
        model = g_state.model
        predict = lambda x: tr.predict(g_state, x)  # noqa: E731
    else:
        from sr_torch.train.trainer import Trainer

        tr = Trainer(cfg, device=device)
        pipe = build_pipeline(cfg, spec, device)
        b0 = pipe(sample_gen)
        state = tr.init_state(cfg.seed)
        print(f"params: {tr.num_params(state):,}")
        restored = None
        if cfg.resume:
            restored = ck.restore(state)
            if restored is not None:
                print(f"[resume] step {state.step}")
        if eval_only and restored is None:
            raise SystemExit(
                "--eval_only needs a trained checkpoint in "
                f"{os.path.join(run_dir, 'ckpt')} (refusing to evaluate "
                "randomly-initialized weights; reference wrappers refuse too)"
            )
        predict_fn = tr.make_predict_fn()
        if not eval_only:
            epoch_losses = []

            def log_cb(rec):
                jsonl(rec)
                if tb.active:
                    tb.scalar("loss", rec["loss"], rec["step"])
                if "loss" in rec:
                    epoch_losses.append(rec["loss"])

            state = tr.fit(
                state, pipe, checkpointer=ck, log_cb=log_cb,
                eval_hook=_make_sample_hook(
                    cfg, run_dir, lambda s, x: predict_fn(s.model, x), b0
                ) if writer else None,
            )
            if epoch_losses and writer:
                plot_loss(epoch_losses, os.path.join(run_dir, "loss.png"),
                          title=f"{cfg.model_name} x{cfg.scale_factor}")
        model = state.model
        predict = lambda x: predict_fn(model, x)  # noqa: E731

    if writer:  # the other processes wait for it at the barrier
        # the npz is written from the LIVE weights, so it always matches
        # the weights just trained or evaluated (a resumed run's checkpoint
        # can be newer than an npz written before; the export must not
        # ship stale params)
        save_params(os.path.join(run_dir, f"{cfg.model_name}_params.npz"),
                    to_jax_params(model), to_jax_batch_stats(model))
        if self_ensemble:
            from sr_torch.eval.ensemble import make_self_ensemble_predict

            # below run_eval's static tiling: a per-tile D4 ensemble is
            # exact (sr_torch/eval/ensemble.py)
            predict = make_self_ensemble_predict(predict)
            print("[eval] geometric self-ensemble enabled (8 forwards per "
                  "image)")
        summary = run_eval(cfg, spec, predict, run_dir, log=print,
                           fast=fast_eval, device=device)
        if self_ensemble:
            summary["self_ensemble"] = True
        jsonl({"event": "eval", **summary})
        if export:
            print(f"[export] {export_artifact(cfg, spec, run_dir, device)}")
        if export_torch:
            from sr_torch.utils.refckpt import export_reference_checkpoint

            pkl = os.path.join(run_dir, f"{cfg.model_name}_param.pkl")
            print("[export_torch] " + export_reference_checkpoint(
                cfg.model_name, model, pkl))
    barrier()
    jsonl.close()
    tb.close()
    return 0


def export_artifact(cfg: SRConfig, spec, run_dir: str, device="cuda") -> str:
    """Write the trained run's serving artifact (``sr_torch/export.py``).

    Input spatial size matches the training convention: crop_size for
    pre-upsample models (they receive the bicubic-upscaled image),
    crop_size/scale for raw-LR models. Batch is symbolic.
    """
    from sr_torch.export import export_predict, save_artifact

    params_path = os.path.join(run_dir, f"{cfg.model_name}_params.npz")
    if not os.path.exists(params_path):
        raise SystemExit(f"--export needs trained params at {params_path}")
    size = (cfg.crop_size if spec.pre_upsample
            else cfg.crop_size // cfg.scale_factor)
    exp = export_predict(
        cfg.model_name, params_path, cfg.scale_factor, cfg.num_channels,
        cfg.dtype, lr_size=size, device=device,
        # every topology knob: res_scale has no parameter and would
        # otherwise change the exported function without a trace
        cfg_overrides={"num_resblocks": cfg.num_resblocks,
                       "base_filter": cfg.base_filter,
                       "res_scale": cfg.res_scale,
                       "num_recursions": cfg.num_recursions},
    )
    out = os.path.join(run_dir, f"{cfg.model_name}_x{cfg.scale_factor}.pt2")
    save_artifact(out, exp)
    return out


if __name__ == "__main__":
    sys.exit(main())
