"""Checkpoints: full train state with resume, and the params-only export.

Port of ``sr/utils/checkpoint.py``.

* :class:`Checkpointer` keeps the last k full-state checkpoints of a run
  (model and optimizer state dicts, batch statistics included, the update
  count and the sampler generator's state) in the port's own format, one
  ``torch.save`` file per step, written to a temporary name and renamed,
  so a crash never leaves a torn checkpoint. It checks :func:`run_meta` before a resume, with the
  JAX package's keys and refusals. The JAX package's Orbax checkpoints are
  neither needed nor readable here. In a process group only the
  coordinator writes (checkpoints, ``run_meta.json``, the pruning of old
  steps), through temporary names unique to its process, and every
  process waits at a barrier after a save; every process restores. A
  checkpoint holds no topology, so one saved by W processes restores in
  any number.
* :func:`save_params`/:func:`load_params` write and read the params-only
  export in the JAX package's ``.npz`` format: one array per leaf of the
  nested params dict, keyed by its path joined with ``/`` under
  ``params/`` (and ``batch_stats/``), for example
  ``params/blocks_0/Conv_0/kernel`` holding an HWIO kernel. A file written
  by either package loads in the other, and a model trained by the port
  serves through ``sr_torch.infer.upscale``. ``sr_torch.utils.interop``
  moves such a dict into and out of a port module.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from sr_torch.parallel.multihost import barrier, is_coordinator

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


def run_meta(cfg) -> dict:
    """The schedule and topology constants a resumed run must not change:
    epoch recovery is ``step // steps_per_epoch``, the lr schedule is a
    function of the restored step, and a changed model cannot restore."""
    return {
        "model_name": cfg.model_name,
        "scale_factor": cfg.scale_factor,
        "num_channels": cfg.num_channels,
        "base_filter": cfg.base_filter,
        "num_resblocks": cfg.num_resblocks,
        "num_recursions": cfg.num_recursions,
        "res_scale": cfg.res_scale,
        "steps_per_epoch": cfg.steps_per_epoch,
        "pretrain_epochs": cfg.pretrain_epochs,
        "lr_halve_steps": cfg.lr_halve_steps,
    }


class Checkpointer:
    """Keep-last-k full-state checkpoints under ``directory``.

    ``meta`` (see :func:`run_meta`): if the directory already holds
    checkpoints saved under other meta values, construction fails instead
    of letting a resumed run shift its schedule; ``resume=False`` starts
    afresh and records the new values.
    """

    def __init__(self, directory: str, keep: int = 3,
                 meta: dict | None = None, resume: bool = True):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        if meta is not None:
            self._check_meta(meta, resume)

    def _check_meta(self, meta: dict, resume: bool = True) -> None:
        path = os.path.join(self.directory, "run_meta.json")
        if resume and os.path.exists(path) and self.latest_step() is not None:
            with open(path) as f:
                old = json.load(f)
            mismatch = {k: (old[k], v) for k, v in meta.items()
                        if k in old and old[k] != v}
            if mismatch:
                detail = "; ".join(
                    f"{k}: checkpoint={a!r} vs run={b!r}"
                    for k, (a, b) in sorted(mismatch.items()))
                raise ValueError(
                    f"resume-consistency check failed for {self.directory}: "
                    f"{detail}. Changing steps_per_epoch/pretrain_epochs "
                    "silently shifts the epoch schedule of a resumed run, "
                    "and a changed topology cannot restore; use a fresh "
                    "save_dir or pass --no_resume.")
        if not is_coordinator():
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, path)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}.pt")

    def steps(self) -> list[int]:
        """The steps of the checkpoints on disk, oldest first."""
        found = (_CKPT.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state, step: int | None = None) -> int:
        """Save ``state`` at ``state.step`` (or an explicit ``step`` id),
        then drop all but the newest ``keep`` checkpoints: the
        coordinator does, and every process of a group then waits for
        it, so a checkpoint that any process has passed is whole."""
        step = state.step if step is None else int(step)
        if is_coordinator():
            tree = {"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step,
                    "generator": (None if state.generator is None
                                  else state.generator.get_state())}
            path = self._path(step)
            tmp = path + f".{os.getpid()}.tmp"
            torch.save(tree, tmp)
            os.replace(tmp, path)
            for old in self.steps()[:-self.keep]:
                os.remove(self._path(old))
        barrier()
        return step

    def restore(self, like, step: int | None = None):
        """Load a checkpoint into ``like`` (a state of the same model, made
        by ``Trainer.init_state``) in place and return it; None if there is
        no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        tree = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        like.model.load_state_dict(tree["model"])
        like.optimizer.load_state_dict(tree["optimizer"])
        if like.generator is not None:
            like.generator.set_state(tree["generator"])
        like.step = int(tree["step"])
        return like


def _flatten(tree: dict, prefix: tuple) -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat["/".join(prefix + (k,))] = np.asarray(v)
    return flat


def save_params(path: str, params: Any, batch_stats: Any = None) -> None:
    """Write the nested ``params`` dict, and a batch-norm model's
    ``batch_stats``, as a flat .npz."""
    flat = _flatten(params, ("params",))
    if batch_stats is not None:
        flat.update(_flatten(batch_stats, ("batch_stats",)))
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_params(path: str) -> tuple[dict, dict | None]:
    """Inverse of :func:`save_params` → (params, batch_stats | None). A
    round-2 DRCN layout is moved to the current one
    (``sr_torch.models.drcn.migrate_params_r2``)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    params = tree.get("params", {})
    if "Scan_RecStep_0" in params:  # a round-2 DRCN export
        from sr_torch.models.drcn import migrate_params_r2

        params = migrate_params_r2(params)
    return params, tree.get("batch_stats")
