"""One process of a multi-process ``sr_torch`` run on the CPU (gloo), for
``tests/test_torch_parallel_*.py``.

    python tests/test_torch_parallel_worker.py JOB RANK WORLD INIT_FILE IN OUT

joins a group of WORLD processes through ``sr_torch.parallel.multihost``
(rendezvous in the file INIT_FILE, a 60 s timeout), runs JOB on the inputs
in IN (a ``torch.save``d dict the test wrote) and writes its results to OUT.
The jobs import no JAX; the tests compare what they write with the JAX
package. WORLD 0 runs the job without a group (the one-process run).
The module holds no tests itself: :func:`run` (:func:`start`,
:func:`finish`) launches the processes for the tests that do.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
import uuid
from pathlib import Path

import torch

torch.set_num_threads(1)

from sr_torch.parallel.multihost import initialize_multihost  # noqa: E402
from sr_torch.utils.config import SRConfig  # noqa: E402
from sr_torch.utils.interop import (  # noqa: E402
    from_jax_params, to_jax_batch_stats, to_jax_params)


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def trainer(inp: dict) -> dict:
    """Single steps on the given global batches from the given params, then
    a K-step dispatch from a fresh state on batches drawn on the device."""
    from sr_torch.data.pipeline import PatchPipeline
    from sr_torch.train.trainer import Trainer

    tr = Trainer(SRConfig(**inp["cfg"]), device="cpu")
    state = tr.init_state(0)
    from_jax_params(state.model, inp["params"])
    steps, after = [], []
    for b in inp["batches"]:
        steps.append(_floats(tr.train_step(state, _batch(b))[1]))
        after.append(to_jax_params(state.model))
    out = {"steps": steps, "params": after[-1], "params_1": after[0],
           "step": state.step}
    if "corpus" in inp:
        pipe = PatchPipeline(inp["corpus"], crop_size=inp["cfg"]["crop_size"],
                             scale_factor=inp["cfg"]["scale_factor"],
                             batch_size=inp["cfg"]["batch_size"], channels=3,
                             augment=False, random_scale=False, device="cpu")
        state = tr.init_state(2)
        from_jax_params(state.model, inp["params"])
        metrics = tr.make_multi_step(pipe, inp["k"])(state)
        out["multi"] = {"metrics": _floats(metrics),
                        "params": to_jax_params(state.model),
                        "step": state.step,
                        "generator": state.generator.get_state()}
    return out


def gan(inp: dict) -> dict:
    """A pretrain step, then an adversarial step, from the given G and D."""
    from sr_torch.train.gan import GANTrainer

    tr = GANTrainer(SRConfig(**inp["cfg"]), device="cpu")
    g, d = tr.init_states(0)
    from_jax_params(g.model, inp["g_params"], inp["g_stats"])
    from_jax_params(d.model, inp["d_params"], inp["d_stats"])
    probe = torch.from_numpy(inp["probe"])
    b0, b1 = inp["batches"]
    out = {"pretrain": _floats(tr.pretrain_step(g, _batch(b0))[1])}
    out["pretrain_fn"] = tr.predict(g, probe).numpy()
    out["adversarial"] = _floats(tr.adversarial_step(g, d, _batch(b1))[2])
    out["fn"] = tr.predict(g, probe).numpy()
    out["g_stats"], out["d_stats"] = (to_jax_batch_stats(g.model),
                                      to_jax_batch_stats(d.model))
    out["steps"] = (g.step, d.step)
    return out


def fit(inp: dict) -> dict:
    """``Trainer.fit`` with a checkpointer in ``inp['ckpt']``, resuming from
    it; with ``inp['kill_after']``, process 1 SIGKILLs itself once the
    epoch with that index has saved."""
    from sr_torch.data.pipeline import PatchPipeline
    from sr_torch.parallel.multihost import process_index
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.checkpoint import Checkpointer, run_meta

    cfg = SRConfig(**inp["cfg"])
    tr = Trainer(cfg, device="cpu")
    pipe = PatchPipeline(inp["corpus"], crop_size=cfg.crop_size,
                         scale_factor=cfg.scale_factor,
                         batch_size=cfg.batch_size, channels=1,
                         augment=False, random_scale=False, device="cpu")
    state = tr.init_state(cfg.seed)
    ck = Checkpointer(inp["ckpt"], meta=run_meta(cfg))
    restored = ck.restore(state) is not None

    def hook(state, epoch):
        if epoch == inp.get("kill_after") and process_index() == 1:
            os.kill(os.getpid(), signal.SIGKILL)

    tr.fit(state, pipe, checkpointer=ck, eval_hook=hook)
    return {"params": to_jax_params(state.model), "step": state.step,
            "restored": restored}


def sharded(inp: dict) -> dict:
    """``sharded_predict`` of the given model on the given image, f32 and
    static int8 with the given scales, on a ``(data, spatial)`` mesh and on
    the default 1-D one."""
    from sr_torch.eval.tiling import sharded_predict
    from sr_torch.models.registry import get_spec
    from sr_torch.parallel.mesh import make_mesh
    from sr_torch.quant import quantized_apply

    cfg = SRConfig(**inp["cfg"])
    model = get_spec(cfg.model_name).make_model(cfg).eval()
    from_jax_params(model, inp["params"])
    x = torch.from_numpy(inp["x"])
    routes = {"exact": model,
              "static": lambda z: quantized_apply(model, z, inp["scales"])}
    meshes = {"data_spatial": make_mesh((1, 2), ("data", "spatial")),
              "default": make_mesh()}
    with torch.no_grad():
        return {(route, m): sharded_predict(fn, x, mesh,
                                            halo=inp["halo"]).numpy()
                for route, fn in routes.items()
                for m, mesh in meshes.items()}


def cli(inp: dict) -> dict:
    """``sr_torch.main.main(argv)`` with TensorBoard off (importing it
    loads TensorFlow where that is installed), recording every file this
    process opens for writing under ``inp['watch']``."""
    import builtins

    from sr_torch import main as cli_main

    class _Off:
        active = False

        def __init__(self, *a):
            pass

        def close(self):
            pass

    written, real_open = [], builtins.open

    def watched_open(file, mode="r", *a, **kw):
        path = os.path.abspath(os.fspath(file)) if isinstance(
            file, (str, os.PathLike)) else ""
        if set(mode) & set("wax+") and path.startswith(inp["watch"]):
            written.append(os.path.relpath(path, inp["watch"]))
        return real_open(file, mode, *a, **kw)

    cli_main.TensorBoardLogger = _Off
    builtins.open = watched_open
    try:
        rc = cli_main.main(inp["argv"])
    finally:
        builtins.open = real_open
    return {"rc": rc, "written": written}


JOBS = {"trainer": trainer, "gan": gan, "fit": fit, "sharded": sharded,
        "cli": cli}

ROOT = Path(__file__).resolve().parents[1]


def start(job: str, inp: dict, tmp, world: int = 2,
          env: dict | None = None) -> list:
    """Start JOB in ``world`` processes (one without a group for 0), each
    with a rendezvous file, inputs and outputs of its own under ``tmp``.
    ``env`` adds to each child's environment (a callable: of its rank)."""
    tmp, tag = Path(tmp), f"{job}_{uuid.uuid4().hex[:8]}"
    inp_path = tmp / f"{tag}.in.pt"
    torch.save(inp, inp_path)
    runs = []
    for rank in range(max(world, 1)):
        out = tmp / f"{tag}.{rank}.out.pt"
        extra = env(rank) if callable(env) else (env or {})
        child_env = {**os.environ, "PYTHONPATH": str(ROOT),
                     "OMP_NUM_THREADS": "1", **extra}
        runs.append((subprocess.Popen(
            [sys.executable, __file__, job, str(rank), str(world),
             str(tmp / f"{tag}.rendezvous"), str(inp_path), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, env=child_env), out))
    return runs


def finish(runs: list, timeout: float = 240) -> list:
    """Wait for every process of ``runs`` (at most ``timeout`` s in all),
    killing all on a timeout: ``[(returncode, log, output or None)]``."""
    deadline = time.monotonic() + timeout
    results = []
    try:
        for proc, out in runs:
            log = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0]
            results.append((proc.returncode, log,
                            torch.load(out, weights_only=False)
                            if proc.returncode == 0 else None))
    finally:
        for proc, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return results


def run(job: str, inp: dict, tmp, world: int = 2, env=None,
        timeout: float = 240) -> list:
    """:func:`start`, then :func:`finish`; every process must succeed.
    Returns their outputs."""
    results = finish(start(job, inp, tmp, world, env), timeout)
    for rank, (rc, log, _) in enumerate(results):
        assert rc == 0, f"{job} process {rank} exited {rc}:\n{log[-4000:]}"
    return [out for _, _, out in results]


def main() -> int:
    job, rank, world, init_file, inp_path, out_path = sys.argv[1:7]
    inp = torch.load(inp_path, weights_only=False)
    if int(world) and job != "cli":  # the CLI brings its group up itself
        initialize_multihost(f"file://{init_file}", int(world), int(rank),
                             backend="gloo", timeout_s=60)
    out = JOBS[job](inp)
    torch.save(out, out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
