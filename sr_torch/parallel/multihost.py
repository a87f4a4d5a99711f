"""Multi-process initialization, the collectives the port runs, and the
rows a process feeds.

Port of ``sr/parallel/multihost.py``. The JAX package scales out with one
``jax.distributed`` job whose processes form one global mesh; the port runs
one process per card, joined by ``torch.distributed``:

* :func:`initialize_multihost` brings the process group up: explicit
  arguments, then the ``SR_COORDINATOR`` / ``SR_NUM_PROCESSES`` /
  ``SR_PROCESS_ID`` environment, then, with ``SR_MULTIHOST=auto``, the
  launcher's environment (torchrun's ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), the port's form of
  JAX's "the runtime gives the topology". ``SR_COORDINATOR`` is
  ``host:port``, as in JAX, or a rendezvous URL that torch takes
  (``file:///shared/path``, ``tcp://host:port``). NCCL joins CUDA devices,
  gloo the CPU; ``backend=`` is the only other route. The group has a
  finite timeout (``SR_TIMEOUT_S``, default 30 minutes), so a dead peer
  fails a run instead of hanging it.
* The port's own collectives are ``all_reduce`` and ``barrier`` (and
  DDP's broadcast and all-reduce), the three that gloo runs on CUDA
  tensors too, so one code path runs under NCCL across cards and under
  gloo on the CPU or several processes on one card.
  :func:`mean_over_replicas` is the mean over the group with its gradient
  (a batch norm's statistics); :func:`all_reduce_mean` the same without.
* :func:`local_rows` is the counterpart of ``host_local_to_global``: the
  rows of the global batch a process feeds, along the mesh's ``data``
  axis.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

#: seconds a collective waits for a peer before the run fails
DEFAULT_TIMEOUT_S = 1800.0


def multihost_env() -> dict | None:
    """Read SR_COORDINATOR/SR_NUM_PROCESSES/SR_PROCESS_ID, or None."""
    addr = os.environ.get("SR_COORDINATOR")
    if not addr:
        return None
    return {
        "coordinator_address": addr,
        "num_processes": int(os.environ.get("SR_NUM_PROCESSES", "1")),
        "process_id": int(os.environ.get("SR_PROCESS_ID", "0")),
    }


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def _local_device(process_id: int | None, local_device_ids) -> int:
    """The card this process drives: the one id it was given, else the
    launcher's ``LOCAL_RANK``, else its process id modulo the cards on the
    host (one process a card)."""
    if local_device_ids is not None:
        ids = list(local_device_ids)
        if len(ids) != 1:
            raise ValueError(
                f"local_device_ids={ids}: the port runs one device a "
                "process; launch one process per card")
        return int(ids[0])
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return int(process_id or 0) % torch.cuda.device_count()


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    backend: str | None = None,
    timeout_s: float | None = None,
) -> bool:
    """Bring up the process group of a multi-process run.

    Resolution order: explicit args → SR_* environment variables → the
    launcher's environment when requested via ``SR_MULTIHOST=auto``.
    Returns True when ``torch.distributed.init_process_group`` was called,
    False for the (default) single-process no-op. Where CUDA is present,
    the process's card (``local_device_ids``, ``LOCAL_RANK`` or the
    process id modulo the cards) becomes the current device, so ``cuda``
    means it. ``backend``: NCCL where CUDA is present, else gloo.
    """
    if dist.is_initialized():
        raise RuntimeError("initialize_multihost: the process group is "
                           "already initialized")
    if coordinator_address is None:
        env = multihost_env()
        if env is not None:
            coordinator_address = env["coordinator_address"]
            num_processes = num_processes or env["num_processes"]
            process_id = process_id if process_id is not None else env["process_id"]
        elif os.environ.get("SR_MULTIHOST", "") != "auto":
            return False
    elif num_processes is None or process_id is None:
        raise ValueError("initialize_multihost: an explicit "
                         "coordinator_address needs num_processes and "
                         "process_id")
    if timeout_s is None:
        timeout_s = float(os.environ.get("SR_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda:
        torch.cuda.set_device(_local_device(process_id, local_device_ids))
    kwargs = {"backend": backend,
              "timeout": datetime.timedelta(seconds=timeout_s)}
    if coordinator_address is None:  # SR_MULTIHOST=auto: the launcher's
        kwargs["init_method"] = "env://"
    else:
        kwargs.update(init_method=_init_method(coordinator_address),
                      world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(**kwargs)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on the process that should write checkpoints/logs/renders."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every process of the group; a no-op without one."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the group's processes (``t`` itself without
    a group), out of place and without a gradient."""
    if not dist.is_initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out / dist.get_world_size()


def global_means(metrics: dict) -> dict:
    """Scalar metrics averaged over the group in one ``all_reduce``: over
    equal shards, the global batch's means (unchanged without a group)."""
    if not dist.is_initialized():
        return metrics
    return dict(zip(metrics, all_reduce_mean(
        torch.stack(list(metrics.values())))))


class _MeanOverReplicas(torch.autograd.Function):
    """y = mean of x over the group. The backward of a mean over the
    processes is the mean of the output gradients over them: each process
    holds ∂L_r/∂y for its own loss, and DDP averages the parameter
    gradients that follow, so the sum over processes of what flows back
    is ∂(mean L_r)/∂x, the global batch's gradient."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_mean(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_mean(grad)


def mean_over_replicas(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the group's processes, differentiable (one
    ``all_reduce`` forward, one backward); ``t`` itself without a group."""
    if not dist.is_initialized():
        return t
    return _MeanOverReplicas.apply(t)


def local_rows(batch_size: int, mesh, axis: str = "data") -> slice:
    """The rows of a global batch of ``batch_size`` this process feeds: its
    block along ``axis`` of ``mesh`` (all rows where the mesh has no such
    axis), as ``P(axis)`` shards the batch in the JAX package. A batch the
    axis does not divide is refused, as GSPMD refuses it."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if batch_size % n:
        raise ValueError(
            f"batch of {batch_size} rows does not divide over the {n} "
            f"processes of the mesh's {axis!r} axis {mesh.shape}")
    per = batch_size // n
    return slice(i * per, (i + 1) * per)
