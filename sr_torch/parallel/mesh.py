"""The process mesh and data-parallel replicas.

Port of ``sr/parallel/mesh.py``. The JAX package lays a ``Mesh`` over its
chips, shards batches over the ``data`` axis, replicates parameters, and
lets GSPMD insert the gradient all-reduce. The port's mesh is the process
group itself, one process per card (``sr_torch/parallel/multihost.py``):

* :func:`make_mesh` describes it: its shape and axis names laid row-major
  over the ranks, this process's rank, whether a group is up; it refuses
  a shape whose size is not the number of processes present.
* :func:`batch_slice` takes a process's rows of the global batch along
  ``data`` (the counterpart of ``shard_batch`` / ``batch_sharding``);
  processes that differ only along ``spatial`` hold the same rows.
* :func:`replicate` puts a model under ``DistributedDataParallel`` (the
  gradient all-reduce) with its batch norms' statistics taken over the
  group (``sr_torch.nn.blocks.BatchNorm``), the port's form of a
  replicated parameter tree.

Axes: ``data`` (batch) and ``spatial`` (image rows for
``sr_torch.eval.tiling.sharded_predict``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch.distributed as dist
from torch import nn

from sr_torch.parallel.multihost import local_rows, process_count, process_index

_LAUNCH_HINT = (
    "launch one process per card: set SR_COORDINATOR (host:port or "
    "file:///path), SR_NUM_PROCESSES and SR_PROCESS_ID in each, or start "
    "them with torchrun and SR_MULTIHOST=auto")


@dataclass(frozen=True)
class Mesh:
    """The processes as a mesh: ``shape`` over ``axes``, rank-major."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]
    rank: int = 0
    distributed: bool = False  # a process group is up (even of one)

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def axis_index(self, axis: str) -> int:
        """This process's coordinate along ``axis`` (0 where absent)."""
        if axis not in self.axes:
            return 0
        k = self.axes.index(axis)
        return self.rank // math.prod(self.shape[k + 1:]) % self.shape[k]


def make_mesh(shape: tuple[int, ...] = (),
              axes: tuple[str, ...] = ("data",)) -> Mesh:
    """The mesh over the processes present; defaults to 1-D data parallel.
    Refuses a shape whose size differs from the number of processes."""
    world = process_count()
    if not shape:
        shape, axes = (world,), tuple(axes[:1])
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {shape} needs {math.prod(shape)} processes, "
            f"{world} present: {_LAUNCH_HINT}")
    return Mesh(shape, axes, process_index(), dist.is_initialized())


def batch_slice(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This process's rows of every tensor in the global ``batch`` along
    ``axis`` of ``mesh`` (:func:`local_rows`); the batch as it is where the
    axis has one process."""
    if mesh.axis_size(axis) == 1:
        return batch
    return {k: v[local_rows(v.shape[0], mesh, axis)]
            for k, v in batch.items()}


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class _Replica(nn.Module):
    """``forward(*args) = fn(module, *args)``: every use of the module's
    parameters in one forward, so DDP sees them (a pre-shuffle fold calls
    the model's children, a discriminator step runs the net twice)."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.module, *args)


def replicate(model: nn.Module, fn: Callable | None = None) -> nn.Module:
    """``model`` under ``DistributedDataParallel`` on the group, called as
    ``replica(*args) = fn(model, *args)`` (default: ``model(*args)``).
    Gradients are averaged over the processes in the backward; the
    model's batch norms take their statistics over the group from now on
    (``sr_torch.nn.blocks.BatchNorm.sync``), so their running statistics
    agree everywhere and no buffer is broadcast. Checkpoints and
    inference keep using ``model`` itself."""
    from torch.nn.parallel import DistributedDataParallel

    from sr_torch.nn.blocks import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync = True
    device = next(model.parameters()).device
    return DistributedDataParallel(
        _Replica(model, fn or (lambda m, *a: m(*a))),
        device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False)
