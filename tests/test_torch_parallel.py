"""sr_torch's process mesh and multi-process bootstrap
(``sr_torch/parallel``) against the JAX package's (``sr/parallel``).

* The bootstrap, with ``torch.distributed.init_process_group`` mocked, as
  ``tests/test_multihost.py`` mocks ``jax.distributed.initialize``: the
  no-op, explicit arguments, the ``SR_*`` environment, the launcher's
  environment (``SR_MULTIHOST=auto``), the card a process drives.
* ``make_mesh`` refuses a shape the processes present do not fill, with
  the launch hint; ``batch_slice`` gives each process the rows that
  ``sr.parallel.multihost.host_local_to_global`` puts on the matching
  device of the 8-device CPU mesh (``tests/conftest.py``), on a 1-D and a
  ``(data, spatial)`` mesh, and refuses a batch the data axis does not
  divide.
* Outside a process group the collectives are the identity and a synced
  batch norm is the plain one.
"""

import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sr.parallel.mesh import make_mesh as jax_make_mesh
from sr.parallel.multihost import host_local_to_global
from sr_torch.nn.blocks import BatchNorm
from sr_torch.parallel import mesh as port_mesh
from sr_torch.parallel import multihost
from sr_torch.parallel.mesh import Mesh, batch_slice, make_mesh, pad_to_multiple
from sr_torch.parallel.multihost import (
    initialize_multihost, is_coordinator, local_rows, mean_over_replicas,
    multihost_env, process_count)

torch.set_num_threads(1)


@pytest.fixture
def mock_dist(monkeypatch):
    calls = []
    for var in ("SR_COORDINATOR", "SR_MULTIHOST", "SR_NUM_PROCESSES",
                "SR_PROCESS_ID", "SR_TIMEOUT_S", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


@pytest.fixture
def cards(monkeypatch):
    """Four CUDA cards, as far as the bootstrap can tell; the devices it
    makes current are recorded."""
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    return current


_HOUR_HALF = datetime.timedelta(seconds=1800)


def test_noop_without_config(mock_dist):
    assert initialize_multihost() is False
    assert mock_dist == []


def test_explicit_args(mock_dist):
    assert initialize_multihost("10.0.0.1:1234", 4, 2) is True
    assert mock_dist == [{"backend": "gloo", "timeout": _HOUR_HALF,
                          "init_method": "tcp://10.0.0.1:1234",
                          "world_size": 4, "rank": 2}]
    with pytest.raises(ValueError, match="num_processes and process_id"):
        initialize_multihost("10.0.0.1:1234")


def test_env_var_path(mock_dist, monkeypatch):
    monkeypatch.setenv("SR_COORDINATOR", "file:///shared/rendezvous")
    monkeypatch.setenv("SR_NUM_PROCESSES", "8")
    monkeypatch.setenv("SR_PROCESS_ID", "3")
    monkeypatch.setenv("SR_TIMEOUT_S", "60")
    assert multihost_env() == {
        "coordinator_address": "file:///shared/rendezvous",
        "num_processes": 8,
        "process_id": 3,
    }
    assert initialize_multihost() is True
    assert mock_dist == [{"backend": "gloo",
                          "timeout": datetime.timedelta(seconds=60),
                          "init_method": "file:///shared/rendezvous",
                          "world_size": 8, "rank": 3}]


def test_launcher_path(mock_dist, monkeypatch, cards):
    """``SR_MULTIHOST=auto``: torchrun's environment through ``env://``,
    NCCL where CUDA is present, the card of ``LOCAL_RANK``."""
    monkeypatch.setenv("SR_MULTIHOST", "auto")
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert initialize_multihost() is True
    assert mock_dist == [{"backend": "nccl", "timeout": _HOUR_HALF,
                          "init_method": "env://"}]
    assert cards == [2]


def test_local_device_ids_and_backend(mock_dist, cards):
    initialize_multihost("h:1", 2, 1, local_device_ids=[3])
    initialize_multihost("h:1", 8, 6)  # one process a card: 6 mod 4
    initialize_multihost("h:1", 2, 1, backend="gloo")  # two on one host
    assert cards == [3, 2, 1]
    assert [c["backend"] for c in mock_dist] == ["nccl", "nccl", "gloo"]
    with pytest.raises(ValueError, match="one device a process"):
        initialize_multihost("h:1", 2, 0, local_device_ids=[0, 1])


def test_refuses_a_second_initialization(mock_dist, monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="already initialized"):
        initialize_multihost("h:1", 2, 0)


def test_single_process_defaults():
    assert process_count() == 1 and is_coordinator() is True
    mesh = make_mesh()
    assert (mesh.shape, mesh.axes, mesh.rank, mesh.distributed) == (
        (1,), ("data",), 0, False)
    assert make_mesh((1, 1), ("data", "spatial")).world == 1
    assert pad_to_multiple(10, 4) == 12


@pytest.mark.parametrize("shape,axes", [((2,), ("data",)),
                                        ((4, 2), ("data", "spatial"))])
def test_make_mesh_refuses_what_the_processes_do_not_fill(shape, axes):
    with pytest.raises(ValueError, match=r"needs \d processes, 1 present: "
                                         "launch one process per card.*"
                                         "SR_NUM_PROCESSES.*torchrun"):
        make_mesh(shape, axes)
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((1,), ("data", "spatial"))


def test_mesh_coordinates_are_rank_major():
    got = [(Mesh((4, 2), ("data", "spatial"), r).axis_index("data"),
            Mesh((4, 2), ("data", "spatial"), r).axis_index("spatial"))
           for r in range(8)]
    assert got == [(d, s) for d in range(4) for s in range(2)]
    assert Mesh((4,), ("data",), 3).axis_index("spatial") == 0
    assert Mesh((4,), ("data",), 3).axis_size("spatial") == 1


@pytest.mark.parametrize("shape,axes", [((8,), ("data",)),
                                        ((4, 2), ("data", "spatial")),
                                        ((2, 4), ("data", "spatial"))])
def test_batch_slice_is_host_local_to_global(shape, axes):
    """Each device's shard of JAX's globally sharded batch is the port's
    ``batch_slice`` on the process at the device's place in the mesh."""
    jmesh = jax_make_mesh(shape, axes)
    rng = np.random.default_rng(0)
    local = {"lr": rng.random((8, 4, 4, 3), np.float32),
             "hr": rng.random((8, 16, 16, 3), np.float32)}
    glob = host_local_to_global(local, jmesh)
    batch = {k: torch.from_numpy(v) for k, v in local.items()}
    for key in local:
        shards = glob[key].addressable_shards
        assert len(shards) == 8
        for shard in shards:
            coords = np.argwhere(jmesh.devices == shard.device)[0]
            rank = int(np.ravel_multi_index(tuple(coords), shape))
            got = batch_slice(batch, Mesh(shape, axes, rank))[key]
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


def test_batch_slice_refuses_a_batch_the_data_axis_does_not_divide():
    mesh = Mesh((4, 2), ("data", "spatial"), 5)
    with pytest.raises(ValueError, match="6 rows does not divide over the "
                                         "4 processes"):
        batch_slice({"lr": torch.zeros(6, 2, 2, 1)}, mesh)
    assert local_rows(8, mesh) == slice(4, 6)
    one = {"lr": torch.zeros(6, 2, 2, 1)}
    assert batch_slice(one, Mesh((1, 2), ("data", "spatial"), 1)) is one


def test_collectives_are_the_identity_without_a_group():
    x = torch.randn(2, 5, requires_grad=True)
    assert mean_over_replicas(x) is x
    assert multihost.all_reduce_mean(x) is x
    multihost.barrier()  # returns at once


def test_synced_batch_norm_without_a_group_is_the_plain_one():
    """Outside a process group ``sync`` changes nothing: output, gradient
    and running statistics bit for bit."""
    x = torch.randn(4, 3, 5, 5)
    outs = []
    for sync in (False, True):
        bn = BatchNorm(3)
        bn.sync = sync
        xi = x.clone().requires_grad_()
        y = bn(xi)
        (y * torch.arange(3.0).view(1, 3, 1, 1)).sum().backward()
        outs.append((y.detach(), xi.grad, bn.mean.clone(), bn.var.clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_replicate_syncs_batch_norms(monkeypatch):
    """``replicate`` marks every batch norm of the model and hands DDP a
    forward that runs ``fn`` on the model, without broadcasting buffers."""
    seen = {}

    class FakeDDP(torch.nn.Module):
        def __init__(self, module, **kw):
            super().__init__()
            self.module, seen["kw"] = module, kw

        def forward(self, *a):
            return self.module(*a)

    monkeypatch.setattr(torch.nn.parallel, "DistributedDataParallel",
                        FakeDDP)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 3, 1), BatchNorm(3))
    rep = port_mesh.replicate(model, lambda m, a, b: (m(a), m(b)))
    assert model[1].sync is True
    assert seen["kw"] == {"device_ids": None, "broadcast_buffers": False}
    x = torch.randn(2, 3, 4, 4)
    model.eval()
    a, b = rep(x, 2 * x)
    assert torch.equal(a, model(x)) and torch.equal(b, model(2 * x))
    assert jax.device_count() == 8  # the JAX side ran on its CPU mesh
