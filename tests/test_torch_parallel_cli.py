"""``python -m sr_torch.main`` on two processes on the CPU: each started
with ``SR_COORDINATOR`` (a ``file://`` rendezvous under the test's
directory), ``SR_NUM_PROCESSES``, ``SR_PROCESS_ID`` and a 60 s collective
timeout (``SR_TIMEOUT_S``), ``--mesh 2 --device cpu`` (gloo), SRCNN ×4 on
the synthetic sets, f32, global batch 4, 2 epochs of 2 steps in
dispatches of 2. Only the coordinator writes the run directory, which
then holds what a one-process ``--mesh 1`` run of the same flags writes,
with the same log records; the final params equal that run's within
1e-5 of each tensor's largest entry, the port's parity tests' measure
after several Adam steps (elementwise, Adam's first update of a
near-zero gradient magnifies the reduction order's noise).
"""

import json
import os
import re

import numpy as np

import test_torch_parallel_worker as worker


def _argv(save_dir, data_dir, *mesh):
    return ["--model_name", "SRCNN", "--num_epochs", "2",
            "--steps_per_epoch", "2", "--batch_size", "4", "--crop_size",
            "32", "--save_epochs", "1", "--steps_per_dispatch", "2",
            "--train_dataset", "synthetic", "--test_dataset", "synthetic",
            "--dtype", "float32", "--device", "cpu", "--save_dir",
            str(save_dir), "--data_dir", str(data_dir), "--mesh", *mesh]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _records(run):
    with open(run / "metrics.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("ts", "wall_s")} for line in f]


def test_two_process_cli_writes_on_the_coordinator_only(tmp_path):
    data = tmp_path / "data"
    two_dir, one_dir = tmp_path / "two", tmp_path / "one"
    env = lambda rank: {  # noqa: E731
        "SR_COORDINATOR": f"file://{tmp_path / 'rendezvous'}",
        "SR_NUM_PROCESSES": "2", "SR_PROCESS_ID": str(rank),
        "SR_TIMEOUT_S": "60"}
    two = worker.run("cli", {"argv": _argv(two_dir, data, "2"),
                             "watch": str(two_dir)}, tmp_path, env=env)
    (one,) = worker.run("cli", {"argv": _argv(one_dir, data, "1"),
                                "watch": str(one_dir)}, tmp_path, world=0)
    assert [o["rc"] for o in two + [one]] == [0, 0, 0]
    assert two[1]["written"] == [] and two[0]["written"]
    run2, run1 = two_dir / "SRCNN_x4", one_dir / "SRCNN_x4"
    assert _tree(run2) == _tree(run1)
    def names(written):  # temporary names carry their process's id
        return sorted({re.sub(r"\.\d+\.tmp", ".tmp", w) for w in written})

    assert names(two[0]["written"]) == names(one["written"])
    rec2, rec1 = _records(run2), _records(run1)
    assert [sorted(r) for r in rec2] == [sorted(r) for r in rec1]
    assert [r["step"] for r in rec2 if "step" in r] == [2, 4]
    with np.load(run2 / "SRCNN_params.npz") as a, \
            np.load(run1 / "SRCNN_params.npz") as b:
        assert set(a.files) == set(b.files)
        for k in b.files:
            rel = np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()
            assert float(rel) <= 1e-5, k
