"""The port's CLI (``sr_torch/main.py``) against the JAX package's
(``sr/main.py``), on the CPU.

* ``parse_args`` builds the same ``SRConfig`` as ``sr.main.parse_args``,
  field for field (exact equality), over a table of argv that covers every
  reference flag, the TPU-era flags and each model's defaults; the flags
  tuple agrees and adds the device. ``--use_pallas`` is rejected,
  ``check_args`` refuses what JAX's refuses with its messages; ``--mesh
  2`` in one process is refused with the launch hint, and the multihost
  environment (``SR_COORDINATOR``, ``SR_MULTIHOST``) brings the process
  group up before anything else (``tests/test_torch_parallel_cli.py`` runs
  the CLI on two processes).
* ``main`` in process on SRCNN (``--num_epochs 2 --steps_per_epoch 2
  --batch_size 2 --crop_size 32``, f32), one run of each package (module
  fixtures): a run directory with the JAX package's file names (``.pt2``
  for ``.hloart``); a run resumed from its first epoch ends with the
  uninterrupted run's params bit for bit; ``--eval_only`` reproduces the
  run's summary exactly, refuses without a checkpoint with JAX's message,
  and runs the self-ensemble.
* ``run_eval`` of the port on the weights the JAX run trained (its
  ``SRCNN_params.npz``, carried across with ``from_jax_params``) against
  that run's own ``run_eval`` on the synthetic test set: summaries within
  1e-3 dB (PSNR) and 1e-4 (SSIM), SR PNGs within 1 u8 level, the same
  file names.

Every run directory lies under ``tmp_path``. TensorBoard is replaced by an
inactive logger in both packages (importing it loads TensorFlow where that
is installed, many seconds a process); ``tests/test_torch_panels_logging.py``
covers the real one.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import sr.main as jax_main
from sr.utils.checkpoint import load_params as jax_load_params
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch import main as port_main
from sr_torch.data.datasets import (
    get_test_set, get_training_set, procedural_cache, procedural_split)
from sr_torch.data.procedural import ProceduralDataset
from sr_torch.models.registry import available_models, get_spec
from sr_torch.utils.checkpoint import load_params
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params

torch.set_num_threads(1)

MODELS = ("SRCNN", "VDSR", "DRCN", "ESPCN", "FSRCNN", "EDSR", "SRResNet",
          "SRGAN", "LapSRN")


class _InactiveTB:
    active = False

    def __init__(self, log_dir):
        pass

    def scalar(self, *a):
        raise AssertionError("an inactive logger takes no scalar")

    def close(self):
        pass


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(port_main, "TensorBoardLogger", _InactiveTB)
    monkeypatch.setattr(jax_main, "TensorBoardLogger", _InactiveTB)


# ------------------------------------------------------------ parse_args ----

def _argv_table():
    """Argv lists (without ``--save_dir``) for :func:`parse_args`."""
    return {
        "defaults": [],
        "reference flags": [
            "--model_name", "ESPCN", "--num_channels", "1",
            "--scale_factor", "2", "--crop_size", "64", "--num_epochs", "5",
            "--save_epochs", "2", "--batch_size", "16",
            "--test_batch_size", "2", "--lr", "0.001", "--data_dir", "d",
            "--train_dataset", "bsds300", "--test_dataset", "Set5",
            "--num_threads", "4"],
        "later flags": [
            "--model_name", "VDSR", "--dtype", "float32",
            "--steps_per_epoch", "7", "--seed", "3", "--mesh", "1",
            "--no_resume", "--eval_only", "--vgg_weights_path", "v.pth",
            "--pretrain_epochs", "3", "--multi_scale", "2", "3", "4",
            "--steps_per_dispatch", "5", "--vdsr_clip_theta", "0.4",
            "--random_scale_mode", "item", "--preshuffle_loss",
            "--self_ensemble", "--fast_eval", "--export", "--export_torch"],
        "preshuffle full, 2-d mesh": [
            "--model_name", "EDSR", "--preshuffle_loss", "full",
            "--mesh", "2", "4", "--random_scale_mode", "batch"],
        **{f"{m} defaults": ["--model_name", m] for m in MODELS},
    }


@pytest.mark.parametrize("case", list(_argv_table()))
def test_parse_args_builds_jax_config_field_for_field(case, tmp_path):
    argv = _argv_table()[case] + ["--save_dir", str(tmp_path)]
    cfg, flags = port_main.parse_args(argv)
    jcfg, jflags = jax_main.parse_args(argv)
    got, want = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert list(got) == list(want)
    assert got == want
    assert flags[:5] == jflags
    assert flags[5] == "cuda"  # the device, the port's one extra flag


def test_available_models_are_the_jax_packages():
    from sr.models.registry import available_models as jax_available_models

    assert available_models() == jax_available_models()
    assert sorted(m.lower() for m in MODELS) == available_models()


def test_device_flag_and_use_pallas_refusal(tmp_path, capsys):
    _, flags = port_main.parse_args(["--device", "cpu", "--save_dir",
                                     str(tmp_path)])
    assert flags[5] == "cpu"
    jcfg, _ = jax_main.parse_args(["--use_pallas", "--save_dir",
                                   str(tmp_path)])
    assert jcfg.use_pallas
    with pytest.raises(SystemExit) as e:
        port_main.parse_args(["--use_pallas", "--save_dir", str(tmp_path)])
    assert e.value.code == 2
    assert "--use_pallas" in capsys.readouterr().err


@pytest.mark.parametrize("bad", [dict(crop_size=65, scale_factor=4),
                                 dict(num_epochs=0), dict(batch_size=0)])
def test_check_args_refuses_as_jax(bad, tmp_path):
    with pytest.raises(SystemExit) as want:
        jax_main.check_args(JaxSRConfig(save_dir=str(tmp_path), **bad))
    with pytest.raises(SystemExit) as got:
        port_main.check_args(SRConfig(save_dir=str(tmp_path), **bad))
    assert str(got.value) == str(want.value)
    ok = port_main.check_args(SRConfig(save_dir=str(tmp_path),
                                       model_name="EDSR"))
    assert (tmp_path / "EDSR_x4").is_dir() and ok.model_name == "EDSR"


@pytest.mark.parametrize("model", ["SRCNN", "SRGAN"])
def test_mesh_refuses_with_queue_a_10(model, tmp_path):
    """A mesh of 2 in one process: both trainers refuse it with the launch
    hint (the name predates multi-process training, which now runs)."""
    with pytest.raises(ValueError, match="needs 2 processes, 1 present.*"
                                         "SR_COORDINATOR"):
        port_main.main(["--model_name", model, "--mesh", "2", "--device",
                        "cpu", "--save_dir", str(tmp_path)])


@pytest.mark.parametrize("var,value", [("SR_COORDINATOR", "localhost:1234"),
                                       ("SR_MULTIHOST", "auto")])
def test_multihost_environment_refuses_with_queue_a_10(var, value, tmp_path,
                                                       monkeypatch):
    """The multihost environment now bootstraps, before the arguments are
    parsed: the JAX-style coordinator through ``tcp://`` with the
    ``SR_*`` world and rank, ``SR_MULTIHOST=auto`` through the launcher's
    ``env://``; gloo for ``--device cpu`` (the name predates it)."""
    import torch.distributed as dist

    calls = []

    def init_process_group(**kw):
        calls.append(kw)
        raise _Stop

    monkeypatch.delenv("SR_COORDINATOR", raising=False)
    monkeypatch.delenv("SR_MULTIHOST", raising=False)
    monkeypatch.setenv(var, value)
    monkeypatch.setenv("SR_NUM_PROCESSES", "2")
    monkeypatch.setenv("SR_PROCESS_ID", "1")
    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    with pytest.raises(_Stop):
        port_main.main(["--device", "cpu", "--save_dir", str(tmp_path)])
    (kw,) = calls
    assert kw["backend"] == "gloo"
    if var == "SR_COORDINATOR":
        assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
            "tcp://localhost:1234", 2, 1)
    else:
        assert kw["init_method"] == "env://" and "rank" not in kw
    assert not os.listdir(tmp_path)  # nothing written before the group


class _Stop(Exception):
    pass


def test_main_runs_with_deterministic_cudnn_and_restores_it(monkeypatch):
    seen = []

    def probe(**kw):
        seen.append(torch.backends.cudnn.deterministic)
        raise _Stop

    monkeypatch.setattr(port_main, "initialize_multihost", probe)
    before = torch.backends.cudnn.deterministic
    with pytest.raises(_Stop):
        port_main.main(["--device", "cpu"])
    assert seen == [True]
    assert torch.backends.cudnn.deterministic is before


def test_procedural_split_is_what_the_getters_materialize(tmp_path,
                                                          monkeypatch):
    seen = []

    def materialize(self, cache_dir):
        seen.append((self, cache_dir))
        return self

    monkeypatch.setattr(ProceduralDataset, "materialize", materialize)
    for split, getter in (("train", get_training_set),
                          ("test", get_test_set)):
        ds = getter(str(tmp_path), "procedural", "rgb")
        assert ds == procedural_split(split, "rgb")
        assert (ds.num_images, ds.size, ds.seed) == (
            {"train": 512, "test": 128}[split], (384, 384), 0)
        cache = procedural_cache(str(tmp_path))
        assert seen[-1] == (ds, cache)
        assert cache == os.path.join(str(tmp_path), "procedural_cache")
        assert ds.cache_path(cache) == os.path.join(
            cache, f"procedural_v2_{split}_s0_384x384_rgb_n{ds.num_images}.npz")


# ------------------------------------------------------------------ main ----

def _argv(save_dir, data_dir, *extra, epochs=2):
    return ["--model_name", "SRCNN", "--num_epochs", str(epochs),
            "--steps_per_epoch", "2", "--batch_size", "2", "--crop_size",
            "32", "--save_epochs", "1", "--train_dataset", "synthetic",
            "--test_dataset", "synthetic", "--dtype", "float32",
            "--save_dir", str(save_dir), "--data_dir", str(data_dir),
            *extra]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _evals(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r.get("event") == "eval"], recs


def _main_run(pkg, tmp_path_factory, *extra):
    """One uninterrupted run of 2 epochs of ``pkg``'s CLI with --export and
    --export_torch: (save dir, data dir)."""
    root = tmp_path_factory.mktemp("cli")
    mp = pytest.MonkeyPatch()
    mp.setattr(pkg, "TensorBoardLogger", _InactiveTB)
    try:
        assert pkg.main(_argv(root / "a", root / "data", "--export",
                              "--export_torch", *extra)) == 0
    finally:
        mp.undo()
    return root / "a", root / "data"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's run, on the CPU."""
    return _main_run(port_main, tmp_path_factory, "--device", "cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run of the same argv."""
    return _main_run(jax_main, tmp_path_factory)


def test_main_run_directory_has_the_jax_layout(trained, jax_run):
    save, _ = trained
    jsave, _ = jax_run
    port_files = [f for f in _tree(save / "SRCNN_x4")
                  if not f.startswith("ckpt")]
    jax_files = [f.replace(".hloart", ".pt2")
                 for f in _tree(jsave / "SRCNN_x4")
                 if not f.startswith("ckpt")]
    assert port_files == jax_files
    assert "run_meta.json" in os.listdir(save / "SRCNN_x4" / "ckpt")
    # the same metrics.jsonl records, key for key
    (pe,), precs = _evals(save / "SRCNN_x4")
    (je,), jrecs = _evals(jsave / "SRCNN_x4")
    assert set(pe) == set(je)
    assert [set(r) for r in precs] == [set(r) for r in jrecs]
    # the params .npz reads in the JAX package, equal to the port's reading
    jp, jbs = jax_load_params(str(save / "SRCNN_x4" / "SRCNN_params.npz"))
    tp, tbs = load_params(str(save / "SRCNN_x4" / "SRCNN_params.npz"))
    assert jbs is None and tbs is None
    for blk in tp:
        for leaf in tp[blk]["Conv_0"]:
            np.testing.assert_array_equal(
                np.asarray(jp[blk]["Conv_0"][leaf]), tp[blk]["Conv_0"][leaf])


def test_run_eval_matches_jax(jax_run, tmp_path):
    jsave, data = jax_run
    jdir = jsave / "SRCNN_x4"
    (want,), _ = _evals(jdir)
    params, _ = jax_load_params(str(jdir / "SRCNN_params.npz"))
    cfg = SRConfig(model_name="SRCNN", num_channels=1, dtype="float32",
                   test_dataset="synthetic", data_dir=str(data))
    model = from_jax_params(get_spec("SRCNN").make_model(cfg), params).eval()
    with torch.no_grad():
        got = port_main.run_eval(cfg, get_spec("SRCNN"), model,
                                 str(tmp_path), log=lambda s: None,
                                 device="cpu")

    assert set(got) == set(want) - {"ts", "event"}
    for k in ("dataset", "scale_factor", "num_images"):
        assert got[k] == want[k]
    for k in ("psnr_sr", "psnr_bicubic"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    for k in ("ssim_sr", "ssim_bicubic"):
        assert abs(got[k] - want[k]) <= 1e-4, k
    rendered = [f for f in _tree(jdir) if f.startswith(("images", "panels"))]
    assert _tree(tmp_path) == rendered
    for rel in rendered:
        if rel.startswith("images"):
            a = np.asarray(Image.open(tmp_path / rel), np.int16)
            b = np.asarray(Image.open(jdir / rel), np.int16)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel


def test_main_resume_ends_bit_for_bit(trained, tmp_path):
    save, data = trained
    for epochs in (1, 2):
        assert port_main.main(_argv(tmp_path, data, "--device", "cpu",
                                    epochs=epochs)) == 0
    want, _ = load_params(str(save / "SRCNN_x4" / "SRCNN_params.npz"))
    got, _ = load_params(str(tmp_path / "SRCNN_x4" / "SRCNN_params.npz"))
    for blk in want:
        for leaf in want[blk]["Conv_0"]:
            np.testing.assert_array_equal(got[blk]["Conv_0"][leaf],
                                          want[blk]["Conv_0"][leaf])
    steps = [r["step"] for r in _evals(tmp_path / "SRCNN_x4")[1]
             if "step" in r]
    assert steps == sorted(steps) and steps[-1] == 4


def test_main_eval_only_reproduces_the_summary(trained, capsys):
    save, data = trained
    (first,), _ = _evals(save / "SRCNN_x4")
    assert port_main.main(_argv(save, data, "--device", "cpu",
                                "--eval_only")) == 0
    evals, _ = _evals(save / "SRCNN_x4")
    again = {k: v for k, v in evals[-1].items() if k != "ts"}
    assert again == {k: v for k, v in first.items() if k != "ts"}
    assert "[resume] step 4" in capsys.readouterr().out
    assert port_main.main(_argv(save, data, "--device", "cpu",
                                "--eval_only", "--self_ensemble",
                                "--fast_eval")) == 0
    ens = _evals(save / "SRCNN_x4")[0][-1]
    assert ens["self_ensemble"] is True and np.isfinite(ens["psnr_sr"])


def test_main_eval_only_refuses_without_a_checkpoint(tmp_path):
    run = tmp_path / "SRCNN_x4"
    with pytest.raises(SystemExit) as e:
        port_main.main(_argv(tmp_path, tmp_path / "data", "--device", "cpu",
                             "--eval_only"))
    assert str(e.value) == (
        f"--eval_only needs a trained checkpoint in {run / 'ckpt'} "
        "(refusing to evaluate randomly-initialized weights; reference "
        "wrappers refuse too)")
