"""Rendering and logging: ``sr_torch/eval/panels.py`` and
``sr_torch/utils/logging.py`` against the JAX package's
``sr/eval/panels.py`` and ``sr/utils/logging.py``, on the CPU.

* ``to_displayable`` and ``save_img``: the same uint8 pixels as the JAX
  package's for gray, RGB and YCbCr images (tolerance 0), the PNGs read
  back equal.
* A panel holds the three displayable images pixel for pixel at
  ``panel_offsets``; its frame and text are Pillow's, not matplotlib's, so
  only the images are compared. ``plot_loss`` is deterministic.
* ``JSONLLogger`` writes the JAX package's lines for the same records at
  the same clock (tolerance 0: string equality).
* ``TensorBoardLogger`` forwards each call to ``SummaryWriter`` (a
  recording stand-in for ``torch.utils.tensorboard``'s, whose import loads
  TensorFlow where that is installed) where the module imports, and is
  inactive where it does not.
"""

import json
import sys
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image

from sr.eval import panels as jax_panels
from sr.utils.logging import JSONLLogger as JaxJSONLLogger
from sr_torch.eval import panels
from sr_torch.utils.logging import JSONLLogger, TensorBoardLogger

torch.set_num_threads(1)


def _img(seed, c, hw=(37, 29)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, c),
                                                dtype=np.uint8)


CASES = [(1, "ycbcr"), (3, "ycbcr"), (3, "rgb"), (1, "rgb")]


@pytest.mark.parametrize("c,cs", CASES)
def test_to_displayable_and_save_img_equal_jax(c, cs, tmp_path):
    img = _img(c, c)
    got, want = panels.to_displayable(img, cs), jax_panels.to_displayable(
        img, cs)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    panels.save_img(img, str(tmp_path / "port" / "a.png"), cs)
    jax_panels.save_img(img, str(tmp_path / "jax" / "a.png"), cs)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "port" / "a.png")),
        np.asarray(Image.open(tmp_path / "jax" / "a.png")))


def test_ycbcr_round_trip_over_every_level():
    # every Y level with varied chroma: rounding ties would show here
    y = np.arange(256, dtype=np.uint8)
    img = np.stack([y, np.roll(y, 85), np.roll(y, 170)], -1)[None]
    np.testing.assert_array_equal(panels.to_displayable(img, "ycbcr"),
                                  jax_panels.to_displayable(img, "ycbcr"))


@pytest.mark.parametrize("c,cs", CASES[:3])
def test_panel_holds_the_displayable_images(c, cs, tmp_path):
    bic, sr, hr = _img(1, c), _img(2, c), _img(3, c)
    path = tmp_path / "panel.png"
    panels.plot_test_result(bic, sr, hr, str(path), psnr_bicubic=23.456,
                            psnr_sr=25.0, color_space=cs)
    panel = np.asarray(Image.open(path).convert("RGB"))
    imgs = [bic, sr, hr]
    for im, (row, col) in zip(imgs, panels.panel_offsets(imgs)):
        h, w = im.shape[:2]
        np.testing.assert_array_equal(
            panel[row:row + h, col:col + w],
            jax_panels.to_displayable(im, cs))
    # titles sit above the images, in the band they do not cover
    band = panel[:panels.PANEL_TITLE]
    assert (band != 255).any()


def test_plot_loss_is_deterministic(tmp_path):
    losses = [0.3, 0.2, 0.25, 0.1, float("nan"), 0.05]
    for name in ("a.png", "b.png"):
        panels.plot_loss(losses, str(tmp_path / name), title="EDSR x4")
    a = np.asarray(Image.open(tmp_path / "a.png"))
    assert a.shape == (400, 600, 3)
    np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path /
                                                           "b.png")))
    panels.plot_loss(losses[:3], str(tmp_path / "c.png"))
    assert not np.array_equal(a, np.asarray(Image.open(tmp_path / "c.png")))
    panels.plot_loss([0.5], str(tmp_path / "one.png"))
    panels.plot_loss([], str(tmp_path / "none.png"))


def test_jsonl_lines_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792300000.123456)
    records = [
        {"epoch": 0, "step": 40, "wall_s": 1.25, "loss": 0.0123456789},
        {"event": "eval", "dataset": "procedural", "psnr_sr": np.float32(
            27.5), "num_images": np.int64(128), "self_ensemble": True},
        {"epoch": 1, "phase": "adversarial", "d_loss": np.float64(1.5)},
    ]
    paths = {}
    for name, cls in (("port", JSONLLogger), ("jax", JaxJSONLLogger)):
        paths[name] = tmp_path / name / "metrics.jsonl"
        log = cls(str(paths[name]))
        for rec in records:
            log(rec)
        log.close()
    got = paths["port"].read_text().splitlines()
    assert got == paths["jax"].read_text().splitlines()
    assert len(got) == 3 and json.loads(got[1])["num_images"] == 128


class _FakeWriter:
    """Stands in for ``torch.utils.tensorboard.SummaryWriter``: records
    every call. Importing the real one loads TensorFlow where that is
    installed (many seconds and a large share of memory a process)."""

    def __init__(self, log_dir):
        self.log_dir, self.calls = log_dir, []

    def __getattr__(self, name):
        return lambda *a, **kw: self.calls.append((name, a, kw))


def test_tensorboard_logger_forwards_to_the_summary_writer(tmp_path,
                                                           monkeypatch):
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = _FakeWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    tb = TensorBoardLogger(str(tmp_path / "logs"))
    assert tb.active and tb._writer.log_dir == str(tmp_path / "logs")
    img = np.full((4, 4, 3), 0.5, np.float32)
    tb.scalar("loss", np.float32(0.5), 1)
    tb.image("sample", img, 2)
    tb.histogram("w", [0.0, 1.0, 2.0], 3)
    tb.flush()
    tb.close()
    (n0, a0, k0), (n1, a1, k1), (n2, a2, k2), (n3, _, _), (n4, _, _) = (
        tb._writer.calls)
    assert (n0, a0, k0) == ("add_scalar", ("loss", 0.5), {"global_step": 1})
    assert type(a0[1]) is float
    assert n1 == "add_image" and a1[0] == "sample"
    assert k1 == {"global_step": 2, "dataformats": "HWC"}
    np.testing.assert_array_equal(a1[1], np.full((4, 4, 3), 127, np.uint8))
    assert n2 == "add_histogram" and a2[0] == "w" and k2 == {"global_step": 3}
    np.testing.assert_array_equal(a2[1], [0.0, 1.0, 2.0])
    assert (n3, n4) == ("flush", "close")


def test_tensorboard_logger_is_inactive_without_tensorboard(tmp_path,
                                                            monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tb = TensorBoardLogger(str(tmp_path / "logs"))
    assert not tb.active
    tb.scalar("loss", 0.5, 1)
    tb.image("sample", np.zeros((4, 4, 3), np.float32), 1)
    tb.histogram("w", np.arange(5.0), 1)
    tb.flush()
    tb.close()
    assert not (tmp_path / "logs").exists()
