"""The traffic mixes: deterministic for a seed, at the stated shapes."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from srbench.kinds import frames, photos

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


SEED = 2 ** 31 + 12345


def test_frames_deterministic_with_stated_shapes():
    t = _mix("reds_frames")
    a = frames.make_pool(t, SEED, "cpu")
    b = frames.make_pool(t, SEED, "cpu")
    assert a.dtype == torch.uint8
    assert a.shape == (t["pool_frames"], t["lr_height"], t["lr_width"], 3)
    assert (t["lr_height"], t["lr_width"], t["batch"]) == (180, 320, 8)
    assert torch.equal(a, b)
    assert not torch.equal(a, frames.make_pool(t, SEED + 1, "cpu"))
    # image-like: a spread of values, not a constant
    assert float(a.float().std()) > 20


def test_frames_batches_are_consecutive_frames_of_one_clip():
    t = _mix("reds_frames")
    pool = frames.make_pool(t, SEED, "cpu").view(
        -1, t["clip_frames"], t["lr_height"], t["lr_width"], 3)
    # a pan by whole pixels: frame k+1 is frame k moved by one offset
    clip = pool[0].float()
    shifts = []
    for k in range(t["clip_frames"] - 1):
        best = min(((float((clip[k + 1, 3 + dy:-3 + dy or None,
                                     3 + dx:-3 + dx or None]
                              - clip[k, 3:-3, 3:-3]).abs().mean()), (dy, dx))
                    for dy in range(-3, 4) for dx in range(-3, 4)))
        assert best[0] == 0.0
        shifts.append(best[1])
    assert len(set(shifts)) == 1
    assert t["clip_frames"] % t["batch"] == 0  # no batch spans two clips
    order = frames.batch_order(t, SEED)
    assert sorted(order) == list(range(t["pool_frames"] // t["batch"]))
    assert order == frames.batch_order(t, SEED)


def test_photos_same_sizes_for_every_seed():
    t = _mix("div2k_photo")
    a = photos.make_pool(t, SEED, "cpu")
    b = photos.make_pool(t, SEED, "cpu")
    c = photos.make_pool(t, SEED + 7, "cpu")
    assert len(a) == t["pool_photos"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    sizes = Counter(x.shape for x in a)
    assert sizes == Counter(x.shape for x in c)
    want = {(h, w, 3) for h, w in photos.geometries(t)}
    assert set(sizes) == want
    assert len(set(sizes.values())) == 1  # each geometry equally often
    # DIV2K x4: 2040 px on the long side, so 510 LR px; half portrait
    assert all(max(s[:2]) == 510 for s in sizes)
    assert sum(s[0] > s[1] for s in sizes) * 2 == len(sizes)
    assert [x.shape for x in a] != [x.shape for x in c]  # another order


@pytest.mark.parametrize("name", ["reds_frames", "div2k_photo"])
def test_mix_names_a_kind_the_harness_has(name):
    from srbench import kinds

    assert hasattr(kinds.load(_mix(name)["kind"]), "Runner")
