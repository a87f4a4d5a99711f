"""sr_torch's test sets against the JAX package: the procedural corpus, its
on-disk cache, folder datasets and image decode, and ``get_test_set``.

Images are small (64², 3 images) and PNGs are written to ``tmp_path``; the
128-image procedural set is never generated. Everything runs on the CPU.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from sr.data import decode as jax_decode
from sr.data.datasets import FolderDataset as JaxFolderDataset
from sr.data.datasets import SyntheticDataset as JaxSyntheticDataset
from sr.data.procedural import ProceduralDataset as JaxProceduralDataset
from sr.data.procedural import (
    generate_procedural_image as jax_generate_procedural_image)
from sr_torch.data import decode, procedural
from sr_torch.data.datasets import FolderDataset, get_test_set
from sr_torch.data.procedural import (
    ProceduralDataset, generate_procedural_image)

torch.set_num_threads(1)


# ----------------------------------------------------------- procedural ----

@pytest.mark.parametrize("color_space", ["rgb", "ycbcr"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_procedural_bit_for_bit(split, color_space):
    kw = dict(num_images=3, size=(64, 64), seed=5, split=split,
              color_space=color_space)
    port, ref = ProceduralDataset(**kw), JaxProceduralDataset(**kw)
    assert len(port) == len(ref) == 3 and port.names == ref.names
    for i in range(3):
        assert port[i].dtype == np.uint8 and port[i].shape == (64, 64, 3)
        np.testing.assert_array_equal(port[i], ref[i])


def test_procedural_image_generator_bit_for_bit():
    for seed, hw in ((0, (48, 80)), (1, (72, 40))):
        got = generate_procedural_image(np.random.default_rng(seed), *hw)
        want = jax_generate_procedural_image(np.random.default_rng(seed), *hw)
        np.testing.assert_array_equal(got, want)


def test_procedural_refusals():
    with pytest.raises(ValueError, match="split"):
        ProceduralDataset(split="val")
    with pytest.raises(ValueError, match="color_space"):
        ProceduralDataset(color_space="y")


def test_procedural_materialize_round_trips(tmp_path):
    """One .npz under the JAX package's cache key; a second dataset loads
    it instead of generating, with the same images."""
    kw = dict(num_images=3, size=(64, 64), seed=2, split="test")
    first = ProceduralDataset(**kw).materialize(str(tmp_path))
    files = os.listdir(tmp_path)
    assert files == [f"procedural_v{procedural.GEN_VERSION}_test_s2_64x64_"
                     "rgb_n3.npz"]
    assert procedural.GEN_VERSION == 2  # the JAX package's cache version
    second = ProceduralDataset(**kw)
    second.materialize(str(tmp_path))
    assert sorted(second._cache) == [0, 1, 2]
    ref = JaxProceduralDataset(**kw)
    for i in range(3):
        np.testing.assert_array_equal(second._cache[i], ref[i])
        np.testing.assert_array_equal(first[i], ref[i])
    assert ProceduralDataset(**kw).materialize(None)._cache.keys() == {0, 1, 2}


# -------------------------------------------------------------- folders ----

def _write_pngs(directory, rng, sizes, modes=("RGB",)):
    directory.mkdir(parents=True, exist_ok=True)
    for k, (h, w) in enumerate(sizes):
        mode = modes[k % len(modes)]
        shape = (h, w) if mode == "L" else (h, w, 3)
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        Image.fromarray(arr, mode).save(directory / f"img_{k:02d}.png")
    (directory / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("color_space", ["rgb", "ycbcr", "y"])
def test_folder_dataset_and_load_img_equal_jax(tmp_path, color_space):
    _write_pngs(tmp_path, np.random.default_rng(11),
                ((30, 26), (17, 41), (24, 24)), modes=("RGB", "L"))
    paths = decode.list_images(str(tmp_path))
    assert paths == jax_decode.list_images(str(tmp_path))
    assert len(paths) == 3
    port = FolderDataset(paths, color_space)
    ref = JaxFolderDataset(paths, color_space)
    assert len(port) == 3 and port.names == ref.names
    for i, p in enumerate(paths):
        want = jax_decode.load_img(p, color_space)
        np.testing.assert_array_equal(decode.load_img(p, color_space), want)
        np.testing.assert_array_equal(port[i], ref[i])
        assert port[i].shape[-1] == (1 if color_space == "y" else 3)
    with pytest.raises(ValueError, match="color_space"):
        decode.load_img(paths[0], "lab")


def test_is_image_file_equals_jax():
    for name in ("a.PNG", "b.jpeg", "c.tiff", "d.txt", "e.npz", "f.bmp"):
        assert decode.is_image_file(name) == jax_decode.is_image_file(name)


# ---------------------------------------------------------- get_test_set ----

def test_get_test_set_synthetic_equals_jax():
    ds = get_test_set("unused", "synthetic")
    ref = JaxSyntheticDataset(num_images=5, size=(128, 128), seed=7)
    assert (len(ds), ds.size, ds.seed) == (5, (128, 128), 7)
    assert ds.names == ref.names
    np.testing.assert_array_equal(ds[4], ref[4])


def test_get_test_set_procedural_arguments(tmp_path, monkeypatch):
    """128 held-out images at 384², seed 0, cached under
    ``data_dir/procedural_cache``: checked before ``materialize`` runs."""
    seen = {}

    def materialize(self, cache_dir):
        seen.update(ds=self, cache_dir=cache_dir)
        return self

    monkeypatch.setattr(ProceduralDataset, "materialize", materialize)
    ds = get_test_set(str(tmp_path), "Procedural", color_space="ycbcr")
    assert seen["ds"] is ds
    assert seen["cache_dir"] == os.path.join(str(tmp_path),
                                             "procedural_cache")
    assert (ds.num_images, ds.size, ds.seed, ds.split, ds.color_space) == (
        128, (384, 384), 0, "test", "ycbcr")


def test_get_test_set_named_folder_and_bsds300(tmp_path):
    rng = np.random.default_rng(12)
    _write_pngs(tmp_path / "test" / "Set5", rng, ((20, 24), (18, 18)))
    ds = get_test_set(str(tmp_path), "Set5", color_space="rgb")
    assert isinstance(ds, FolderDataset) and ds.names == ["img_00", "img_01"]
    assert ds[1].shape == (18, 18, 3)
    with pytest.raises(RuntimeError, match="download"):
        get_test_set(str(tmp_path), "bsds300")
    _write_pngs(tmp_path / "BSDS300" / "images" / "test", rng, ((32, 48),))
    ds = get_test_set(str(tmp_path), "BSDS300")
    assert ds.names == ["img_00"] and ds.color_space == "ycbcr"
    assert ds[0].shape == (32, 48, 3)
