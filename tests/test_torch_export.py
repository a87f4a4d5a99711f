"""sr_torch's serving export (``torch.export`` artifacts and bundles)
against its own eager routes and the JAX package's ``sr/export.py``.

Each program reloads without model code and must equal the port's eager
predict of the same route bit for bit (the same operators in the same
order); bundle headers must equal the JAX package's metadata for the same
arguments. Weights come from a JAX ``init`` with seeded nonzero biases, in
the JAX package's ``.npz``. Everything runs on the CPU, where each
operator takes its plain version.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.export import export_bundle as jax_export_bundle
from sr.export import save_bundle as jax_save_bundle
from sr.models.registry import get_spec as jax_get_spec
from sr.utils.checkpoint import save_params as jax_save_params
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch import export as ex
from sr_torch.eval.ensemble import make_self_ensemble_predict
from sr_torch.infer import make_pyramid_level_predict, make_serving_predict
from sr_torch.models.registry import get_spec
from sr_torch.utils.checkpoint import load_params
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import from_jax_params
from test_torch_port_d2s_bias import with_random_biases

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL_EDSR = {"num_resblocks": 2, "base_filter": 16}


def _npz(tmp_path, name, channels, **cfg_kw):
    """A JAX init of ``name`` ×4 at f32 with seeded nonzero biases, saved
    as the JAX package's .npz; returns its path."""
    cfg = JaxSRConfig(model_name=name, num_channels=channels,
                      scale_factor=4, dtype="float32", **cfg_kw)
    model = jax_get_spec(name).make_model(cfg)
    v = model.init(jax.random.key(0), jnp.zeros((1, 8, 8, channels)),
                   train=False)
    params = with_random_biases(jax.tree.map(np.asarray, v["params"]), 2,
                                std=0.05)
    stats = v.get("batch_stats")
    path = str(tmp_path / f"{name}_params.npz")
    jax_save_params(path, params,
                    None if stats is None else jax.tree.map(np.asarray,
                                                            stats))
    return path


def _model(name, path, channels, dtype="float32", scale=4, **cfg_kw):
    """The port's model on the .npz's weights, in eval mode on the CPU."""
    m = get_spec(name).make_model(SRConfig(
        model_name=name, num_channels=channels, scale_factor=scale,
        dtype=dtype, **cfg_kw))
    params, stats = load_params(path)
    from_jax_params(m, params, stats)
    return m.eval().requires_grad_(False)


def _x(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, shape).astype(np.float32))


@pytest.fixture(scope="module")
def espcn(tmp_path_factory):
    return _npz(tmp_path_factory.mktemp("export_espcn"), "ESPCN", 1)


@pytest.fixture(scope="module")
def edsr(tmp_path_factory):
    return _npz(tmp_path_factory.mktemp("export_edsr"), "EDSR", 3,
                **SMALL_EDSR)


def test_export_roundtrip_symbolic_batch(espcn, tmp_path):
    """One program, traced at batch 2, serves batches 1 and 3 and equals
    the eager model bit for bit."""
    ep = ex.export_predict("ESPCN", espcn, num_channels=1, dtype="float32",
                           lr_size=8, device="cpu")
    art = str(tmp_path / "espcn.pt2")
    ex.save_artifact(art, ep)
    fn = ex.load_artifact(art, device="cpu")
    assert fn.in_shape == (None, 8, 8, 1) and fn.out_shape == (None, 32,
                                                                32, 1)
    model = _model("ESPCN", espcn, 1)
    for b in (1, 3):
        x = _x(b, (b, 8, 8, 1))
        with torch.no_grad():
            want = model(x)
        assert torch.equal(fn(x), want)
    # numpy in works as the server passes it
    assert torch.equal(fn(x.numpy()), want)


@pytest.mark.parametrize("name,dtype", [("EDSR", "bfloat16"),
                                        ("SRResNet", "float32")],
                         ids=["edsr-affine-bf16", "srresnet-folded-f32"])
def test_export_fused_tail(name, dtype, tmp_path):
    """The collapsed (EDSR) and folded (SRResNet) tails export and equal
    their eager routes bit for bit."""
    kw = SMALL_EDSR if name == "EDSR" else {"num_resblocks": 2}
    path = _npz(tmp_path, name, 3, **kw)
    ep = ex.export_predict(name, path, dtype=dtype, fused=True, lr_size=8,
                           device="cpu", cfg_overrides=kw)
    fn = ex._make_fn(ep, torch.device("cpu"))
    predict = make_serving_predict(_model(name, path, 3, dtype, **kw), True)
    x = _x(4, (2, 8, 8, 3))
    with torch.no_grad():
        want = predict(x)
    got = fn(x)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_export_static_batch_refuses_another_batch(espcn):
    ep = ex.export_predict("ESPCN", espcn, num_channels=1, dtype="float32",
                           lr_size=8, symbolic_batch=False, device="cpu")
    fn = ex._make_fn(ep, torch.device("cpu"))
    assert fn.in_shape == (1, 8, 8, 1)
    assert fn(torch.zeros((1, 8, 8, 1))).shape == (1, 32, 32, 1)
    with pytest.raises(Exception):
        fn(torch.zeros((3, 8, 8, 1)))


@pytest.mark.parametrize("case", [
    dict(name="ESPCN", channels=1, sizes=(8, 12)),
    dict(name="ESPCN", channels=1, sizes=(8,), output_u8=True,
         self_ensemble=True),
    dict(name="EDSR", channels=3, sizes=(12, 8), dtype="bfloat16",
         fused=True, overrides=SMALL_EDSR),
    dict(name="LapSRN", channels=1, sizes=(8,), scale=2, trained_scale=4),
    dict(name="SRCNN", channels=1, sizes=(16,)),
], ids=["espcn", "espcn-u8-ensemble", "edsr-fused-bf16", "lapsrn-x2-of-x4",
        "srcnn-preupsample"])
def test_bundle_header_equals_jax_meta(case, tmp_path):
    """The same arguments give the JAX package's metadata, key for key
    (net_scale 1 for a pre-upsample net, 2 for LapSRN's level)."""
    overrides = case.get("overrides")
    path = _npz(tmp_path, case["name"], case["channels"],
                **(overrides or {}))
    kw = dict(scale_factor=case.get("scale", 4),
              num_channels=case["channels"],
              dtype=case.get("dtype", "float32"),
              fused=case.get("fused", False), lr_sizes=case["sizes"],
              cfg_overrides=overrides,
              output_u8=case.get("output_u8", False),
              self_ensemble=case.get("self_ensemble", False),
              trained_scale=case.get("trained_scale"))
    jmeta, _ = jax_export_bundle(case["name"], path, **kw)
    meta, programs = ex.export_bundle(case["name"], path, device="cpu",
                                      **kw)
    assert meta == jmeta
    assert len(programs) == len(meta["buckets"])
    art = str(tmp_path / "b.srtbundle")
    ex.save_bundle(art, meta, programs)
    meta2, buckets = ex.load_bundle(art, device="cpu")
    assert {k: v for k, v in meta2.items() if k != "buckets"} == {
        k: v for k, v in jmeta.items() if k != "buckets"}
    assert [(b["h"], b["w"]) for b in meta2["buckets"]] == [
        (b["h"], b["w"]) for b in jmeta["buckets"]]
    assert all({"offset", "length"} <= set(b) for b in meta2["buckets"])


def test_bundle_roundtrip_and_legacy_artifact(espcn, tmp_path):
    """Buckets load sorted by area and equal the eager model; a legacy
    single artifact loads through the same reader with no metadata."""
    meta, programs = ex.export_bundle("ESPCN", espcn, num_channels=1,
                                      dtype="float32", lr_sizes=(12, 8),
                                      device="cpu")
    art = str(tmp_path / "espcn.srtbundle")
    ex.save_bundle(art, meta, programs)
    meta2, buckets = ex.load_bundle(art, device="cpu")
    assert meta2["net_scale"] == 4 and meta2["model_name"] == "ESPCN"
    assert [(h, w) for h, w, _ in buckets] == [(8, 8), (12, 12)]
    model = _model("ESPCN", espcn, 1)
    for h, w, fn in buckets:
        x = _x(h, (2, h, w, 1))
        with torch.no_grad():
            assert torch.equal(fn(x), model(x))
    legacy = str(tmp_path / "espcn.pt2")
    ex.save_artifact(legacy, ex.export_predict(
        "ESPCN", espcn, num_channels=1, dtype="float32", lr_size=8,
        device="cpu"))
    meta3, buckets3 = ex.load_bundle(legacy, device="cpu")
    assert meta3 is None and [(h, w) for h, w, _ in buckets3] == [(8, 8)]


@pytest.mark.parametrize("fused", [False, True], ids=["exact", "fused"])
def test_static_int8_bundle_equals_eager_int8_bit_for_bit(edsr, fused):
    """Corpus calibration: the program's int8 sites carry the eager
    route's weights and scales as constants, so its output equals the
    eager static route's bit for bit at every bucket and batch."""
    calib = [_x(20 + i, (1, 8, 8, 3)) for i in range(2)]
    meta, programs = ex.export_bundle(
        "EDSR", edsr, dtype="float32", fused=fused, lr_sizes=(8, 12),
        quantize="static", calib_input=[c.numpy() for c in calib],
        device="cpu", cfg_overrides=SMALL_EDSR)
    predict = make_serving_predict(
        _model("EDSR", edsr, 3, **SMALL_EDSR), fused, "static",
        calib_headroom=1.0, calib_batches=calib)
    for ep, b in zip(programs, meta["buckets"]):
        fn = ex._make_fn(ep, torch.device("cpu"))
        for n in (1, 3):
            x = _x(b["h"] + n, (n, b["h"], b["w"], 3))
            with torch.no_grad():
                assert torch.equal(fn(x), predict(x))


def test_static_scales_do_not_depend_on_the_batch_layout(edsr):
    """numpy's ``x[None]`` gives the batch dimension a stride of 0; a
    float conv may take another path for it than for a row-major copy.
    Calibration copies the batch first, so both layouts give the same
    scales, bit for bit (float32 and bfloat16 models)."""
    from sr_torch.quant import calibrate_scales

    img = np.random.default_rng(13).uniform(0, 1, (16, 16, 3)).astype(
        np.float32)
    strided = torch.from_numpy(img[None])
    assert strided.stride()[0] == 0
    row_major = torch.from_numpy(img.reshape(1, 16, 16, 3).copy())
    for dtype in ("float32", "bfloat16"):
        model = _model("EDSR", edsr, 3, dtype, **SMALL_EDSR)
        a = calibrate_scales(model, strided)
        b = calibrate_scales(model, row_major)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_cli_static_int8_bundle_equals_eager(edsr, tmp_path):
    """``python -m sr_torch.export --quantize static --calib_image`` reads
    the images with Pillow; the eager route calibrated on the same images
    as ``x[None]`` arrays serves the same program bit for bit."""
    from PIL import Image

    pngs = []
    for i in range(2):
        p = tmp_path / f"calib{i}.png"
        Image.fromarray(np.random.default_rng(20 + i).integers(
            0, 256, (16, 16, 3), np.uint8)).save(p)
        pngs.append(p)
    art = str(tmp_path / "int8.srtbundle")
    ex.main(["--model_name", "EDSR", "--params", edsr, "--out", art,
             "--dtype", "float32", "--num_resblocks", "2", "--base_filter",
             "16", "--lr_size", "16", "24", "--fused", "--quantize",
             "static", "--calib_image", *map(str, pngs), "--device", "cpu"])
    calib = [torch.from_numpy(
        (np.asarray(Image.open(p), np.float32) / 255.0)[None]) for p in pngs]
    predict = make_serving_predict(_model("EDSR", edsr, 3, **SMALL_EDSR),
                                   True, "static", calib_headroom=1.0,
                                   calib_batches=calib)
    x = _x(14, (3, 24, 24, 3))
    with torch.no_grad():
        want = predict(x)
    got = ex.load_bundle(art, device="cpu")[1][-1][2](x)
    assert torch.equal(got, want)


def test_dynamic_int8_and_u8_artifact_equal_eager(edsr):
    """Dynamic per-sample scales are computed in the program; with
    output_u8 the program returns u8, equal to the eager route."""
    ep = ex.export_predict("EDSR", edsr, dtype="float32", quantize="dynamic",
                           output_u8=True, lr_size=8, device="cpu",
                           cfg_overrides=SMALL_EDSR)
    fn = ex._make_fn(ep, torch.device("cpu"))
    assert fn.out_dtype == torch.uint8
    predict = make_serving_predict(_model("EDSR", edsr, 3, **SMALL_EDSR),
                                   False, "dynamic", output_u8=True)
    x = _x(7, (3, 8, 8, 3))
    with torch.no_grad():
        assert torch.equal(fn(x), predict(x))


def test_pyramid_level_artifact_equals_level_predict(tmp_path):
    """LapSRN trained at ×4 exports its ×2 level: equal to
    ``make_pyramid_level_predict`` bit for bit; int8 does not compose."""
    path = _npz(tmp_path, "LapSRN", 1)
    meta, programs = ex.export_bundle(
        "LapSRN", path, scale_factor=2, num_channels=1, dtype="float32",
        lr_sizes=(8,), trained_scale=4, device="cpu")
    assert meta["net_scale"] == 2 and meta["trained_scale"] == 4
    fn = ex._make_fn(programs[0], torch.device("cpu"))
    predict = make_pyramid_level_predict(
        _model("LapSRN", path, 1), get_spec("LapSRN"), 4, 2)
    x = _x(8, (2, 8, 8, 1))
    with torch.no_grad():
        want = predict(x)
    assert want.shape == (2, 16, 16, 1) and torch.equal(fn(x), want)
    with pytest.raises(ValueError, match="net_scale"):
        ex.export_predict("LapSRN", path, scale_factor=2, num_channels=1,
                          dtype="float32", lr_size=8, trained_scale=4,
                          quantize="dynamic", device="cpu")


def test_baked_ensemble_equals_serve_time_wrap(espcn):
    """The ensemble traced into one program equals the same 8 members run
    through the plain program and averaged outside it (f32, bit for bit:
    the same operators in the same order), and the eager ensemble."""
    ep = ex.export_predict("ESPCN", espcn, num_channels=1, dtype="float32",
                           lr_size=8, self_ensemble=True, device="cpu")
    baked = ex._make_fn(ep, torch.device("cpu"))
    plain = ex._make_fn(ex.export_predict(
        "ESPCN", espcn, num_channels=1, dtype="float32", lr_size=8,
        device="cpu"), torch.device("cpu"))
    x = _x(9, (2, 8, 8, 1))
    wrapped = make_self_ensemble_predict(plain)(x)
    model = _model("ESPCN", espcn, 1)
    with torch.no_grad():
        eager = make_self_ensemble_predict(model)(x)
    got = baked(x)
    assert torch.equal(got, wrapped) and torch.equal(got, eager)


def test_static_int8_ensemble_calibrates_on_the_d4_members(espcn):
    """Export's static calibration of an ensemble program covers all 8
    variants of each calibration batch, as ``sr/export.py`` does."""
    calib = _x(11, (1, 8, 8, 1))
    ep = ex.export_predict("ESPCN", espcn, num_channels=1, dtype="float32",
                           lr_size=8, quantize="static",
                           calib_input=calib.numpy(), self_ensemble=True,
                           device="cpu")
    fn = ex._make_fn(ep, torch.device("cpu"))
    from sr_torch.eval.ensemble import TRANSFORMS, transform

    predict = make_serving_predict(
        _model("ESPCN", espcn, 1), False, "static", calib_headroom=1.0,
        calib_batches=[transform(calib, f, k) for f, k in TRANSFORMS])
    x = _x(12, (2, 8, 8, 1))
    with torch.no_grad():
        assert torch.equal(fn(x), make_self_ensemble_predict(predict)(x))


def test_loading_imports_no_model_code_and_no_jax(espcn, tmp_path):
    """A fresh process loads a bundle and runs it with no sr_torch.models,
    no sr_torch.nn and nothing of JAX imported."""
    meta, programs = ex.export_bundle("ESPCN", espcn, num_channels=1,
                                      dtype="float32", lr_sizes=(8,),
                                      quantize="static", device="cpu")
    art = str(tmp_path / "espcn.srtbundle")
    ex.save_bundle(art, meta, programs)
    code = (
        "import sys, torch\n"
        "from sr_torch.export import load_bundle\n"
        f"meta, buckets = load_bundle({art!r}, device='cpu')\n"
        "y = buckets[0][2](torch.zeros((2, 8, 8, 1)))\n"
        "assert y.shape == (2, 32, 32, 1), y.shape\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'sr') or m.startswith("
        "('sr_torch.models', 'sr_torch.nn'))]\n"
        "print(bad)\n"
        "sys.exit(bool(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_jax_bundle_is_refused(espcn, tmp_path):
    meta, exports = jax_export_bundle("ESPCN", espcn, num_channels=1,
                                      dtype="float32", lr_sizes=(8,))
    art = str(tmp_path / "espcn.srbundle")
    jax_save_bundle(art, meta, exports)
    with pytest.raises(ValueError, match="JAX package"):
        ex.load_bundle(art, device="cpu")


def test_export_defaults_to_the_card(espcn):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.export_predict("ESPCN", espcn, num_channels=1, lr_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.load_bundle("unused.pt2")


def test_cli_writes_an_artifact_and_a_bundle(edsr, tmp_path, capsys):
    """``python -m sr_torch.export``: one --lr_size writes a single
    artifact, several a bundle; --calib_image calibrates static int8 on
    image files (Pillow, resized to the smallest bucket)."""
    from PIL import Image

    imgs = []
    for i in range(2):
        p = tmp_path / f"calib{i}.png"
        Image.fromarray(np.random.default_rng(i).integers(
            0, 256, (20, 24, 3), np.uint8)).save(p)
        imgs.append(str(p))
    single = str(tmp_path / "edsr.pt2")
    ex.main(["--model_name", "EDSR", "--params", edsr, "--out", single,
             "--dtype", "float32", "--num_resblocks", "2", "--base_filter",
             "16", "--lr_size", "8", "--device", "cpu"])
    assert "exported EDSR" in capsys.readouterr().out
    fn = ex.load_artifact(single, device="cpu")
    assert fn.out_shape == (None, 32, 32, 3)
    bundle = str(tmp_path / "edsr.srtbundle")
    ex.main(["--model_name", "EDSR", "--params", edsr, "--out", bundle,
             "--dtype", "float32", "--num_resblocks", "2", "--base_filter",
             "16", "--lr_size", "8", "12", "--fused", "--quantize",
             "static", "--calib_image", *imgs, "--output_u8", "--device",
             "cpu"])
    meta, buckets = ex.load_bundle(bundle, device="cpu")
    assert meta["fused"] and meta["output_u8"] and len(buckets) == 2
    assert buckets[0][2].out_dtype == torch.uint8
    with open(bundle, "rb") as f:
        assert f.read(len(ex._BUNDLE_MAGIC)) == ex._BUNDLE_MAGIC
    header = json.loads(Path(bundle).read_bytes()[
        len(ex._BUNDLE_MAGIC) + 8:].split(b"}]}")[0] + b"}]}")
    assert header["buckets"][1]["offset"] == header["buckets"][0]["length"]
