"""sr_torch serving against the JAX package: upscale, the HTTP server, and
the port's isolation from JAX.

One ``.npz`` written by ``sr.utils.checkpoint.save_params`` feeds both
packages' ``upscale``. The port runs with ``device="cpu"`` here, where its
kernels take their plain PyTorch versions.
"""

import ast
import http.client
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.infer import upscale as jax_upscale
from sr.models.edsr import Net as FlaxEDSR
from sr.utils.checkpoint import save_params as jax_save_params
from sr_torch.infer import make_serving_predict, upscale
from sr_torch.models.edsr import Net
from sr_torch.models.registry import get_spec
from sr_torch.serve import SRService, serve_background
from sr_torch.utils.checkpoint import save_params
from sr_torch.utils.config import SRConfig
from sr_torch.utils.interop import to_jax_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "flax", "optax", "sr"}


@pytest.fixture(scope="module")
def edsr_params(tmp_path_factory):
    """Full-width EDSR ×4 (what ``upscale`` builds), weights from a JAX
    init scaled like a trained EDSR's (small residual branches, mid-grey
    output bias) so the u8 outputs are not saturated."""
    model = FlaxEDSR(3, 64, 16, 4)
    v = model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), train=False)
    params = jax.tree.map(np.array, v["params"])
    for i in range(16):
        params[f"blocks_{i}"]["Conv_1"]["kernel"] *= 0.1
    params["out_conv"]["Conv_0"]["bias"][:] = 0.5
    path = str(tmp_path_factory.mktemp("port_serve") / "EDSR_params.npz")
    jax_save_params(path, params)
    return path


def _img(seed, h=14, w=11):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_upscale_matches_jax_within_one_level(edsr_params):
    """f32 on both sides; the u8 outputs may differ where float rounding
    straddles a .5 level: at most 1 level."""
    img = _img(0)
    want = jax_upscale(img, "EDSR", edsr_params, scale_factor=4,
                       dtype="float32")
    got = upscale(img, "EDSR", edsr_params, scale_factor=4, dtype="float32",
                  device="cpu")
    assert got.shape == want.shape == (56, 44, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert 10 < want.mean() < 245  # not saturated


def test_upscale_float_output_and_tiling(edsr_params):
    """A tiled upscale equals the full-image one (halo = EDSR's receptive
    field); the float output path rounds on the host like the u8 path."""
    img = _img(1, 30, 26)
    full = upscale(img, "EDSR", edsr_params, dtype="float32", tile=None,
                   device="cpu")
    tiled = upscale(img, "EDSR", edsr_params, dtype="float32", tile=12,
                    device="cpu")
    host = upscale(img, "EDSR", edsr_params, dtype="float32", tile=None,
                   output_u8=False, device="cpu")
    for other in (tiled, host):
        assert np.abs(other.astype(np.int32) - full).max() <= 1


def test_upscale_defaults_to_the_card(edsr_params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        upscale(_img(2), "EDSR", edsr_params)


def test_upscale_refuses_what_a_later_slice_brings(edsr_params, tmp_path):
    # the self-ensemble serves since the export slice
    # (tests/test_torch_ensemble.py): 8 D4 members, averaged
    ens = upscale(_img(3), "EDSR", edsr_params, dtype="float32",
                  self_ensemble=True, device="cpu")
    assert ens.shape == (56, 44, 3) and ens.dtype == np.uint8
    # 1-channel models serve since ESPCN (tests/test_torch_espcn.py) and
    # pre-upsample models (bicubic input: SRCNN, VDSR, DRCN) since slice 9
    # (tests/test_torch_preupsample_serve.py): SRCNN's net keeps its
    # input's size, and the image comes out ×4
    path = str(tmp_path / "SRCNN_params.npz")
    save_params(path, to_jax_params(get_spec("SRCNN").make_model(
        SRConfig(model_name="SRCNN"), torch.Generator().manual_seed(0))))
    assert upscale(_img(3), "SRCNN", path, dtype="float32",
                   device="cpu").shape == (56, 44, 3)
    # net_scale serves a pyramid model's level since LapSRN's slice
    # (tests/test_torch_lapsrn_serve.py); a model without levels is
    # refused, for every input convention, as sr.infer refuses it
    for name, params in (("EDSR", edsr_params), ("SRCNN", path)):
        with pytest.raises(ValueError, match="no intermediate scales"):
            upscale(_img(3), name, params, scale_factor=2, net_scale=4,
                    device="cpu")
    with pytest.raises(ValueError, match="quantize must be"):
        make_serving_predict(Net(3, 16, 1, 4), fused=False, quantize="int4")


def test_server_model_mode_roundtrip(edsr_params):
    service = SRService(model_name="EDSR", params=edsr_params, scale_factor=4,
                        device="cpu")
    httpd, port = serve_background(service)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read()) == {"ok": True}
        conn.request("GET", "/info")
        info = json.loads(conn.getresponse().read())
        assert info["model_name"] == "EDSR" and info["device"] == "cpu"
        assert info["fused"] is True

        img = _img(4, 12, 16)
        conn.request("POST", "/upscale", body=_png(img),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200, body
        from PIL import Image

        got = np.asarray(Image.open(io.BytesIO(body)))
        want = upscale(img, "EDSR", edsr_params, fused=True, device="cpu")
        np.testing.assert_array_equal(got, want)

        conn.request("POST", "/upscale", body=b"not an image")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 400
        conn.request("GET", "/metrics")
        metrics = json.loads(conn.getresponse().read())
        assert metrics["requests_total"] == 2 and metrics["errors_total"] == 1
        assert "p50" in metrics["latency_ms"]
        conn.request("GET", "/nowhere")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_service_refuses_artifact_mode(edsr_params):
    # artifact mode serves since the export slice
    # (tests/test_torch_serve_artifact.py); what it refuses: int8 flags
    # on an artifact (int8 is baked in at export), both modes at once, and
    # a model without params
    with pytest.raises(ValueError, match="--quantize applies"):
        SRService(artifact="edsr.pt2", quantize="static", device="cpu")
    with pytest.raises(ValueError, match="either"):
        SRService(artifact="edsr.pt2", model_name="EDSR",
                  params=edsr_params, device="cpu")
    with pytest.raises(ValueError):
        SRService(model_name="EDSR", device="cpu")


def _port_sources():
    return sorted((ROOT / "sr_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")


def test_importing_the_port_loads_no_jax():
    code = ("import sys, sr_torch.infer, sr_torch.serve, sr_torch.export, "
            "sr_torch.eval.ensemble, sr_torch.kernels.ops, sr_torch.main, "
            "sr_torch.compat, sr_torch.eval.panels, sr_torch.utils.logging, "
            "sr_torch.utils.profiling, sr_torch.utils.refckpt, "
            "sr_torch.parallel, sr_torch.eval.tiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
