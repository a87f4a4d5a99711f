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
from sr_torch.serve import SRService, serve_background

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


def test_upscale_refuses_what_a_later_slice_brings(edsr_params):
    with pytest.raises(NotImplementedError, match="later port slice"):
        upscale(_img(3), "EDSR", edsr_params, self_ensemble=True,
                device="cpu")
    with pytest.raises(NotImplementedError, match="later port slice"):
        upscale(_img(3), "EDSR", edsr_params, num_channels=1, device="cpu")
    with pytest.raises(NotImplementedError, match="later port slice"):
        upscale(_img(3), "EDSR", edsr_params, scale_factor=2, net_scale=4,
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
    with pytest.raises(NotImplementedError, match="later port slice"):
        SRService(artifact="edsr.hloart")
    with pytest.raises(ValueError):
        SRService(model_name="EDSR")


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
    code = ("import sys, sr_torch.infer, sr_torch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
