"""sr_torch's HTTP server in artifact mode, and its micro-batcher, against
the JAX package's (``tests/test_serve.py``'s artifact cases, port side):
the input contract, the pre-upsample bicubic, multi-size bundles, the
luma/chroma path against model mode, micro-batching and its metrics, a
failed chunk delivered to its own callers only, the queue bound, the
serve-time and baked self-ensemble, overload shedding, and the HTTP output
against the JAX package's artifact server on the same weights and image.

Artifacts are exported on the CPU from JAX ``init`` weights with seeded
nonzero biases; the server loads them with ``device="cpu"``, where the
operators take their plain versions.
"""

import http.client
import io
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr.export import export_bundle as jax_export_bundle
from sr.export import save_bundle as jax_save_bundle
from sr.models.registry import get_spec as jax_get_spec
from sr.serve import SRService as JaxSRService
from sr.serve import serve_background as jax_serve_background
from sr.utils.checkpoint import save_params as jax_save_params
from sr.utils.config import SRConfig as JaxSRConfig
from sr_torch.data.native import resize_bicubic_u8
from sr_torch.export import (
    export_bundle, export_predict, save_artifact, save_bundle)
from sr_torch.serve import (
    MicroBatcher, Overloaded, SRService, serve_background)
from test_torch_port_d2s_bias import with_random_biases

torch.set_num_threads(1)


def _png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _unpng(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def _npz(tmp_path, name, channels=1):
    cfg = JaxSRConfig(model_name=name, num_channels=channels,
                      scale_factor=4, dtype="float32")
    model = jax_get_spec(name).make_model(cfg)
    v = model.init(jax.random.key(0), jnp.zeros((1, 16, 16, channels)),
                   train=False)
    params = with_random_biases(jax.tree.map(np.asarray, v["params"]), 3,
                                std=0.05)
    path = str(tmp_path / f"{name}_params.npz")
    jax_save_params(path, params)
    return path


@pytest.fixture(scope="module")
def espcn(tmp_path_factory):
    return _npz(tmp_path_factory.mktemp("serve_artifact"), "ESPCN")


def _post(port, body, results=None, i=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/upscale", body=body)
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    if results is not None:
        results[i] = out
    return out


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    out = json.loads(conn.getresponse().read())
    conn.close()
    return out


def _artifact(tmp_path, params, name="ESPCN", channels=1, size=8, **kw):
    art = str(tmp_path / f"{name.lower()}_{size}.pt2")
    save_artifact(art, export_predict(name, params, num_channels=channels,
                                      dtype="float32", lr_size=size,
                                      device="cpu", **kw))
    return art


def test_artifact_mode_enforces_contract(tmp_path, espcn):
    service = SRService(artifact=_artifact(tmp_path, espcn), scale_factor=4,
                        device="cpu")
    info = service.info()
    assert info["mode"] == "artifact" and info["buckets"] == [[8, 8]]
    assert info["net_scale"] == 4 and info["num_channels"] == 1
    httpd, port = serve_background(service)
    try:
        assert _get(port, "/healthz") == {"ok": True}
        status, body = _post(port, _png(np.zeros((8, 8, 3), np.uint8)))
        assert status == 200, body
        assert _unpng(body).shape == (32, 32, 3)
        # a size no bucket holds is a 400 with a helpful message
        status, body = _post(port, _png(np.zeros((9, 9, 3), np.uint8)))
        assert status == 400 and b"artifact serves 8x8" in body
    finally:
        httpd.shutdown()
        httpd.server_close()
    # the refusals of the JAX package's server
    with pytest.raises(ValueError, match="either"):
        SRService(device="cpu")
    with pytest.raises(ValueError, match="--quantize applies"):
        SRService(artifact="x.pt2", quantize="static", device="cpu")


def test_preupsample_artifact_applies_bicubic(tmp_path):
    """A pre-upsample artifact (SRCNN, HR-size input) takes the LR image;
    the server owes it the bicubic upscale."""
    path = _npz(tmp_path, "SRCNN")
    service = SRService(artifact=_artifact(tmp_path, path, "SRCNN",
                                           size=16),
                        scale_factor=4, device="cpu")
    assert service.net_scale == 1
    lr = np.random.default_rng(0).integers(0, 255, (4, 4, 3), np.uint8)
    out = _unpng(service.upscale_bytes(_png(lr)))
    assert out.shape == (16, 16, 3)


def test_bundle_serves_several_sizes(tmp_path, espcn):
    """One bundle serves exact-bucket and padded sizes, embeds its scale,
    and refuses a contradicting --scale_factor."""
    meta, programs = export_bundle("ESPCN", espcn, num_channels=1,
                                   dtype="float32", lr_sizes=(8, 16),
                                   device="cpu")
    art = str(tmp_path / "espcn.srtbundle")
    save_bundle(art, meta, programs)
    with pytest.raises(ValueError, match="contradicts"):
        SRService(artifact=art, scale_factor=2, device="cpu")
    service = SRService(artifact=art, device="cpu")
    assert service.scale_factor == 4 and service.net_scale == 4
    httpd, port = serve_background(service)
    try:
        rng = np.random.default_rng(1)
        for in_shape, out_shape in (((8, 8), (32, 32)),
                                    ((12, 10), (48, 40)),
                                    ((16, 16), (64, 64))):
            img = rng.integers(0, 255, (*in_shape, 3), np.uint8)
            status, body = _post(port, _png(img))
            assert status == 200, body
            assert _unpng(body).shape == (*out_shape, 3)
        status, body = _post(port, _png(np.zeros((20, 20, 3), np.uint8)))
        assert status == 400 and b"artifact serves" in body
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_artifact_chroma_matches_model_mode(tmp_path, espcn):
    """A 1-channel artifact: the luma through the program, the chroma
    from ``resize_bicubic_u8``, equal to model mode's ``upscale`` at the
    same (f32) compute, byte for byte."""
    art = _artifact(tmp_path, espcn)
    img = np.random.default_rng(2).integers(0, 255, (8, 8, 3), np.uint8)
    a = _unpng(SRService(artifact=art, scale_factor=4,
                         device="cpu").upscale_bytes(_png(img)))
    from sr_torch.infer import upscale

    m = upscale(img, "ESPCN", espcn, dtype="float32", device="cpu")
    assert a.shape == m.shape == (32, 32, 3)
    assert not (a[..., 0] == a[..., 1]).all()  # chroma, not a grey repeat
    np.testing.assert_array_equal(a, m)
    # the chroma is the bicubic upscale's: the output is the program's
    # luma merged with resize_bicubic_u8's Cb/Cr, back in RGB
    from sr_torch.eval.metrics import rgb_to_ycbcr, ycbcr_to_rgb
    from sr_torch.export import load_artifact

    def u8(v):
        return np.clip(np.round(np.asarray(v)), 0, 255).astype(np.uint8)

    ycc = u8(rgb_to_ycbcr(img.astype(np.float32)).numpy())
    luma = load_artifact(art, device="cpu")(
        ycc[None, ..., :1].astype(np.float32) / 255.0)[0].numpy()
    merged = np.concatenate([u8(luma * 255.0),
                             resize_bicubic_u8(ycc, (32, 32))[..., 1:]], -1)
    np.testing.assert_array_equal(
        a, u8(ycbcr_to_rgb(merged.astype(np.float32)).numpy()))


def test_micro_batching_and_metrics(tmp_path, espcn):
    """Concurrent same-bucket requests share fewer program calls than
    requests, each response equals the unbatched path's bytes, and
    /metrics reports the counters."""
    meta, programs = export_bundle("ESPCN", espcn, num_channels=1,
                                   dtype="float32", lr_sizes=(8,),
                                   device="cpu")
    art = str(tmp_path / "espcn_mb.srtbundle")
    save_bundle(art, meta, programs)
    service = SRService(artifact=art, linger_ms=300.0, device="cpu")
    ref_service = SRService(artifact=art, micro_batch=False, device="cpu")
    assert ref_service.batcher is None
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, (8, 8, 3), np.uint8) for _ in range(6)]
    refs = [ref_service.upscale_bytes(_png(im)) for im in imgs]
    httpd, port = serve_background(service)
    results = [None] * len(imgs)
    try:
        threads = [threading.Thread(target=_post,
                                    args=(port, _png(im), results, i))
                   for i, im in enumerate(imgs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(r is not None and r[0] == 200 for r in results), results
        for (_, got), ref in zip(results, refs):
            assert got == ref
        assert service.batcher.dispatches < len(imgs)
        assert service.batcher.batched_requests >= 2
        snap = _get(port, "/metrics")
        assert snap["requests_total"] == len(imgs)
        assert snap["errors_total"] == 0
        assert snap["device_dispatches"] == service.batcher.dispatches
        assert snap["batch_queue_depth"] == 0
        assert snap["latency_ms"]["p50"] > 0
        limits = _get(port, "/info")["limits"]
        assert limits["micro_batch"] == 32 and limits["batch_queue"] == 64
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_preupsample_bundle_lr_wins_bucket_coincidence(tmp_path):
    """A 16px request against a bundle with 16 and 64 buckets is an LR
    image (bicubic to 64, then the net), not an already upscaled one; a
    64px request is too big to be LR and exactly bucket-sized."""
    path = _npz(tmp_path, "SRCNN")
    meta, programs = export_bundle("SRCNN", path, num_channels=1,
                                   dtype="float32", lr_sizes=(16, 64),
                                   device="cpu")
    art = str(tmp_path / "srcnn.srtbundle")
    save_bundle(art, meta, programs)
    service = SRService(artifact=art, device="cpu")
    rng = np.random.default_rng(1)
    out = service._serve_artifact(rng.integers(0, 255, (16, 16, 3),
                                               np.uint8))
    assert out.shape == (64, 64, 3)
    out = service._serve_artifact(rng.integers(0, 255, (64, 64, 3),
                                               np.uint8))
    assert out.shape == (64, 64, 3)


def test_micro_batcher_chunk_failure_isolated():
    """A failure in a later chunk of a split micro-batch fails only that
    chunk's callers; the completed chunk's results still return."""
    mb = MicroBatcher(max_batch=2, linger_s=0.25)
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        if len(calls) == 2:
            raise RuntimeError("chunk 2 failed")
        return torch.from_numpy(x * 2.0)  # a program returns tensors

    results = {}

    def req(i):
        x = np.full((1, 2, 2, 1), float(i), np.float32)
        try:
            results[i] = mb.run("k", fn, x)
        except RuntimeError as e:
            results[i] = e

    threads = [threading.Thread(target=req, args=(i,)) for i in range(3)]
    threads[0].start()
    time.sleep(0.05)  # the leader enqueues first
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert calls == [2, 1]
    ok = [i for i, v in results.items() if isinstance(v, np.ndarray)]
    failed = [i for i, v in results.items() if isinstance(v, RuntimeError)]
    assert len(ok) == 2 and len(failed) == 1
    for i in ok:
        np.testing.assert_array_equal(results[i],
                                      np.full((1, 2, 2, 1), 2.0 * i))
    assert mb.dispatches == 1 and mb.batched_requests == 2


def test_micro_batcher_queue_bound():
    """A full per-bucket queue sheds with Overloaded."""
    mb = MicroBatcher(max_batch=8, linger_s=0.5, max_queue=2)
    release = threading.Event()

    def fn(x):
        release.wait(timeout=30)
        return x

    results = {}

    def req(i):
        x = np.full((1, 2, 2, 1), float(i), np.float32)
        try:
            results[i] = mb.run("k", fn, x)
        except Overloaded as e:
            results[i] = e

    t0 = threading.Thread(target=req, args=(0,))
    t0.start()
    time.sleep(0.05)
    t1 = threading.Thread(target=req, args=(1,))
    t1.start()
    time.sleep(0.05)
    req(2)
    assert isinstance(results[2], Overloaded)
    release.set()
    t0.join(timeout=30)
    t1.join(timeout=30)
    assert isinstance(results[0], np.ndarray)
    assert isinstance(results[1], np.ndarray)
    assert mb.queue_depth() == 0


def test_model_mode_self_ensemble(espcn):
    """--self_ensemble in model mode serves the D4 average."""
    service = SRService(model_name="ESPCN", params=espcn, num_channels=1,
                        fused=False, self_ensemble=True, device="cpu")
    assert service.info().get("self_ensemble") is True
    img = np.random.default_rng(3).integers(0, 255, (16, 12, 3), np.uint8)
    ens = _unpng(service.upscale_bytes(_png(img)))
    plain = _unpng(SRService(model_name="ESPCN", params=espcn,
                             num_channels=1, fused=False,
                             device="cpu").upscale_bytes(_png(img)))
    assert ens.shape == plain.shape == (64, 48, 3)
    assert (ens != plain).any()


def test_artifact_self_ensemble(tmp_path, espcn):
    """A bundle with the ensemble baked in serves over HTTP, reports it,
    and equals model mode's --self_ensemble at f32 byte for byte; a plain
    artifact wrapped at serve time equals the baked one; the serve-time
    wrap refuses non-square buckets."""
    img = np.random.default_rng(5).integers(0, 255, (8, 8, 3), np.uint8)
    from sr_torch.infer import upscale

    ref = upscale(img, "ESPCN", espcn, dtype="float32", self_ensemble=True,
                  device="cpu")
    meta, programs = export_bundle("ESPCN", espcn, num_channels=1,
                                   dtype="float32", lr_sizes=(8,),
                                   self_ensemble=True, device="cpu")
    assert meta["self_ensemble"] is True
    baked = str(tmp_path / "espcn_plus.srtbundle")
    save_bundle(baked, meta, programs)
    svc = SRService(artifact=baked, device="cpu")
    assert svc.info()["self_ensemble"] is True
    httpd, port = serve_background(svc)
    try:
        status, body = _post(port, _png(img))
        assert status == 200, body
        baked_out = _unpng(body)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert baked_out.shape == ref.shape == (32, 32, 3)
    np.testing.assert_array_equal(baked_out, ref)
    svc2 = SRService(artifact=_artifact(tmp_path, espcn), scale_factor=4,
                     self_ensemble=True, device="cpu")
    assert svc2.info()["self_ensemble"] is True
    np.testing.assert_array_equal(_unpng(svc2.upscale_bytes(_png(img))),
                                  baked_out)
    rect = _artifact(tmp_path, espcn, size=(8, 12))
    with pytest.raises(ValueError, match="square buckets"):
        SRService(artifact=rect, self_ensemble=True, device="cpu")


def test_serve_time_ensemble_of_a_u8_artifact_warns(tmp_path, espcn,
                                                     capsys):
    """Over a u8 artifact the members are the program's rounded (and
    clipped) u8 outputs: the server warns, and each bucket averages them
    as ``make_self_ensemble_predict`` does over u8 members, bit for bit."""
    from sr_torch.eval.ensemble import make_self_ensemble_predict
    from sr_torch.export import load_artifact
    from sr_torch.quant import to_u8

    art = _artifact(tmp_path, espcn, output_u8=True)
    svc = SRService(artifact=art, scale_factor=4, self_ensemble=True,
                    device="cpu")
    assert "WARNING" in capsys.readouterr().err
    plain = load_artifact(_artifact(tmp_path, espcn, size=8), device="cpu")
    want = make_self_ensemble_predict(lambda v: to_u8(plain(v)),
                                      output_u8=True)
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (2, 8, 8, 1)).astype(np.float32))
    got = svc.buckets[0][2](x.numpy())
    assert got.dtype == torch.uint8 and torch.equal(got, want(x))
    img = np.random.default_rng(6).integers(0, 255, (8, 8, 3), np.uint8)
    assert svc._serve_artifact(img).shape == (32, 32, 3)


def test_overload_shedding(espcn):
    """max_inflight admission sheds excess concurrent requests with 429,
    an oversized body gets 413, successes stay correct, the concurrency
    never exceeds the bound, and /metrics counts the sheds."""
    service = SRService(model_name="ESPCN", params=espcn, num_channels=1,
                        fused=False, max_inflight=2, device="cpu")
    orig = service.upscale_bytes
    peak = {"now": 0, "max": 0}
    lock = threading.Lock()

    def slow(data):
        with lock:
            peak["now"] += 1
            peak["max"] = max(peak["max"], peak["now"])
        try:
            time.sleep(0.4)
            return orig(data)
        finally:
            with lock:
                peak["now"] -= 1

    service.upscale_bytes = slow
    httpd, port = serve_background(service)
    rng = np.random.default_rng(7)
    sizes = [(16, 12), (8, 8), (12, 16), (16, 16), (8, 12), (12, 8)]
    results = [None] * len(sizes)
    try:
        threads = [threading.Thread(target=_post, args=(
            port, _png(rng.integers(0, 255, (*s, 3), np.uint8)), results,
            i)) for i, s in enumerate(sizes)]
        for t in threads:
            t.start()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.putrequest("POST", "/upscale")
        conn.putheader("Content-Length", str(100 << 20))
        conn.endheaders()
        conn.send(b"x" * 1024)
        conn.sock.shutdown(1)
        resp = conn.getresponse()
        assert resp.status == 413, resp.read()
        conn.close()
        for t in threads:
            t.join(timeout=120)
        statuses = [r[0] for r in results]
        ok = [i for i, s in enumerate(statuses) if s == 200]
        shed = [i for i, s in enumerate(statuses) if s == 429]
        assert len(ok) + len(shed) == len(sizes), statuses
        assert ok and shed
        for i in ok:
            assert _unpng(results[i][1]).shape == (sizes[i][0] * 4,
                                                   sizes[i][1] * 4, 3)
        assert peak["max"] <= 2
        snap = _get(port, "/metrics")
        assert snap["shed_total"] == len(shed) and snap["inflight"] == 0
        assert "device_dispatches" not in snap  # model mode: no batcher
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("name,size,img_shape", [
    ("ESPCN", 12, (10, 12)),   # sub-pixel net on Y, a padded bucket
    ("SRCNN", 32, (8, 7)),     # pre-upsample: the host bicubic input
], ids=["espcn", "srcnn"])
def test_http_output_within_one_level_of_jax(tmp_path, name, size,
                                             img_shape):
    """The same weights exported by both packages at f32 and served over
    HTTP: the port's response is within 1 u8 level of the JAX package's
    (float rounding may straddle a .5 level)."""
    path = _npz(tmp_path, name)
    jmeta, jexports = jax_export_bundle(name, path, num_channels=1,
                                        dtype="float32", lr_sizes=(size,))
    jart = str(tmp_path / "jax.srbundle")
    jax_save_bundle(jart, jmeta, jexports)
    meta, programs = export_bundle(name, path, num_channels=1,
                                   dtype="float32", lr_sizes=(size,),
                                   device="cpu")
    art = str(tmp_path / "port.srtbundle")
    save_bundle(art, meta, programs)
    img = np.random.default_rng(8).integers(0, 255, (*img_shape, 3),
                                            np.uint8)
    outs = []
    for service, serve in ((JaxSRService(artifact=jart),
                            jax_serve_background),
                           (SRService(artifact=art, device="cpu"),
                            serve_background)):
        httpd, port = serve(service)
        try:
            status, body = _post(port, _png(img))
            assert status == 200, body
            outs.append(_unpng(body))
        finally:
            httpd.shutdown()
            httpd.server_close()
    want, got = outs
    assert got.shape == want.shape == (img_shape[0] * 4, img_shape[1] * 4,
                                       3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
