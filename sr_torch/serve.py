"""Minimal HTTP serving endpoint for trained SR models.

Port of ``sr/serve.py``. Two serving surfaces in one stdlib HTTP server:

  * model mode (``--model_name --params``): any input size, through
    :func:`sr_torch.infer.upscale` (fused or folded tail, halo tiling, int8
    with ``--quantize``, the D4 self-ensemble with ``--self_ensemble``) on
    ``--device`` (the card by default). A batch-norm model's ``.npz``
    (SRResNet, SRGAN's generator) carries its running statistics, which it
    serves with;
  * artifact mode (``--artifact``): a program exported by
    ``sr_torch.export`` (a legacy single artifact or a multi-bucket
    bundle), loaded onto ``--device`` with no model code. Bundles embed
    their training scale and conventions and carry N input sizes; each
    request takes the smallest bucket that holds the image, edge-padded,
    and the output is cropped. A ``--scale_factor`` contradicting a
    bundle's is refused at startup.

Concurrent artifact-mode requests that land in the same bucket are
micro-batched (:class:`MicroBatcher`): a leader thread lingers a few ms,
stacks every queued image into one batch and makes one call of the
program, whose symbolic batch dimension takes any stack size.

Endpoints:
  GET  /healthz          -> {"ok": true}
  GET  /info             -> serving config (mode, model, device, limits)
  GET  /metrics          -> request/error/latency/batching counters
  POST /upscale          -> request body: PNG/JPEG bytes;
                            response: image/png of the upscaled image

A 1-channel model or artifact (ESPCN, SRCNN, VDSR, DRCN, FSRCNN, LapSRN)
super-resolves the luma of the decoded RGB image, merges bicubic-upscaled
chroma and returns RGB, as ``upscale`` does; a pre-upsample model (SRCNN,
VDSR, DRCN) takes the image bicubic-upscaled on the host. ``--net_scale``
serves a pyramid model (LapSRN) trained at that scale at a smaller
``--scale_factor`` from its intermediate level.

Usage:
  python -m sr_torch.serve --model_name EDSR --params EDSR_params.npz --port 8000
  python -m sr_torch.serve --model_name EDSR --params EDSR_params.npz --quantize static
  python -m sr_torch.serve --model_name ESPCN --params ESPCN_params.npz
  python -m sr_torch.serve --model_name VDSR --params VDSR_params.npz --quantize dynamic
  python -m sr_torch.serve --model_name SRGAN --params SRGAN_params.npz --quantize static
  python -m sr_torch.serve --model_name LapSRN --params LapSRN_params.npz --net_scale 4 --scale_factor 2
  python -m sr_torch.serve --artifact edsr_x4.bundle
  python -m sr_torch.serve --artifact edsr_x4.pt2 --scale_factor 4 --self_ensemble
"""

from __future__ import annotations

import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from sr_torch.utils.device import resolve_device


class Overloaded(Exception):
    """Request shed under load (mapped to HTTP 429)."""


def _host(y) -> np.ndarray:
    """A program's output as a host array, in its own dtype (u8 stays
    u8)."""
    if isinstance(y, torch.Tensor):
        return y.cpu().numpy()
    return np.asarray(y)


class MicroBatcher:
    """Leader/follower request coalescing per static-shape bucket.

    ``run(key, fn, x)``: the first thread to enqueue for ``key`` becomes
    the leader: it sleeps ``linger_s``, takes everything queued for that
    bucket, runs ``fn`` on the stacked batch (in chunks of ``max_batch``),
    and hands each caller its slice. Followers block on an event. A chunk
    failure propagates to the callers whose chunk did not complete;
    finished chunks' results still return.

    ``max_queue`` bounds the per-bucket queue: a request arriving at a full
    queue raises :class:`Overloaded` (HTTP 429) instead of growing host
    memory without limit. ``dispatches`` counts the calls of ``fn``,
    ``batched_requests`` the requests that shared one.
    """

    def __init__(self, max_batch: int = 32, linger_s: float = 0.003,
                 max_queue: int = 64):
        self.max_batch = max_batch
        self.linger_s = linger_s
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._queues: dict = {}
        self.dispatches = 0
        self.batched_requests = 0

    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def run(self, key, fn, x: np.ndarray) -> np.ndarray:
        item = {"x": x, "evt": threading.Event(), "out": None, "err": None}
        with self._lock:
            q = self._queues.setdefault(key, [])
            if len(q) >= self.max_queue:
                raise Overloaded(
                    f"micro-batch queue full ({self.max_queue} queued "
                    f"for bucket {key}); retry later")
            q.append(item)
            leader = len(q) == 1
        if not leader:
            item["evt"].wait()
            if item["err"] is not None:
                raise item["err"]
            return item["out"]
        if self.linger_s:
            time.sleep(self.linger_s)
        with self._lock:
            batch = self._queues.pop(key)
        try:
            for start in range(0, len(batch), self.max_batch):
                chunk = batch[start:start + self.max_batch]
                ys = _host(fn(np.concatenate([b["x"] for b in chunk],
                                             axis=0)))
                for i, b in enumerate(chunk):
                    b["out"] = ys[i:i + 1]
                with self._lock:
                    self.dispatches += 1
                    if len(chunk) > 1:
                        self.batched_requests += len(chunk)
        except Exception as e:  # noqa: BLE001 — delivered to its callers
            # only to callers whose chunk did not complete: earlier
            # chunks' results are computed and good
            for b in batch:
                if b["out"] is None:
                    b["err"] = e
        finally:
            for b in batch:
                b["evt"].set()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]


class ServeStats:
    """Thread-safe request counters + bounded latency reservoir."""

    def __init__(self, keep: int = 1024):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.sheds = 0  # 429s (overload) — not counted as errors
        self.inflight = 0
        self._lat = []
        self._keep = keep

    def record(self, ms: float, error: bool) -> None:
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            else:
                self._lat.append(ms)
                if len(self._lat) > self._keep:
                    del self._lat[: len(self._lat) - self._keep]

    def record_shed(self) -> None:
        with self._lock:
            self.requests += 1
            self.sheds += 1

    def enter(self) -> None:
        with self._lock:
            self.inflight += 1

    def exit(self) -> None:
        with self._lock:
            self.inflight -= 1

    def snapshot(self, batcher: MicroBatcher | None = None) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            out = {"requests_total": self.requests,
                   "errors_total": self.errors,
                   "shed_total": self.sheds,
                   "inflight": self.inflight}
            if lat:
                def pct(p):
                    return round(lat[min(len(lat) - 1, int(p * len(lat)))], 2)
                out["latency_ms"] = {
                    "p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
                    "mean": round(sum(lat) / len(lat), 2),
                }
        if batcher is not None:
            out["device_dispatches"] = batcher.dispatches
            out["batched_requests"] = batcher.batched_requests
            out["batch_queue_depth"] = batcher.queue_depth()
        return out


def _ensemble_bucket(fn):
    """A loaded bucket's ``fn`` wrapped in the D4 self-ensemble at serve
    time: the transforms run around the program's calls, so one program
    serves all 8 members. A u8 program's members are already rounded (up
    to half a level each); baking the ensemble in at export keeps them
    float."""
    from sr_torch.eval.ensemble import make_self_ensemble_predict

    emits_u8 = fn.out_dtype == torch.uint8
    if emits_u8:
        print("[serve] WARNING: --self_ensemble over an output_u8 artifact "
              "averages u8-rounded members; re-export with "
              "self_ensemble=True for the float-member '+' mode",
              file=sys.stderr)
    device = fn.program_device
    ens = make_self_ensemble_predict(fn, output_u8=emits_u8)

    def out(x):
        return ens(torch.as_tensor(x, dtype=torch.float32, device=device))

    for attr in ("program", "program_device", "in_shape", "out_shape"):
        setattr(out, attr, getattr(fn, attr))
    out.out_dtype = torch.uint8 if emits_u8 else torch.float32
    return out


class SRService:
    """The request-independent serving state, loaded once: a model
    (``model_name`` + ``params``) or an exported ``artifact``."""

    def __init__(self, model_name=None, params=None, artifact=None,
                 scale_factor: int | None = None, fused: bool = True,
                 num_channels: int | None = None,
                 micro_batch: bool = True, linger_ms: float = 3.0,
                 quantize: bool | str = False, calib_headroom: float = 1.25,
                 self_ensemble: bool = False,
                 max_inflight: int = 16, max_queue: int = 64,
                 device: str = "cuda", net_scale: int | None = None):
        if (artifact is None) == (model_name is None):
            raise ValueError("pass either --artifact or --model_name and "
                             "--params")
        if quantize and artifact is not None:
            # an artifact is traced already: int8 is baked in at export
            raise ValueError(
                "--quantize applies to model mode; for artifacts, export "
                "with quantize (python -m sr_torch.export --quantize)")
        self.mode = "artifact" if artifact is not None else "model"
        self.model_name = model_name
        self.params = params
        self.fused = fused
        self.num_channels = num_channels
        self.quantize = quantize
        self.calib_headroom = calib_headroom
        self.self_ensemble = self_ensemble
        self.device = resolve_device(device)
        self.stats = ServeStats()
        self.max_body_bytes = 64 << 20
        # admission control: at most max_inflight requests hold decoded
        # bodies / run inference at once; the rest are shed with 429
        self.max_inflight = max_inflight
        self._admission = threading.BoundedSemaphore(max_inflight)
        self.batcher = (
            MicroBatcher(linger_s=linger_ms / 1e3, max_queue=max_queue)
            if micro_batch and artifact is not None else None)
        if artifact is None:
            if params is None:
                raise ValueError("--model_name needs --params")
            self.scale_factor = 4 if scale_factor is None else scale_factor
            self.buckets = None
            # a pyramid model trained at net_scale can serve a smaller
            # scale_factor from its intermediate level (LapSRN)
            self.net_scale = net_scale
            return
        from sr_torch.export import load_bundle

        self.meta, self.buckets = load_bundle(artifact, self.device)
        if self.meta is not None and self.meta.get("self_ensemble"):
            # baked into the program; --self_ensemble is then a no-op and
            # /info reports it either way
            self.self_ensemble = True
        elif self_ensemble:
            bad = [(h, w) for h, w, _ in self.buckets if h != w]
            if bad:
                raise ValueError(
                    f"--self_ensemble needs square buckets (rot90 swaps "
                    f"H and W), the artifact has {bad}; re-export with "
                    "self_ensemble=True instead")
            self.buckets = [(h, w, _ensemble_bucket(fn))
                            for h, w, fn in self.buckets]
        if self.meta is not None:
            # the bundle knows its training scale: a contradicting flag is
            # a configuration error, not something to serve through
            art_scale = int(self.meta["scale_factor"])
            if scale_factor is not None and scale_factor != art_scale:
                raise ValueError(
                    f"--scale_factor {scale_factor} contradicts the "
                    f"artifact's embedded training scale x{art_scale}")
            self.scale_factor = art_scale
            self.channels = int(self.meta["num_channels"])
            self.model_name = self.meta.get("model_name")
            self.net_scale = int(self.meta["net_scale"])
        else:
            # legacy single artifact: conventions come from the flags
            fn = self.buckets[0][2]
            self.scale_factor = 4 if scale_factor is None else scale_factor
            self.channels = fn.in_shape[3]
            self.net_scale = fn.out_shape[1] // fn.in_shape[1]

    def info(self) -> dict:
        out = {"mode": self.mode, "model_name": self.model_name,
               "scale_factor": self.scale_factor,
               "net_scale": self.net_scale, "device": str(self.device)}
        if self.self_ensemble:
            out["self_ensemble"] = True
        out["limits"] = {"max_inflight": self.max_inflight,
                         "max_body_bytes": self.max_body_bytes}
        if self.batcher is not None:
            out["limits"]["batch_queue"] = self.batcher.max_queue
            out["limits"]["micro_batch"] = self.batcher.max_batch
        if self.mode == "artifact":
            out["buckets"] = [[h, w] for h, w, _ in self.buckets]
            out["num_channels"] = self.channels
        else:
            out["fused"] = self.fused
            out["quantize"] = self.quantize
            out["input_shape"] = [None, None, None, None]
        return out

    def _serve_artifact(self, img_rgb: np.ndarray) -> np.ndarray:
        """Bucketed artifact inference: the smallest bucket that holds the
        (pre-upsampled) image, edge padding, one program call (shared with
        concurrent requests of that bucket), the crop. 1-channel artifacts
        super-resolve the luma and merge bicubic-upscaled chroma, as model
        mode (``sr_torch.infer.upscale``) does."""
        from sr_torch.data.native import resize_bicubic_u8
        from sr_torch.eval.metrics import rgb_to_ycbcr, ycbcr_to_rgb

        r, ns, c = self.scale_factor, self.net_scale, self.channels
        ih, iw = img_rgb.shape[:2]
        if c == 1:
            # the u8 rounding of upscale, so both modes give equal outputs
            work = _u8(rgb_to_ycbcr(img_rgb.astype(np.float32)).numpy())
        else:
            work = img_rgb
        if ns == 1:
            # pre-upsample model: the client sends the LR image. The LR
            # reading wins whenever ih*r fits a bucket; only an image too
            # big to be an LR input but exactly bucket-sized is taken as
            # upscaled already (else a 64px LR request against a 64px
            # bucket would silently skip SR)
            out_h, out_w = ih * r, iw * r
            fits_as_lr = any(h >= out_h and w >= out_w
                             for h, w, _ in self.buckets)
            if not fits_as_lr and any((ih, iw) == (h, w)
                                      for h, w, _ in self.buckets):
                model_img = work
                out_h, out_w = ih, iw
            else:
                model_img = resize_bicubic_u8(work, (out_h, out_w))
            bc_full = model_img  # chroma source, already at output size
        else:
            model_img = work
            out_h, out_w = ih * ns, iw * ns
            bc_full = (resize_bicubic_u8(work, (out_h, out_w))
                       if c == 1 else None)
        mh, mw = model_img.shape[:2]
        bucket = next(((h, w, fn) for h, w, fn in self.buckets
                       if h >= mh and w >= mw), None)
        if bucket is None:
            sizes = "/".join(f"{h}x{w}" for h, w, _ in self.buckets)
            hint = (f" (pre-upsample: LR up to {self.buckets[-1][0] // r}x"
                    f"{self.buckets[-1][1] // r})" if ns == 1 else "")
            raise ValueError(
                f"artifact serves {sizes} inputs, got {mh}x{mw}{hint} "
                "(export more bucket sizes, or use model mode for "
                "arbitrary sizes)")
        bh, bw, fn = bucket
        net_in = model_img[..., :1] if c == 1 else model_img
        x = net_in.astype(np.float32) / 255.0
        if (bh, bw) != (mh, mw):
            x = np.pad(x, ((0, bh - mh), (0, bw - mw), (0, 0)), mode="edge")
        if self.batcher is not None:
            # concurrent same-bucket requests share one program call
            out = self.batcher.run((bh, bw), fn, x[None])
        else:
            out = _host(fn(x[None]))
        if out.dtype == np.uint8:  # exported with output_u8
            sr_u8 = out[0][:out_h, :out_w]
        else:
            sr_u8 = _u8(out.astype(np.float32)[0][:out_h, :out_w] * 255.0)
        if c == 1:
            merged = np.concatenate([sr_u8[..., :1], bc_full[..., 1:]],
                                    axis=-1)
            sr_u8 = _u8(ycbcr_to_rgb(merged.astype(np.float32)).numpy())
        return sr_u8

    def upscale_array(self, img: np.ndarray) -> np.ndarray:
        if self.mode == "artifact":
            return self._serve_artifact(img)
        from sr_torch.infer import upscale

        return upscale(img, self.model_name, self.params,
                       scale_factor=self.scale_factor,
                       num_channels=self.num_channels, fused=self.fused,
                       quantize=self.quantize,
                       calib_headroom=self.calib_headroom,
                       self_ensemble=self.self_ensemble,
                       net_scale=self.net_scale, device=self.device)

    def upscale_bytes(self, data: bytes) -> bytes:
        from PIL import Image

        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        buf = io.BytesIO()
        Image.fromarray(self.upscale_array(img)).save(buf, format="PNG")
        return buf.getvalue()


def _u8(y) -> np.ndarray:
    """A float [0, 255] array → uint8, rounded half to even and clipped."""
    return np.clip(np.round(np.asarray(y)), 0, 255).astype(np.uint8)


def make_server(service: SRService, port: int = 0,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; port 0 = ephemeral (tests).

    ``host`` defaults to loopback; pass 0.0.0.0 to serve remote traffic
    behind a reverse proxy (one thread per connection; bodies bounded at
    64 MB, concurrent work at ``max_inflight`` with 429 shedding)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj, headers=()):
            self._send(code, json.dumps(obj).encode(), "application/json",
                       headers)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/info":
                self._json(200, service.info())
            elif self.path == "/metrics":
                self._json(200, service.stats.snapshot(service.batcher))
            else:
                self._json(404, {"error": "not found"})

        def _drain(self, n: int):
            # consume the declared body in bounded chunks so the client
            # sees the status instead of a broken pipe mid-upload
            left = n
            while left > 0:
                chunk = self.rfile.read(min(left, 1 << 20))
                if not chunk:
                    break
                left -= len(chunk)

        def do_POST(self):
            if self.path != "/upscale":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "bad Content-Length"})
                return
            if n > service.max_body_bytes:
                self._drain(n)
                self._json(413, {"error": "payload too large"})
                return
            # admission control BEFORE buffering the body
            if not service._admission.acquire(blocking=False):
                self._drain(n)
                service.stats.record_shed()
                self._json(429, {"error": "server overloaded, retry later"},
                           headers=(("Retry-After", "1"),))
                return
            try:
                data = self.rfile.read(n)
                t0 = time.perf_counter()
                service.stats.enter()
                try:
                    png = service.upscale_bytes(data)
                except Overloaded as e:
                    service.stats.record_shed()
                    self._json(429, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    service.stats.record((time.perf_counter() - t0) * 1e3,
                                         True)
                    self._json(400, {"error": str(e)})
                    return
                finally:
                    service.stats.exit()
                service.stats.record((time.perf_counter() - t0) * 1e3, False)
                self._send(200, png, "image/png")
            finally:
                service._admission.release()

    return ThreadingHTTPServer((host, port), Handler)


def serve_background(service: SRService, port: int = 0):
    """Start the server on a daemon thread; returns (server, actual_port).
    Stop it with ``server.shutdown(); server.server_close()``."""
    httpd = make_server(service, port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, httpd.server_address[1]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_name", default=None)
    p.add_argument("--params", default=None)
    p.add_argument("--artifact", default=None,
                   help="a program or bundle from python -m "
                        "sr_torch.export, served without model code")
    p.add_argument("--scale_factor", type=int, default=None,
                   help="model mode and legacy artifacts (default 4); "
                        "bundles embed it and refuse a contradiction")
    p.add_argument("--num_channels", type=int, default=None)
    p.add_argument("--net_scale", type=int, default=None,
                   help="pyramid models (LapSRN): the scale the params were "
                        "trained at; serve a smaller --scale_factor from "
                        "its intermediate level")
    p.add_argument("--no_fused", action="store_true",
                   help="serve the exact graph instead of the fast tail")
    p.add_argument("--quantize", nargs="?", const="dynamic", default=False,
                   choices=["dynamic", "static"],
                   help="int8 convs: 'static' calibrates activation scales "
                        "on the first request (bare flag = dynamic)")
    p.add_argument("--calib_headroom", type=float, default=1.25,
                   help="scale headroom for --quantize static's "
                        "first-request calibration (clip margin for "
                        "hotter later inputs)")
    p.add_argument("--micro_batch", dest="micro_batch",
                   action="store_true", default=True,
                   help="artifact mode: coalesce concurrent same-bucket "
                        "requests into one program call (the default)")
    p.add_argument("--no_micro_batch", dest="micro_batch",
                   action="store_false",
                   help="one program call a request")
    p.add_argument("--linger_ms", type=float, default=3.0,
                   help="micro-batch window: how long the first request "
                        "of a bucket waits for company")
    p.add_argument("--max_queue", type=int, default=64,
                   help="per-bucket micro-batch queue bound (artifact "
                        "mode); a full queue sheds with 429")
    p.add_argument("--self_ensemble", action="store_true",
                   help="serve the D4 geometric self-ensemble (8 forwards "
                        "a request; artifacts: square buckets)")
    p.add_argument("--max_inflight", type=int, default=16,
                   help="admission bound: concurrent requests allowed to "
                        "buffer bodies / run inference; excess get 429")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; 'cpu' "
                        "runs the kernels' plain PyTorch versions)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; 0.0.0.0 exposes "
                        "the server — front it with a reverse proxy)")
    a = p.parse_args(argv)
    service = SRService(
        model_name=a.model_name, params=a.params, artifact=a.artifact,
        scale_factor=a.scale_factor, fused=not a.no_fused,
        num_channels=a.num_channels,
        micro_batch=a.micro_batch, linger_ms=a.linger_ms,
        quantize=a.quantize, calib_headroom=a.calib_headroom,
        self_ensemble=a.self_ensemble,
        max_inflight=a.max_inflight, max_queue=a.max_queue,
        device=a.device, net_scale=a.net_scale,
    )
    httpd = make_server(service, a.port, a.host)
    print(f"serving {service.info()} on {a.host}:{httpd.server_address[1]}")
    httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
