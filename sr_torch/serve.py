"""Minimal HTTP serving endpoint for trained SR models (model mode).

Port of ``sr/serve.py``'s model mode: ``--model_name --params`` serves any
input size through :func:`sr_torch.infer.upscale` (fused or folded tail,
halo tiling, int8 with ``--quantize``) on ``--device`` (the card by
default). A batch-norm model's ``.npz`` (SRResNet, SRGAN's generator)
carries its running statistics, which it serves with.
Artifact mode and its micro-batcher land with the export slice.

Endpoints:
  GET  /healthz          -> {"ok": true}
  GET  /info             -> serving config (mode, model, device, limits)
  GET  /metrics          -> request/error/latency counters
  POST /upscale          -> request body: PNG/JPEG bytes;
                            response: image/png of the upscaled image

A 1-channel model (ESPCN, SRCNN, VDSR, DRCN, FSRCNN, LapSRN)
super-resolves the luma of the decoded RGB image and returns RGB, as
``upscale`` does; a pre-upsample model (SRCNN, VDSR, DRCN) takes the image
bicubic-upscaled on the host. ``--net_scale`` serves a pyramid model
(LapSRN) trained at that scale at a smaller ``--scale_factor`` from its
intermediate level.

Usage:
  python -m sr_torch.serve --model_name EDSR --params EDSR_params.npz --port 8000
  python -m sr_torch.serve --model_name EDSR --params EDSR_params.npz --quantize static
  python -m sr_torch.serve --model_name ESPCN --params ESPCN_params.npz
  python -m sr_torch.serve --model_name VDSR --params VDSR_params.npz --quantize dynamic
  python -m sr_torch.serve --model_name SRGAN --params SRGAN_params.npz --quantize static
  python -m sr_torch.serve --model_name LapSRN --params LapSRN_params.npz --net_scale 4 --scale_factor 2
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from sr_torch.infer import resolve_device, upscale


class Overloaded(Exception):
    """Request shed under load (mapped to HTTP 429)."""


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

    def snapshot(self) -> dict:
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
        return out


class SRService:
    """The request-independent serving state (model mode)."""

    def __init__(self, model_name=None, params=None, artifact=None,
                 scale_factor: int | None = None, fused: bool = True,
                 num_channels: int | None = None,
                 quantize: bool | str = False, calib_headroom: float = 1.25,
                 max_inflight: int = 16, device: str = "cuda",
                 net_scale: int | None = None):
        if artifact is not None:
            raise NotImplementedError(
                "artifact mode lands in a later port slice")
        if model_name is None or params is None:
            raise ValueError("pass --model_name and --params")
        self.mode = "model"
        self.model_name = model_name
        self.params = params
        self.scale_factor = 4 if scale_factor is None else scale_factor
        self.fused = fused
        self.num_channels = num_channels
        self.quantize = quantize
        self.calib_headroom = calib_headroom
        # a pyramid model trained at net_scale can serve a smaller
        # scale_factor from its intermediate level (LapSRN)
        self.net_scale = net_scale
        self.device = resolve_device(device)
        self.stats = ServeStats()
        self.max_body_bytes = 64 << 20
        # admission control: at most max_inflight requests hold decoded
        # bodies / run inference at once; the rest are shed with 429
        self.max_inflight = max_inflight
        self._admission = threading.BoundedSemaphore(max_inflight)

    def info(self) -> dict:
        return {
            "mode": self.mode,
            "model_name": self.model_name,
            "scale_factor": self.scale_factor,
            "net_scale": self.net_scale,
            "fused": self.fused,
            "quantize": self.quantize,
            "device": str(self.device),
            "limits": {"max_inflight": self.max_inflight,
                       "max_body_bytes": self.max_body_bytes},
            "input_shape": [None, None, None, None],
        }

    def upscale_array(self, img: np.ndarray) -> np.ndarray:
        return upscale(img, self.model_name, self.params,
                       scale_factor=self.scale_factor,
                       num_channels=self.num_channels, fused=self.fused,
                       quantize=self.quantize,
                       calib_headroom=self.calib_headroom,
                       net_scale=self.net_scale, device=self.device)

    def upscale_bytes(self, data: bytes) -> bytes:
        from PIL import Image

        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        buf = io.BytesIO()
        Image.fromarray(self.upscale_array(img)).save(buf, format="PNG")
        return buf.getvalue()


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
                self._json(200, service.stats.snapshot())
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
    p.add_argument("--scale_factor", type=int, default=None,
                   help="model scale (default 4)")
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
        model_name=a.model_name, params=a.params,
        scale_factor=a.scale_factor, fused=not a.no_fused,
        num_channels=a.num_channels,
        quantize=a.quantize, calib_headroom=a.calib_headroom,
        max_inflight=a.max_inflight, device=a.device,
        net_scale=a.net_scale,
    )
    httpd = make_server(service, a.port, a.host)
    print(f"serving {service.info()} on {a.host}:{httpd.server_address[1]}")
    httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
