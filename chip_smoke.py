#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sr_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU (Hopper,
``sm_90a``), the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero without the final line:

1. Refuse to run without a card; print the toolchain and the card's name
   and power limit.
2. Build the CUDA kernels from ``sr_torch/kernels/csrc`` into ``build/``.
3. Hold each kernel against its plain PyTorch version on the card, and time
   kernel, plain version, one library call and the bound at the serving
   path's shapes (CUDA events, median of 30).
4. Serve EDSR ×4 (16 resblocks × 64 filters, RGB, seeded random weights
   saved in the JAX package's .npz format) through ``sr_torch.infer.upscale``
   and the port's HTTP server: exact and fused tails, bf16 and f32, three
   image sizes, one of them tiled. Launch counts are zeroed just before and
   read just after; both kernels must have run.
5. Throughput of the exact and fused bf16 paths at 128² LR → 512² out, b16,
   and a torch.profiler breakdown of their device time by kernel.

It prints a ``{"kernels": [...]}`` JSON line, then the card line, then as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import http.client
import importlib.metadata
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, n: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, one CUDA event pair per call."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_toolchain() -> str:
    from sr_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    card = card_line()
    print(f"[1] torch {torch.__version__}  torch.version.cuda "
          f"{torch.version.cuda}")
    print(f"[1] nvcc: {nvcc.strip().splitlines()[-1]}")
    print(f"[1] triton {importlib.metadata.version('triton')}")
    print(f"[1] card: {card}")
    return card


def phase_build() -> float:
    from sr_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[2] {name}: {len(regs)} kernels, registers "
              f"{min(regs)}-{max(regs)}, spill stores max {max(spills)} B")
    print(f"[2] build seconds {seconds:.1f} ({len(logs)} sources compiled "
          "in parallel)")
    return seconds


def _resblock_operands(shape, dtype, gen):
    b, h, w, c = shape
    x = torch.rand(shape, device="cuda", generator=gen).to(dtype)
    std = (1.0 / (9 * c)) ** 0.5
    w1, w2 = ((torch.randn(9 * c, c, device="cuda", generator=gen) * std)
              .to(dtype) for _ in range(2))
    b1, b2 = (torch.randn(c, device="cuda", generator=gen) * 0.1
              for _ in range(2))
    return x, w1, b1, w2, b2


def phase_kernels(card: str) -> list[dict]:
    from sr_torch.kernels.depth_to_space import (
        depth_to_space, depth_to_space_plain)
    from sr_torch.kernels.fused_resblock import (
        fused_resblock, fused_resblock_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    # depth_to_space: exact equality, odd H and W included
    n, d2s_err = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for r in (2, 3, 4):
            for act in (None, "relu"):
                for b, h, w, c in ((2, 5, 7, 3), (2, 17, 9, 64)):
                    x = torch.randn((b, h, w, c * r * r), device="cuda",
                                    generator=gen).to(dtype)
                    got = depth_to_space(x, r, act)
                    want = depth_to_space_plain(x, r, act)
                    torch.cuda.synchronize()
                    d2s_err = max(d2s_err, float(
                        (got.float() - want.float()).abs().max()))
                    check(torch.equal(got, want),
                          f"depth_to_space differs: {dtype} r={r} act={act} "
                          f"{(b, h, w, c)}")
                    n += 1
    print(f"[3] depth_to_space == plain on {n} cases (exact)")

    # fused_resblock: tolerances from f32 summation order over K=576, and
    # about one bf16 ulp at these magnitudes (outputs below 4)
    main_err = None
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((16, 128, 128, 64), (2, 37, 53, 64), (2, 24, 40, 32)):
            for rs in (1.0, 0.1):
                ops = _resblock_operands(shape, dtype, gen)
                got = fused_resblock(*ops, res_scale=rs)
                want = fused_resblock_plain(*ops, res_scale=rs)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                print(f"[3] fused_resblock {str(dtype)[6:]} {shape} "
                      f"res_scale={rs}: max |kernel - plain| {err:.3g} "
                      f"(tol {TOL[dtype]})")
                check(err <= TOL[dtype], "fused_resblock disagrees")
                if dtype == torch.bfloat16 and shape[0] == 16 and rs == 1.0:
                    main_err = err

    entries = []
    # depth_to_space at the serving path's shapes (b16 bf16 128² LR)
    for stage, (h, cin) in enumerate(((128, 256), (256, 256), (128, 48))):
        r = 4 if cin == 48 else 2
        x = torch.randn((16, h, h, cin), device="cuda",
                        generator=gen).to(torch.bfloat16)
        xc = x.permute(0, 3, 1, 2)  # the same memory as NCHW channels_last
        got = depth_to_space(x, r)
        d2s_err = max(d2s_err, float(
            (got.float() - depth_to_space_plain(x, r).float()).abs().max()))
        check(d2s_err == 0.0, f"depth_to_space differs at {tuple(x.shape)}")
        t_k = time_ms(lambda: depth_to_space(x, r))
        t_p = time_ms(lambda: depth_to_space_plain(x, r).contiguous())
        t_l = time_ms(lambda: F.pixel_shuffle(xc, r))
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        print(f"[3] depth_to_space {tuple(x.shape)} r={r} bf16: kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, F.pixel_shuffle "
              f"{t_l:.4f} ms, bound {bound:.4f} ms (bytes) | {card}")
        if stage == 1:  # the largest shuffle of the exact path
            entries.append(dict(
                name="depth_to_space", route="cuda",
                source="sr_torch/kernels/csrc/depth_to_space.cu",
                replaces="sr/kernels/depth_to_space.py:73", launches=None,
                max_abs_err=d2s_err, ms=t_k, plain_ms=t_p, bound_ms=bound,
                bound_by="bytes", library_ms=t_l, shape=list(x.shape),
                dtype="bfloat16"))

    # fused_resblock at EDSR's body shape
    for dtype in (torch.bfloat16, torch.float32):
        shape = (16, 128, 128, 64)
        x, w1, b1, w2, b2 = _resblock_operands(shape, dtype, gen)
        c = shape[-1]
        t_k = time_ms(lambda: fused_resblock(x, w1, b1, w2, b2))
        t_p = time_ms(lambda: fused_resblock_plain(x, w1, b1, w2, b2))
        xc = x.permute(0, 3, 1, 2)
        k1, k2 = (w.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) for w in (w1, w2))
        lb1, lb2 = b1.to(dtype), b2.to(dtype)
        t_l = time_ms(lambda: xc + F.conv2d(
            F.relu(F.conv2d(xc, k1, lb1, padding=1)), k2, lb2, padding=1))
        flops = 2 * 2 * x.numel() * 9 * c
        nbytes = (2 * x.numel() + 2 * 9 * c * c) * x.element_size() + 2 * c * 4
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        print(f"[3] fused_resblock {shape} {str(dtype)[6:]}: kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, conv-relu-conv-add "
              f"{t_l:.4f} ms, bound {bound:.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}) | {card}")
        if dtype == torch.bfloat16:
            entries.append(dict(
                name="fused_resblock", route="cuda",
                source="sr_torch/kernels/csrc/fused_resblock.cu",
                replaces="sr/kernels/fused_resblock.py:119", launches=None,
                max_abs_err=main_err, ms=t_k, plain_ms=t_p, bound_ms=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=t_l, shape=list(shape), dtype="bfloat16"))
    return entries


def _seeded_edsr(dtype: str):
    """Full-width EDSR ×4 with seeded random weights, scaled like a trained
    EDSR's: small residual branches and a mid-grey output bias, so the
    outputs spread over [0, 1] instead of saturating."""
    from sr_torch.models.registry import get_spec
    from sr_torch.utils.config import SRConfig

    cfg = SRConfig(model_name="EDSR", num_channels=3, scale_factor=4,
                   dtype=dtype)
    model = get_spec("EDSR").make_model(
        cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for blk in model.blocks:
            blk.Conv_1.weight.mul_(0.1)
        model.out_conv.Conv_0.bias.fill_(0.5)
    return cfg, model


def _png(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def phase_serve(entries: list[dict]) -> Path:
    from sr_torch.infer import upscale
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.kernels.fused_resblock import fused_resblock
    from sr_torch.serve import SRService, serve_background
    from sr_torch.utils.checkpoint import load_params, save_params
    from sr_torch.utils.interop import from_jax_params, to_jax_params
    from sr_torch.utils.precision import no_tf32

    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "EDSR_x4_seed0.npz"
    cfg, model = _seeded_edsr("float32")
    save_params(str(path), to_jax_params(model))

    rng = np.random.default_rng(0)
    # 400×260 exceeds one 336-px window (tile 256 + 2·halo 40): 4 tiles
    sizes = ((128, 128), (96, 160), (400, 260))
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]

    # ---- the main path: counts zeroed just before, read just after ----
    depth_to_space.launches = 0
    fused_resblock.launches = 0
    outs = {}
    for dtype in ("bfloat16", "float32"):
        for fused in (False, True):
            for img in imgs:
                t0 = time.perf_counter()
                out = upscale(img, "EDSR", str(path), scale_factor=4,
                              dtype=dtype, fused=fused, output_u8=True)
                ms = (time.perf_counter() - t0) * 1e3
                h, w = img.shape[:2]
                check(out.shape == (4 * h, 4 * w, 3) and out.dtype == np.uint8,
                      f"upscale output {out.shape} {out.dtype}")
                outs[dtype, fused, img.shape] = out
                print(f"[4] upscale {h}x{w} {dtype} "
                      f"{'fused' if fused else 'exact'}: {out.shape} uint8 "
                      f"in {ms:.1f} ms (host clock, first call loads)")
    service = SRService(model_name="EDSR", params=str(path), scale_factor=4)
    httpd, port = serve_background(service)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    for route in ("/healthz", "/info"):
        conn.request("GET", route)
        resp = conn.getresponse()
        check(resp.status == 200, f"GET {route}: {resp.status}")
        print(f"[4] GET {route}: {resp.read().decode()}")
    from PIL import Image

    for img in imgs:
        conn.request("POST", "/upscale", body=_png(img),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        body = resp.read()
        check(resp.status == 200, f"POST /upscale: {resp.status} {body[:200]}")
        got = np.asarray(Image.open(io.BytesIO(body)))
        check(np.array_equal(got, outs["bfloat16", True, img.shape]),
              "served PNG differs from a direct upscale")
    conn.request("GET", "/metrics")
    print(f"[4] POST /upscale x{len(imgs)} == direct upscale; /metrics: "
          f"{conn.getresponse().read().decode()}")
    conn.close()
    launches = {"depth_to_space": depth_to_space.launches,
                "fused_resblock": fused_resblock.launches}
    httpd.shutdown()
    httpd.server_close()
    print(f"[4] main-path launches: {launches}")
    for e in entries:
        e["launches"] = launches[e["name"]]
        check(e["launches"] > 0, f"{e['name']} never launched on the path")

    # ---- per-forward counts (the loaded functions are cached) ----
    for fused, want_d2s in ((False, 2), (True, 1)):
        d0, r0 = depth_to_space.launches, fused_resblock.launches
        upscale(imgs[0], "EDSR", str(path), fused=fused)
        got = (fused_resblock.launches - r0, depth_to_space.launches - d0)
        print(f"[4] one {'fused' if fused else 'exact'} forward: "
              f"fused_resblock +{got[0]}, depth_to_space +{got[1]}")
        check(got == (16, want_d2s), "unexpected launches per forward")

    # ---- card f32 forward == CPU f32 forward (plain versions) ----
    params, _ = load_params(str(path))
    _, cpu_model = _seeded_edsr("float32")
    from_jax_params(cpu_model, params)
    _, gpu_model = _seeded_edsr("float32")
    gpu_model = from_jax_params(gpu_model, params).cuda()
    x = torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode(), no_tf32():
        on_card = gpu_model(x.cuda()).cpu()
        on_cpu = cpu_model(x)
    err = float((on_card - on_cpu).abs().max())
    print(f"[4] f32 64x64 forward, card vs CPU: max abs err {err:.3g} "
          "(tol 1e-3, TF32 off)")
    check(err <= 1e-3, "card forward differs from the CPU forward")

    # ---- fused interior == exact interior (border band 3 LR px × 4) ----
    # f32: the two paths differ by float rounding only (TF32 in cuDNN's
    # f32 convs), which flips a u8 rounding now and then: at most 1 level.
    # bf16: the composite kernel is rounded to bf16 once where the exact
    # tail rounds after every stage: a few levels, below 1 on average.
    m = 3 * 4
    worst = []
    for dtype, max_lv, mean_lv in (("float32", 1, 0.5), ("bfloat16", 8, 1.0)):
        for img in imgs:
            a = outs[dtype, True, img.shape].astype(np.int32)
            b = outs[dtype, False, img.shape].astype(np.int32)
            d = np.abs(a - b)[m:-m, m:-m]
            print(f"[4] fused vs exact interior {img.shape[:2]} {dtype}: max "
                  f"{d.max()} u8 levels, mean {d.mean():.4f} "
                  f"(tol {max_lv} / {mean_lv})")
            worst.append(d.max() <= max_lv and d.mean() <= mean_lv)
    check(all(worst), "fused interior differs from exact")
    return path


def phase_throughput(path: Path, card: str) -> None:
    from sr_torch.infer import make_serving_predict
    from sr_torch.utils.checkpoint import load_params
    from sr_torch.utils.interop import from_jax_params

    _, model = _seeded_edsr("bfloat16")
    model = from_jax_params(model, load_params(str(path))[0]).cuda().eval()
    x = torch.rand((16, 128, 128, 3), device="cuda")
    mp = 16 * 512 * 512 / 1e6
    with torch.inference_mode():
        for fused in (False, True):
            fn = make_serving_predict(model, fused)
            name = "fused" if fused else "exact"
            ms = time_ms(lambda: fn(x), n=20)
            print(f"[5] EDSR x4 {name} bf16 b16 128->512: {ms:.3f} ms/batch, "
                  f"{mp / ms * 1e3:.1f} MP/s | {card}")
            profile_batches(lambda: fn(x), name)


def profile_batches(fn, name: str, n: int = 5) -> None:
    """Device time by kernel over ``n`` batches, and the device's busy
    share of the window from the first to the last kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    if not kernels:
        print(f"[5] profile {name}: the profiler saw no device time "
              "(not measured)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    # from the first kernel's start to the last one's end: the profiler's
    # own start and stop stay outside the window
    window = max(end for _, end in spans) - spans[0][0]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    print(f"[5] profile {name}: device busy {busy / n / 1e3:.3f} ms/batch of "
          f"a {window / n / 1e3:.3f} ms/batch window "
          f"({100 * busy / window:.1f}% busy)")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[5]   {us / n / 1e3:8.3f} ms/batch {100 * us / total:5.1f}%  "
              f"{kname[:150]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = phase_toolchain()
    phase_build()
    entries = phase_kernels(card)
    path = phase_serve(entries)
    phase_throughput(path, card)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
