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
   path's shapes (device time: CUDA events around 20 calls queued behind a
   sleep kernel, so the host's launch overhead stays out; median of 5).
   One wgmma product must match a plain matmul; the int8 conv (raw and
   fused entries) must equal its plain version exactly, the shuffle too
   (f32, bf16 and u8, with and without the PS conv's bias).
4. Serve EDSR ×4 (16 resblocks × 64 filters, RGB, seeded random weights
   and nonzero biases saved in the JAX package's .npz format) through
   ``sr_torch.infer.upscale`` and the port's HTTP server: exact and fused
   tails, bf16 and f32, three image sizes, one of them tiled. Then the int8
   paths (static exact, static fused, dynamic) on the same images and one
   POST to an int8 service.
   Launch counts are zeroed just before each of the two runs and read just
   after; every kernel of a run must have run (the int8 paths through the
   fused int8 entry). Per-forward launch counts,
   card == CPU (f32 float forward within 1e-3, the static int8 graph bit
   for bit), and int8 against float interiors.
5. Throughput of the exact and fused bf16 paths and of the int8-static
   exact and fused paths at 128² LR → 512² out, b16, and a torch.profiler
   breakdown of their device time by kernel; the bf16 profiles must show
   no add over a shuffled conv's output (the shuffle adds that bias), the
   int8 profiles no quantize pass (its ``round`` kernel).

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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,  # dense, no TF32
              torch.int8: 1979e12}
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
    """Median time of ``fn`` in ms, one CUDA event pair per call: the span
    on the card from the first kernel's queueing to the last one's end, so
    it includes gaps where the card waits for the host (end to end)."""
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


def kernel_ms(fn, n: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` in ms, the host's launch overhead
    left out: a sleep kernel holds the stream while the host queues ``n``
    calls between two events, which the card then runs back to back. The
    median over ``reps`` of the span over ``n``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    cycles = int((2 * n * host_s + 1e-3) * 2e9)  # SM clocks are below 2 GHz
    spans = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end) / n)
    return statistics.median(spans)


def host_us(fn, n: int = 20) -> float:
    """Host time of one call of ``fn`` in µs: what the caller's thread
    spends to queue it (the card is idle and synchronised first)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


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


def _kernel_operands(ops):
    """The resblock kernel's operands: bf16 weights in the wgmma layout,
    packed once as ResnetBlock.packed() caches them; f32 as they are."""
    from sr_torch.kernels.fused_resblock import pack_wgmma_weights

    x, w1, b1, w2, b2 = ops
    if x.dtype == torch.bfloat16:
        w1, w2 = pack_wgmma_weights(w1), pack_wgmma_weights(w2)
    return x, w1, b1, w2, b2


def _d2s_operands(shape, dtype, gen, with_bias):
    """A shuffle's input, and a bias of its channels (None for u8)."""
    if dtype == torch.uint8:
        x = torch.randint(0, 256, shape, device="cuda", generator=gen)
        return x.to(dtype), None
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    bias = (torch.randn(shape[-1], device="cuda", generator=gen).to(dtype)
            if with_bias else None)
    return x, bias


#: the serving path's shuffles at b16, 128² LR: (H, C·r², r). bf16 exact
#: runs the two r=2 stages with the PS convs' biases, bf16 fused the r=4
#: tail; the int8 paths run the same shapes in f32, and the fused-quant
#: tail in u8.
D2S_SHAPES = ((128, 256, 2), (256, 256, 2), (128, 48, 4))


def _d2s_serving(card: str, gen, d2s_err: float) -> dict:
    """The shuffle at the serving shapes: exact against its plain version
    with and without bias; times of the kernel (with the bias too), the
    plain version, F.pixel_shuffle and the bytes bound. Returns the JSON
    entry, at the largest bf16 shuffle of the exact path."""
    from sr_torch.kernels.depth_to_space import (
        depth_to_space, depth_to_space_plain)

    entry = None
    for dtype in (torch.bfloat16, torch.float32, torch.uint8):
        for h, cin, r in D2S_SHAPES:
            if dtype == torch.uint8 and r != 4:
                continue  # u8 is the fused-quant tail's output only
            x, bias = _d2s_operands((16, h, h, cin), dtype, gen, True)
            xc = x.permute(0, 3, 1, 2)  # the same memory as NCHW channels_last
            for b_ in (None, bias) if bias is not None else (None,):
                got = depth_to_space(x, r, None, b_)
                want = depth_to_space_plain(x, r, None, b_)
                d2s_err = max(d2s_err, float(
                    (got.float() - want.float()).abs().max()))
                check(torch.equal(got, want),
                      f"depth_to_space differs at {tuple(x.shape)} r={r} "
                      f"{dtype} bias={b_ is not None}")
                del got, want
            t_k = kernel_ms(lambda: depth_to_space(x, r))
            t_h = host_us(lambda: depth_to_space(x, r))
            t_p = kernel_ms(lambda: depth_to_space_plain(x, r).contiguous())
            t_l = kernel_ms(lambda: F.pixel_shuffle(xc, r))
            bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            with_bias = ""
            if bias is not None:
                t_kb = kernel_ms(lambda: depth_to_space(x, r, None, bias))
                t_pb = kernel_ms(lambda: depth_to_space_plain(
                    x, r, None, bias).contiguous())
                with_bias = (f"; with bias: kernel {t_kb:.4f} ms, plain "
                             f"{t_pb:.4f} ms")
            print(f"[3] depth_to_space {tuple(x.shape)} r={r} "
                  f"{str(dtype)[6:]}: kernel {t_k:.4f} ms, plain {t_p:.4f} "
                  f"ms, F.pixel_shuffle {t_l:.4f} ms, bound {bound:.4f} ms "
                  f"(bytes){with_bias}; host {t_h:.1f} us a call | {card}")
            if dtype == torch.bfloat16 and h == 256:
                entry = dict(
                    name="depth_to_space", route="cuda",
                    source="sr_torch/kernels/csrc/depth_to_space.cu",
                    replaces="sr/kernels/depth_to_space.py:73", launches=None,
                    max_abs_err=None, ms=t_k, plain_ms=t_p, bound_ms=bound,
                    bound_by="bytes", library_ms=t_l, shape=list(x.shape),
                    dtype="bfloat16", ms_with_bias=t_kb,
                    plain_ms_with_bias=t_pb)
            del x, xc, bias
    entry["max_abs_err"] = d2s_err
    return entry


def phase_kernels(card: str) -> list[dict]:
    from sr_torch.kernels.depth_to_space import (
        depth_to_space, depth_to_space_plain)
    from sr_torch.kernels.fused_resblock import (
        fused_resblock, fused_resblock_plain, wgmma_matmul)
    from sr_torch.utils.precision import no_tf32

    gen = torch.Generator(device="cuda").manual_seed(0)
    # one wgmma product first: the resblock's bf16 body is built on it
    a, b = (torch.randn((64, 64), device="cuda", generator=gen).div(8)
            .bfloat16() for _ in range(2))
    mm_err = float((wgmma_matmul(a, b) - a.float() @ b.float()).abs().max())
    print(f"[3] wgmma m64n64k16 x4 product vs plain matmul: max err "
          f"{mm_err:.3g} (tol 1e-4)")
    check(mm_err <= 1e-4, "wgmma product disagrees with a plain matmul")
    # depth_to_space: exact equality, with and without bias, odd H and W
    n, d2s_err = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        for r in (2, 3, 4):
            for act in (None, "relu"):
                for b, h, w, c in ((2, 5, 7, 3), (2, 17, 9, 64)):
                    for with_bias in (False, True):
                        if dtype == torch.uint8 and (with_bias or act):
                            continue
                        x, bias = _d2s_operands((b, h, w, c * r * r), dtype,
                                                gen, with_bias)
                        got = depth_to_space(x, r, act, bias)
                        want = depth_to_space_plain(x, r, act, bias)
                        torch.cuda.synchronize()
                        d2s_err = max(d2s_err, float(
                            (got.float() - want.float()).abs().max()))
                        check(torch.equal(got, want),
                              f"depth_to_space differs: {dtype} r={r} "
                              f"act={act} {(b, h, w, c)} bias={with_bias}")
                        n += 1
    print(f"[3] depth_to_space == plain on {n} cases (exact; f32, bf16, u8; "
          "with and without bias)")

    # fused_resblock: tolerances from f32 summation order over K=576, and
    # about one bf16 ulp at these magnitudes (outputs below 4)
    main_err = None
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((16, 128, 128, 64), (2, 37, 53, 64), (2, 24, 40, 32)):
            for rs in (1.0, 0.1):
                ops = _resblock_operands(shape, dtype, gen)
                got = fused_resblock(*_kernel_operands(ops), res_scale=rs)
                want = fused_resblock_plain(*ops, res_scale=rs)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                print(f"[3] fused_resblock {str(dtype)[6:]} {shape} "
                      f"res_scale={rs}: max |kernel - plain| {err:.3g} "
                      f"(tol {TOL[dtype]})")
                check(err <= TOL[dtype], "fused_resblock disagrees")
                if dtype == torch.bfloat16 and shape[0] == 16 and rs == 1.0:
                    main_err = err

    entries = [_d2s_serving(card, gen, d2s_err)]

    # fused_resblock at EDSR's body shape
    for dtype in (torch.bfloat16, torch.float32):
        shape = (16, 128, 128, 64)
        ops = _resblock_operands(shape, dtype, gen)
        x, w1, b1, w2, b2 = ops
        c = shape[-1]
        kops = _kernel_operands(ops)
        t_k = kernel_ms(lambda: fused_resblock(*kops))
        t_p = kernel_ms(lambda: fused_resblock_plain(x, w1, b1, w2, b2))
        xc = x.permute(0, 3, 1, 2)
        k1, k2 = (w.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) for w in (w1, w2))
        lb1, lb2 = b1.to(dtype), b2.to(dtype)
        def library():
            return xc + F.conv2d(F.relu(F.conv2d(xc, k1, lb1, padding=1)),
                                 k2, lb2, padding=1)

        t_l = kernel_ms(library)  # PyTorch's default: TF32 for f32 convs
        with no_tf32():
            t_l32 = kernel_ms(library)
        flops = 2 * 2 * x.numel() * 9 * c
        nbytes = (2 * x.numel() + 2 * 9 * c * c) * x.element_size() + 2 * c * 4
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        tf32 = (f" (TF32 on); TF32 off {t_l32:.4f} ms"
                if dtype == torch.float32 else "")
        print(f"[3] fused_resblock {shape} {str(dtype)[6:]}: kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, conv-relu-conv-add "
              f"{t_l:.4f} ms{tf32}, bound {bound:.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}) | {card}")
        if dtype == torch.bfloat16:
            entries.append(dict(
                name="fused_resblock", route="cuda",
                source="sr_torch/kernels/csrc/fused_resblock.cu",
                replaces="sr/kernels/fused_resblock.py:119", launches=None,
                max_abs_err=main_err, ms=t_k, plain_ms=t_p, bound_ms=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=t_l, shape=list(shape), dtype="bfloat16"))
        else:  # the f32 body's numbers ride on the same entry
            entries[-1].update(f32_ms=t_k, f32_plain_ms=t_p,
                               f32_bound_ms=bound, f32_library_ms=t_l,
                               f32_library_ms_tf32_off=t_l32)
    return entries


#: the int8 path's conv shapes at b16, 128² LR: (name, B, H, W, C, N, k)
INT8_SHAPES = (
    ("head", 16, 128, 128, 3, 64, 3),
    ("body", 16, 128, 128, 64, 64, 3),  # 32 block convs + body_conv
    ("PS stage 1", 16, 128, 128, 64, 256, 3),
    ("PS stage 2", 16, 256, 256, 64, 256, 3),
    ("out conv", 16, 512, 512, 64, 3, 3),
    ("fused-quant tail", 16, 128, 128, 64, 48, 7),
)


def _int_mm_operands(q_x, q_w):
    """The same contraction as one (M, K) × (K, N) int8 GEMM: an unfolded
    (im2col) matrix built beforehand, K and N zero-padded to multiples of
    8 as ``torch._int_mm`` needs. Built in half precision (exact for
    int8), then cast."""
    b, h, w, c = q_x.shape
    k, n = q_w.shape[0], q_w.shape[-1]
    cols = F.unfold(q_x.permute(0, 3, 1, 2).half(), k, padding=k // 2)
    a = cols.transpose(1, 2).reshape(b * h * w, c * k * k)
    kp, np_ = -(-a.shape[1] // 8) * 8, -(-n // 8) * 8
    a = F.pad(a, (0, kp - a.shape[1])).to(torch.int8).contiguous()
    wm = q_w.permute(2, 0, 1, 3).reshape(c * k * k, n).half()
    wm = F.pad(wm, (0, np_ - n, 0, kp - wm.shape[0])).to(torch.int8)
    return a, wm.contiguous()


def _fused_operands(gen, shape, n, mode):
    """The fused int8 entry's operands as the int8 sites make them: f32
    input with ±127 saturation and .5 ties (exact at a power-of-two
    per-tensor scale, within a few ulps at per-channel scales that are not
    powers of two), a per-tensor, per-channel or per-sample scale, the
    dequantize table and a bias."""
    b, h, w, c = shape
    x = torch.randn(shape, device="cuda", generator=gen) * 2
    s_w = torch.rand(n, device="cuda", generator=gen) * 1e-3 + 1e-4
    if mode == "per_tensor":
        scale = torch.tensor(2.0 ** -4, device="cuda")
        dequant = scale * s_w
    elif mode == "per_channel":
        # not powers of two: x / s lands within a few ulps of .5 ties
        scale = torch.rand(c, device="cuda", generator=gen) * 0.05 + 0.01
        dequant = s_w
    else:
        scale = torch.clamp_min(
            x.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0, 1e-12)
        dequant = scale * s_w
    if mode != "dynamic":
        x[:, 0] = ((torch.arange(w * c, device="cuda").reshape(w, c) % 41
                    - 20) + 0.5) * scale
        x[:, -1, 0] = 300.0 * scale
    bias = torch.randn(n, device="cuda", generator=gen)
    return x.contiguous(), scale, dequant, bias


def phase_int8_conv(card: str) -> dict:
    """Kernel 3 on the card: the raw entry exact against its plain version,
    the bf16 instantiation within tolerance, the fused entry (quantize on
    load, dequantize and bias on store) bit for bit against its plain
    version, and times at the int8 path's shapes."""
    from sr_torch.kernels.int8_conv import (
        conv_bf16_im2col, conv_bf16_plain, conv_int8_fused,
        conv_int8_fused_plain, conv_int8_im2col, conv_int8_plain,
        pack_weights)

    gen = torch.Generator(device="cuda").manual_seed(3)

    def q(shape):
        return torch.randint(-127, 128, shape, device="cuda",
                             generator=gen).to(torch.int8)

    cases = [((2, 5, 7, 3), 64, 3), ((2, 17, 9, 64), 64, 3),
             ((2, 17, 9, 64), 256, 3), ((2, 16, 16, 64), 3, 3),
             ((2, 13, 11, 64), 48, 7)]
    for shape, n, k in cases:
        q_x, q_w = q(shape), q((k, k, shape[-1], n))
        check(torch.equal(conv_int8_im2col(q_x, q_w),
                          conv_int8_plain(q_x, q_w)),
              f"int8_conv differs at {shape} -> {n}, k={k}")
    sat_x = torch.full((1, 8, 8, 64), 127, dtype=torch.int8, device="cuda")
    sat_w = torch.full((3, 3, 64, 64), -127, dtype=torch.int8, device="cuda")
    sat = conv_int8_im2col(sat_x, sat_w)
    check(torch.equal(sat, conv_int8_plain(sat_x, sat_w))
          and int(sat.min()) == -9 * 64 * 127 * 127,
          "int8_conv differs on saturated inputs")
    print(f"[3] int8_conv raw entry == plain on {len(cases) + 1} cases "
          "(exact, ±127 saturation included)")
    n_fused = 0
    for shape, n, k in cases:
        q_w = q((k, k, shape[-1], n))
        packed = pack_weights(q_w)
        for mode in ("per_tensor", "per_channel", "dynamic"):
            x, scale, dequant, bias = _fused_operands(gen, shape, n, mode)
            for b_ in (bias, None):
                got = conv_int8_fused(x, q_w, scale, dequant, b_,
                                      packed=packed)
                want = conv_int8_fused_plain(x, q_w, scale, dequant, b_)
                check(torch.equal(got, want),
                      f"fused int8 conv differs: {shape} -> {n}, k={k}, "
                      f"{mode}, bias={b_ is not None}")
                n_fused += 1
        inv = 1.0 / (torch.rand(shape[-1], device="cuda", generator=gen)
                     * 0.05 + 0.01)
        check(torch.equal(
            conv_int8_fused(x, q_w, inv, dequant, bias, reciprocal=True,
                            packed=packed),
            conv_int8_fused_plain(x, q_w, inv, dequant, bias,
                                  reciprocal=True)),
            f"fused int8 conv (reciprocal scale) differs at {shape}")
        n_fused += 1
    print(f"[3] int8_conv fused entry == plain on {n_fused} cases (bit for "
          "bit; per-tensor, per-channel, per-sample and reciprocal scales, "
          ".5 ties, ±127 saturation, with and without bias)")
    bf_err = 0.0
    for shape, n, k in cases:
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        w = (torch.randn((k, k, shape[-1], n), device="cuda", generator=gen)
             / (k * k * shape[-1]) ** 0.5).bfloat16()
        bf_err = max(bf_err, float((conv_bf16_im2col(x, w)
                                    - conv_bf16_plain(x, w)).abs().max()))
    print(f"[3] int8_conv bf16 instantiation: max |kernel - plain| "
          f"{bf_err:.3g} (tol 1e-3)")
    check(bf_err <= 1e-3, "bf16 conv disagrees")

    entry = None
    for name, b, h, w, c, n, k in INT8_SHAPES:
        q_w = q((k, k, c, n))
        packed = pack_weights(q_w)  # once, as the int8 sites pack it
        # bit for bit at the path's shapes: the per-sample (dynamic) scale
        # with its (B, 1, 1, N) dequantize table; the per-channel scale (as
        # timed); at the tail, the fused-quant tail's reciprocal scale
        x, scale, dequant, bias = _fused_operands(gen, (b, h, w, c), n,
                                                  "dynamic")
        check(torch.equal(
            conv_int8_fused(x, q_w, scale, dequant, bias, packed=packed),
            conv_int8_fused_plain(x, q_w, scale, dequant, bias)),
            f"fused int8 conv (per-sample scale) differs at the {name} shape")
        x, scale, dequant, bias = _fused_operands(gen, (b, h, w, c), n,
                                                  "per_channel")
        if k == 7:  # the fused-quant tail multiplies by a per-channel 1/s
            inv = 127.0 / x.abs().amax(dim=(0, 1, 2))
            check(torch.equal(
                conv_int8_fused(x, q_w, inv, dequant, bias, reciprocal=True,
                                packed=packed),
                conv_int8_fused_plain(x, q_w, inv, dequant, bias,
                                      reciprocal=True)),
                f"fused int8 conv (reciprocal scale) differs at the {name} "
                "shape")
        got = conv_int8_fused(x, q_w, scale, dequant, bias, packed=packed)
        err = float((got - conv_int8_fused_plain(x, q_w, scale, dequant,
                                                 bias)).abs().max())
        check(err == 0.0, f"fused int8 conv differs at the {name} shape")
        del got
        q_x = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        check(torch.equal(conv_int8_im2col(q_x, q_w),
                          conv_int8_plain(q_x, q_w)),
              f"int8_conv differs at the {name} shape")
        t_k = kernel_ms(lambda: conv_int8_fused(x, q_w, scale, dequant,
                                                bias, packed=packed))
        t_p = kernel_ms(lambda: conv_int8_fused_plain(x, q_w, scale,
                                                      dequant, bias))
        t_raw = kernel_ms(lambda: conv_int8_im2col(q_x, q_w))

        def former():  # the raw kernel inside the passes it replaced
            qq = torch.clamp(torch.round(x / scale), -127, 127).to(
                torch.int8)
            return conv_int8_im2col(qq, q_w).to(torch.float32) * dequant + bias

        t_f = kernel_ms(former)
        a, wm = _int_mm_operands(q_x, q_w)
        try:  # a yardstick only: the port never calls it
            t_l = kernel_ms(lambda: torch._int_mm(a, wm))
        except RuntimeError as e:
            print(f"[3] torch._int_mm refused {tuple(a.shape)} x "
                  f"{tuple(wm.shape)}: {e}")
            t_l = None
        del a, wm
        xb = x.permute(0, 3, 1, 2).bfloat16()  # channels_last bf16
        kb = q_w.permute(3, 2, 0, 1).bfloat16().contiguous(
            memory_format=torch.channels_last)
        t_c = kernel_ms(lambda: F.conv2d(xb, kb, padding=k // 2))
        del xb, q_x
        ops = 2 * b * h * w * k * k * c * n
        t_ops = ops / PEAK_FLOPS[torch.int8] * 1e3
        # fused: f32 in, int8 weights, f32 out (the scale, dequantize and
        # bias tables are below a KB); raw: int8 in, int32 out
        nbytes = 4 * b * h * w * c + k * k * c * n + 4 * b * h * w * n
        raw_bytes = b * h * w * c + k * k * c * n + 4 * b * h * w * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        raw_bound = max(t_ops, raw_bytes / HBM_BYTES_PER_S * 1e3)
        by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[3] int8_conv {name} {(b, h, w, c)}->{n} k={k}: fused kernel "
              f"{t_k:.4f} ms (f32 in/out, bound {bound:.4f} ms, {by}), plain "
              f"{t_p:.4f} ms, raw kernel + its former passes {t_f:.4f} ms, "
              f"raw kernel alone {t_raw:.4f} ms (bound {raw_bound:.4f}), "
              f"torch._int_mm on a prebuilt im2col matrix {t_l} ms (GEMM "
              f"alone), cuDNN bf16 conv {t_c:.4f} ms; max err {err:g} "
              f"| {card}")
        if name == "body":
            entry = dict(
                name="int8_conv", route="cuda",
                source="sr_torch/kernels/csrc/int8_conv.cu",
                replaces="sr/kernels/int8_conv.py:75", launches=None,
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bound,
                bound_by=by, library_ms=t_l, shape=[b, h, w, c, n, k],
                dtype="f32 -> int8 -> f32 (fused entry)", former_ms=t_f,
                raw_ms=t_raw, raw_bound_ms=raw_bound)
        del x
    return entry


def _seeded_edsr(dtype: str):
    """Full-width EDSR ×4 with seeded random weights, scaled like a trained
    EDSR's: small residual branches, small biases and a mid-grey output
    bias, so the outputs spread over [0, 1] instead of saturating."""
    from sr_torch.models.registry import get_spec
    from sr_torch.utils.config import SRConfig

    cfg = SRConfig(model_name="EDSR", num_channels=3, scale_factor=4,
                   dtype=dtype)
    model = get_spec("EDSR").make_model(
        cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for blk in model.blocks:
            blk.Conv_1.weight.mul_(0.1)
        # every conv gets a small nonzero bias (flax's init zeroes them), so
        # a bias the PS blocks drop or add twice shows in the checks
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.02)
        model.out_conv.Conv_0.bias.add_(0.5)
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
    return path, outs


def phase_int8_serve(path: Path, entry: dict, outs: dict) -> None:
    """The int8 paths through ``upscale`` and the server: counts zeroed just
    before, read just after; then per-forward counts, card == CPU for the
    static int8 graph, and int8 against the f32 exact graph."""
    from PIL import Image

    from sr_torch.infer import upscale
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.kernels.fused_resblock import fused_resblock
    from sr_torch.kernels.int8_conv import conv_int8_fused, conv_int8_im2col
    from sr_torch.quant import calibrate_scales, quantized_apply
    from sr_torch.serve import SRService, serve_background
    from sr_torch.utils.checkpoint import load_params
    from sr_torch.utils.interop import from_jax_params

    rng = np.random.default_rng(0)
    sizes = ((128, 128), (96, 160), (400, 260))  # the float path's images
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    modes = (("static", True), ("static", False), ("dynamic", False))

    # ---- the int8 path: counts zeroed just before, read just after ----
    conv_int8_fused.launches = 0
    conv_int8_im2col.launches = 0
    depth_to_space.launches = 0
    fused_resblock.launches = 0
    q_outs = {}
    for quantize, fused in modes:
        for img in imgs:
            t0 = time.perf_counter()
            out = upscale(img, "EDSR", str(path), scale_factor=4,
                          fused=fused, quantize=quantize)
            ms = (time.perf_counter() - t0) * 1e3
            h, w = img.shape[:2]
            check(out.shape == (4 * h, 4 * w, 3) and out.dtype == np.uint8,
                  f"int8 upscale output {out.shape} {out.dtype}")
            q_outs[quantize, fused, img.shape] = out
            print(f"[4] upscale {h}x{w} int8 {quantize} "
                  f"{'fused' if fused else 'exact'}: {out.shape} uint8 in "
                  f"{ms:.1f} ms (host clock, first call loads/calibrates)")
    service = SRService(model_name="EDSR", params=str(path), scale_factor=4,
                        quantize="static")
    httpd, port = serve_background(service)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("GET", "/info")
    info = json.loads(conn.getresponse().read())
    check(info["quantize"] == "static", f"/info: {info}")
    conn.request("POST", "/upscale", body=_png(imgs[0]),
                 headers={"Content-Type": "image/png"})
    resp = conn.getresponse()
    body = resp.read()
    check(resp.status == 200, f"POST /upscale int8: {resp.status}")
    got = np.asarray(Image.open(io.BytesIO(body)))
    check(np.array_equal(got, q_outs["static", True, imgs[0].shape]),
          "served int8 PNG differs from a direct upscale")
    conn.close()
    httpd.shutdown()
    httpd.server_close()
    launches = {"int8_conv": conv_int8_fused.launches,
                "int8_conv raw entry": conv_int8_im2col.launches,
                "depth_to_space": depth_to_space.launches,
                "fused_resblock": fused_resblock.launches}
    print(f"[4] POST /upscale to a quantize='static' service == direct "
          f"upscale; /info {info}")
    print(f"[4] int8-path launches: {launches}")
    entry["launches"] = launches["int8_conv"]
    check(entry["launches"] > 0, "int8_conv never launched on the int8 path")
    check(launches["depth_to_space"] > 0 and launches["fused_resblock"] == 0
          and launches["int8_conv raw entry"] == 0,
          "the int8 path must shuffle with the kernel, run every int8 conv "
          "through the fused entry and run no float resblock")

    # ---- per-forward counts, after calibration (the functions are cached)
    for (quantize, fused), want in zip(modes, ((35, 1), (37, 2), (37, 2))):
        c0, d0, r0 = (conv_int8_fused.launches, depth_to_space.launches,
                      fused_resblock.launches)
        upscale(imgs[0], "EDSR", str(path), fused=fused, quantize=quantize)
        got = (conv_int8_fused.launches - c0, depth_to_space.launches - d0,
               fused_resblock.launches - r0)
        print(f"[4] one int8 {quantize} {'fused' if fused else 'exact'} "
              f"forward: int8_conv +{got[0]}, depth_to_space +{got[1]}, "
              f"fused_resblock +{got[2]}")
        check(got == (*want, 0), "unexpected int8 launches per forward")

    # ---- static int8 graph, card == CPU bit for bit, one scales dict ----
    params, _ = load_params(str(path))
    _, cpu_model = _seeded_edsr("bfloat16")
    from_jax_params(cpu_model, params)
    _, gpu_model = _seeded_edsr("bfloat16")
    gpu_model = from_jax_params(gpu_model, params).cuda()
    x = torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    scales = calibrate_scales(gpu_model, x.cuda(), headroom=1.25)
    on_card = quantized_apply(gpu_model, x.cuda(), scales).cpu()
    on_cpu = quantized_apply(cpu_model, x, scales)
    n_diff = int((on_card != on_cpu).sum())
    print(f"[4] static int8 64x64 forward, card vs CPU with one scales "
          f"dict: {n_diff} of {on_cpu.numel()} outputs differ (want 0)")
    check(n_diff == 0 and torch.equal(on_card, on_cpu),
          "card int8 forward differs from the CPU's")

    # ---- int8 against the f32 exact graph, interiors ----
    m = 3 * 4
    for (quantize, fused) in modes:
        for img in imgs:
            a = q_outs[quantize, fused, img.shape].astype(np.int32)
            b = outs["float32", False, img.shape].astype(np.int32)
            d = np.abs(a - b)[m:-m, m:-m]
            print(f"[4] int8 {quantize} {'fused' if fused else 'exact'} vs "
                  f"f32 exact interior {img.shape[:2]}: max {d.max()} u8 "
                  f"levels, mean {d.mean():.4f} (tol mean 4)")
            check(d.mean() <= 4, "int8 interior too far from f32")


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
            _, adds = profile_batches(lambda: fn(x), name, card)
            # the shuffle adds the PS convs' biases (exact) and the
            # composite tail conv's (fused): no add pass over their outputs
            # (NCHW shapes of the conv outputs)
            conv_outs = ([[16, 48, 128, 128]] if fused else
                         [[16, 256, 128, 128], [16, 256, 256, 256]])
            over = [a for a in adds if any(list(t) in conv_outs for t in a)]
            print(f"[5] {name}: add ops over the shuffled conv outputs: "
                  f"{len(over)} (want 0; {len(adds)} add ops in the profile)")
            check(not over, f"bf16 {name} still adds a bias over a shuffled "
                  f"conv's output: {over[:2]}")
        for fused in (False, True):
            fn = make_serving_predict(model, fused, quantize="static",
                                      calib_headroom=1.25)
            fn.calibrate([x])  # one batch, before timing
            name = f"int8-static {'fused' if fused else 'exact'}"
            ms = time_ms(lambda: fn(x), n=20)
            print(f"[5] EDSR x4 {name} b16 128->512: {ms:.3f} ms/batch, "
                  f"{mp / ms * 1e3:.1f} MP/s | {card}")
            names, _ = profile_batches(lambda: fn(x), name, card)
            # every quantize pass ran a round kernel (torch.relu is a
            # clamp_min, so clamp alone does not mark one)
            passes = [k for k in names if re.search(r"round", k)]
            check(not passes, f"{name} still runs quantize passes: {passes}")


def profile_batches(fn, name: str, card: str, n: int = 5
                    ) -> tuple[list[str], list[list]]:
    """Device time by kernel over ``n`` batches, and the device's busy
    share of the window from the first to the last kernel (torch.profiler).
    Returns the names of the kernels seen and the input shapes of every
    ``aten::add``/``aten::add_`` op."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    adds = [e.input_shapes for e in events
            if e.name in ("aten::add", "aten::add_")]
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    if not kernels:
        print(f"[5] profile {name}: the profiler saw no device time "
              "(not measured)")
        return [], adds
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
          f"({100 * busy / window:.1f}% busy) | {card}")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[5]   {us / n / 1e3:8.3f} ms/batch {100 * us / total:5.1f}%  "
              f"{kname[:150]}")
    return list(by_name), adds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = phase_toolchain()
    phase_build()
    entries = phase_kernels(card)
    int8_entry = phase_int8_conv(card)
    path, outs = phase_serve(entries)
    phase_int8_serve(path, int8_entry, outs)
    entries.append(int8_entry)
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
