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
   fused entries) must equal its plain version exactly, at EDSR's sites
   and at each shape class's edges (``INT8_CASES``), the shuffle too
   (f32, bf16 and u8, with and without the PS conv's bias). Each int8 row
   prints the class and the plan the kernel chose.
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

6. Train full-width EDSR ×4 (bf16 compute, crop 64, b32, the synthetic
   corpus in a 'matrix' ``PatchPipeline`` on the card, bench.py's train
   axis): the shuffle under autograd bit for bit against its plain version
   at the training shapes, with its forward and backward times; one f32
   step card vs CPU; the pre-shuffle modes against the default (every
   parameter with a gradient, 2/1/0 shuffle launches a step); then the
   train path with its counts zeroed just before and read just after:
   K=40 and K=120 dispatches (marginal steps/s), one ``fit`` epoch with a
   checkpoint that must restore exactly, and ``predict`` (the resblock
   kernel), whose every block must then agree with the plain block on its
   own input and whose output with the plain one. The loss must fall; the
   step's layers (events around the trainer's own stages) and a profile
   follow;
   the trained weights must serve through ``upscale``, and the folded tail
   must equal the exact graph.
7. Evaluate phase 6's trained model through ``sr_torch.eval.runner.evaluate``
   and ``Trainer.make_predict_fn`` (the shuffle and resblock kernels), with
   the counts zeroed just before and read just after: the synthetic test
   set, 8 procedural test images at 384² by the direct route and a folder
   of mixed-size PNGs by the static (shape-bucketed) route, each with host
   and device metrics. (a)/(b) device PSNR and SSIM within 1e-4 dB and
   1e-5 of the host's, no SSIM above 1; (c) in f32 the static route's SR
   image equals the direct route's on the metric region within 1e-4 and
   its PSNR within 1e-3 dB; (d) f32 ``evaluate`` on the card against the
   CPU, 1e-3 dB and 1e-5 SSIM; (e) 2 shuffles and 16 resblocks per predict
   call; (f) the native data-prep library must run and equal numpy bit for
   bit; (g) images/s and ms per image by route and metric path (CUDA
   events); (h) both kernels against their plain versions at the eval
   shapes, with their times.

8. ESPCN ×4 on Y at full width (64/32 filters, r=4, one channel): (a) the
   shuffle at r=4, 16→1 and the fused int8 entry at ESPCN's three sites
   (5×5 over one channel, 64→32, 32→16) at the forward shapes ``upscale``
   gives the net for the two images of (c) (one whole, one as a batch of 4
   halo tiles), the shuffle also at the eval shape, under autograd at the
   training shape and on an odd 37×53 input (and, rowless, at b16 128²,
   which no path serves); each exact against its plain version and timed
   as in phase 3, each row with the launches of its own shape on its
   path; (b) training with the bench's ESPCN
   configuration: f32 step card vs CPU, 'last' against off, 1/0 shuffles a
   step, two K=300 dispatches whose loss falls, a checkpoint that restores
   exactly; (c) the trained params served through ``upscale`` on RGB
   images (Y through the net, bicubic chroma; one tiled) in bf16, f32 and
   int8 static and dynamic, and one HTTP POST: f32 card vs CPU within one
   u8 level, a YCbCr image's chroma == ``resize_bicubic_u8``, int8 vs f32
   interior mean ≤ 4 levels, 1 shuffle and 3 int8 convs a forward, no
   resblock; (d) ``evaluate(channels=1)`` on the synthetic set and 8
   procedural 384² images, device metrics within 1e-4 dB / 1e-5 SSIM of
   the host's, images/s. Each path's counts are zeroed just before it and
   read just after.
9. Each kernel against its plain version at the bench's b192 shapes; then
   ``sr_torch.bench``'s whole measurement in process (serving marginals at
   b64→b192, the EDSR and ESPCN train axes), its counts zeroed just before
   and read just after (all three kernels must run); its JSON line is
   printed on a line of its own and checked: every key present and
   positive, ``train`` holding EDSR and ESPCN.

10. SRCNN, VDSR and DRCN ×4 on Y at full width (SRCNN 9-5-5 64/32, VDSR
   20 × 64 without biases, DRCN 64 filters × 16 recursions), the
   pre-upsample family, whose only port kernel is the int8 conv: (a) the
   fused int8 entry at every int8 site shape ``upscale`` gives each net
   for (c)'s two images (the ×4 bicubic upscale whole, and in 4 halo
   tiles), exact against its plain version and timed as in phase 3, with
   cuDNN's bf16 conv as the library time; per model (b) training with the
   bench's recipe on the corpus's first plane ('bc' input, bf16, crop 64,
   b32, the model's own optimizer): f32 step card vs CPU, 3 single steps
   (VDSR's clip scale), two K-step dispatches (DRCN's α) after which a
   fixed probe batch's loss has fallen,
   a checkpoint that restores exactly, no port kernel launched; (c)
   serving through ``upscale`` in bf16, f32, int8 static and dynamic and
   one HTTP POST: f32 card vs CPU within one u8 level, tiled vs whole, a
   YCbCr image's chroma == ``resize_bicubic_u8``, int8 vs f32 interior
   mean ≤ 4 levels, 3 / 20 / 50 int8 convs a forward and no shuffle or
   resblock; (d) ``evaluate(pre_upsample=True)`` on the synthetic set and
   8 procedural 384² images, device metrics within 1e-4 dB / 1e-5 SSIM of
   the host's, images/s. Each path's counts are zeroed just before it and
   read just after; each kernel row carries the launches of its shape on
   its model's serving path.

11. SRResNet and SRGAN ×4 at full width (16 resblocks × 64 filters, 9×9
   head and output convs, RGB; the discriminator at base 64): (a) the
   shuffle (bf16 stages with the PS conv's bias, f32 stages of the int8
   routes, the folded tail's 12-channel shuffle in bf16 and u8) and the
   fused int8 entry (9×9 head over 3 channels, body, stages, the folded
   5×5 256→12 and the exact 9×9 64→3 out convs) at every shape
   ``upscale`` gives the net for (d)'s two images, one whole and one in
   halo tiles, plus the two out convs at the throughput batch; each exact
   against its plain version and timed as in phase 3 (library time
   cuDNN's bf16 conv or ``F.pixel_shuffle``), each row with the launches
   of its shape on its path; the shuffle under autograd at the training
   shapes; (b) SRResNet training with the bench's EDSR recipe shape
   (bf16, crop 64, b32, the synthetic corpus in a 'matrix'
   ``PatchPipeline``): f32 step card vs CPU (gradients, batch statistics,
   the Adam updates' signs and sizes), two K=40 dispatches after which a probe batch's loss has
   fallen, 2 shuffles a step, a checkpoint that restores exactly; (c)
   SRGAN with the synthetic VGG19 of ``scripts/make_synthetic_vgg.py`` at
   relu2_2: an f32 adversarial step card vs CPU, a pretrain and two
   adversarial K=10 dispatches with finite losses (2 and 4 shuffles a
   step), a profile of one step, a G+D checkpoint that restores exactly;
   (d) serving (b)'s model through ``upscale`` by five routes (exact,
   folded, int8 static fused = the folded int8 tail, int8 static exact,
   int8 dynamic) and one HTTP POST: per-forward launches (2 shuffles, 37
   int8 convs on the int8 routes, no resblock), f32 card vs CPU and folded
   vs exact ≤ 1 u8 level, int8 vs f32 interior mean ≤ 4 levels, MP/s by
   route at b16 128² → 512² with profiles; (e) ``evaluate`` through
   ``Trainer.make_predict_fn`` on the synthetic set and 8 procedural 384²
   images, device metrics within 1e-4 dB / 1e-5 SSIM of the host's,
   images/s. Each path's counts are zeroed just before it and read just
   after.

12. FSRCNN and LapSRN ×4 on Y at full width (FSRCNN 56/12/4 with its 9×9
   stride-4 deconv; LapSRN 64 filters × 5 convs a level, two levels, 4×4
   stride-2 deconvs): (a) the fused int8 entry at every int8 site shape
   (the 1×1 shrink and expand among them, and each deconv's phase-packed
   3×3 conv of s²·N outputs) and the f32 shuffle at every int8-deconv
   shape, for a 96×80 image whole and a 360×300 one in halo tiles, each
   exact against its plain version and timed as in phase 3 (library time
   cuDNN's bf16 conv, or ``F.conv_transpose2d`` of the deconv), each row
   with the launches of its shape on its path; per model (c) training
   (bf16, crop 64, b32, the synthetic corpus's Y): f32 step card vs CPU
   (loss, gradients, the first Adam update at each group's rate: FSRCNN's
   deconv at 1e-4, its base at 1e-3), two K-step dispatches after which a
   probe batch's loss (each of LapSRN's levels) has fallen, no port kernel
   launched, a checkpoint that restores exactly, then a LapSRN dispatch
   from the procedural train split's first 32 images; (b) serving through
   ``upscale`` (bf16, f32, int8 static and dynamic) with per-forward
   launches (7 / 13 int8 convs, no shuffle), f32 card vs CPU and tiled vs
   whole ≤ 1 u8 level, chroma == ``resize_bicubic_u8``, int8 vs f32
   interior mean ≤ 4; the int8 deconv route
   (``make_quantized_predict(quantize_deconv=True)``, 8 int8 convs and 1
   shuffle a forward for FSRCNN, 17 and 4 for LapSRN) on the same images,
   card == CPU bit for bit; (d) LapSRN's ×2 level (``net_scale=4``) equal
   to level 0 of its ``all_scales`` forward, card vs CPU ≤ 1 level,
   ``sr.infer``'s refusals, and the HTTP server with ``net_scale``; (e)
   ``evaluate(channels=1)`` on the synthetic set and 8 procedural 384²
   images, device metrics within 1e-4 dB / 1e-5 SSIM of the host's,
   images/s; (f) MP/s at b16 128² → 512² on Y by route (bf16 exact, int8
   static, int8 static with quantize_deconv, int8 dynamic), reported. Each
   path's counts are zeroed just before it and read just after.
13. Export, artifact serving and the D4 self-ensemble (EDSR ×4 at full
   width, bf16, phase 4's seeded weights): four bundles at buckets 64 and
   128 through ``python -m sr_torch.export`` in parallel processes (bf16
   exact, bf16 fused, int8 static fused calibrated on two synthetic PNGs,
   bf16 fused with the ensemble baked in); a fresh process loads them with
   no ``sr_torch.models`` or ``sr_torch.nn`` imported and runs b1 and b16,
   bit for bit against the eager routes (else at most 1 u8 level, said)
   with the eager launches a call (2+16, 1+16, 1 shuffle + 35 int8, 8+128);
   the main path (each artifact at b1 and b16 in this process, the counts
   zeroed just before and read just after); each kernel against its plain
   version at the arguments captured inside the programs (a dispatch
   mode), timed as in phase 3; the bf16 exact program exported on the CPU
   and moved to the card == the card's; the int8 bundle over HTTP, 16
   concurrent requests in one bucket in fewer program calls, each == a
   direct call; an ESPCN ×4 int8-static bundle on Y through the server's
   luma and chroma path == model mode's ``upscale``; f32
   ``upscale(self_ensemble=True)`` card vs CPU and tiled vs whole ≤ 1
   level; MP/s at b16 128² → 512² of each artifact against its eager route
   (eager, artifact, artifact, eager), reported.
14. The CLI and the reference-style wrappers (EDSR ×4 at full width, bf16,
   crop 64, b32, ``sr_torch.main.main`` in this process, each run's counts
   zeroed just before and read just after, cuDNN deterministic as the CLI
   sets it), after its inputs are made where a cache under ``build/``
   lacks them (the procedural splits in 8 processes of a child without
   torch, the synthetic VGG19): (a) train 2 epochs of 40 steps on the
   procedural corpus, evaluate the 128 procedural test images with panels
   and SR PNGs,
   export the ``.pt2`` and the reference ``.pkl`` (2 shuffles a step, 2 +
   16 a predict; the loss falls); (b) one epoch, then resumed to two: the
   params equal (a)'s bit for bit; (c)
   ``--eval_only``: (a)'s summary bit for bit; (d) ``--self_ensemble``: 8×
   (c)'s launches; (e) the ``.pt2`` and the ``.pkl``'s model equal the
   eager predict bit for bit; (f) ``sr_torch.compat.ESPCN`` on Y trains,
   tests a PNG folder with YCbCr panels and loads its ``.pkl`` alone; (g)
   the SRGAN CLI, a pretrain and an adversarial epoch; (h) full-width
   ``Upsample2xBlock('ps')`` and an instance-norm ``ConvBlock`` card vs
   CPU (1e-3); (i) each kernel at the arguments captured in a train step
   and a predict, against its plain version and timed; (j) wall seconds,
   steps/s, images/s, export seconds, reported.
15. Data parallel over processes and the sharded forward, the port's
   counterpart of ``dryrun_multichip`` (children started with
   ``subprocess``; one that fails fails the phase): (a) one process joins
   a group of one through ``SR_COORDINATOR`` (NCCL); K=20 DDP steps of
   full-width EDSR ×4 (bf16, crop 64, b32) equal the plain ``Trainer``'s
   bit for bit (loss, params, generator), 2 shuffles a step; a K=20
   dispatch of each timed with the card to itself; (b) two
   processes share the card (gloo), f32, TF32 off, global b32: 3 EDSR
   steps (loss within 1e-5 of one process's; params bit for bit those of
   one process stepping on the same two halves, their distance to the b32
   steps printed beside the two-halves run's own), then SRGAN's pretrain
   and adversarial steps with batch statistics over the group (d/g loss
   1e-4, G on a probe 1e-4, running statistics 1e-4), the processes
   bit-equal, steps/s a process reported as one
   shared card; (c) ``sharded_predict`` of phase 4's seeded EDSR on a
   384×256 LR image over the same two processes: bf16 exact within one u8
   level of the whole-image forward, int8 static fused bit for bit, 2 + 16
   and 1 + 35 launches a band; each kernel at these paths' shapes against
   its plain version and timed, with the launches the children counted at
   that shape; (d) ``python -m sr_torch.main --mesh 1``
   with ``SR_COORDINATOR`` writes what the one-process CLI writes, with
   its launches and its params bit for bit. NCCL across two or more
   cards is not run: the machine has one.

It prints the bench's JSON line, a ``{"kernels": [...]}`` JSON line, then
the card line, then as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import functools
import http.client
import importlib.metadata
import io
import json
import os
import re
import shutil
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


def _resblock_bound(x) -> tuple[float, str]:
    """The least time of one block on ``x`` (B, H, W, C): two 3×3 convs'
    products at the peak rate of x's type, or x read and the output
    written, the two (9·C, C) weights read and the f32 biases read."""
    c = x.shape[-1]
    flops = 2 * 2 * x.numel() * 9 * c
    nbytes = (2 * x.numel() + 2 * 9 * c * c) * x.element_size() + 2 * c * 4
    t_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _resblock_library(x, w1, b1, w2, b2, res_scale: float = 1.0):
    """The block as PyTorch's convs (cuDNN) on channels-last operands, in
    x's type: the library call of the resblock rows."""
    c = x.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    k1, k2 = (w.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last) for w in (w1, w2))
    lb1, lb2 = b1.to(x.dtype), b2.to(x.dtype)

    def library():
        h = F.conv2d(F.relu(F.conv2d(xc, k1, lb1, padding=1)), k2, lb2,
                     padding=1)
        return xc + (h if res_scale == 1.0 else h * res_scale)

    return library


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


def _d2s_exact(x, r: int, bias) -> None:
    """The shuffle kernel on ``x`` equal to its plain version, without and
    with ``bias`` (None for u8)."""
    from sr_torch.kernels.depth_to_space import (
        depth_to_space, depth_to_space_plain)

    for b_ in (None, bias) if bias is not None else (None,):
        check(torch.equal(depth_to_space(x, r, None, b_),
                          depth_to_space_plain(x, r, None, b_)),
              f"depth_to_space differs at {tuple(x.shape)} r={r} {x.dtype} "
              f"bias={b_ is not None}")


def _d2s_row(card: str, gen, shape, r: int, dtype, tag: str = "[3]",
             path: str | None = None, odd=None) -> dict:
    """The shuffle at one shape: exact against its plain version without
    and with bias (and at ``odd`` (B, H, W): ragged heads and tails of the
    output runs); times of the kernel (with the bias too), the plain
    version, F.pixel_shuffle and the bytes bound. Returns the kernels-line
    row."""
    from sr_torch.kernels.depth_to_space import (
        depth_to_space, depth_to_space_plain)

    x, bias = _d2s_operands(shape, dtype, gen, True)
    _d2s_exact(x, r, bias)
    if odd is not None:
        xo, bo = _d2s_operands((*odd, shape[-1]), dtype, gen, True)
        _d2s_exact(xo, r, bo)
        del xo, bo
    xc = x.permute(0, 3, 1, 2)  # the same memory as NCHW channels_last
    t_k = kernel_ms(lambda: depth_to_space(x, r))
    t_h = host_us(lambda: depth_to_space(x, r))
    t_p = kernel_ms(lambda: depth_to_space_plain(x, r).contiguous())
    t_l = kernel_ms(lambda: F.pixel_shuffle(xc, r))
    bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    row = dict(
        name="depth_to_space", route="cuda",
        source="sr_torch/kernels/csrc/depth_to_space.cu",
        replaces="sr/kernels/depth_to_space.py:73", launches=None,
        max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=bound,
        bound_by="bytes", library_ms=t_l, shape=list(x.shape),
        dtype=str(dtype)[6:])
    with_bias = ""
    if bias is not None:
        row["ms_with_bias"] = kernel_ms(
            lambda: depth_to_space(x, r, None, bias))
        row["plain_ms_with_bias"] = kernel_ms(lambda: depth_to_space_plain(
            x, r, None, bias).contiguous())
        with_bias = (f"; with bias: kernel {row['ms_with_bias']:.4f} ms, "
                     f"plain {row['plain_ms_with_bias']:.4f} ms")
    if path is not None:
        row["path"] = path
    print(f"{tag} depth_to_space {tuple(x.shape)} r={r} {str(dtype)[6:]}"
          f"{f' ({path})' if path else ''}: kernel {t_k:.4f} ms, plain "
          f"{t_p:.4f} ms, F.pixel_shuffle {t_l:.4f} ms, bound {bound:.4f} "
          f"ms (bytes){with_bias}; host {t_h:.1f} us a call; == plain"
          f"{f', and at {odd}' if odd else ''} | {card}")
    return row


def _d2s_serving(card: str, gen, d2s_err: float) -> dict:
    """The shuffle at the serving shapes, each a :func:`_d2s_row`. Returns
    the JSON entry, at the largest bf16 shuffle of the exact path."""
    entry = None
    for dtype in (torch.bfloat16, torch.float32, torch.uint8):
        for h, cin, r in D2S_SHAPES:
            if dtype == torch.uint8 and r != 4:
                continue  # u8 is the fused-quant tail's output only
            row = _d2s_row(card, gen, (16, h, h, cin), r, dtype)
            if dtype == torch.bfloat16 and h == 256:
                entry = row
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
        kops = _kernel_operands(ops)
        t_k = kernel_ms(lambda: fused_resblock(*kops))
        t_p = kernel_ms(lambda: fused_resblock_plain(x, w1, b1, w2, b2))
        library = _resblock_library(*ops)
        t_l = kernel_ms(library)  # PyTorch's default: TF32 for f32 convs
        with no_tf32():
            t_l32 = kernel_ms(library)
        bound, bound_by = _resblock_bound(x)
        tf32 = (f" (TF32 on); TF32 off {t_l32:.4f} ms"
                if dtype == torch.float32 else "")
        print(f"[3] fused_resblock {shape} {str(dtype)[6:]}: kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, conv-relu-conv-add "
              f"{t_l:.4f} ms{tf32}, bound {bound:.4f} ms "
              f"({bound_by}) | {card}")
        if dtype == torch.bfloat16:
            entries.append(dict(
                name="fused_resblock", route="cuda",
                source="sr_torch/kernels/csrc/fused_resblock.cu",
                replaces="sr/kernels/fused_resblock.py:119", launches=None,
                max_abs_err=main_err, ms=t_k, plain_ms=t_p, bound_ms=bound,
                bound_by=bound_by, library_ms=t_l, shape=list(shape),
                dtype="bfloat16"))
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
    # no EDSR path at these two: a whole 96x80 image's body conv (the
    # single-request case) and SRCNN's 9x9 over one channel
    ("body, one 96x80 image", 1, 96, 80, 64, 64, 3),
    ("9x9 over one channel", 4, 272, 260, 1, 64, 9),
)

#: exactness cases of phase 3, (shape, N, k): EDSR's sites at small sizes
#: with ragged tiles, then each shape class at its edges (C = 1, 3, 8, 12,
#: 32, 56, 256; k = 1, 9; N = 1, 3, 4; odd W; one whole 96x80 image)
INT8_CASES = (
    ((2, 5, 7, 3), 64, 3), ((2, 17, 9, 64), 64, 3), ((2, 17, 9, 64), 256, 3),
    ((2, 16, 16, 64), 3, 3), ((2, 13, 11, 64), 48, 7),
    ((1, 37, 53, 1), 64, 9), ((1, 37, 53, 3), 64, 9), ((1, 37, 53, 1), 4, 3),
    ((1, 37, 53, 8), 16, 3), ((1, 37, 53, 12), 12, 3),
    ((1, 37, 53, 12), 56, 1),
    ((1, 37, 53, 32), 1, 5), ((1, 37, 53, 56), 16, 3),
    ((1, 37, 53, 256), 12, 5), ((2, 37, 53, 64), 3, 9),
    ((1, 96, 80, 64), 64, 3),
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
        conv_bf16_im2col, conv_bf16_plain, conv_class, conv_fits,
        conv_int8_fused, conv_int8_fused_plain, conv_int8_im2col,
        conv_int8_plain, pack_weights)

    gen = torch.Generator(device="cuda").manual_seed(3)

    def q(shape):
        return torch.randint(-127, 128, shape, device="cuda",
                             generator=gen).to(torch.int8)

    cases = INT8_CASES
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
          "(exact, ±127 saturation included; classes: "
          + ", ".join(f"{shape}->{n} k{k} {conv_class(k, shape[-1])}"
                      for shape, n, k in cases) + ")")
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
    bf_err, refused = 0.0, []
    for shape, n, k in cases:
        if not conv_fits(k, shape[-1], n, torch.bfloat16):
            refused.append(f"{shape}->{n} k{k}")  # no path runs it
            continue
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        w = (torch.randn((k, k, shape[-1], n), device="cuda", generator=gen)
             / (k * k * shape[-1]) ** 0.5).bfloat16()
        bf_err = max(bf_err, float((conv_bf16_im2col(x, w)
                                    - conv_bf16_plain(x, w)).abs().max()))
    print(f"[3] int8_conv bf16 instantiation: max |kernel - plain| "
          f"{bf_err:.3g} (tol 1e-3); refused as too large for shared "
          f"memory (bf16 doubles K): {', '.join(refused) or 'none'}")
    check(bf_err <= 1e-3, "bf16 conv disagrees")

    entry = None
    for name, b, h, w, c, n, k in INT8_SHAPES:
        row = _int8_row(card, gen, name, (b, h, w, c), n, k)
        if name == "body":
            entry = row
    return entry


def _int8_exact(gen, name: str, shape, n: int, k: int):
    """The fused int8 entry at one conv's shape, bit for bit against its
    plain version: the per-sample scale with its (B, 1, 1, N) dequantize
    table, the per-channel scale of a static site (at k=7 also the
    fused-quant tail's reciprocal scale); and the raw entry exact. Returns
    the per-channel operands ``(x, q_w, packed, scale, dequant, bias,
    q_x)`` and the largest error."""
    from sr_torch.kernels.int8_conv import (
        conv_int8_fused, conv_int8_fused_plain, conv_int8_im2col,
        conv_int8_plain, pack_weights)

    b, h, w, c = shape
    q_w = torch.randint(-127, 128, (k, k, c, n), device="cuda",
                        generator=gen).to(torch.int8)
    packed = pack_weights(q_w)  # once, as the int8 sites pack it
    x, scale, dequant, bias = _fused_operands(gen, (b, h, w, c), n,
                                              "dynamic")
    check(torch.equal(
        conv_int8_fused(x, q_w, scale, dequant, bias, packed=packed),
        conv_int8_fused_plain(x, q_w, scale, dequant, bias)),
        f"fused int8 conv (per-sample scale) differs at the {name} shape "
        f"{shape}")
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
            f"shape {shape}")
    got = conv_int8_fused(x, q_w, scale, dequant, bias, packed=packed)
    err = float((got - conv_int8_fused_plain(x, q_w, scale, dequant,
                                             bias)).abs().max())
    check(err == 0.0, f"fused int8 conv differs at the {name} shape {shape}")
    del got
    q_x = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    check(torch.equal(conv_int8_im2col(q_x, q_w),
                      conv_int8_plain(q_x, q_w)),
          f"int8_conv differs at the {name} shape {shape}")
    return (x, q_w, packed, scale, dequant, bias, q_x), err


def _int8_row(card: str, gen, name: str, shape, n: int, k: int,
              tag: str = "[3]") -> dict:
    """The fused int8 entry at one conv's shape: exact
    (:func:`_int8_exact`), and times of the fused kernel, its plain
    version, the raw kernel with and without its former passes,
    torch._int_mm on a prebuilt im2col matrix (the GEMM alone) and cuDNN's
    bf16 conv, beside the bound. Returns the kernels-line row."""
    from sr_torch.kernels.int8_conv import (
        conv_class, conv_int8_fused, conv_int8_fused_plain, conv_int8_im2col,
        conv_plan)

    b, h, w, c = shape
    (x, q_w, packed, scale, dequant, bias, q_x), err = _int8_exact(
        gen, name, shape, n, k)
    cls, plan = conv_class(k, c), conv_plan(shape, n, k)
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
        print(f"{tag} torch._int_mm refused {tuple(a.shape)} x "
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
    print(f"{tag} int8_conv {name} {(b, h, w, c)}->{n} k={k}: fused kernel "
          f"{t_k:.4f} ms (f32 in/out, bound {bound:.4f} ms, {by}), plain "
          f"{t_p:.4f} ms, raw kernel + its former passes {t_f:.4f} ms, "
          f"raw kernel alone {t_raw:.4f} ms (bound {raw_bound:.4f}), "
          f"torch._int_mm on a prebuilt im2col matrix {t_l} ms (GEMM "
          f"alone), cuDNN bf16 conv {t_c:.4f} ms; max err {err:g}; class "
          f"{cls}, plan {plan} | {card}")
    del x
    return dict(
        name="int8_conv", route="cuda",
        source="sr_torch/kernels/csrc/int8_conv.cu",
        replaces="sr/kernels/int8_conv.py:75", launches=None,
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bound,
        bound_by=by, library_ms=t_l, shape=[b, h, w, c, n, k],
        dtype="f32 -> int8 -> f32 (fused entry)", former_ms=t_f,
        raw_ms=t_raw, raw_bound_ms=raw_bound, cudnn_bf16_ms=t_c,
        shape_class=cls, plan=plan)


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


def profile_batches(fn, name: str, card: str, n: int = 5, tag: str = "[5]",
                    unit: str = "batch") -> tuple[list[str], list[list]]:
    """Device time by kernel over ``n`` calls of ``fn`` (a batch, or a
    ``unit``), and the device's busy share of the window from the first to
    the last kernel (torch.profiler). Returns the names of the kernels seen
    and the input shapes of every ``aten::add``/``aten::add_`` op."""
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
    # device-side ranges of user annotations (the optimizer's
    # ``Optimizer.step#Adam.step``) span kernels and are not kernels
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"{tag} profile {name}: the profiler saw no device time "
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
    print(f"{tag} profile {name}: device busy {busy / n / 1e3:.3f} ms/{unit} "
          f"of a {window / n / 1e3:.3f} ms/{unit} window "
          f"({100 * busy / window:.1f}% busy) | {card}")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{tag}   {us / n / 1e3:8.3f} ms/{unit} {100 * us / total:5.1f}%  "
              f"{kname[:150]}")
    return list(by_name), adds


#: the train axis of bench.py: EDSR ×4 bf16, crop 64, b32, K-step dispatches
TRAIN_CROP, TRAIN_BATCH, TRAIN_K, TRAIN_REPEATS = 64, 32, (40, 120), 3
TRAIN_EPOCH = 40  # steps in fit's epoch, two dispatches of 20
#: the training shuffles at crop 64 b32 (16² LR): the PS stages' (H, C·r²)
TRAIN_D2S = ((16, 256), (32, 256))


def _grads(model) -> dict[str, torch.Tensor]:
    """Every parameter's gradient on the CPU in f32; each must exist and be
    nonzero (a kernel without a backward would leave the layers before it
    without one)."""
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(p.grad.abs().max() > 0)]
    check(not missing, f"no gradient reached {missing}")
    return {n: p.grad.detach().float().cpu() for n, p in
            model.named_parameters()}


def _train_d2s(card: str, gen, shapes=TRAIN_D2S, r: int = 2,
               tag: str = "[6]",
               path: str = "train forward (PS conv bias inside)"
               ) -> list[dict]:
    """(b) The shuffle under autograd at the training shapes, bf16, with the
    conv's bias, without and with the fused ReLU: forward and the
    gradients of x and of the bias through the kernel equal autograd
    through the plain version, bit for bit. Times of the forward (kernel,
    plain, F.pixel_shuffle) and of the backward (the plain transpose the
    kernel's Function runs, and F.pixel_unshuffle), beside their bounds."""
    from sr_torch.kernels.depth_to_space import (
        depth_to_space, depth_to_space_plain)

    rows = []
    for h, cin in shapes:
        shape = (TRAIN_BATCH, h, h, cin)
        x0, b0 = _d2s_operands(shape, torch.bfloat16, gen, True)
        g = torch.randn((TRAIN_BATCH, r * h, r * h, cin // (r * r)),
                        device="cuda", generator=gen).bfloat16()
        for act in (None, "relu"):
            got = []
            for fn in (depth_to_space, depth_to_space_plain):
                x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
                y = fn(x, r, act, b)
                y.backward(g)
                got.append((y.detach(), x.grad, b.grad))
            torch.cuda.synchronize()
            for name, k, p in zip(("forward", "grad x", "grad bias"), *got):
                check(k.dtype == p.dtype and torch.equal(k, p),
                      f"depth_to_space {name} under autograd differs from "
                      f"the plain version at {shape} act={act}")
        print(f"{tag} depth_to_space {shape} r={r} bf16 under autograd, with the "
              "bias, act None and relu: forward, grad x and grad bias == "
              "plain autograd (bit for bit)")
        x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
        y = depth_to_space(x, r, None, b)
        xc = x0.permute(0, 3, 1, 2)
        gc = g.permute(0, 3, 1, 2)
        t_k = kernel_ms(lambda: depth_to_space(x0, r, None, b0))
        t_p = kernel_ms(lambda: depth_to_space_plain(x0, r, None, b0))
        t_l = kernel_ms(lambda: F.pixel_shuffle(xc, r))
        t_bw = kernel_ms(lambda: torch.autograd.grad(y, (x, b), g,
                                                     retain_graph=True))
        t_lbw = kernel_ms(lambda: F.pixel_unshuffle(gc, r))
        nbytes = 2 * x0.numel() * x0.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{tag} depth_to_space {shape} r={r} bf16 (train forward, with "
              f"bias): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"F.pixel_shuffle {t_l:.4f} ms, bound {bound:.4f} ms (bytes); "
              f"backward (plain transpose + bias sum) {t_bw:.4f} ms, "
              f"F.pixel_unshuffle {t_lbw:.4f} ms, bound {bound:.4f} ms "
              f"| {card}")
        rows.append(dict(
            name="depth_to_space", route="cuda",
            source="sr_torch/kernels/csrc/depth_to_space.cu",
            replaces="sr/kernels/depth_to_space.py:73", launches=None,
            max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=bound,
            bound_by="bytes", library_ms=t_l, shape=list(shape),
            dtype="bfloat16", path=path,
            backward_ms=t_bw, backward_bound_ms=bound,
            backward_library_ms=t_lbw))
        del x0, b0, g, x, b, y, xc, gc
    return rows


def _step_card_vs_cpu(cfg, batch, tag: str = "[6]", step: int = 0) -> None:
    """(c) One f32 full-width step on the card (TF32 off) against the CPU's
    from the same weights and batch, at the schedule's ``step``: the loss
    within 1e-5 and every gradient within 1e-3 of its largest entry
    (float32 summation order; 1e-5 to 6e-6 is what f32 against f64 shows
    on the CPU)."""
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.precision import no_tf32

    cfg32 = cfg.replace(dtype="float32")
    grads, losses = [], []
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg32, device=device)
        st = tr.init_state(5)
        b = {k: v.to(device) for k, v in batch.items()}
        with no_tf32():
            loss, _ = tr.loss_fn(st.model, b, step)
            loss.backward()
        losses.append(float(loss.detach()))
        grads.append(_grads(st.model))
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    worst = max((float((grads[0][n] - g).abs().max() / g.abs().max()), n)
                for n, g in grads[1].items())
    print(f"{tag} f32 train step, card vs CPU (TF32 off): loss {losses[0]:.6f} "
          f"vs {losses[1]:.6f} (rel {loss_err:.2e}, tol 1e-5); worst "
          f"gradient {worst[1]} rel {worst[0]:.2e} (tol 1e-3)")
    check(loss_err <= 1e-5 and worst[0] <= 1e-3,
          "the card's f32 train step differs from the CPU's")


def _preshuffle_modes(cfg, batch, modes=((False, 2), ("last", 1),
                                         ("full", 0)),
                      tag: str = "[6]") -> None:
    """(a) and (e): per mode the shuffle's launches per step (EDSR: 2 with
    the pre-shuffle loss off, 1 'last', 0 'full'); each mode's loss and
    gradients from the same weights and batch against the default mode's,
    within bf16 tolerance (loss 1e-3 relative, each gradient's L2 error
    5e-2 of its norm; the CPU at full width shows 2e-4 and 5e-3)."""
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.train.trainer import Trainer

    ref = None
    for mode, per_step in modes:
        tr = Trainer(cfg.replace(preshuffle_loss=mode))
        st = tr.init_state(3)
        d0 = depth_to_space.launches
        loss, _ = tr.loss_fn(st.model, batch, 0)
        loss.backward()
        torch.cuda.synchronize()
        fwd_bwd = depth_to_space.launches - d0
        out = (float(loss.detach()), _grads(st.model))
        d0 = depth_to_space.launches
        tr.train_step(st, batch)
        step = depth_to_space.launches - d0
        name = mode or "off"
        print(f"{tag} preshuffle_loss={name}: all {len(out[1])} parameters "
              f"have a nonzero gradient; depth_to_space launches per "
              f"forward+backward {fwd_bwd}, per train step {step} (want "
              f"{per_step})")
        check(fwd_bwd == step == per_step,
              f"preshuffle_loss={name}: {step} shuffle launches a step")
        if ref is None:
            ref = out
            continue
        loss_err = abs(out[0] - ref[0]) / abs(ref[0])
        worst = max((float((g - ref[1][n]).norm() / ref[1][n].norm()), n)
                    for n, g in out[1].items())
        print(f"{tag} preshuffle_loss={name} vs off, bf16: loss rel "
              f"{loss_err:.2e} (tol 1e-3); worst gradient {worst[1]} L2 rel "
              f"{worst[0]:.2e} (tol 5e-2)")
        check(loss_err <= 1e-3 and worst[0] <= 5e-2,
              f"preshuffle_loss={name} differs from the default mode")


class _Marked:
    """Calls ``fn`` and then ``mark()``; with ``first``, ``mark()`` before
    as well. Stands in for one stage of the trainer's own step, so the
    events fall between its stages."""

    def __init__(self, fn, mark, first=False):
        self.fn, self.mark, self.first = fn, mark, first

    def __call__(self, *args, **kwargs):
        if self.first:
            self.mark()
        out = self.fn(*args, **kwargs)
        self.mark()
        return out


def _train_layers(tr, state, pipe, card: str, n: int = 20) -> None:
    """Where a step's time goes: the trainer's own ``make_multi_step(pipe,
    1)``, with a CUDA event and a host clock reading taken before the
    sampler and after each of its stages: the sampler (the pipeline's
    call), the forward with the loss (``Trainer.loss_fn``), the backward
    (up to the recipe's update) and the optimizer (``Recipe.step``). Each
    stretch is device time, which includes any wait for the host, and the
    host's own time to queue it."""
    names = ("sampler", "forward+loss", "backward", "optimizer")
    marks = []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((ev, time.perf_counter()))

    class Tx:  # the recipe, with a mark on entry and on exit of its step
        def __init__(self, tx):
            self.tx = tx
            self.step = _Marked(tx.step, mark, first=True)

    tx = state.tx
    tr.loss_fn = _Marked(tr.loss_fn, mark)
    state.tx = Tx(tx)
    step = tr.make_multi_step(_Marked(pipe, mark, first=True), 1)
    dev = {k: [] for k in names}
    host = {k: [] for k in names}
    try:
        for _ in range(n):
            marks.clear()
            step(state)
            torch.cuda.synchronize()
            # before sampler, after sampler, after loss_fn, before and
            # after the optimizer's update
            check(len(marks) == 5, f"{len(marks)} marks in a train step")
            for i, k in enumerate(names):
                (e0, t0), (e1, t1) = marks[i], marks[i + 1]
                dev[k].append(e0.elapsed_time(e1))
                host[k].append((t1 - t0) * 1e3)
    finally:
        del tr.loss_fn
        state.tx = tx
    parts = ", ".join(f"{k} {statistics.median(dev[k]):.3f} ms (host "
                      f"{statistics.median(host[k]):.3f})" for k in names)
    total = sum(statistics.median(dev[k]) for k in names)
    print(f"[6] train step by layer (median of {n}, CUDA events around the "
          f"trainer's stages; host = enqueue time): {parts}; sum "
          f"{total:.3f} ms | {card}")


def _train_predict(state, x, sr_out, card: str, launches: int) -> dict:
    """The resblock kernel at the shape the trainer's ``predict`` gives it.
    A second predict on ``x`` with a hook on each body block: the hook holds
    the kernel's output against ``fused_resblock_plain`` on the input the
    block received, within two bf16 ulps of the output's largest magnitude
    (the block rounds its conv sum and its residual add) and never below
    phase 3's 2e-2, and hands the plain output on. That predict is then
    the plain one, held against ``sr_out``, the kernel's, within 1e-2 in
    relative L2; and against the float32 predict of the same weights, the
    kernel's may be no further off than 1.25 times the plain one's plus
    1e-3. Times at this shape, with the first block's weights and input.
    Returns the row of the kernels line."""
    from sr_torch.kernels.fused_resblock import (
        fused_resblock, fused_resblock_plain, pack_weights)
    from sr_torch.utils.precision import no_tf32

    errs, seen = [], []

    def hook(blk, args, out):
        x_in = args[0].to(blk.dtype).permute(0, 2, 3, 1).contiguous()
        w1, b1, w2, b2 = pack_weights(blk.Conv_0.weight, blk.Conv_0.bias,
                                      blk.Conv_1.weight, blk.Conv_1.bias)
        ops = (x_in, w1.to(blk.dtype), b1, w2.to(blk.dtype), b2)
        want = fused_resblock_plain(*ops, res_scale=blk.res_scale)
        amax = float(want.float().abs().max())
        tol = max(TOL[torch.bfloat16],
                  2.0 ** (np.floor(np.log2(max(amax, 1e-30))) - 6))
        err = float((out.permute(0, 2, 3, 1).float() - want.float())
                    .abs().max())
        errs.append((err, tol, amax))
        if not seen:
            seen.append((blk, ops))
        return want.permute(0, 3, 1, 2)

    blocks = list(state.model.blocks)
    handles = [blk.register_forward_hook(hook) for blk in blocks]
    try:
        with torch.no_grad():
            state.model.eval()
            plain_out = state.model(x)
    finally:
        for h in handles:
            h.remove()
    check(len(errs) == len(blocks), "a body block was not checked")
    shape = tuple(seen[0][1][0].shape)
    worst = max(errs, key=lambda e: e[0] / e[1])
    print(f"[6] fused_resblock {shape} bf16 in predict, each of "
          f"{len(errs)} blocks on its own input vs fused_resblock_plain: "
          f"max abs err {max(e[0] for e in errs):.3g}; worst against its "
          f"tolerance {worst[0]:.3g} (tol {worst[1]:.3g}, output up to "
          f"{worst[2]:.3g})")
    check(all(err <= tol for err, tol, _ in errs),
          "fused_resblock disagrees with its plain version in predict")
    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    rel = rel_l2(sr_out, plain_out)
    dmax = float((sr_out.float() - plain_out.float()).abs().max())
    # the scale of bf16 rounding: both bf16 predicts against the same
    # weights' float32 predict (TF32 off)
    with no_tf32(), torch.no_grad():
        ref32 = state.model.clone(torch.float32)(x)
    e_k, e_p = rel_l2(sr_out, ref32), rel_l2(plain_out, ref32)
    print(f"[6] predict through the kernel vs predict through "
          f"fused_resblock_plain, bf16 {tuple(x.shape)}: rel L2 {rel:.3g} "
          f"(tol 1e-2), max abs {dmax:.3g}; against the f32 predict: kernel "
          f"{e_k:.3g}, plain {e_p:.3g} (kernel tol 1.25 x plain + 1e-3)")
    check(rel <= 1e-2 and e_k <= 1.25 * e_p + 1e-3,
          "predict through the kernel differs from the plain predict")
    blk, ops = seen[0]
    kops = (ops[0], *blk.packed())
    t_k = kernel_ms(lambda: fused_resblock(*kops, res_scale=blk.res_scale))
    t_p = kernel_ms(lambda: fused_resblock_plain(*ops,
                                                 res_scale=blk.res_scale))
    t_l = kernel_ms(_resblock_library(*ops, res_scale=blk.res_scale))
    bound, bound_by = _resblock_bound(ops[0])
    print(f"[6] fused_resblock {shape} bf16 (train predict): kernel "
          f"{t_k:.4f} ms, plain {t_p:.4f} ms, conv-relu-conv-add "
          f"{t_l:.4f} ms, bound {bound:.4f} ms ({bound_by}) | {card}")
    return dict(
        name="fused_resblock", route="cuda",
        source="sr_torch/kernels/csrc/fused_resblock.cu",
        replaces="sr/kernels/fused_resblock.py:119", launches=launches,
        max_abs_err=max(e[0] for e in errs), ms=t_k, plain_ms=t_p,
        bound_ms=bound, bound_by=bound_by, library_ms=t_l, shape=list(shape),
        dtype="bfloat16", path="train predict")


def phase_train(card: str, d2s_entry: dict, resblock_entry: dict):
    """Train full-width EDSR ×4 (bf16 compute, f32 weights) on the card
    through the port's entry points: SyntheticDataset(32, 160², seed 100),
    PatchPipeline 'matrix' on the card, crop 64, b32 (bench.py's train
    axis); make_multi_step at K=40 and K=120, fit for one short epoch with
    a checkpointer, predict, then serve the trained weights. Launch counts
    are zeroed just before that run and read just after. Returns the
    shuffle's training-shape entries and the resblock's entry at the shape
    of the trainer's predict, the trainer and the trained state."""
    import tempfile

    from sr_torch.data.datasets import SyntheticDataset
    from sr_torch.data.pipeline import PatchPipeline
    from sr_torch.infer import upscale
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.kernels.fused_resblock import fused_resblock
    from sr_torch.kernels.shuffle_fold import make_folded_tail_predict
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.checkpoint import Checkpointer, run_meta, save_params
    from sr_torch.utils.config import SRConfig
    from sr_torch.utils.interop import to_jax_params
    from sr_torch.utils.precision import no_tf32

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = _train_d2s(card, gen)
    ds = SyntheticDataset(num_images=32, size=(160, 160), channels=3,
                          seed=100)
    pipe = PatchPipeline([ds[i] for i in range(len(ds))],
                         crop_size=TRAIN_CROP, scale_factor=4,
                         batch_size=TRAIN_BATCH, channels=3)
    cfg = SRConfig(model_name="EDSR", num_channels=3, scale_factor=4,
                   crop_size=TRAIN_CROP, batch_size=TRAIN_BATCH,
                   dtype="bfloat16", steps_per_epoch=TRAIN_EPOCH,
                   steps_per_dispatch=TRAIN_EPOCH // 2,
                   log_every=TRAIN_EPOCH // 2, save_epochs=1)
    batch = pipe(torch.Generator(device="cuda").manual_seed(7))
    _step_card_vs_cpu(cfg, batch)
    _preshuffle_modes(cfg, batch)

    tr = Trainer(cfg)
    state = tr.init_state(1)
    print(f"[6] EDSR x4 train: {tr.num_params(state)} params, bf16 compute, "
          f"crop {TRAIN_CROP} b{TRAIN_BATCH}, PatchPipeline "
          f"'{pipe.random_scale_mode}' on {pipe.bank.device} "
          f"{tuple(pipe.bank.shape)}")
    multi = {k: tr.make_multi_step(pipe, k) for k in TRAIN_K}
    # K steps queue with no host sync: PyTorch raises on any synchronizing
    # call inside this mode (after one warm-up dispatch, which sets up
    # cuDNN and cuBLAS)
    probe, step3 = tr.init_state(4), tr.make_multi_step(pipe, 3)
    step3(probe)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step3(probe)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("[6] a K=3 dispatch made no host sync "
          "(torch.cuda.set_sync_debug_mode('error'))")
    del probe, step3
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=out_dir)

    # ---- the train path: counts zeroed just before, read just after ----
    depth_to_space.launches = 0
    fused_resblock.launches = 0
    dispatch_loss, times = [], {k: [] for k in TRAIN_K}
    for rep in range(TRAIN_REPEATS + 1):  # the first round warms up
        for k in TRAIN_K:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            m = multi[k](state)
            end.record()
            torch.cuda.synchronize()
            dispatch_loss.append(float(m["loss"]))
            if rep:
                times[k].append(start.elapsed_time(end))
    steps_run = state.step
    ckpt = Checkpointer(ckpt_dir, meta=run_meta(cfg))
    epoch = state.step // cfg.steps_per_epoch
    state = tr.fit(state, pipe, num_epochs=epoch + 1, checkpointer=ckpt)
    check(state.step == steps_run + cfg.steps_per_epoch,
          f"fit ran {state.step - steps_run} steps")
    sr_out = tr.predict(state, batch["lr"])
    torch.cuda.synchronize()
    launches = {"depth_to_space": depth_to_space.launches,
                "fused_resblock": fused_resblock.launches}
    print(f"[6] train-path launches over {state.step} steps and one "
          f"predict: {launches} (want {2 * state.step + 2} and 16)")
    check(launches == {"depth_to_space": 2 * state.step + 2,
                       "fused_resblock": 16},
          "the train path did not run 2 shuffles a step and the resblock "
          "kernel in predict")
    for row in rows:
        row["launches"] = launches["depth_to_space"]
    d2s_entry["train_launches"] = launches["depth_to_space"]
    resblock_entry["train_launches"] = launches["fused_resblock"]
    check(bool(torch.isfinite(sr_out.float()).all()),
          "predict after training is not finite")
    rows.append(_train_predict(state, batch["lr"], sr_out, card,
                               launches["fused_resblock"]))

    # ---- throughput: marginal steps per second between K=40 and K=120
    k_s, k_l = TRAIN_K
    marg = [(k_l - k_s) / ((t_l - t_s) / 1e3)
            for t_s, t_l in zip(times[k_s], times[k_l])]
    steps_s = statistics.median(marg)
    for k in TRAIN_K:
        per_step = statistics.median(times[k]) / k
        print(f"[6] K={k} dispatches: "
              + ", ".join(f"{t:.1f}" for t in times[k])
              + f" ms ({per_step:.3f} ms/step)")
    print(f"[6] EDSR x4 bf16 train, crop {TRAIN_CROP} b{TRAIN_BATCH}: "
          f"{steps_s:.1f} steps/s marginal (K={k_s}->{k_l}, median of "
          f"{TRAIN_REPEATS}; {', '.join(f'{v:.1f}' for v in marg)}), "
          f"{1e3 / steps_s:.3f} ms/step | {card}")
    print(f"[6] mean loss per dispatch: first {dispatch_loss[0]:.5f}, last "
          f"{dispatch_loss[-1]:.5f}")
    check(dispatch_loss[-1] < dispatch_loss[0], "(d) the loss did not fall")

    # ---- exact resume from the epoch's checkpoint
    restored = ckpt.restore(tr.init_state(99))
    check(restored.step == state.step and all(
        torch.equal(p, q) for p, q in zip(restored.model.parameters(),
                                          state.model.parameters()))
          and torch.equal(restored.generator.get_state(),
                          state.generator.get_state()),
          "the checkpoint did not restore the trained state")
    print(f"[6] checkpoint at step {ckpt.latest_step()} restores the state "
          "(weights, step, generator) exactly")

    # ---- where the time goes
    _train_layers(tr, state, pipe, card)
    step1 = tr.make_multi_step(pipe, 1)
    profile_batches(lambda: step1(state), "train step", card, n=10,
                    tag="[6]", unit="step")

    # ---- (f) the trained weights serve; (g) the folded tail is exact
    path = out_dir / "EDSR_x4_trained.npz"
    save_params(str(path), to_jax_params(state.model))
    img = np.random.default_rng(2).integers(0, 256, (96, 80, 3), np.uint8)
    served = upscale(img, "EDSR", str(path), scale_factor=4, device="cuda")
    check(served.shape == (384, 320, 3) and served.dtype == np.uint8,
          f"serving the trained weights gave {served.shape} {served.dtype}")
    print(f"[6] the trained weights serve through upscale: {served.shape} "
          f"uint8, mean {served.mean():.1f}")
    m32 = state.model.clone(torch.float32)
    x = batch["lr"][:4]
    with no_tf32(), torch.no_grad():
        d0 = depth_to_space.launches
        folded = make_folded_tail_predict(m32)(x)
        d_folded = depth_to_space.launches - d0
        exact = m32(x)
    err = float((folded - exact).abs().max())
    print(f"[6] make_folded_tail_predict vs the exact graph, f32 (TF32 off): "
          f"max abs err {err:.2e} (tol 1e-4), {d_folded} shuffle launches")
    check(err <= 1e-4 and d_folded == 2, "the folded tail differs")
    shutil.rmtree(ckpt_dir)
    return rows, tr, state


#: the eval harness's route shapes for EDSR ×4 (halo 40, tile 96, window
#: 176): the procedural set's 384² HR runs direct at 96² LR; the static
#: route runs its tiled images 8 windows a call
EVAL_TILE, EVAL_HALO = 96, 40
EVAL_WIN = EVAL_TILE + 2 * EVAL_HALO
EVAL_SHAPES = (("procedural direct", 1, 96), ("static route", 8, EVAL_WIN))
#: the static route's folder (H, W): two BSD-like images and one smaller,
#: all padded up to the window; one too small to pad (a native-size
#: forward); one that tiles in 6 windows (one call of 8)
EVAL_FOLDER = (("bsd_landscape", 321, 481), ("bsd_portrait", 481, 321),
               ("padded", 232, 200), ("tiny", 44, 40), ("tiled", 720, 960))


class _Counted:
    """``predict`` that counts its calls, records their input shapes and a
    CUDA event pair around each, so a run's predict time can be read
    after it."""

    def __init__(self, predict):
        self.predict, self.calls, self.events = predict, 0, []
        self.shapes: set = set()

    def __call__(self, x):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.predict(x)
        end.record()
        self.calls += 1
        self.events.append((start, end))
        self.shapes.add(tuple(x.shape))
        return out

    def predict_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def _timed_eval(predict, ds, **kw):
    """``evaluate`` between two CUDA events: (result, ms on the card's
    clock from the first queued op to the last, which includes the card
    waiting on the host's degradation and metrics; predict ms inside it;
    the counted predict)."""
    from sr_torch.eval.runner import evaluate

    counted = _Counted(predict)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    res = evaluate(counted, ds, **kw)
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end), counted.predict_ms(), counted


def _check_eval(res, what: str) -> None:
    ssims = [v for r in res.images for v in (r.ssim_sr, r.ssim_bicubic)
             if v is not None]
    vals = [v for r in res.images for v in (r.psnr_sr, r.psnr_bicubic)]
    check(bool(np.isfinite(vals).all()) and all(
        np.isfinite(s) and s <= 1.0 for s in ssims),
        f"{what}: PSNR or SSIM not finite, or SSIM above 1: {res.summary()}")


def _metric_region(hr_shape) -> tuple:
    """The static route's metric region of an HR image at ×4: (vh, vw),
    None where the input was not padded."""
    from sr_torch.eval.runner import _pad_plan

    ih, iw = hr_shape[0] // 4, hr_shape[1] // 4
    pad_h, pad_w, _ = _pad_plan(ih, iw, EVAL_WIN, EVAL_HALO)
    return ((ih - EVAL_HALO) * 4 if pad_h else None,
            (iw - EVAL_HALO) * 4 if pad_w else None)


def _eval_native(datasets) -> None:
    """(f) The native library runs, and its resize and PSNR equal numpy's
    bit for bit on every test image: the degradation, the bicubic
    baseline, and the Y-plane PSNR at borders 0 and 4."""
    from sr_torch.data import native
    from sr_torch.eval.metrics import modulo_crop, psnr
    from sr_torch.kernels.bicubic import pil_resize_exact_u8

    check(native.available(), "the native data-prep library did not build "
          "(a C++ compiler is required here; no numpy fallback)")
    n = 0
    for ds in datasets:
        for i in range(len(ds)):
            hr = modulo_crop(ds[i], 4)
            h, w = hr.shape[:2]
            lr = native.resize_bicubic_u8(hr, (h // 4, w // 4))
            bc = native.resize_bicubic_u8(lr, (h, w))
            check(np.array_equal(lr, pil_resize_exact_u8(hr, (h // 4, w // 4)))
                  and np.array_equal(bc, pil_resize_exact_u8(lr, (h, w))),
                  f"native resize differs from numpy on {ds.names[i]}")
            a, b = hr[..., 0], bc[..., 0]
            for border in (0, 4):
                check(native.psnr_y_u8(a, b, border) == psnr(
                    a.astype(np.float64), b.astype(np.float64),
                    border=border),
                    f"native PSNR differs from numpy on {ds.names[i]}")
            n += 1
    print(f"[7] native library ({native.BUILD_DIR.name}): resize and Y-PSNR "
          f"== numpy bit for bit on {n} test images")


def _eval_static_vs_direct(predict, folder) -> None:
    """(c) The static route against the direct route: the SR image on the
    metric region within 1e-4, per-image Y-PSNR within 1e-3 dB (the direct
    route's PSNR taken on the same region). ``predict`` is f32 and runs
    with TF32 off."""
    from sr_torch.eval.metrics import psnr
    from sr_torch.eval.runner import (
        _prep_eval_image, _rgb_to_y, _static_predict, evaluate)

    kw = dict(scale_factor=4, channels=3, color_space="rgb")
    static_fn = _static_predict(predict, EVAL_TILE, EVAL_HALO, 4, set())
    worst_img = 0.0
    for i in range(len(folder)):
        hr, _, _, x = _prep_eval_image(folder[i], 4, 3, False)
        vh, vw = _metric_region(hr.shape)
        x = torch.from_numpy(x).cuda()
        with torch.inference_mode():
            d = predict(x)[0, :vh, :vw].float()
            s = static_fn(x)[0, :vh, :vw].float()
        check(d.shape == s.shape, f"static route shape {tuple(s.shape)}")
        worst_img = max(worst_img, float((d - s).abs().max()))
    static = evaluate(predict, folder, static_shapes=True, tile=EVAL_TILE,
                      model_name="EDSR", **kw)
    direct = evaluate(predict, folder, keep_images=True, **kw)
    worst_psnr = 0.0
    for a, b in zip(static.images, direct.images):
        vh, vw = _metric_region(b.hr.shape)
        p = psnr(_rgb_to_y(b.sr[:vh, :vw]), _rgb_to_y(b.hr[:vh, :vw]),
                 border=4)
        worst_psnr = max(worst_psnr, abs(a.psnr_sr - p))
    print(f"[7] static vs direct route, f32 (TF32 off), {len(folder)} "
          f"images: SR max abs err on the metric region {worst_img:.3g} (tol "
          f"1e-4), Y-PSNR max diff {worst_psnr:.3g} dB (tol 1e-3)")
    check(worst_img <= 1e-4 and worst_psnr <= 1e-3,
          "the static route differs from the direct route")


def _eval_card_vs_cpu(tr, model32, ds) -> None:
    """(d) The same f32 model through ``evaluate`` on the CPU (the kernels'
    plain versions) and on the card (TF32 off): per-image PSNR within 1e-3
    dB, SSIM within 1e-5."""
    from sr_torch.eval.runner import evaluate
    from sr_torch.utils.precision import no_tf32

    kw = dict(scale_factor=4, channels=3, color_space="rgb")
    fn = tr.make_predict_fn()
    cpu_model = model32.clone(torch.float32).to("cpu")
    cpu = evaluate(functools.partial(fn, cpu_model), ds, device="cpu", **kw)
    with no_tf32():
        card = evaluate(functools.partial(fn, model32), ds, **kw)
    pairs = list(zip(card.images, cpu.images))
    dp = max(abs(a.psnr_sr - b.psnr_sr) for a, b in pairs)
    dss = max(abs(a.ssim_sr - b.ssim_sr) for a, b in pairs)
    print(f"[7] evaluate f32 card vs CPU, {len(ds)} images: PSNR max diff "
          f"{dp:.3g} dB (tol 1e-3), SSIM max diff {dss:.3g} (tol 1e-5)")
    check(dp <= 1e-3 and dss <= 1e-5,
          "evaluate on the card differs from the CPU")


def _eval_kernel_rows(card: str, launches: dict) -> list[dict]:
    """(h) The shuffle (both ×2 stages) and the resblock at the eval
    routes' shapes, bf16: against their plain versions, and timed as phase
    3 times them."""
    from sr_torch.kernels.depth_to_space import (
        depth_to_space, depth_to_space_plain)
    from sr_torch.kernels.fused_resblock import (
        fused_resblock, fused_resblock_plain)

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for route, b, h in EVAL_SHAPES:
        for hh in (h, 2 * h):
            x, bias = _d2s_operands((b, hh, hh, 256), torch.bfloat16, gen,
                                    True)
            check(torch.equal(depth_to_space(x, 2, None, bias),
                              depth_to_space_plain(x, 2, None, bias)),
                  f"depth_to_space differs at {tuple(x.shape)}")
            xc = x.permute(0, 3, 1, 2)
            t_k = kernel_ms(lambda: depth_to_space(x, 2))
            t_p = kernel_ms(lambda: depth_to_space_plain(x, 2).contiguous())
            t_l = kernel_ms(lambda: F.pixel_shuffle(xc, 2))
            t_kb = kernel_ms(lambda: depth_to_space(x, 2, None, bias))
            t_pb = kernel_ms(lambda: depth_to_space_plain(
                x, 2, None, bias).contiguous())
            bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            print(f"[7] depth_to_space {tuple(x.shape)} r=2 bf16 ({route}): "
                  f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, F.pixel_shuffle "
                  f"{t_l:.4f} ms, bound {bound:.4f} ms (bytes); with bias: "
                  f"kernel {t_kb:.4f} ms, plain {t_pb:.4f} ms | {card}")
            rows.append(dict(
                name="depth_to_space", route="cuda",
                source="sr_torch/kernels/csrc/depth_to_space.cu",
                replaces="sr/kernels/depth_to_space.py:73",
                launches=launches["depth_to_space"], max_abs_err=0.0,
                ms=t_k, plain_ms=t_p, bound_ms=bound, bound_by="bytes",
                library_ms=t_l, shape=list(x.shape), dtype="bfloat16",
                path=f"eval, {route}", ms_with_bias=t_kb,
                plain_ms_with_bias=t_pb))
            del x, xc, bias
        ops = _resblock_operands((b, h, h, 64), torch.bfloat16, gen)
        kops = _kernel_operands(ops)
        err = float((fused_resblock(*kops, res_scale=0.1).float()
                     - fused_resblock_plain(*ops, res_scale=0.1).float())
                    .abs().max())
        check(err <= TOL[torch.bfloat16],
              f"fused_resblock disagrees at {(b, h, h, 64)}: {err}")
        t_k = kernel_ms(lambda: fused_resblock(*kops, res_scale=0.1))
        t_p = kernel_ms(lambda: fused_resblock_plain(*ops, res_scale=0.1))
        t_l = kernel_ms(_resblock_library(*ops, res_scale=0.1))
        bound, bound_by = _resblock_bound(ops[0])
        print(f"[7] fused_resblock {(b, h, h, 64)} bf16 ({route}): kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, conv-relu-conv-add "
              f"{t_l:.4f} ms, bound {bound:.4f} ms ({bound_by}); max err "
              f"{err:.3g} (tol {TOL[torch.bfloat16]}) | {card}")
        rows.append(dict(
            name="fused_resblock", route="cuda",
            source="sr_torch/kernels/csrc/fused_resblock.cu",
            replaces="sr/kernels/fused_resblock.py:119",
            launches=launches["fused_resblock"], max_abs_err=err, ms=t_k,
            plain_ms=t_p, bound_ms=bound, bound_by=bound_by, library_ms=t_l,
            shape=[b, h, h, 64], dtype="bfloat16", path=f"eval, {route}"))
        del ops, kops
    return rows


def phase_eval(card: str, tr, state) -> list[dict]:
    """Evaluate phase 6's trained full-width EDSR ×4 (bf16) on the card
    through ``sr_torch.eval.runner.evaluate`` and
    ``Trainer.make_predict_fn``, the kernel counts zeroed just before and
    read just after: the synthetic test set, 8 procedural test images by
    the direct route and a folder of mixed-size PNGs by the static route,
    each with host and device metrics. Then the checks (a)-(h) of the
    module docstring. Returns the kernel rows at the eval shapes."""
    import tempfile

    from PIL import Image

    from sr_torch.data.datasets import FolderDataset, get_test_set
    from sr_torch.data.decode import list_images
    from sr_torch.data.procedural import (
        ProceduralDataset, generate_procedural_image)
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.kernels.fused_resblock import fused_resblock
    from sr_torch.utils.precision import no_tf32

    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    synthetic = get_test_set(str(out_dir), "synthetic")
    # 8 of get_test_set('procedural')'s 128 images, unmaterialized
    proc = ProceduralDataset(num_images=8, size=(384, 384), split="test",
                             color_space="rgb")
    folder_dir = Path(tempfile.mkdtemp(prefix="eval_folder_", dir=out_dir))
    rng = np.random.default_rng(7)
    for name, h, w in EVAL_FOLDER:
        Image.fromarray(generate_procedural_image(rng, h, w)).save(
            folder_dir / f"{name}.png")
    folder = FolderDataset(list_images(str(folder_dir)), "rgb")
    sets = (synthetic, proc, folder)
    for ds in sets:  # generate and decode before any timing
        for i in range(len(ds)):
            ds[i]
    print(f"[7] test sets: synthetic {len(synthetic)} x 128x128, procedural "
          f"{len(proc)} x 384x384 (test split), folder of {len(folder)} PNGs "
          f"{[(h, w) for _, h, w in EVAL_FOLDER]}; made in "
          f"{time.perf_counter() - t0:.1f} s (host clock)")
    _eval_native(sets)

    predict = functools.partial(tr.make_predict_fn(), state.model)
    rgb = dict(scale_factor=4, channels=3, color_space="rgb")
    static = dict(static_shapes=True, tile=EVAL_TILE, model_name="EDSR")
    routes = (("synthetic", synthetic, {}), ("procedural direct", proc, {}),
              ("folder static", folder, static))
    for _, ds, extra in routes:  # warm-up: cuDNN's plans at each shape
        for on_dev in (False, True):
            _timed_eval(predict, ds, on_device_metrics=on_dev, **rgb, **extra)

    # ---- the eval path: counts zeroed just before, read just after ----
    depth_to_space.launches = 0
    fused_resblock.launches = 0
    runs = {}
    for name, ds, extra in routes:
        for on_dev in (False, True):
            runs[name, on_dev] = _timed_eval(
                predict, ds, on_device_metrics=on_dev, **rgb, **extra)
    launches = {"depth_to_space": depth_to_space.launches,
                "fused_resblock": fused_resblock.launches}
    calls = sum(r[3].calls for r in runs.values())
    print(f"[7] eval-path launches over {calls} predict calls: {launches} "
          f"(want {2 * calls} and {16 * calls})")
    check(launches == {"depth_to_space": 2 * calls,
                       "fused_resblock": 16 * calls},
          "(e) the eval path did not run 2 shuffles and 16 resblocks a "
          "predict")
    shapes = runs["folder static", False][3].shapes
    print(f"[7] static route predict input shapes: {sorted(shapes)} (the "
          f"tiny image runs native-size)")
    check(shapes == {(8, EVAL_WIN, EVAL_WIN, 3), (1, EVAL_WIN, EVAL_WIN, 3),
                     (1, 11, 10, 3)}, "the static route ran other shapes")

    # ---- (a), (b) host against device metrics; no SSIM above 1
    for name, ds, _ in routes:
        host, dev = runs[name, False][0], runs[name, True][0]
        _check_eval(host, name)
        _check_eval(dev, name)
        pairs = list(zip(host.images, dev.images))
        dp = max(abs(a.psnr_sr - b.psnr_sr) for a, b in pairs)
        dss = max(abs(a.ssim_sr - b.ssim_sr) for a, b in pairs
                  if a.ssim_sr is not None)
        print(f"[7] {name}: host vs device metrics, per image PSNR max diff "
              f"{dp:.3g} dB (tol 1e-4), SSIM {dss:.3g} (tol 1e-5); model "
              f"{host.avg_psnr_sr:.4f} dB / SSIM "
              f"{host.summary().get('ssim_sr')}, bicubic "
              f"{host.avg_psnr_bicubic:.4f} dB / SSIM "
              f"{host.summary().get('ssim_bicubic')}")
        check(dp <= 1e-4 and dss <= 1e-5,
              f"{name}: device metrics differ from the host's")

    # ---- (g) images/s and ms per image; host against device metrics
    for name, _, _ in routes:
        for on_dev in (False, True):
            res, ms, pred_ms, counted = runs[name, on_dev]
            n = len(res.images)
            print(f"[7] eval {name}, {'device' if on_dev else 'host'} "
                  f"metrics: {n / ms * 1e3:.2f} images/s, {ms / n:.3f} "
                  f"ms/image (CUDA events), predict {pred_ms / n:.3f} "
                  f"ms/image over {counted.calls} calls "
                  f"({100 * pred_ms / ms:.1f}% of the span) | {card}")
        host_ms, dev_ms = runs[name, False][1], runs[name, True][1]
        print(f"[7] eval {name}: host metrics {host_ms:.1f} ms against "
              f"device metrics {dev_ms:.1f} ms for the set "
              f"({host_ms / dev_ms:.2f}x) | {card}")

    # ---- (c) static against direct, (d) card against CPU; f32, TF32 off
    model32 = state.model.clone(torch.float32)
    with no_tf32():
        _eval_static_vs_direct(
            functools.partial(tr.make_predict_fn(), model32), folder)
    _eval_card_vs_cpu(tr, model32, synthetic)
    shutil.rmtree(folder_dir)

    # ---- (h) the kernels at the eval shapes
    return _eval_kernel_rows(card, launches)


#: ESPCN ×4 on Y at full width (64/32 filters, r=4, 1 channel): the
#: shuffle's r=4, 16→1 shapes by path, (path, B, H, dtype); the int8
#: ESPCN's int8 sites (name, C, N, k); the train dispatch (the bench's K)
ESPCN_INT8 = (("conv 1", 1, 64, 5), ("conv 2", 64, 32, 3),
              ("conv 3", 32, 16, 3))
ESPCN_K = 300
#: serving modes (dtype, quantize), all with fused=True: ESPCN has no
#: affine tail, so each runs its exact graph
ESPCN_SERVE = (("bfloat16", False), ("float32", False),
               ("bfloat16", "static"), ("bfloat16", "dynamic"))
#: RGB images served in (c), (H, W); the second exceeds one 266-px window
#: (tile 256 + 2·halo 5) and runs tiled
ESPCN_IMAGES = ((96, 80), (300, 260))


def _espcn_forward_shape(hw) -> tuple:
    """The (B, H, W) batch of LR windows that ``upscale`` hands ESPCN's
    net for an image of ``hw``: the image whole, or its halo tiles in one
    call, as ``tiled_predict`` cuts them at ``upscale``'s default tile."""
    from sr_torch.eval.tiling import RECEPTIVE_FIELD, tiled_predict

    seen = []

    def record(t):
        seen.append(tuple(t.shape[:3]))
        return t.new_zeros((t.shape[0], 4 * t.shape[1], 4 * t.shape[2], 1))

    x = torch.zeros((1, *hw, 1))
    if max(hw) > 256:
        tiled_predict(record, x, 4, tile=256, halo=RECEPTIVE_FIELD["espcn"])
    else:
        record(x)
    check(len(seen) == 1, f"ESPCN serving of {hw} takes {len(seen)} calls")
    return seen[0]


def _espcn_train(card: str):
    """(b) ESPCN trains with the bench's configuration: the f32 step card
    vs CPU, 'last' against off (1 and 0 shuffles a step), then the train
    path with its counts zeroed just before and read just after: two K=300
    dispatches (the loss must fall; 1 shuffle a step, no resblock), and a
    checkpoint that restores exactly. Returns the trainer, the state and
    the path's launches."""
    import tempfile

    from sr_torch.data.datasets import SyntheticDataset
    from sr_torch.data.pipeline import PatchPipeline
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.kernels.fused_resblock import fused_resblock
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.checkpoint import Checkpointer, run_meta
    from sr_torch.utils.config import SRConfig

    ds = SyntheticDataset(num_images=32, size=(160, 160), channels=3,
                          seed=100)
    pipe = PatchPipeline([ds[i][..., :1] for i in range(len(ds))],
                         crop_size=TRAIN_CROP, scale_factor=4,
                         batch_size=TRAIN_BATCH, channels=1)
    cfg = SRConfig(model_name="ESPCN", num_channels=1, scale_factor=4,
                   crop_size=TRAIN_CROP, batch_size=TRAIN_BATCH,
                   dtype="bfloat16")
    batch = pipe(torch.Generator(device="cuda").manual_seed(9))
    _step_card_vs_cpu(cfg, batch, tag="[8]")
    _preshuffle_modes(cfg, batch, modes=((False, 1), ("last", 0)),
                      tag="[8]")
    tr = Trainer(cfg)
    state = tr.init_state(1)
    multi = tr.make_multi_step(pipe, ESPCN_K)
    print(f"[8] ESPCN x4 train: {tr.num_params(state)} params, bf16, crop "
          f"{TRAIN_CROP} b{TRAIN_BATCH}, MSE, Adam {tr.cfg.effective_lr:g}, "
          f"PatchPipeline '{pipe.random_scale_mode}' on {pipe.bank.device} "
          f"{tuple(pipe.bank.shape)}")

    # ---- the train path: counts zeroed just before, read just after ----
    depth_to_space.launches = 0
    fused_resblock.launches = 0
    losses, times = [], []
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        m = multi(state)
        end.record()
        end.synchronize()
        losses.append(float(m["loss"]))
        times.append(start.elapsed_time(end))
    launches = {"depth_to_space": depth_to_space.launches,
                "fused_resblock": fused_resblock.launches}
    print(f"[8] two K={ESPCN_K} dispatches: {times[0]:.1f} / {times[1]:.1f} "
          f"ms (one dispatch each, not a marginal: {times[1] / ESPCN_K:.3f} "
          f"ms/step); mean loss {losses[0]:.5f} then {losses[1]:.5f}; "
          f"launches {launches} (want {2 * ESPCN_K} and 0) | {card}")
    check(launches == {"depth_to_space": 2 * ESPCN_K, "fused_resblock": 0},
          "the ESPCN train path did not run 1 shuffle a step")
    check(losses[1] < losses[0], "the ESPCN loss did not fall")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="espcn_ckpt_", dir=out_dir)
    ckpt = Checkpointer(ckpt_dir, meta=run_meta(cfg))
    ckpt.save(state)
    restored = ckpt.restore(tr.init_state(99))
    check(restored.step == state.step == 2 * ESPCN_K and all(
        torch.equal(p, q) for p, q in zip(restored.model.parameters(),
                                          state.model.parameters()))
          and torch.equal(restored.generator.get_state(),
                          state.generator.get_state()),
          "the ESPCN checkpoint did not restore the trained state")
    print(f"[8] checkpoint at step {ckpt.latest_step()} restores the state "
          "exactly")
    shutil.rmtree(ckpt_dir)
    return tr, state, launches


def _espcn_serve(card: str, state) -> dict:
    """(c) The trained params, saved in the JAX package's .npz format,
    served through ``upscale`` on RGB images (one tiled) in bf16 and f32,
    int8 static and dynamic, and through one HTTP POST, the counts zeroed
    just before and read just after; then per-forward launches, f32 card
    vs CPU, the chroma planes against ``resize_bicubic_u8`` and int8
    against f32 interiors. Returns the path's launches, in all and by
    forward shape: ``{("depth_to_space", (B, H, W), dtype): n,
    ("int8_conv", (B, H, W)): launches of each site}``."""
    import collections

    from PIL import Image

    from sr_torch.data.native import resize_bicubic_u8
    from sr_torch.infer import upscale
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.kernels.fused_resblock import fused_resblock
    from sr_torch.kernels.int8_conv import conv_int8_fused, conv_int8_im2col
    from sr_torch.serve import SRService, serve_background
    from sr_torch.utils.checkpoint import save_params
    from sr_torch.utils.interop import to_jax_params
    from sr_torch.utils.precision import no_tf32

    out_dir = ROOT / "build" / "chip_smoke"
    path = str(out_dir / "ESPCN_x4_trained.npz")
    save_params(path, to_jax_params(state.model))
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ESPCN_IMAGES]
    ycc = rng.integers(0, 256, (52, 44, 3), dtype=np.uint8)
    by_shape = collections.Counter()

    def counted(fn, hw, dtype):
        """``fn()``, its launches added to ``by_shape`` at the forward
        shape of an ``hw`` image served with a ``dtype`` model. An int8
        forward runs each site once and shuffles in float32 (upscale's
        input dtype, which an int8 site returns); every other shuffle is a
        float forward's, in the model's dtype (a static predict's first
        call calibrates with one)."""
        d0, c0 = depth_to_space.launches, conv_int8_fused.launches
        out = fn()
        shape = _espcn_forward_shape(hw)
        n_q = (conv_int8_fused.launches - c0) // len(ESPCN_INT8)
        by_shape["int8_conv", shape] += n_q
        by_shape["depth_to_space", shape, "float32"] += n_q
        by_shape["depth_to_space", shape, dtype] += (
            depth_to_space.launches - d0 - n_q)
        return out

    # ---- the serving path: counts zeroed just before, read just after --
    for fn in (depth_to_space, fused_resblock, conv_int8_fused,
               conv_int8_im2col):
        fn.launches = 0
    outs = {}
    for dtype, quantize in ESPCN_SERVE:
        for img in imgs:
            t0 = time.perf_counter()
            out = counted(functools.partial(
                upscale, img, "ESPCN", path, dtype=dtype, quantize=quantize,
                fused=True), img.shape[:2], dtype)
            ms = (time.perf_counter() - t0) * 1e3
            h, w = img.shape[:2]
            check(out.shape == (4 * h, 4 * w, 3) and out.dtype == np.uint8,
                  f"ESPCN upscale output {out.shape} {out.dtype}")
            outs[dtype, quantize, img.shape] = out
            print(f"[8] upscale ESPCN {h}x{w} RGB {dtype} int8 {quantize}: "
                  f"{out.shape} uint8 in {ms:.1f} ms (host clock, first "
                  "call loads/calibrates)")
    got = upscale(ycc, "ESPCN", path, color_space="ycbcr", fused=True)
    bc = resize_bicubic_u8(ycc, (4 * ycc.shape[0], 4 * ycc.shape[1]))
    check(np.array_equal(got[..., 1:], bc[..., 1:]),
          "the YCbCr output's chroma is not the bicubic upscale's")
    service = SRService(model_name="ESPCN", params=path, scale_factor=4)
    httpd, port = serve_background(service)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)

    def post():
        conn.request("POST", "/upscale", body=_png(imgs[0]),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        return resp, resp.read()

    # the service serves a bf16 model
    resp, body = counted(post, imgs[0].shape[:2], "bfloat16")
    conn.close()
    httpd.shutdown()
    httpd.server_close()
    check(resp.status == 200, f"POST /upscale ESPCN: {resp.status}")
    check(np.array_equal(np.asarray(Image.open(io.BytesIO(body))),
                         outs["bfloat16", False, imgs[0].shape]),
          "the served ESPCN PNG differs from a direct upscale")
    launches = {"depth_to_space": depth_to_space.launches,
                "int8_conv": conv_int8_fused.launches,
                "int8_conv raw entry": conv_int8_im2col.launches,
                "fused_resblock": fused_resblock.launches}
    print(f"[8] chroma of a YCbCr upscale == resize_bicubic_u8 (bit for "
          f"bit); POST /upscale == direct upscale; serving-path launches: "
          f"{launches}; by forward shape: {dict(by_shape)}")
    check(launches["depth_to_space"] > 0 and launches["int8_conv"] > 0
          and launches["fused_resblock"] == 0
          and launches["int8_conv raw entry"] == 0,
          "the ESPCN serving path must shuffle and run its int8 convs "
          "through the kernels, and run no resblock")

    # ---- per-forward counts (the loaded functions are cached) ----
    for dtype, quantize in ESPCN_SERVE:
        c0, d0, r0 = (conv_int8_fused.launches, depth_to_space.launches,
                      fused_resblock.launches)
        upscale(imgs[0], "ESPCN", path, dtype=dtype, quantize=quantize,
                fused=True)
        got = (conv_int8_fused.launches - c0, depth_to_space.launches - d0,
               fused_resblock.launches - r0)
        print(f"[8] one ESPCN {dtype} int8 {quantize} forward: int8_conv "
              f"+{got[0]}, depth_to_space +{got[1]}, fused_resblock "
              f"+{got[2]}")
        check(got == ((3 if quantize else 0), 1, 0),
              "unexpected ESPCN launches per forward")

    # ---- f32 card vs CPU (TF32 off on the card), every pixel ----
    for img in imgs:
        with no_tf32():
            card_out = upscale(img, "ESPCN", path, dtype="float32",
                               fused=True)
        cpu_out = upscale(img, "ESPCN", path, dtype="float32", fused=True,
                          device="cpu")
        d = np.abs(card_out.astype(np.int32) - cpu_out)
        print(f"[8] ESPCN f32 upscale {img.shape[:2]}, card vs CPU: max "
              f"{d.max()} u8 levels, mean {d.mean():.5f} (tol 1)")
        check(d.max() <= 1, "the card's ESPCN upscale differs from the CPU's")

    # ---- int8 against f32, interiors (ESPCN's receptive field, 5 LR px) --
    m = 5 * 4
    for quantize in ("static", "dynamic"):
        for img in imgs:
            a = outs["bfloat16", quantize, img.shape].astype(np.int32)
            b = outs["float32", False, img.shape].astype(np.int32)
            d = np.abs(a - b)[m:-m, m:-m]
            print(f"[8] ESPCN int8 {quantize} vs f32 interior "
                  f"{img.shape[:2]}: max {d.max()} u8 levels, mean "
                  f"{d.mean():.4f} (tol mean 4)")
            check(d.mean() <= 4, "ESPCN int8 interior too far from f32")
    return launches, by_shape


def _espcn_eval(card: str, tr, state) -> dict:
    """(d) The trained ESPCN through ``evaluate(channels=1)`` on the
    synthetic set and 8 procedural 384² test images (YCbCr), host and
    device metrics, the counts zeroed just before and read just after (1
    shuffle and no resblock a predict call); device metrics within 1e-4
    dB and 1e-5 SSIM of the host's; images/s by CUDA events. Returns the
    path's launches and its predict calls on the procedural set, each a
    (1, 96, 96) forward."""
    from sr_torch.data.datasets import get_test_set
    from sr_torch.data.procedural import ProceduralDataset
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.kernels.fused_resblock import fused_resblock

    out_dir = ROOT / "build" / "chip_smoke"
    synthetic = get_test_set(str(out_dir), "synthetic")
    proc = ProceduralDataset(num_images=8, size=(384, 384), split="test",
                             color_space="ycbcr")
    for ds in (synthetic, proc):
        for i in range(len(ds)):
            ds[i]
    predict = functools.partial(tr.make_predict_fn(), state.model)
    kw = dict(scale_factor=4, channels=1, color_space="ycbcr")
    sets = (("synthetic", synthetic), ("procedural", proc))
    for _, ds in sets:  # warm-up: cuDNN's plans at each shape
        for on_dev in (False, True):
            _timed_eval(predict, ds, on_device_metrics=on_dev, **kw)

    # ---- the eval path: counts zeroed just before, read just after ----
    depth_to_space.launches = 0
    fused_resblock.launches = 0
    runs = {(name, on_dev): _timed_eval(predict, ds,
                                        on_device_metrics=on_dev, **kw)
            for name, ds in sets for on_dev in (False, True)}
    launches = {"depth_to_space": depth_to_space.launches,
                "fused_resblock": fused_resblock.launches}
    calls = sum(r[3].calls for r in runs.values())
    print(f"[8] ESPCN eval-path launches over {calls} predict calls: "
          f"{launches} (want {calls} and 0)")
    check(launches == {"depth_to_space": calls, "fused_resblock": 0},
          "the ESPCN eval path did not run 1 shuffle a predict")
    for name, _ in sets:
        host, dev = runs[name, False][0], runs[name, True][0]
        _check_eval(host, f"ESPCN {name}")
        _check_eval(dev, f"ESPCN {name}")
        pairs = list(zip(host.images, dev.images))
        dp = max(abs(a.psnr_sr - b.psnr_sr) for a, b in pairs)
        dss = max(abs(a.ssim_sr - b.ssim_sr) for a, b in pairs)
        print(f"[8] ESPCN eval {name} (Y): host vs device metrics, PSNR max "
              f"diff {dp:.3g} dB (tol 1e-4), SSIM {dss:.3g} (tol 1e-5); "
              f"model {host.avg_psnr_sr:.4f} dB, bicubic "
              f"{host.avg_psnr_bicubic:.4f} dB")
        check(dp <= 1e-4 and dss <= 1e-5,
              f"ESPCN {name}: device metrics differ from the host's")
        for on_dev in (False, True):
            res, ms, pred_ms, counted = runs[name, on_dev]
            n = len(res.images)
            print(f"[8] ESPCN eval {name}, {'device' if on_dev else 'host'} "
                  f"metrics: {n / ms * 1e3:.2f} images/s, {ms / n:.3f} "
                  f"ms/image (CUDA events), predict {pred_ms / n:.3f} "
                  f"ms/image ({100 * pred_ms / ms:.1f}% of the span) | {card}")
    return launches, sum(runs["procedural", on_dev][3].calls
                         for on_dev in (False, True))


def phase_espcn(card: str) -> list[dict]:
    """Phase 8: ESPCN ×4 on Y at full width. (a) the shuffle (r=4, 16→1)
    and the fused int8 entry at ESPCN's shapes, against their plain
    versions and timed; (b) training, (c) serving, (d) eval through the
    port's entry points, each with its own zeroed counts. Returns the
    kernel rows, each with the launches of its path."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(8)
    d2s_rows, int8_rows = [], []
    for h, w in ESPCN_IMAGES:  # the forward shapes upscale gives the net
        shape = _espcn_forward_shape((h, w))
        for dtype, what in ((torch.bfloat16, "bf16 serving"),
                            (torch.float32, "f32 and int8 serving")):
            d2s_rows.append(_d2s_row(
                card, gen, (*shape, 16), 4, dtype, tag="[8]",
                path=f"ESPCN {what}, {h}x{w} image", odd=(1, 37, 53)))
        for name, c, n, k in ESPCN_INT8:
            row = _int8_row(card, gen, f"ESPCN {name}", (*shape, c), n, k,
                            tag="[8]")
            row["path"] = f"ESPCN int8 serving, {name}, {h}x{w} image"
            int8_rows.append(row)
    # b16 at 128² LR, phase 5's EDSR serving batch: no ESPCN path serves
    # it, so it is checked and timed for comparison but has no row
    for dtype in (torch.bfloat16, torch.float32):
        _d2s_row(card, gen, (16, 128, 128, 16), 4, dtype, tag="[8]",
                 path="b16 128², no path serves it")
    for name, c, n, k in ESPCN_INT8:
        _int8_row(card, gen, f"ESPCN {name} (b16 128², no path serves it)",
                  (16, 128, 128, c), n, k, tag="[8]")
    eval_row = _d2s_row(card, gen, (1, 96, 96, 16), 4, torch.bfloat16,
                        tag="[8]", path="ESPCN eval, procedural direct",
                        odd=(1, 37, 53))
    train_row = _train_d2s(card, gen, shapes=((16, 16),), r=4, tag="[8]",
                           path="ESPCN train forward (last conv's bias "
                                "inside)")[0]
    tr, state, train_launches = _espcn_train(card)
    _, by_shape = _espcn_serve(card, state)
    _, eval_row["launches"] = _espcn_eval(card, tr, state)
    train_row["launches"] = train_launches["depth_to_space"]
    for row in d2s_rows:
        row["launches"] = by_shape["depth_to_space", tuple(row["shape"][:3]),
                                   row["dtype"]]
    for row in int8_rows:
        row["launches"] = by_shape["int8_conv", tuple(row["shape"][:3])]
    rows = d2s_rows + [eval_row, train_row] + int8_rows
    check(all(row["launches"] > 0 for row in rows),
          "an ESPCN kernel row's shape was not launched on its path: "
          f"{[(r['name'], r['shape'], r['launches']) for r in rows]}")
    print(f"[8] phase seconds {time.perf_counter() - t0:.1f}")
    return rows


#: the pre-upsample family ×4 on Y at full width (phase 10): each model's
#: int8 sites with distinct shapes (name, C, N, k) and its int8 convs a
#: forward (DRCN: 2 embedding sites, 3 recursion sites × 16)
PRE_INT8 = {
    "SRCNN": (("conv 1 (9x9)", 1, 64, 9), ("conv 2 (5x5)", 64, 32, 5),
              ("conv 3 (5x5)", 32, 1, 5)),
    "VDSR": (("conv 1", 1, 64, 3), ("body x18", 64, 64, 3),
             ("conv 20", 64, 1, 3)),
    "DRCN": (("embed 1", 1, 64, 3), ("embed 2 + recursion x32", 64, 64, 3),
             ("reconstruction x16", 64, 1, 3)),
}
PRE_PER_FWD = {"SRCNN": 3, "VDSR": 20, "DRCN": 50}
#: K of the two train dispatches; the run's length is 2K + 3 steps, so
#: DRCN's α anneals over them
PRE_K = {"SRCNN": 100, "VDSR": 40, "DRCN": 50}
#: RGB LR images served in (c): the net sees their ×4 bicubic upscale,
#: (96, 80) whole and (320, 260) in 4 halo tiles at upscale's tile 256
PRE_IMAGES = ((24, 20), (80, 65))


def _pre_forward_shape(name: str, hw) -> tuple:
    """The (B, H, W) batch that ``upscale`` hands a pre-upsample net for an
    LR image of ``hw``: its ×4 bicubic upscale whole, or that upscale's
    halo tiles in one call, as ``tiled_predict`` cuts them."""
    from sr_torch.eval.tiling import RECEPTIVE_FIELD, tiled_predict

    seen = []

    def record(t):
        seen.append(tuple(t.shape[:3]))
        return t

    x = torch.zeros((1, 4 * hw[0], 4 * hw[1], 1))
    if max(x.shape[1:3]) > 256:
        tiled_predict(record, x, 1, tile=256,
                      halo=RECEPTIVE_FIELD[name.lower()])
    else:
        record(x)
    check(len(seen) == 1, f"{name} serving of {hw} takes {len(seen)} calls")
    return seen[0]


class _Tally:
    """Inside ``with``, tallies each shuffle kernel launch by (NHWC shape,
    dtype) and each fused int8 launch of the int8 sites by (B, H, W, C, N,
    k), on the card only; the wrappers still count their launches."""

    def __init__(self):
        import collections

        self.d2s = collections.Counter()
        self.int8 = collections.Counter()

    def __enter__(self):
        from sr_torch import quant
        from sr_torch.kernels import ops

        # the shuffle wrapper calls its operator through this name
        self._d2s, self._int8 = real_d2s, real_int8 = (
            ops._d2s_op, quant.conv_int8_fused)

        def d2s_seen(x, r, act, bias):
            if x.is_cuda:
                self.d2s[tuple(x.shape), x.dtype] += 1
            return real_d2s(x, r, act, bias)

        def int8_seen(x, q_w, *args, **kwargs):
            if x.is_cuda:
                self.int8[(*x.shape, q_w.shape[-1], q_w.shape[0])] += 1
            return real_int8(x, q_w, *args, **kwargs)

        ops._d2s_op, quant.conv_int8_fused = d2s_seen, int8_seen
        return self

    def __exit__(self, *exc):
        from sr_torch import quant
        from sr_torch.kernels import ops

        ops._d2s_op, quant.conv_int8_fused = self._d2s, self._int8


def _zero_counts() -> dict:
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.kernels.fused_resblock import fused_resblock
    from sr_torch.kernels.int8_conv import conv_int8_fused, conv_int8_im2col

    fns = {"depth_to_space": depth_to_space, "fused_resblock": fused_resblock,
           "int8_conv": conv_int8_fused,
           "int8_conv raw entry": conv_int8_im2col}
    for fn in fns.values():
        fn.launches = 0
    return fns


def _pre_train(card: str, name: str, images):
    """(b) ``name`` trains with the bench's recipe on the synthetic corpus's
    first plane (bf16, crop 64, b32, the model's own optimizer): the f32
    step card vs CPU on two samples at step K (DRCN's α about 0.5), then
    the train path with its counts
    zeroed just before and read just after (cuDNN convs only: no kernel of
    the port may run): 3 single steps (VDSR prints its clip scale) and two
    K-step dispatches (DRCN prints α at each), after which the loss on a
    fixed probe batch, at the run's last schedule step, must have fallen
    (each dispatch's mean loss is printed too: DRCN's Adam at 1e-4 moves
    it less than the spread between batches), and a checkpoint that
    restores exactly. Returns the trainer and state."""
    import tempfile

    from sr_torch.data.pipeline import PatchPipeline
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.checkpoint import Checkpointer, run_meta
    from sr_torch.utils.config import SRConfig

    k = PRE_K[name]
    cfg = SRConfig(model_name=name, num_channels=1, scale_factor=4,
                   crop_size=TRAIN_CROP, batch_size=TRAIN_BATCH,
                   dtype="bfloat16", num_epochs=1, steps_per_epoch=2 * k + 3)
    pipe = PatchPipeline(images, crop_size=TRAIN_CROP, scale_factor=4,
                         batch_size=TRAIN_BATCH, channels=1,
                         pre_upsample=True)
    batch = pipe(torch.Generator(device="cuda").manual_seed(9))
    # mid-run, where DRCN's α < 1 sends gradient to the recursion weights
    _step_card_vs_cpu(cfg, {key: v[:2] for key, v in batch.items()},
                      tag="[10]", step=k)
    tr = Trainer(cfg)
    state = tr.init_state(1)
    multi = tr.make_multi_step(pipe, k)
    probe = pipe(torch.Generator(device="cuda").manual_seed(11))

    def probe_loss() -> float:
        state.model.train()  # DRCN's training output feeds its loss
        with torch.no_grad():
            return float(tr.loss_fn(state.model, probe, 2 * k + 3)[0])

    before = probe_loss()
    print(f"[10] {name} x4 train: {tr.num_params(state)} params, bf16, crop "
          f"{TRAIN_CROP} b{TRAIN_BATCH}, {type(state.optimizer).__name__} "
          f"{tr.cfg.effective_lr:g}, input 'bc' {tuple(batch['bc'].shape)}")

    # ---- the train path: counts zeroed just before, read just after ----
    fns = _zero_counts()
    firsts = [tr.train_step(state, pipe(state.generator))[1]
              for _ in range(3)]
    if name == "VDSR":
        print(f"[10] VDSR clip scale of steps 1-3 (θ/lr = "
              f"{cfg.vdsr_clip_theta / tr.cfg.effective_lr:g} over the "
              f"gradient norm, at most 1): "
              f"{[round(float(m['clip_scale']), 6) for m in firsts]}")
    losses, times = [], []
    for _ in range(2):
        alpha = tr.spec.schedule(cfg, state.step).get("alpha")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        m = multi(state)
        end.record()
        end.synchronize()
        losses.append(float(m["loss"]))
        times.append(start.elapsed_time(end))
        extra = "" if alpha is None else f", alpha at its start {alpha:.4f}"
        extra += ("" if "clip_scale" not in m
                  else f", mean clip scale {float(m['clip_scale']):.4f}")
        print(f"[10] {name} K={k} dispatch at step {state.step - k}: "
              f"{times[-1]:.1f} ms ({k / times[-1] * 1e3:.1f} steps/s, one "
              f"dispatch, not a marginal), mean loss {losses[-1]:.6f}"
              f"{extra} | {card}")
    launches = {n: fn.launches for n, fn in fns.items()}
    check(all(v == 0 for v in launches.values()),
          f"the {name} train path launched a port kernel: {launches}")
    after = probe_loss()
    print(f"[10] {name} probe-batch loss {before:.6f} before training, "
          f"{after:.6f} after {state.step} steps")
    check(after < before, f"the {name} loss did not fall")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix=f"{name.lower()}_ckpt_", dir=out_dir)
    ckpt = Checkpointer(ckpt_dir, meta=run_meta(cfg))
    ckpt.save(state)
    restored = ckpt.restore(tr.init_state(99))
    check(restored.step == state.step == 2 * k + 3 and all(
        torch.equal(p, q) for p, q in zip(restored.model.parameters(),
                                          state.model.parameters()))
          and torch.equal(restored.generator.get_state(),
                          state.generator.get_state()),
          f"the {name} checkpoint did not restore the trained state")
    shutil.rmtree(ckpt_dir)
    return tr, state


def _pre_serve(card: str, name: str, state, shapes: _Tally) -> None:
    """(c) The trained params, saved in the JAX package's .npz format,
    served through ``upscale`` on RGB images (the net on the ×4 bicubic
    upscale of Y; one image in halo tiles) in bf16, f32, int8 static and
    dynamic, and through one HTTP POST, the counts zeroed just before and
    read just after (the int8 sites tallied by shape into ``shapes``);
    then per-forward launches, f32 card vs CPU, tiled vs whole, a YCbCr
    image's chroma and int8 against f32 interiors."""
    from PIL import Image

    from sr_torch.data.native import resize_bicubic_u8
    from sr_torch.eval.tiling import RECEPTIVE_FIELD
    from sr_torch.infer import upscale
    from sr_torch.serve import SRService, serve_background
    from sr_torch.utils.checkpoint import save_params
    from sr_torch.utils.interop import to_jax_params
    from sr_torch.utils.precision import no_tf32

    path = str(ROOT / "build" / "chip_smoke" / f"{name}_x4_trained.npz")
    save_params(path, to_jax_params(state.model))
    rng = np.random.default_rng(10)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in PRE_IMAGES]

    # ---- the serving path: counts zeroed just before, read just after --
    fns = _zero_counts()
    outs = {}
    with shapes:
        for dtype, quantize in ESPCN_SERVE:
            for img in imgs:
                t0 = time.perf_counter()
                out = upscale(img, name, path, dtype=dtype,
                              quantize=quantize, fused=True)
                ms = (time.perf_counter() - t0) * 1e3
                h, w = img.shape[:2]
                check(out.shape == (4 * h, 4 * w, 3)
                      and out.dtype == np.uint8,
                      f"{name} upscale output {out.shape} {out.dtype}")
                outs[dtype, quantize, img.shape] = out
                print(f"[10] upscale {name} {h}x{w} RGB {dtype} int8 "
                      f"{quantize}: {out.shape} uint8 in {ms:.1f} ms (host "
                      "clock, first call loads/calibrates)")
        service = SRService(model_name=name, params=path, scale_factor=4)
        httpd, port = serve_background(service)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/upscale", body=_png(imgs[0]),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        httpd.shutdown()
        httpd.server_close()
    launches = {n: fn.launches for n, fn in fns.items()}
    check(resp.status == 200, f"POST /upscale {name}: {resp.status}")
    check(np.array_equal(np.asarray(Image.open(io.BytesIO(body))),
                         outs["bfloat16", False, imgs[0].shape]),
          f"the served {name} PNG differs from a direct upscale")
    print(f"[10] {name} serving-path launches: {launches}")
    check(launches["int8_conv"] > 0 and launches["depth_to_space"] == 0
          and launches["fused_resblock"] == 0
          and launches["int8_conv raw entry"] == 0,
          f"the {name} serving path must run its int8 convs through the "
          "fused int8 kernel and no shuffle or resblock")
    ycc = rng.integers(0, 256, (13, 11, 3), dtype=np.uint8)
    got = upscale(ycc, name, path, color_space="ycbcr", fused=True)
    check(np.array_equal(got[..., 1:], resize_bicubic_u8(ycc, (52, 44))
                         [..., 1:]),
          f"the {name} YCbCr output's chroma is not the bicubic upscale's")

    # ---- per-forward counts (the loaded functions are cached) ----
    fns = _zero_counts()
    for dtype, quantize in ESPCN_SERVE:
        before = {n: fn.launches for n, fn in fns.items()}
        upscale(imgs[0], name, path, dtype=dtype, quantize=quantize,
                fused=True)
        got = {n: fn.launches - before[n] for n, fn in fns.items()}
        want = {"depth_to_space": 0, "fused_resblock": 0,
                "int8_conv": PRE_PER_FWD[name] if quantize else 0,
                "int8_conv raw entry": 0}
        print(f"[10] one {name} {dtype} int8 {quantize} forward: {got}")
        check(got == want, f"unexpected {name} launches per forward")

    # ---- f32: card vs CPU (TF32 off) on the whole image; tiled vs whole
    with no_tf32():
        card_out = upscale(imgs[0], name, path, dtype="float32", fused=True)
        whole = upscale(imgs[1], name, path, dtype="float32", fused=True,
                        tile=None)
    cpu_out = upscale(imgs[0], name, path, dtype="float32", fused=True,
                      device="cpu")
    d = np.abs(card_out.astype(np.int32) - cpu_out)
    dt = np.abs(whole.astype(np.int32)
                - outs["float32", False, imgs[1].shape])
    print(f"[10] {name} f32 upscale {imgs[0].shape[:2]}, card vs CPU: max "
          f"{d.max()} u8 levels, mean {d.mean():.5f} (tol 1); "
          f"{imgs[1].shape[:2]} in halo tiles vs whole on the card: max "
          f"{dt.max()} (tol 1)")
    check(d.max() <= 1 and dt.max() <= 1,
          f"the {name} f32 upscale differs card vs CPU or tiled vs whole")

    # ---- int8 against f32, interiors (the receptive field, HR px) ----
    m = RECEPTIVE_FIELD[name.lower()]
    for quantize in ("static", "dynamic"):
        for img in imgs:
            a = outs["bfloat16", quantize, img.shape].astype(np.int32)
            b = outs["float32", False, img.shape].astype(np.int32)
            d = np.abs(a - b)[m:-m, m:-m]
            print(f"[10] {name} int8 {quantize} vs f32 interior "
                  f"{img.shape[:2]}: max {d.max()} u8 levels, mean "
                  f"{d.mean():.4f} (tol mean 4)")
            check(d.mean() <= 4, f"{name} int8 interior too far from f32")


def _pre_eval(card: str, name: str, tr, state, sets) -> None:
    """(d) The trained model through ``evaluate(pre_upsample=True)`` on the
    synthetic set and 8 procedural 384² images (YCbCr), host and device
    metrics, the counts zeroed just before and read just after (no kernel
    of the port runs in these models' float forward); device metrics
    within 1e-4 dB and 1e-5 SSIM of the host's; images/s by CUDA
    events."""
    predict = functools.partial(tr.make_predict_fn(), state.model)
    kw = dict(scale_factor=4, channels=1, color_space="ycbcr",
              pre_upsample=True)
    for _, ds in sets:  # warm-up: cuDNN's plans at each shape
        _timed_eval(predict, ds, on_device_metrics=True, **kw)
    fns = _zero_counts()
    runs = {(set_name, on_dev): _timed_eval(predict, ds,
                                            on_device_metrics=on_dev, **kw)
            for set_name, ds in sets for on_dev in (False, True)}
    launches = {n: fn.launches for n, fn in fns.items()}
    check(all(v == 0 for v in launches.values()),
          f"the {name} eval path launched a port kernel: {launches}")
    for set_name, _ in sets:
        host, dev = runs[set_name, False][0], runs[set_name, True][0]
        _check_eval(host, f"{name} {set_name}")
        _check_eval(dev, f"{name} {set_name}")
        pairs = list(zip(host.images, dev.images))
        dp = max(abs(a.psnr_sr - b.psnr_sr) for a, b in pairs)
        dss = max(abs(a.ssim_sr - b.ssim_sr) for a, b in pairs)
        print(f"[10] {name} eval {set_name} (Y): host vs device metrics, "
              f"PSNR max diff {dp:.3g} dB (tol 1e-4), SSIM {dss:.3g} (tol "
              f"1e-5); model {host.avg_psnr_sr:.4f} dB, bicubic "
              f"{host.avg_psnr_bicubic:.4f} dB")
        check(dp <= 1e-4 and dss <= 1e-5,
              f"{name} {set_name}: device metrics differ from the host's")
        for on_dev in (False, True):
            res, ms, pred_ms, _ = runs[set_name, on_dev]
            n = len(res.images)
            print(f"[10] {name} eval {set_name}, "
                  f"{'device' if on_dev else 'host'} metrics: "
                  f"{n / ms * 1e3:.2f} images/s, {ms / n:.3f} ms/image (CUDA "
                  f"events), predict {pred_ms / n:.3f} ms/image "
                  f"({100 * pred_ms / ms:.1f}% of the span) | {card}")


def phase_preupsample(card: str) -> list[dict]:
    """Phase 10: SRCNN, VDSR and DRCN ×4 on Y at full width (SRCNN 9-5-5
    64/32, VDSR 20 × 64 without biases, DRCN 64 filters × 16 recursions).
    (a) the fused int8 entry at every int8 site shape ``upscale`` gives
    each net for (c)'s two images, exact against its plain version and
    timed (library time: cuDNN's bf16 conv at the shape); then per model
    (b) training, (c) serving and (d) eval through the port's entry
    points, each path with its own zeroed counts. Returns the kernel rows,
    each with the launches of its shape on its model's serving path."""
    from sr_torch.data.datasets import SyntheticDataset, get_test_set
    from sr_torch.data.procedural import ProceduralDataset

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    for name, sites in PRE_INT8.items():
        for h, w in PRE_IMAGES:
            shape = _pre_forward_shape(name, (h, w))
            for site, c, n, k in sites:
                row = _int8_row(card, gen, f"{name} {site}", (*shape, c), n,
                                k, tag="[10]")
                row.update(path=f"{name} int8 serving, {site}, {h}x{w} "
                                "image", model=name,
                           library_ms=row["cudnn_bf16_ms"],
                           library="cuDNN bf16 conv")
                rows.append(row)
        torch.cuda.empty_cache()
    print(f"[10] kernel rows: {time.perf_counter() - t0:.1f} s")
    ds = SyntheticDataset(num_images=32, size=(160, 160), channels=3,
                          seed=100)
    images = [ds[i][..., :1] for i in range(len(ds))]
    sets = (("synthetic",
             get_test_set(str(ROOT / "build" / "chip_smoke"), "synthetic")),
            ("procedural", ProceduralDataset(
                num_images=8, size=(384, 384), split="test",
                color_space="ycbcr")))
    for _, test_set in sets:
        for i in range(len(test_set)):
            test_set[i]
    shapes = {}
    for name in PRE_INT8:
        t1 = time.perf_counter()
        tr, state = _pre_train(card, name, images)
        shapes[name] = _Tally()
        _pre_serve(card, name, state, shapes[name])
        _pre_eval(card, name, tr, state, sets)
        del tr, state
        torch.cuda.empty_cache()
        print(f"[10] {name} seconds {time.perf_counter() - t1:.1f}")
    for row in rows:
        row["launches"] = shapes[row.pop("model")].int8[tuple(row["shape"])]
    check(all(row["launches"] > 0 for row in rows),
          "a pre-upsample kernel row's shape was not launched on its path: "
          f"{[(r['name'], r['shape'], r['launches']) for r in rows]}")
    print(f"[10] phase seconds {time.perf_counter() - t0:.1f}")
    return rows


# ----------------------------------------------------------------------
# phase 11: SRResNet and SRGAN ×4
# ----------------------------------------------------------------------

#: SRResNet ×4 at full width (16 × 64, 9×9 head and out conv, RGB): the
#: images served in (d), (H, W); the first runs whole, the second in 4 halo
#: windows of 344×300 (upscale's tile 256, halo 44)
SR_IMAGES = ((96, 80), (360, 300))
#: the int8 sites a forward by kind: (name, C, N, k, the site's size over
#: the LR input's, sites a forward); the folded int8 tail runs the folded
#: out conv, the exact graphs (static exact, dynamic) the 9×9 one
SR_INT8 = (("head", 3, 64, 9, 1, 1), ("body", 64, 64, 3, 1, 33),
           ("stage 1", 64, 256, 3, 1, 1), ("stage 2", 64, 256, 3, 2, 1),
           ("folded out conv", 256, 12, 5, 2, 1),
           ("exact out conv", 64, 3, 9, 4, 1))
#: the shuffles a serving forward runs, by route: (name, C·r², size over
#: the LR input's, dtype, with the PS conv's or the folded conv's bias)
SR_D2S = (("stage 1 (float routes)", 256, 1, torch.bfloat16, True),
          ("stage 2 (exact route)", 256, 2, torch.bfloat16, True),
          ("folded tail (folded route)", 12, 2, torch.bfloat16, True),
          ("stage 1 (int8 routes)", 256, 1, torch.float32, False),
          ("stage 2 (int8 exact routes)", 256, 2, torch.float32, False),
          ("folded tail (int8 static fused, u8 out)", 12, 2, torch.uint8,
           False))
#: serving routes (name, dtype, fused, quantize), all through upscale
SR_ROUTES = (("exact", "bfloat16", False, False),
             ("folded", "bfloat16", True, False),
             ("int8 static fused", "bfloat16", True, "static"),
             ("int8 static exact", "bfloat16", False, "static"),
             ("int8 dynamic", "bfloat16", False, "dynamic"))
#: per forward: (shuffles, fused int8 launches) by route
SR_PER_FWD = {"exact": (2, 0), "folded": (2, 0), "int8 static fused": (2, 37),
              "int8 static exact": (2, 37), "int8 dynamic": (2, 37)}
SR_K = 40  # SRResNet steps a dispatch
GAN_K = 10  # SRGAN steps a dispatch (each step: D and G updates)


def _sr_forward_shape(hw) -> tuple:
    """The (B, H, W) batch that ``upscale`` hands SRResNet's net for an RGB
    image of ``hw``: whole, or its halo tiles in one call."""
    from sr_torch.eval.tiling import RECEPTIVE_FIELD, tiled_predict

    seen = []

    def record(t):
        seen.append(tuple(t.shape[:3]))
        return t.new_zeros((t.shape[0], 4 * t.shape[1], 4 * t.shape[2], 3))

    tiled_predict(record, torch.zeros((1, *hw, 3)), 4, tile=256,
                  halo=RECEPTIVE_FIELD["srresnet"])
    check(len(seen) == 1, f"SRResNet serving of {hw} takes {len(seen)} calls")
    return seen[0]


def _sr_int8_row(card: str, gen, name: str, shape, n: int, k: int) -> dict:
    """The fused int8 entry at one SRResNet site's shape: bit for bit
    against its plain version (per-sample and per-channel scales,
    :func:`_int8_exact`), its time, the plain version's and cuDNN's bf16
    conv (the library time) beside the bound. Returns the kernels-line
    row."""
    from sr_torch.kernels.int8_conv import (
        conv_int8_fused, conv_int8_fused_plain)

    b, h, w, c = shape
    (x, q_w, packed, scale, dequant, bias, q_x), err = _int8_exact(
        gen, name, shape, n, k)
    del q_x
    t_k = kernel_ms(lambda: conv_int8_fused(x, q_w, scale, dequant, bias,
                                            packed=packed))
    # the plain version runs an exact float64 conv: up to 0.5 s a call at
    # the tiled image's 9×9 out conv, so fewer calls
    t_p = kernel_ms(lambda: conv_int8_fused_plain(x, q_w, scale, dequant,
                                                  bias), n=2, reps=2,
                    warmup=1)
    xb = x.permute(0, 3, 1, 2).bfloat16()
    kb = q_w.permute(3, 2, 0, 1).bfloat16().contiguous(
        memory_format=torch.channels_last)
    t_c = kernel_ms(lambda: F.conv2d(xb, kb, padding=k // 2))
    del xb, x
    ops = 2 * b * h * w * k * k * c * n
    t_ops = ops / PEAK_FLOPS[torch.int8] * 1e3
    nbytes = 4 * b * h * w * c + k * k * c * n + 4 * b * h * w * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                      else "bytes")
    print(f"[11] int8_conv SRResNet {name} {(b, h, w, c)}->{n} k={k}: fused "
          f"kernel {t_k:.4f} ms (bound {bound:.4f} ms, {by}; ops "
          f"{t_ops:.4f}, bytes {t_bytes:.4f}), plain {t_p:.4f} ms, cuDNN "
          f"bf16 conv {t_c:.4f} ms; == plain | {card}")
    return dict(
        name="int8_conv", route="cuda",
        source="sr_torch/kernels/csrc/int8_conv.cu",
        replaces="sr/kernels/int8_conv.py:75", launches=None,
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bound, bound_by=by,
        library_ms=t_c, library="cuDNN bf16 conv", shape=[b, h, w, c, n, k],
        dtype="f32 -> int8 -> f32 (fused entry)",
        path=f"SRResNet int8 serving, {name}")


def _sr_kernel_rows(card: str) -> list[dict]:
    """(a) Both kernels at every SRResNet serving shape of the two images
    (the shuffle by route and dtype, the int8 entry by site), exact against
    their plain versions and timed; launches are filled in from (d)'s
    tallies."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for hw in SR_IMAGES:
        b, h, w = _sr_forward_shape(hw)
        for name, cin, f, dtype, with_bias in SR_D2S:
            shape = (b, f * h, f * w, cin)
            row = _d2s_row(card, gen, shape, 2, dtype, tag="[11]",
                           path=f"SRResNet serving, {name}, {hw[0]}x{hw[1]} "
                                "image")
            row["with_bias_on_path"] = with_bias
            rows.append(row)
        for name, c, n, k, f, _ in SR_INT8:
            rows.append(_sr_int8_row(card, gen, f"{name}, {hw[0]}x{hw[1]} "
                                     "image", (b, f * h, f * w, c), n, k))
        torch.cuda.empty_cache()
    # the two out convs at the throughput batch, b16 128² -> 512²
    for name, shape, n, k in (("folded out conv, b16", (16, 256, 256, 256),
                               12, 5),
                              ("exact out conv, b16", (16, 512, 512, 64), 3,
                               9)):
        rows.append(_sr_int8_row(card, gen, name, shape, n, k))
        torch.cuda.empty_cache()
    return rows


def _sr_step_card_vs_cpu(cfg, batch) -> None:
    """One f32 SRResNet train step on the card (TF32 off) against the CPU's
    from the same weights and batch: the loss within 1e-5 relative; every
    gradient within 1e-3 of its largest entry (float32 summation order),
    except the conv biases a train-mode BN follows, whose gradient is zero
    up to rounding (both below 1e-3 of the step's largest gradient); every
    running statistic within 1e-4; the Adam update of every parameter
    entry whose CPU gradient exceeds 1e-2 of its tensor's largest (the
    gradient check's noise ×10; the pre-BN biases aside) has the CPU's
    sign and lies within 1e-2·lr of the CPU's. Adam's first update is
    about ±lr whatever the gradient's size, so a bound on the parameters
    alone could not fail; a flipped sign moves the update by 2·lr."""
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.precision import no_tf32

    cfg32 = cfg.replace(dtype="float32")
    out = []
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg32, device=device)
        st = tr.init_state(5)
        b = {k: v.to(device) for k, v in batch.items()}
        p0 = {n: p.detach().float().cpu().clone() for n, p in
              st.model.named_parameters()}
        with no_tf32():
            _, m = tr.train_step(st, b)
        out.append((float(m["loss"]),
                    {n: t.float().cpu() for n, t in
                     st.model.state_dict().items()},
                    {n: p.grad.float().cpu() for n, p in
                     st.model.named_parameters()},
                    {n: p.detach().float().cpu() - p0[n] for n, p in
                     st.model.named_parameters()}))
    (l_card, sd_card, g_card, u_card), (l_cpu, sd_cpu, g_cpu, u_cpu) = out
    lr = cfg.effective_lr
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst_g, worst_noise = (0.0, ""), (0.0, "")
    for n, g in g_cpu.items():
        if _pre_bn_bias(n):
            worst_noise = max(worst_noise, (max(float(g.abs().max()), float(
                g_card[n].abs().max())) / top, n))
        else:
            worst_g = max(worst_g, (float((g_card[n] - g).abs().max()
                                          / g.abs().max()), n))
    worst_s = max((float((sd_card[n] - t).abs().max()), n)
                  for n, t in sd_cpu.items() if n.endswith((".mean", ".var")))
    flips, worst_u, held, total = 0, (0.0, ""), 0, 0
    for n, g in g_cpu.items():
        total += g.numel()
        if _pre_bn_bias(n):
            continue
        sure = g.abs() > 1e-2 * g.abs().max()
        if not sure.any():
            continue
        held += int(sure.sum())
        flips += int((torch.sign(u_card[n]) != torch.sign(u_cpu[n]))[
            sure].sum())
        worst_u = max(worst_u, (float((u_card[n] - u_cpu[n])[sure].abs()
                                      .max()) / lr, n))
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    print(f"[11] f32 SRResNet train step, card vs CPU (TF32 off): loss "
          f"{l_card:.6f} vs {l_cpu:.6f} (rel {loss_err:.2e}, tol 1e-5); "
          f"worst gradient {worst_g} (tol 1e-3), pre-BN bias gradients "
          f"{worst_noise} of the largest (tol 1e-3), running statistics "
          f"{worst_s} (tol 1e-4); Adam updates of {held} of {total} "
          f"entries: {flips} signs differ (tol 0), worst {worst_u} of lr "
          f"(tol 1e-2)")
    check(loss_err <= 1e-5 and worst_g[0] <= 1e-3 and worst_noise[0] <= 1e-3
          and worst_s[0] <= 1e-4 and flips == 0 and worst_u[0] <= 1e-2
          and held > total // 2,
          "the card's f32 SRResNet step differs from the CPU's")


def _pre_bn_bias(name: str) -> bool:
    """An SRResNet conv bias that a batch norm follows (each block's two
    convs, the body conv): in train mode the norm subtracts the batch
    mean, so its gradient is zero up to rounding."""
    return name == "body_conv.bias" or (
        name.startswith("blocks.")
        and name.endswith(("Conv_0.bias", "Conv_1.bias")))


def _same_train_state(a, b) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    return (a.step == b.step and all(torch.equal(sa[n], sb[n]) for n in sa)
            and all(torch.equal(oa[i][k], ob[i][k]) for i in oa
                    for k in oa[i])
            and (a.generator is None or torch.equal(
                a.generator.get_state(), b.generator.get_state())))


def _sr_train(card: str, pipe, tally: _Tally):
    """(b) SRResNet ×4 trains with the bench's EDSR recipe shape (bf16, crop
    64, b32, the synthetic corpus in a 'matrix' PatchPipeline): the f32
    step card vs CPU (params and batch statistics), then the train path
    with its counts zeroed just before and read just after: two K=40
    dispatches, after which a fixed probe batch's loss (train-mode forward,
    running statistics untouched) must have fallen, 2 shuffles a step and
    no resblock kernel; a checkpoint that restores exactly. Returns the
    trainer and state."""
    import tempfile

    from sr_torch.nn.blocks import frozen_batch_stats
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.checkpoint import Checkpointer, run_meta
    from sr_torch.utils.config import SRConfig

    cfg = SRConfig(model_name="SRResNet", num_channels=3, scale_factor=4,
                   crop_size=TRAIN_CROP, batch_size=TRAIN_BATCH,
                   dtype="bfloat16")
    batch = pipe(torch.Generator(device="cuda").manual_seed(9))
    _sr_step_card_vs_cpu(cfg, {k: v[:2] for k, v in batch.items()})
    tr = Trainer(cfg)
    state = tr.init_state(1)
    multi = tr.make_multi_step(pipe, SR_K)
    probe = pipe(torch.Generator(device="cuda").manual_seed(11))

    def probe_loss() -> float:
        state.model.train()
        with torch.no_grad(), frozen_batch_stats():
            return float(tr.loss_fn(state.model, probe, 0)[0])

    before = probe_loss()
    print(f"[11] SRResNet x4 train: {tr.num_params(state)} params, bf16, "
          f"crop {TRAIN_CROP} b{TRAIN_BATCH}, MSE, Adam "
          f"{tr.cfg.effective_lr:g}, PatchPipeline '{pipe.random_scale_mode}'"
          f" on {pipe.bank.device}")

    # ---- the train path: counts zeroed just before, read just after ----
    fns = _zero_counts()
    times, losses = [], []
    with tally:
        for _ in range(2):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            m = multi(state)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
    launches = {n: fn.launches for n, fn in fns.items()}
    after = probe_loss()
    print(f"[11] SRResNet two K={SR_K} dispatches: {times[0]:.1f} / "
          f"{times[1]:.1f} ms ({SR_K / times[1] * 1e3:.2f} steps/s in the "
          f"second, one dispatch, not a marginal), mean loss {losses[0]:.6f}"
          f" then {losses[1]:.6f}; probe loss {before:.6f} -> {after:.6f}; "
          f"launches {launches} | {card}")
    check(launches == {"depth_to_space": 2 * 2 * SR_K, "fused_resblock": 0,
                       "int8_conv": 0, "int8_conv raw entry": 0},
          "the SRResNet train path must run 2 shuffles a step and no other "
          "kernel")
    check(after < before, "the SRResNet loss did not fall")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="srresnet_ckpt_", dir=out_dir)
    ckpt = Checkpointer(ckpt_dir, meta=run_meta(cfg))
    ckpt.save(state)
    restored = ckpt.restore(tr.init_state(99))
    check(_same_train_state(restored, state)
          and restored.step == 2 * SR_K,
          "the SRResNet checkpoint did not restore the trained state "
          "(params, batch statistics, Adam, step, sampler)")
    print(f"[11] SRResNet checkpoint at step {state.step} restores params, "
          "batch statistics, Adam moments, step and sampler exactly")
    shutil.rmtree(ckpt_dir)
    return tr, state


def _gan_train(card: str, pipe) -> None:
    """(c) SRGAN ×4 at full width (G 16 × 64, D base 64 on the 64² crop,
    VGG19 to relu2_2 from ``scripts/make_synthetic_vgg.py``), bf16, b32:
    an f32 adversarial step card vs CPU (d_loss, g_loss, G on a probe),
    then the train path with its counts zeroed just before and read just
    after: one pretrain dispatch and two adversarial dispatches of K=10
    (finite losses; 2 shuffles a pretrain step, 4 an adversarial one: the
    detached fake and the G update), their steps/s and a profile of one
    adversarial step; a G+D checkpoint that restores exactly."""
    import tempfile

    from sr_torch.train.gan import GANTrainer
    from sr_torch.utils.checkpoint import Checkpointer, run_meta
    from sr_torch.utils.config import SRConfig
    from sr_torch.utils.precision import no_tf32

    out_dir = ROOT / "build" / "chip_smoke"
    vgg_dir = Path(tempfile.mkdtemp(prefix="vgg_", dir=out_dir))
    vgg = vgg_dir / "vgg19_synthetic.pth"
    subprocess.run([sys.executable, str(ROOT / "scripts" /
                                        "make_synthetic_vgg.py"), str(vgg)],
                   check=True, capture_output=True, timeout=300)
    cfg = SRConfig(model_name="SRGAN", num_channels=3, scale_factor=4,
                   crop_size=TRAIN_CROP, batch_size=TRAIN_BATCH,
                   dtype="bfloat16", vgg_weights_path=str(vgg),
                   vgg_output_layer="relu2_2")
    batch = pipe(torch.Generator(device="cuda").manual_seed(12))
    small = {k: v[:2] for k, v in batch.items()}
    probe = batch["lr"][2:4]
    res = []
    for device in ("cuda", "cpu"):
        tr = GANTrainer(cfg.replace(dtype="float32"), device=device)
        g, d = tr.init_states(5)
        with no_tf32():
            _, _, m = tr.adversarial_step(
                g, d, {k: v.to(device) for k, v in small.items()})
            res.append(({k: float(v) for k, v in m.items()},
                        tr.predict(g, probe.to(device)).float().cpu()))
    (m_card, p_card), (m_cpu, p_cpu) = res
    errs = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
            for k in ("d_loss", "g_loss")}
    p_err = float((p_card - p_cpu).abs().max())
    print(f"[11] f32 SRGAN adversarial step, card vs CPU (TF32 off): "
          f"d_loss {m_card['d_loss']:.6f} vs {m_cpu['d_loss']:.6f}, g_loss "
          f"{m_card['g_loss']:.6f} vs {m_cpu['g_loss']:.6f} (rel "
          f"{errs}, tol 1e-4); G on a probe after the step: max |card - "
          f"CPU| {p_err:.2e} (tol 3e-4)")
    check(max(errs.values()) <= 1e-4 and p_err <= 3e-4,
          "the card's f32 SRGAN adversarial step differs from the CPU's")

    tr = GANTrainer(cfg)
    g, d = tr.init_states(1)
    pre = tr.make_multi_step(pipe, GAN_K, "pretrain")
    adv = tr.make_multi_step(pipe, GAN_K, "adversarial")
    print(f"[11] SRGAN x4 train: G {sum(p.numel() for p in g.model.parameters())}"
          f" params, D {sum(p.numel() for p in d.model.parameters())} params,"
          f" VGG19 to relu2_2 (synthetic torchvision weights), bf16, crop "
          f"{TRAIN_CROP} b{TRAIN_BATCH}")

    # ---- the train path: counts zeroed just before, read just after ----
    fns = _zero_counts()
    metrics, times = [], []
    for phase in ("pretrain", "adversarial", "adversarial"):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        m = pre(g) if phase == "pretrain" else adv(g, d)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
        print(f"[11] SRGAN {phase} K={GAN_K} dispatch: {times[-1]:.1f} ms "
              f"({GAN_K / times[-1] * 1e3:.2f} steps/s, one dispatch, not a "
              f"marginal); mean metrics {metrics[-1]} | {card}")
    launches = {n: fn.launches for n, fn in fns.items()}
    print(f"[11] SRGAN train-path launches: {launches}")
    check(all(np.isfinite(list(m.values())).all() for m in metrics),
          "an SRGAN loss is not finite")
    check(launches == {"depth_to_space": 2 * GAN_K + 2 * 4 * GAN_K,
                       "fused_resblock": 0, "int8_conv": 0,
                       "int8_conv raw entry": 0},
          "the SRGAN train path must run 2 shuffles a pretrain step, 4 an "
          "adversarial step, and no other kernel")
    profile_batches(lambda: tr.adversarial_step(g, d, pipe(g.generator)),
                    "SRGAN adversarial step bf16 b32", card, n=3,
                    tag="[11]", unit="step")
    gck = Checkpointer(tempfile.mkdtemp(prefix="srgan_g_", dir=out_dir),
                       meta=run_meta(cfg))
    dck = Checkpointer(tempfile.mkdtemp(prefix="srgan_d_", dir=out_dir))
    gck.save(g)
    dck.save(d, step=g.step)
    g2, d2 = tr.init_states(99)
    g2, d2 = gck.restore(g2), dck.restore(d2)
    check(_same_train_state(g, g2) and _same_train_state(d, d2),
          "the SRGAN G+D checkpoint did not restore both states exactly")
    print(f"[11] SRGAN checkpoint at G step {g.step} (D step {d.step}) "
          "restores G and D exactly")
    for p in (gck.directory, dck.directory, vgg_dir):
        shutil.rmtree(p)


def _sr_serve(card: str, state, tally: _Tally) -> None:
    """(d) The trained SRResNet, saved with its batch statistics in the JAX
    package's .npz format, served through ``upscale`` by every route on
    the two images and through one HTTP POST (int8 static), the counts
    zeroed just before and read just after (tallied by shape into
    ``tally``); per-forward launches by route; f32 card vs CPU and the
    folded route against the exact one within one u8 level; int8 against
    f32 interiors; MP/s by route at b16 128² → 512² (tallied too)."""
    from PIL import Image

    from sr_torch.infer import make_serving_predict, upscale
    from sr_torch.serve import SRService, serve_background
    from sr_torch.utils.checkpoint import save_params
    from sr_torch.utils.interop import to_jax_batch_stats, to_jax_params
    from sr_torch.utils.precision import no_tf32

    path = str(ROOT / "build" / "chip_smoke" / "SRResNet_x4_trained.npz")
    save_params(path, to_jax_params(state.model),
                to_jax_batch_stats(state.model))
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in SR_IMAGES]

    # ---- the serving path: counts zeroed just before, read just after --
    fns = _zero_counts()
    outs = {}
    with tally:
        for name, dtype, fused, quantize in SR_ROUTES:
            for img in imgs:
                t0 = time.perf_counter()
                out = upscale(img, "SRResNet", path, dtype=dtype,
                              fused=fused, quantize=quantize)
                ms = (time.perf_counter() - t0) * 1e3
                h, w = img.shape[:2]
                check(out.shape == (4 * h, 4 * w, 3)
                      and out.dtype == np.uint8,
                      f"SRResNet upscale output {out.shape} {out.dtype}")
                outs[name, img.shape] = out
                print(f"[11] upscale SRResNet {h}x{w} {name} ({dtype}): "
                      f"{out.shape} uint8 in {ms:.1f} ms (host clock, first "
                      "call loads/calibrates)")
        service = SRService(model_name="SRGAN", params=path, scale_factor=4,
                            quantize="static")
        httpd, port = serve_background(service)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/upscale", body=_png(imgs[0]),
                     headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        httpd.shutdown()
        httpd.server_close()
    launches = {n: fn.launches for n, fn in fns.items()}
    check(resp.status == 200, f"POST /upscale SRGAN: {resp.status}")
    check(np.array_equal(np.asarray(Image.open(io.BytesIO(body))),
                         outs["int8 static fused", imgs[0].shape]),
          "the served SRGAN PNG differs from a direct int8 upscale")
    print(f"[11] POST /upscale (SRGAN, int8 static) == direct upscale; "
          f"serving-path launches: {launches}")
    check(launches["depth_to_space"] > 0 and launches["int8_conv"] > 0
          and launches["fused_resblock"] == 0
          and launches["int8_conv raw entry"] == 0,
          "the SRResNet serving path must run its shuffles and int8 convs "
          "through the kernels, and no resblock")

    # ---- per-forward counts (the loaded functions are cached) ----
    fns = _zero_counts()
    for name, dtype, fused, quantize in SR_ROUTES:
        before = {n: fn.launches for n, fn in fns.items()}
        upscale(imgs[0], "SRResNet", path, dtype=dtype, fused=fused,
                quantize=quantize)
        got = {n: fn.launches - before[n] for n, fn in fns.items()}
        d2s, q = SR_PER_FWD[name]
        print(f"[11] one SRResNet {name} forward: {got}")
        check(got == {"depth_to_space": d2s, "fused_resblock": 0,
                      "int8_conv": q, "int8_conv raw entry": 0},
              f"unexpected SRResNet launches per forward ({name})")

    # ---- f32: card vs CPU, folded vs exact (TF32 off) ----
    with no_tf32():
        card_out = upscale(imgs[0], "SRResNet", path, dtype="float32")
        folded = upscale(imgs[0], "SRResNet", path, dtype="float32",
                         fused=True)
    cpu_out = upscale(imgs[0], "SRResNet", path, dtype="float32",
                      device="cpu")
    d = np.abs(card_out.astype(np.int32) - cpu_out)
    df = np.abs(folded.astype(np.int32) - card_out)
    print(f"[11] SRResNet f32 upscale {imgs[0].shape[:2]}: card vs CPU max "
          f"{d.max()} u8 levels, mean {d.mean():.5f} (tol 1); folded vs "
          f"exact on the card max {df.max()}, mean {df.mean():.5f} (tol 1)")
    check(d.max() <= 1 and df.max() <= 1,
          "the SRResNet f32 upscale differs card vs CPU or folded vs exact")

    # ---- int8 against f32, interiors (the 9×9 head's half-width, HR px:
    # the folded tail is exact, so no border band needs more) ----
    m = 4 * 4
    with no_tf32():
        f32 = {img.shape: upscale(img, "SRResNet", path, dtype="float32")
               for img in imgs}
    for name, _, _, quantize in SR_ROUTES:
        if not quantize:
            continue
        for img in imgs:
            a = outs[name, img.shape].astype(np.int32)
            dd = np.abs(a - f32[img.shape])[m:-m, m:-m]
            print(f"[11] SRResNet {name} vs f32 interior {img.shape[:2]}: "
                  f"max {dd.max()} u8 levels, mean {dd.mean():.4f} (tol "
                  "mean 4)")
            check(dd.mean() <= 4, f"SRResNet {name} interior too far from "
                  "f32")

    # ---- throughput by route, b16 128² -> 512² (one event pair a batch) --
    model = state.model.eval()
    x = torch.rand((16, 128, 128, 3), device="cuda")
    mp = 16 * 512 * 512 / 1e6
    with torch.inference_mode(), tally:
        for name, _, fused, quantize in SR_ROUTES:
            fn = make_serving_predict(model, fused, quantize,
                                      calib_headroom=1.25)
            if quantize == "static":
                fn.calibrate([x])
            ms = time_ms(lambda: fn(x), n=10)
            print(f"[11] SRResNet x4 {name} bf16 b16 128->512: {ms:.3f} "
                  f"ms/batch, {mp / ms * 1e3:.1f} MP/s | {card}")
            if name in ("exact", "int8 static fused"):
                profile_batches(lambda: fn(x), f"SRResNet {name}", card,
                                n=3, tag="[11]")


def _sr_eval(card: str, tr, state, sets) -> None:
    """(e) The trained SRResNet through ``evaluate`` and
    ``Trainer.make_predict_fn`` (batch norms in eval mode) on the synthetic
    set and 8 procedural 384² images (RGB), host and device metrics, the
    counts zeroed just before and read just after (2 shuffles a predict,
    no other kernel); device metrics within 1e-4 dB and 1e-5 SSIM of the
    host's; images/s by CUDA events."""
    predict = functools.partial(tr.make_predict_fn(), state.model)
    kw = dict(scale_factor=4, channels=3, color_space="rgb")
    for _, ds in sets:  # warm-up: cuDNN's plans at each shape
        _timed_eval(predict, ds, on_device_metrics=True, **kw)
    fns = _zero_counts()
    runs = {(set_name, on_dev): _timed_eval(predict, ds,
                                            on_device_metrics=on_dev, **kw)
            for set_name, ds in sets for on_dev in (False, True)}
    launches = {n: fn.launches for n, fn in fns.items()}
    calls = sum(r[3].calls for r in runs.values())
    check(launches == {"depth_to_space": 2 * calls, "fused_resblock": 0,
                       "int8_conv": 0, "int8_conv raw entry": 0},
          f"the SRResNet eval path ran {launches} over {calls} predicts")
    for set_name, _ in sets:
        host, dev = runs[set_name, False][0], runs[set_name, True][0]
        _check_eval(host, f"SRResNet {set_name}")
        _check_eval(dev, f"SRResNet {set_name}")
        pairs = list(zip(host.images, dev.images))
        dp = max(abs(a.psnr_sr - b.psnr_sr) for a, b in pairs)
        dss = max(abs(a.ssim_sr - b.ssim_sr) for a, b in pairs)
        print(f"[11] SRResNet eval {set_name} (RGB): host vs device metrics,"
              f" PSNR max diff {dp:.3g} dB (tol 1e-4), SSIM {dss:.3g} (tol "
              f"1e-5); model {host.avg_psnr_sr:.4f} dB, bicubic "
              f"{host.avg_psnr_bicubic:.4f} dB")
        check(dp <= 1e-4 and dss <= 1e-5,
              f"SRResNet {set_name}: device metrics differ from the host's")
        for on_dev in (False, True):
            res, ms, pred_ms, _ = runs[set_name, on_dev]
            n = len(res.images)
            print(f"[11] SRResNet eval {set_name}, "
                  f"{'device' if on_dev else 'host'} metrics: "
                  f"{n / ms * 1e3:.2f} images/s, {ms / n:.3f} ms/image (CUDA "
                  f"events), predict {pred_ms / n:.3f} ms/image "
                  f"({100 * pred_ms / ms:.1f}% of the span) | {card}")


def phase_srresnet(card: str) -> list[dict]:
    """Phase 11: SRResNet and SRGAN ×4 at full width. (a) both kernels at
    every SRResNet serving shape, exact and timed; (b) SRResNet training,
    (c) SRGAN training in both phases, (d) serving by every route and
    (e) eval, through the port's entry points, each path with its own
    zeroed counts. Returns the kernel rows, each with the launches of its
    shape on its path."""
    from sr_torch.data.datasets import SyntheticDataset, get_test_set
    from sr_torch.data.pipeline import PatchPipeline
    from sr_torch.data.procedural import ProceduralDataset

    t0 = time.perf_counter()
    rows = _sr_kernel_rows(card)
    print(f"[11] kernel rows: {time.perf_counter() - t0:.1f} s")
    ds = SyntheticDataset(num_images=32, size=(160, 160), channels=3,
                          seed=100)
    pipe = PatchPipeline([ds[i] for i in range(len(ds))],
                         crop_size=TRAIN_CROP, scale_factor=4,
                         batch_size=TRAIN_BATCH, channels=3)
    gen = torch.Generator(device="cuda").manual_seed(12)
    train_tally, serve_tally = _Tally(), _Tally()
    train_rows = _train_d2s(card, gen, tag="[11]",
                            path="SRResNet train forward (PS conv bias "
                                 "inside, PReLU after)")
    t1 = time.perf_counter()
    tr, state = _sr_train(card, pipe, train_tally)
    print(f"[11] SRResNet training seconds {time.perf_counter() - t1:.1f}")
    t1 = time.perf_counter()
    _gan_train(card, pipe)
    torch.cuda.empty_cache()
    print(f"[11] SRGAN training seconds {time.perf_counter() - t1:.1f}")
    t1 = time.perf_counter()
    _sr_serve(card, state, serve_tally)
    torch.cuda.empty_cache()
    print(f"[11] serving seconds {time.perf_counter() - t1:.1f}")
    t1 = time.perf_counter()
    sets = (("synthetic",
             get_test_set(str(ROOT / "build" / "chip_smoke"), "synthetic")),
            ("procedural", ProceduralDataset(
                num_images=8, size=(384, 384), split="test",
                color_space="rgb")))
    for _, test_set in sets:
        for i in range(len(test_set)):
            test_set[i]
    _sr_eval(card, tr, state, sets)
    print(f"[11] eval seconds {time.perf_counter() - t1:.1f}")
    for row in train_rows:
        row["launches"] = train_tally.d2s[tuple(row["shape"]),
                                          torch.bfloat16]
    for row in rows:
        if row["name"] == "depth_to_space":
            dtype = getattr(torch, row["dtype"])
            row["launches"] = serve_tally.d2s[tuple(row["shape"]), dtype]
        else:
            row["launches"] = serve_tally.int8[tuple(row["shape"])]
    rows += train_rows
    check(all(row["launches"] > 0 for row in rows),
          "an SRResNet kernel row's shape was not launched on its path: "
          f"{[(r['name'], r['shape'], r['dtype'], r['launches']) for r in rows]}")
    print(f"[11] phase seconds {time.perf_counter() - t0:.1f}")
    return rows


# ----------------------------------------------------------------------
# phase 12: FSRCNN and LapSRN ×4 on Y
# ----------------------------------------------------------------------

#: the Y images served in (b), (H, W): the first whole, the second in halo
#: tiles at upscale's tile 256 (FSRCNN halo 12, LapSRN 32)
LAP_IMAGES = ((96, 80), (360, 300))
#: each model's int8 sites by kind: (name, C, N, k, the site's size over
#: the LR input's, sites a forward, a phase-packed deconv (its stride) or
#: None); the phase sites run only with quantize_deconv
LAP_INT8 = {
    "FSRCNN": (("feature 5x5", 1, 56, 5, 1, 1, None),
               ("shrink 1x1", 56, 12, 1, 1, 1, None),
               ("map 3x3 x4", 12, 12, 3, 1, 4, None),
               ("expand 1x1", 12, 56, 1, 1, 1, None),
               ("deconv 9x9 s4 phase conv", 56, 16, 3, 1, 1, 4)),
    "LapSRN": (("head", 1, 64, 3, 1, 1, None),
               ("level 1 features x5", 64, 64, 3, 1, 5, None),
               ("level 1 residual", 64, 1, 3, 2, 1, None),
               ("level 2 features x5", 64, 64, 3, 2, 5, None),
               ("level 2 residual", 64, 1, 3, 4, 1, None),
               ("level 1 feature deconv phase conv", 64, 256, 3, 1, 1, 2),
               ("level 1 image deconv phase conv", 1, 4, 3, 1, 1, 2),
               ("level 2 feature deconv phase conv", 64, 256, 3, 2, 1, 2),
               ("level 2 image deconv phase conv", 1, 4, 3, 2, 1, 2)),
}
#: the f32 shuffles of the int8 deconvs: (name, C·r², r, size over the LR
#: input's)
LAP_D2S = {"FSRCNN": (("deconv 9x9 s4", 16, 4, 1),),
           "LapSRN": (("level 1 feature deconv", 256, 2, 1),
                      ("level 1 image deconv", 4, 2, 1),
                      ("level 2 feature deconv", 256, 2, 2),
                      ("level 2 image deconv", 4, 2, 2))}
#: the routes served through upscale (name, dtype, quantize); the int8
#: deconv route runs through make_quantized_predict(quantize_deconv=True)
LAP_ROUTES = (("bf16", "bfloat16", False),
              ("f32", "float32", False),
              ("int8 static", "bfloat16", "static"),
              ("int8 dynamic", "bfloat16", "dynamic"))
#: per forward (fused int8 convs, shuffles): default int8, quantize_deconv
LAP_PER_FWD = {"FSRCNN": ((7, 0), (8, 1)), "LapSRN": ((13, 0), (17, 4))}
LAP_K = {"FSRCNN": 100, "LapSRN": 40}  # steps a train dispatch
#: the procedural train split's images used at crop 64 (of the 512 that
#: get_training_set('procedural') generates: about 0.25 s of host work an
#: image, so the run takes the first 32)
LAP_PROCEDURAL = 32


def _lap_forward_shape(name: str, hw) -> tuple:
    """The (B, H, W) batch that ``upscale`` hands ``name``'s net for a Y
    image of ``hw``: whole, or its halo tiles in one call."""
    from sr_torch.eval.tiling import RECEPTIVE_FIELD, tiled_predict

    seen = []

    def record(t):
        seen.append(tuple(t.shape[:3]))
        return t.new_zeros((t.shape[0], 4 * t.shape[1], 4 * t.shape[2], 1))

    tiled_predict(record, torch.zeros((1, *hw, 1)), 4, tile=256,
                  halo=RECEPTIVE_FIELD[name.lower()])
    check(len(seen) == 1, f"{name} serving of {hw} takes {len(seen)} calls")
    return seen[0]


def _lap_int8_row(card: str, gen, model: str, site: str, shape, n: int,
                  k: int, stride) -> dict:
    """The fused int8 entry at one site's shape: bit for bit against its
    plain version (:func:`_int8_exact`), its time, the plain version's and
    the library's (cuDNN's bf16 conv at a conv site; at a phase-packed
    deconv site cuDNN's bf16 ``F.conv_transpose2d`` of the deconv it
    computes, which includes the shuffle), beside the bound: the bytes the
    fused entry moves (f32 in and out, int8 weights) or the deconv's own
    operations (k_d²·C·N_d a pixel, the phase kernel's zero taps left out),
    whichever is larger. Returns the kernels-line row."""
    from sr_torch.kernels.int8_conv import (
        conv_int8_fused, conv_int8_fused_plain)

    b, h, w, c = shape
    (x, q_w, packed, scale, dequant, bias, q_x), err = _int8_exact(
        gen, f"{model} {site}", shape, n, k)
    del q_x
    t_k = kernel_ms(lambda: conv_int8_fused(x, q_w, scale, dequant, bias,
                                            packed=packed))
    big = b * h * w * (c + n) > 2e8
    t_p = kernel_ms(lambda: conv_int8_fused_plain(x, q_w, scale, dequant,
                                                  bias),
                    **(dict(n=2, reps=2, warmup=1) if big else {}))
    xb = x.permute(0, 3, 1, 2).bfloat16()
    if stride is None:
        kb = q_w.permute(3, 2, 0, 1).bfloat16().contiguous(
            memory_format=torch.channels_last)
        t_c = kernel_ms(lambda: F.conv2d(xb, kb, padding=k // 2))
        library, macs = "cuDNN bf16 conv", k * k * c * n
    else:
        from sr_torch.nn.blocks import deconv_padding

        kd = {2: 4, 4: 9}[stride]
        nd = n // (stride * stride)
        p, op = deconv_padding(kd, stride)
        wd = torch.randn((c, nd, kd, kd), device="cuda", generator=gen
                         ).bfloat16()
        t_c = kernel_ms(lambda: F.conv_transpose2d(
            xb, wd, stride=stride, padding=p, output_padding=op))
        library = "cuDNN bf16 conv_transpose2d (the deconv, shuffle included)"
        macs = kd * kd * c * nd
    del xb, x
    ops = 2 * b * h * w * macs
    t_ops = ops / PEAK_FLOPS[torch.int8] * 1e3
    nbytes = 4 * b * h * w * c + k * k * c * n + 4 * b * h * w * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                      else "bytes")
    print(f"[12] int8_conv {model} {site} {(b, h, w, c)}->{n} k={k}: fused "
          f"kernel {t_k:.4f} ms (bound {bound:.4f} ms, {by}; ops "
          f"{t_ops:.4f}, bytes {t_bytes:.4f}), plain {t_p:.4f} ms, "
          f"{library} {t_c:.4f} ms; == plain | {card}")
    return dict(
        name="int8_conv", route="cuda",
        source="sr_torch/kernels/csrc/int8_conv.cu",
        replaces="sr/kernels/int8_conv.py:75", launches=None,
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bound, bound_by=by,
        library_ms=t_c, library=library, shape=[b, h, w, c, n, k],
        dtype="f32 -> int8 -> f32 (fused entry)",
        path=f"{model} int8 serving, {site}")


def _lap_kernel_rows(card: str) -> list[dict]:
    """(a) The fused int8 entry at every int8 site shape and the shuffle at
    every int8-deconv shape that ``upscale`` and the quantize_deconv route
    give FSRCNN and LapSRN for the two images, each exact against its plain
    version and timed; launches are filled in from the serving tallies."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for model in LAP_INT8:
        for hw in LAP_IMAGES:
            b, h, w = _lap_forward_shape(model, hw)
            image = f"{hw[0]}x{hw[1]} image"
            for site, c, n, k, f, _, stride in LAP_INT8[model]:
                row = _lap_int8_row(card, gen, model, f"{site}, {image}",
                                    (b, f * h, f * w, c), n, k, stride)
                row["model"] = model
                rows.append(row)
            for site, cin, r, f in LAP_D2S[model]:
                row = _d2s_row(card, gen, (b, f * h, f * w, cin), r,
                               torch.float32, tag="[12]",
                               path=f"{model} int8 deconv (quantize_deconv),"
                                    f" {site}, {image}")
                row["model"] = model
                rows.append(row)
            torch.cuda.empty_cache()
    return rows


def _lap_step_card_vs_cpu(name: str, cfg, batch) -> None:
    """One f32 step on the card (TF32 off) against the CPU's from the same
    weights and batch: the loss (and LapSRN's level losses) within 1e-5
    relative, every gradient within 1e-3 of its largest entry; every Adam
    update whose CPU gradient exceeds 1e-2 of its tensor's largest keeps
    the CPU's sign and lies within 1e-2·lr of the CPU's update (phase
    11's check); and the group's rate: Adam's first update is
    lr·g/(|g| + 1e-8), so every entry whose gradient is at least 2e-6
    (ε moves it by under 0.5%) moves by lr within 1e-2·lr, lr its group's:
    1e-4 for FSRCNN's deconv tail, 1e-3 for its base."""
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.precision import no_tf32

    cfg32 = cfg.replace(dtype="float32")
    res = []
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg32, device=device)
        st = tr.init_state(5)
        p0 = {n: p.detach().float().cpu().clone()
              for n, p in st.model.named_parameters()}
        with no_tf32():
            _, m = tr.train_step(st, {k: v.to(device)
                                      for k, v in batch.items()})
        res.append(({k: float(v) for k, v in m.items()}, _grads(st.model),
                    {n: p.detach().float().cpu() - p0[n]
                     for n, p in st.model.named_parameters()},
                    {n: g["lr"] for g in st.optimizer.param_groups
                     for n, p in st.model.named_parameters()
                     if any(p is q for q in g["params"])}))
    (m_card, g_card, u_card, lr_of), (m_cpu, g_cpu, u_cpu, _) = res
    loss_err = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    worst_g = max((float((g_card[n] - g).abs().max() / g.abs().max()), n)
                  for n, g in g_cpu.items())
    flips, worst_u, worst_r, held, rated = 0, (0.0, ""), (0.0, ""), 0, 0
    for n, g in g_cpu.items():
        lr = lr_of[n]
        sure = g.abs() > 1e-2 * g.abs().max()
        held += int(sure.sum())
        flips += int((torch.sign(u_card[n]) != torch.sign(u_cpu[n]))[sure]
                     .sum())
        worst_u = max(worst_u, (float((u_card[n] - u_cpu[n])[sure].abs()
                                      .max()) / lr, n))
        big = g.abs() >= 2e-6
        rated += int(big.sum())
        if big.any():
            worst_r = max(worst_r, (float((u_card[n].abs() - lr)[big].abs()
                                          .max()) / lr, n))
    rates = sorted(set(lr_of.values()))
    print(f"[12] f32 {name} train step, card vs CPU (TF32 off): metrics "
          f"{m_card} vs {m_cpu} (worst rel {loss_err:.2e}, tol 1e-5); worst "
          f"gradient {worst_g} (tol 1e-3); first Adam updates: {flips} of "
          f"{held} signs differ (tol 0), worst card vs CPU {worst_u} of lr "
          f"(tol 1e-2); at rates {rates}, {rated} entries with |g| >= 2e-6 "
          f"move by their group's lr within {worst_r} of it (tol 1e-2)")
    check(loss_err <= 1e-5 and worst_g[0] <= 1e-3 and flips == 0
          and worst_u[0] <= 1e-2 and worst_r[0] <= 1e-2 and held > 0
          and rated > 0,
          f"the card's f32 {name} step differs from the CPU's")
    if name == "FSRCNN":
        check(rates == [1e-4, 1e-3] and all(
            lr_of[n] == (1e-4 if n.startswith("DeconvBlock") else 1e-3)
            for n in lr_of), f"FSRCNN's groups train at {lr_of}")


def _lap_train(card: str, name: str, images, proc_images):
    """(c) ``name`` ×4 trains in bf16 at crop 64 b32 from the synthetic
    corpus's Y plane in a 'matrix' PatchPipeline on the card: the f32 step
    card vs CPU, then the train path with its counts zeroed just before and
    read just after (cuDNN only: no port kernel may run): two K-step
    dispatches, after which a fixed probe batch's loss (LapSRN: each
    level's) has fallen; a checkpoint (FSRCNN's two-group Adam) that
    restores exactly; for LapSRN then one K-step dispatch from the
    procedural train split's first 32 images. Returns the trainer and
    state."""
    import tempfile

    from sr_torch.data.pipeline import PatchPipeline
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.checkpoint import Checkpointer, run_meta
    from sr_torch.utils.config import SRConfig

    k = LAP_K[name]
    cfg = SRConfig(model_name=name, num_channels=1, scale_factor=4,
                   crop_size=TRAIN_CROP, batch_size=TRAIN_BATCH,
                   dtype="bfloat16")
    pipe = PatchPipeline(images, crop_size=TRAIN_CROP, scale_factor=4,
                         batch_size=TRAIN_BATCH, channels=1)
    batch = pipe(torch.Generator(device="cuda").manual_seed(9))
    _lap_step_card_vs_cpu(name, cfg, {key: v[:2] for key, v in batch.items()})
    tr = Trainer(cfg)
    state = tr.init_state(1)
    multi = tr.make_multi_step(pipe, k)
    probe = pipe(torch.Generator(device="cuda").manual_seed(11))

    def probe_losses() -> dict:
        state.model.train()  # LapSRN's levels feed its loss
        with torch.no_grad():
            loss, m = tr.loss_fn(state.model, probe, 0)
        return {"loss": float(loss), **{n: float(v) for n, v in m.items()}}

    before = probe_losses()
    print(f"[12] {name} x4 train: {tr.num_params(state)} params, bf16, crop "
          f"{TRAIN_CROP} b{TRAIN_BATCH}, Adam {tr.cfg.effective_lr:g} "
          f"(groups {[(g.get('group'), g['lr']) for g in state.optimizer.param_groups]})")

    # ---- the train path: counts zeroed just before, read just after ----
    fns = _zero_counts()
    times, metrics = [], []
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        m = multi(state)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        metrics.append({n: round(float(v), 6) for n, v in m.items()})
    launches = {n: fn.launches for n, fn in fns.items()}
    after = probe_losses()
    print(f"[12] {name} two K={k} dispatches: {times[0]:.1f} / {times[1]:.1f}"
          f" ms ({k / times[1] * 1e3:.1f} steps/s in the second, one "
          f"dispatch, not a marginal), mean metrics {metrics[0]} then "
          f"{metrics[1]}; probe {before} -> {after}; launches {launches} "
          f"| {card}")
    check(all(v == 0 for v in launches.values()),
          f"the {name} train path launched a port kernel: {launches}")
    check(all(after[n] < before[n] for n in before)
          and (name != "LapSRN" or {"loss_x2", "loss_x4"} <= set(after)),
          f"a {name} loss did not fall: {before} -> {after}")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix=f"{name.lower()}_ckpt_", dir=out_dir)
    ckpt = Checkpointer(ckpt_dir, meta=run_meta(cfg))
    ckpt.save(state)
    restored = ckpt.restore(tr.init_state(99))
    check(_same_train_state(restored, state) and restored.step == 2 * k
          and [g["lr"] for g in restored.optimizer.param_groups]
          == [g["lr"] for g in state.optimizer.param_groups],
          f"the {name} checkpoint did not restore the trained state")
    print(f"[12] {name} checkpoint at step {state.step} restores params, "
          f"Adam ({len(state.optimizer.param_groups)} groups), step and "
          "sampler exactly")
    shutil.rmtree(ckpt_dir)
    if proc_images is not None:
        ppipe = PatchPipeline(proc_images, crop_size=TRAIN_CROP,
                              scale_factor=4, batch_size=TRAIN_BATCH,
                              channels=1)
        fns = _zero_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        m = tr.make_multi_step(ppipe, k)(state)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        launches = {n: fn.launches for n, fn in fns.items()}
        vals = {n: float(v) for n, v in m.items()}
        print(f"[12] {name} K={k} dispatch on the procedural train split "
              f"({len(proc_images)} of its 512 384² images, Y): {ms:.1f} ms "
              f"({k / ms * 1e3:.1f} steps/s), mean metrics {vals}; launches "
              f"{launches} | {card}")
        check(all(np.isfinite(list(vals.values())))
              and all(v == 0 for v in launches.values()),
              f"the {name} procedural dispatch failed: {vals} {launches}")
    return tr, state


def _lap_serve(card: str, name: str, state, tally: _Tally) -> None:
    """(b) The trained params, saved in the JAX package's .npz format,
    served through ``upscale`` on RGB images (Y through the net, bicubic
    chroma; one image in halo tiles) by the float and int8 routes, with
    the counts zeroed just before and read just after (tallied by shape);
    then per-forward launches, f32 card vs CPU, tiled vs whole, a YCbCr
    image's chroma, int8 against f32 interiors; the int8 deconv route
    (``make_quantized_predict(quantize_deconv=True)``, static and dynamic)
    on the same images, tallied, with its launches a forward and the card
    against the CPU bit for bit (static with one scales dict, as phase
    4)."""
    import copy

    from sr_torch.data.native import resize_bicubic_u8
    from sr_torch.eval.metrics import rgb_to_ycbcr
    from sr_torch.eval.tiling import RECEPTIVE_FIELD, tiled_predict
    from sr_torch.infer import upscale
    from sr_torch.quant import (
        calibrate_scales, make_quantized_predict, quantized_apply)
    from sr_torch.utils.checkpoint import save_params
    from sr_torch.utils.interop import to_jax_params
    from sr_torch.utils.precision import no_tf32

    path = str(ROOT / "build" / "chip_smoke" / f"{name}_x4_trained.npz")
    save_params(path, to_jax_params(state.model))
    rng = np.random.default_rng(12)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in LAP_IMAGES]

    # ---- the serving path: counts zeroed just before, read just after --
    fns = _zero_counts()
    outs = {}
    with tally:
        for route, dtype, quantize in LAP_ROUTES:
            for img in imgs:
                t0 = time.perf_counter()
                out = upscale(img, name, path, dtype=dtype,
                              quantize=quantize, fused=True)
                ms = (time.perf_counter() - t0) * 1e3
                h, w = img.shape[:2]
                check(out.shape == (4 * h, 4 * w, 3)
                      and out.dtype == np.uint8,
                      f"{name} upscale output {out.shape} {out.dtype}")
                outs[route, img.shape] = out
                print(f"[12] upscale {name} {h}x{w} RGB {route}: "
                      f"{out.shape} uint8 in {ms:.1f} ms (host clock, first "
                      "call loads/calibrates)")
    launches = {n: fn.launches for n, fn in fns.items()}
    print(f"[12] {name} serving-path launches: {launches}")
    check(launches["int8_conv"] > 0 and launches["depth_to_space"] == 0
          and launches["fused_resblock"] == 0
          and launches["int8_conv raw entry"] == 0,
          f"the {name} serving path must run its int8 convs through the "
          "fused int8 kernel and no shuffle or resblock")
    ycc = rng.integers(0, 256, (13, 11, 3), dtype=np.uint8)
    got = upscale(ycc, name, path, color_space="ycbcr", fused=True)
    check(np.array_equal(got[..., 1:], resize_bicubic_u8(ycc, (52, 44))
                         [..., 1:]),
          f"the {name} YCbCr output's chroma is not the bicubic upscale's")

    # ---- per-forward counts (the loaded functions are cached) ----
    fns = _zero_counts()
    for route, dtype, quantize in LAP_ROUTES:
        before = {n: fn.launches for n, fn in fns.items()}
        upscale(imgs[0], name, path, dtype=dtype, quantize=quantize,
                fused=True)
        got = {n: fn.launches - before[n] for n, fn in fns.items()}
        q = LAP_PER_FWD[name][0][0] if quantize else 0
        print(f"[12] one {name} {route} forward: {got}")
        check(got == {"depth_to_space": 0, "fused_resblock": 0,
                      "int8_conv": q, "int8_conv raw entry": 0},
              f"unexpected {name} launches per forward ({route})")

    # ---- f32: card vs CPU (TF32 off) on the whole image; tiled vs whole
    with no_tf32():
        card_out = upscale(imgs[0], name, path, dtype="float32", fused=True)
        whole = upscale(imgs[1], name, path, dtype="float32", fused=True,
                        tile=None)
    cpu_out = upscale(imgs[0], name, path, dtype="float32", fused=True,
                      device="cpu")
    d = np.abs(card_out.astype(np.int32) - cpu_out)
    dt = np.abs(whole.astype(np.int32) - outs["f32", imgs[1].shape])
    print(f"[12] {name} f32 upscale {imgs[0].shape[:2]}, card vs CPU: max "
          f"{d.max()} u8 levels, mean {d.mean():.5f} (tol 1); "
          f"{imgs[1].shape[:2]} in halo tiles vs whole on the card: max "
          f"{dt.max()} (tol 1)")
    check(d.max() <= 1 and dt.max() <= 1,
          f"the {name} f32 upscale differs card vs CPU or tiled vs whole")

    # ---- int8 against f32, interiors (the receptive field, HR px) ----
    m = 4 * RECEPTIVE_FIELD[name.lower()]
    for route in ("int8 static", "int8 dynamic"):
        for img in imgs:
            a = outs[route, img.shape].astype(np.int32)
            b = outs["f32", img.shape].astype(np.int32)
            dd = np.abs(a - b)[m:-m, m:-m]
            print(f"[12] {name} {route} vs f32 interior {img.shape[:2]}: "
                  f"max {dd.max()} u8 levels, mean {dd.mean():.4f} (tol mean "
                  "4)")
            check(dd.mean() <= 4, f"{name} {route} interior too far from "
                  "f32")

    # ---- the int8 deconv route (quantize_deconv) on the images' Y, as
    # upscale cuts them (the second in halo tiles), tallied ----
    yccs = [np.clip(np.round(rgb_to_ycbcr(img.astype(np.float32)).numpy()),
                    0, 255).astype(np.uint8) for img in imgs]
    with no_tf32():
        f32y = [upscale(ycc, name, path, dtype="float32", fused=True,
                        color_space="ycbcr")[..., 0].astype(np.int32)
                for ycc in yccs]
    model = state.model.eval()
    halo = RECEPTIVE_FIELD[name.lower()]
    per = LAP_PER_FWD[name][1]
    for mode in ("static", "dynamic"):
        fn = make_quantized_predict(model, mode, calib_headroom=1.25,
                                    output_u8=True, quantize_deconv=True)
        for ycc, ref in zip(yccs, f32y):
            y = torch.from_numpy(ycc[..., :1].astype(np.float32)[None]
                                 / 255.0).cuda()
            fns = _zero_counts()
            with torch.inference_mode(), tally:
                out = (tiled_predict(fn, y, 4, tile=256, halo=halo)
                       if max(y.shape[1:3]) > 256 else fn(y))
            launches = {n: f.launches for n, f in fns.items()}
            got = out[0, ..., 0].cpu().numpy().astype(np.int32)
            dd = np.abs(got - ref)[m:-m, m:-m]
            print(f"[12] {name} int8 {mode} quantize_deconv "
                  f"{tuple(y.shape[1:3])}: launches {launches}; vs f32 "
                  f"interior mean {dd.mean():.4f}, max {dd.max()} u8 levels "
                  "(tol mean 4)")
            check(got.shape == ref.shape and dd.mean() <= 4,
                  f"{name} int8 deconv route interior too far from f32")
            check(launches["fused_resblock"] == 0
                  and launches["int8_conv raw entry"] == 0
                  and (max(y.shape[1:3]) > 256 or (
                      launches["int8_conv"], launches["depth_to_space"])
                      == per),
                  f"{name} int8 deconv route launches {launches}, want "
                  f"{per} a forward")
    # card == CPU bit for bit, static with one scales dict (phase 4)
    x = torch.from_numpy(yccs[0][..., :1].astype(np.float32)[None]
                         / 255.0).cuda()
    scales = calibrate_scales(model, x, headroom=1.25)
    cpu_model = copy.deepcopy(model).cpu()
    for mode, sc in (("static", scales), ("dynamic", None)):
        on_cpu = quantized_apply(cpu_model, x.cpu(), sc,
                                 quantize_deconv=True)
        fns = _zero_counts()
        on_card = quantized_apply(model, x, sc, quantize_deconv=True)
        launches = (fns["int8_conv"].launches,
                    fns["depth_to_space"].launches)
        n_diff = int((on_card.cpu() != on_cpu).sum())
        print(f"[12] {name} int8 {mode} quantize_deconv forward "
              f"{tuple(x.shape)}, card vs CPU: {n_diff} of {on_cpu.numel()}"
              f" outputs differ (want 0); {launches[0]} int8 convs and "
              f"{launches[1]} shuffles (want {per})")
        check(n_diff == 0 and launches == per,
              f"the {name} int8 deconv forward differs card vs CPU")


def _lap_levels(card: str, state) -> None:
    """(d) LapSRN's pyramid: ``upscale(scale_factor=2, net_scale=4)`` of the
    trained ×4 net equals level 0 of its ``all_scales`` forward (the same
    predict, to u8), f32 card vs CPU ≤ 1 u8 level; ``quantize`` with
    ``net_scale``, a non power-of-2 scale and FSRCNN with ``net_scale``
    raise ``ValueError``; the HTTP server with ``net_scale=4,
    scale_factor=2`` returns what ``upscale`` returns, and ``/info`` says
    so."""
    from PIL import Image

    from sr_torch.infer import upscale
    from sr_torch.quant import to_u8
    from sr_torch.serve import SRService, serve_background
    from sr_torch.utils.precision import no_tf32

    path = str(ROOT / "build" / "chip_smoke" / "LapSRN_x4_trained.npz")
    rng = np.random.default_rng(13)
    ycc = rng.integers(0, 256, (96, 80, 3), dtype=np.uint8)
    fns = _zero_counts()
    got = upscale(ycc, "LapSRN", path, scale_factor=2, net_scale=4,
                  color_space="ycbcr", fused=True)
    launches = {n: fn.launches for n, fn in fns.items()}
    model = state.model.eval()
    x = torch.from_numpy(ycc[..., :1].astype(np.float32)[None] / 255.0
                         ).cuda()
    with torch.inference_mode():
        levels = model(x, all_scales=True)
    want = to_u8(levels[0])[0, ..., 0].cpu().numpy()
    check(got.shape == (192, 160, 3) and len(levels) == 2
          and levels[1].shape == (1, 384, 320, 1),
          f"LapSRN x2 level {got.shape}, levels {[t.shape for t in levels]}")
    check(np.array_equal(got[..., 0], want),
          "upscale(scale_factor=2, net_scale=4) is not level 0 of the "
          "all_scales forward")
    with no_tf32():
        card32 = upscale(ycc, "LapSRN", path, scale_factor=2, net_scale=4,
                         dtype="float32", color_space="ycbcr")
    cpu32 = upscale(ycc, "LapSRN", path, scale_factor=2, net_scale=4,
                    dtype="float32", color_space="ycbcr", device="cpu")
    d = np.abs(card32.astype(np.int32) - cpu32)
    print(f"[12] LapSRN x2 level of the x4 net (96x80 Y): == level 0 of "
          f"all_scales; launches {launches}; f32 card vs CPU max {d.max()} "
          "u8 levels (tol 1)")
    check(d.max() <= 1 and all(v == 0 for v in launches.values()),
          "the LapSRN x2 level differs card vs CPU or launched a kernel")
    fsrcnn_path = str(ROOT / "build" / "chip_smoke" / "FSRCNN_x4_trained.npz")
    for kw, what in ((dict(params=path, scale_factor=2, net_scale=4,
                           quantize="static"), "quantize"),
                     (dict(params=path, scale_factor=3, net_scale=4),
                      "power-of-2"),
                     (dict(params=fsrcnn_path, scale_factor=2, net_scale=4,
                           name="FSRCNN"), "intermediate")):
        name = kw.pop("name", "LapSRN")
        try:
            upscale(ycc, name, kw.pop("params"), **kw)
        except ValueError as e:
            check(what in str(e), f"unexpected refusal: {e}")
        else:
            raise SmokeFailure(f"upscale({name}, {kw}) did not refuse")
    print("[12] net_scale with quantize, at scale 3 and on FSRCNN: each "
          "ValueError, as sr.infer")
    service = SRService(model_name="LapSRN", params=path, scale_factor=2,
                        net_scale=4)
    httpd, port = serve_background(service)
    img = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("GET", "/info")
    info = json.loads(conn.getresponse().read())
    conn.request("POST", "/upscale", body=_png(img),
                 headers={"Content-Type": "image/png"})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    httpd.shutdown()
    httpd.server_close()
    check(resp.status == 200 and info["net_scale"] == 4
          and info["scale_factor"] == 2, f"POST /upscale net_scale: "
          f"{resp.status}, /info {info}")
    served = np.asarray(Image.open(io.BytesIO(body)))
    check(np.array_equal(served, upscale(img, "LapSRN", path, scale_factor=2,
                                         net_scale=4, fused=True)),
          "the served x2 level differs from a direct upscale")
    print(f"[12] POST /upscale to a --net_scale 4 --scale_factor 2 service "
          f"== direct upscale {served.shape}")


def _lap_eval(card: str, name: str, tr, state, sets) -> None:
    """(e) The trained model through ``evaluate(channels=1)`` on the
    synthetic set and 8 procedural 384² images (YCbCr), host and device
    metrics, the counts zeroed just before and read just after (no port
    kernel runs in these models' float forward); device metrics within
    1e-4 dB and 1e-5 SSIM of the host's; images/s by CUDA events."""
    predict = functools.partial(tr.make_predict_fn(), state.model)
    kw = dict(scale_factor=4, channels=1, color_space="ycbcr")
    for _, ds in sets:  # warm-up: cuDNN's plans at each shape
        _timed_eval(predict, ds, on_device_metrics=True, **kw)
    fns = _zero_counts()
    runs = {(set_name, on_dev): _timed_eval(predict, ds,
                                            on_device_metrics=on_dev, **kw)
            for set_name, ds in sets for on_dev in (False, True)}
    launches = {n: fn.launches for n, fn in fns.items()}
    check(all(v == 0 for v in launches.values()),
          f"the {name} eval path launched a port kernel: {launches}")
    for set_name, _ in sets:
        host, dev = runs[set_name, False][0], runs[set_name, True][0]
        _check_eval(host, f"{name} {set_name}")
        _check_eval(dev, f"{name} {set_name}")
        pairs = list(zip(host.images, dev.images))
        dp = max(abs(a.psnr_sr - b.psnr_sr) for a, b in pairs)
        dss = max(abs(a.ssim_sr - b.ssim_sr) for a, b in pairs)
        print(f"[12] {name} eval {set_name} (Y): host vs device metrics, "
              f"PSNR max diff {dp:.3g} dB (tol 1e-4), SSIM {dss:.3g} (tol "
              f"1e-5); model {host.avg_psnr_sr:.4f} dB, bicubic "
              f"{host.avg_psnr_bicubic:.4f} dB")
        check(dp <= 1e-4 and dss <= 1e-5,
              f"{name} {set_name}: device metrics differ from the host's")
        for on_dev in (False, True):
            res, ms, pred_ms, _ = runs[set_name, on_dev]
            n = len(res.images)
            print(f"[12] {name} eval {set_name}, "
                  f"{'device' if on_dev else 'host'} metrics: "
                  f"{n / ms * 1e3:.2f} images/s, {ms / n:.3f} ms/image (CUDA "
                  f"events), predict {pred_ms / n:.3f} ms/image "
                  f"({100 * pred_ms / ms:.1f}% of the span) | {card}")


def _lap_throughput(card: str, name: str, state, tally: _Tally) -> None:
    """(f) MP/s at b16 128² → 512² on Y, one route at a time (one event pair
    a batch, median of 10): bf16 exact, int8 static, int8 static with
    quantize_deconv, int8 dynamic. Reported, not gated."""
    from sr_torch.infer import make_serving_predict
    from sr_torch.quant import make_quantized_predict

    model = state.model.eval()
    x = torch.rand((16, 128, 128, 1), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(14))
    mp = 16 * 512 * 512 / 1e6
    routes = (("bf16 exact", lambda: make_serving_predict(model, True)),
              ("int8 static", lambda: make_quantized_predict(
                  model, "static", calib_headroom=1.25)),
              ("int8 static quantize_deconv", lambda: make_quantized_predict(
                  model, "static", calib_headroom=1.25,
                  quantize_deconv=True)),
              ("int8 dynamic", lambda: make_quantized_predict(model,
                                                              "dynamic")))
    with torch.inference_mode(), tally:
        for route, make in routes:
            fn = make()
            if hasattr(fn, "calibrate"):
                fn.calibrate([x])
            ms = time_ms(lambda: fn(x), n=10)
            print(f"[12] {name} x4 {route} b16 128->512 (Y): {ms:.3f} "
                  f"ms/batch, {mp / ms * 1e3:.1f} MP/s | {card}")


def phase_fsrcnn_lapsrn(card: str) -> list[dict]:
    """Phase 12: FSRCNN and LapSRN ×4 on Y at full width (FSRCNN 56/12/4
    with its 9×9 stride-4 deconv, LapSRN 64 filters × 5 convs a level, two
    levels). (a) the fused int8 entry at every int8 site shape and the f32
    shuffle at every int8-deconv shape of both serving images, exact and
    timed; per model (c) training, (b) serving, (d) LapSRN's pyramid
    levels, (e) eval and (f) MP/s by route, each path with its own zeroed
    counts. Returns the kernel rows, each with the launches of its shape
    on its model's serving paths."""
    from sr_torch.data.datasets import SyntheticDataset, get_test_set
    from sr_torch.data.procedural import ProceduralDataset

    t0 = time.perf_counter()
    rows = _lap_kernel_rows(card)
    print(f"[12] kernel rows: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    ds = SyntheticDataset(num_images=32, size=(160, 160), channels=3,
                          seed=100)
    images = [ds[i][..., :1] for i in range(len(ds))]
    proc = ProceduralDataset(num_images=LAP_PROCEDURAL, size=(384, 384),
                             seed=0, split="train", color_space="ycbcr")
    proc_images = [proc[i][..., :1] for i in range(len(proc))]
    sets = (("synthetic",
             get_test_set(str(ROOT / "build" / "chip_smoke"), "synthetic")),
            ("procedural", ProceduralDataset(
                num_images=8, size=(384, 384), split="test",
                color_space="ycbcr")))
    for _, test_set in sets:
        for i in range(len(test_set)):
            test_set[i]
    print(f"[12] corpora (synthetic, {LAP_PROCEDURAL} procedural train "
          f"images, the test sets): {time.perf_counter() - t1:.1f} s")
    tallies = {}
    for name in LAP_INT8:
        t1 = time.perf_counter()
        tr, state = _lap_train(card, name, images,
                               proc_images if name == "LapSRN" else None)
        tallies[name] = _Tally()
        _lap_serve(card, name, state, tallies[name])
        if name == "LapSRN":
            _lap_levels(card, state)
        _lap_eval(card, name, tr, state, sets)
        _lap_throughput(card, name, state, tallies[name])
        del tr, state
        torch.cuda.empty_cache()
        print(f"[12] {name} seconds {time.perf_counter() - t1:.1f}")
    for row in rows:
        tally = tallies[row.pop("model")]
        if row["name"] == "depth_to_space":
            row["launches"] = tally.d2s[tuple(row["shape"]), torch.float32]
        else:
            row["launches"] = tally.int8[tuple(row["shape"])]
    check(all(row["launches"] > 0 for row in rows),
          "an FSRCNN / LapSRN kernel row's shape was not launched on its "
          "path: "
          f"{[(r['name'], r.get('path'), r['shape'], r['launches']) for r in rows]}")
    print(f"[12] phase seconds {time.perf_counter() - t0:.1f}")
    return rows


# ----------------------------------------------------------------------
# phase 13: export, artifact serving and the D4 self-ensemble
# ----------------------------------------------------------------------

#: phase 13's EDSR ×4 bundles (bf16 model, buckets ART_BUCKETS): (file
#: name, route, fused, quantize, the ensemble baked in) and the launches of
#: (shuffle, resblock, fused int8 conv) one artifact call makes, the eager
#: route's
ART_ROUTES = (
    ("bf16_exact", "bf16 exact", False, False, False, (2, 16, 0)),
    ("bf16_fused", "bf16 fused", True, False, False, (1, 16, 0)),
    ("int8_static_fused", "int8 static fused", True, "static", False,
     (1, 0, 35)),
    ("bf16_fused_ensemble", "bf16 fused + ensemble", True, False, True,
     (8, 128, 0)),
)
ART_BUCKETS = (64, 128)
ART_BATCHES = (1, 16)

#: run in a fresh process: load every bundle onto the card with no model
#: code, call the 128 bucket at each batch with the launch counts zeroed
#: just before and read just after, save the outputs, report the port's
#: model modules (and JAX's) found in sys.modules
_ART_CHILD = r"""
import json, sys
import torch
from sr_torch.export import load_bundle
from sr_torch.kernels import ops

out_dir, names = sys.argv[1], json.loads(sys.argv[2])
xs = torch.load(out_dir + "/inputs.pt")
counters = (ops.depth_to_space, ops.fused_resblock, ops.conv_int8_fused)
outs, counts = {}, {}
for name in names:
    meta, buckets = load_bundle(f"{out_dir}/{name}.srtbundle", device="cuda")
    fn = buckets[-1][2]
    for b, x in xs.items():
        for c in counters:
            c.launches = 0
        y = fn(x.cuda())
        torch.cuda.synchronize()
        counts[f"{name} b{b}"] = [c.launches for c in counters]
        outs[f"{name} b{b}"] = y.cpu()
torch.save(outs, out_dir + "/outputs.pt")
bad = sorted(m for m in sys.modules
             if m.startswith(("sr_torch.models", "sr_torch.nn"))
             or m.split(".")[0] in ("jax", "flax", "sr"))
print(json.dumps({"counts": counts, "model_modules": bad}))
"""


class _OpCapture:
    """Inside ``with``, records the arguments (detached) of the first call
    of each ``sr_torch`` operator at each distinct input shape and type,
    and counts the calls at each (a ``TorchDispatchMode``: it sees the
    calls an exported program makes, and a train step's forward below
    autograd). ``seen``: key → arguments; ``calls``: key → calls."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen: dict = {}
        calls: collections.Counter = collections.Counter()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.name()
                if name.startswith("sr_torch::"):
                    x = args[0]
                    shapes = tuple(tuple(a.shape) for a in args[1:]
                                   if isinstance(a, torch.Tensor))
                    key = (name.split("::")[1], tuple(x.shape), x.dtype,
                           shapes)
                    calls[key] += 1
                    if key not in seen:
                        seen[key] = tuple(
                            a.detach() if isinstance(a, torch.Tensor) else a
                            for a in args)
                return func(*args, **(kwargs or {}))

        self.seen, self.calls, self._mode = seen, calls, Mode()

    def counts(self) -> dict:
        """``calls`` with each key as its ``str``, for a child's JSON."""
        return {str(k): n for k, n in self.calls.items()}

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def _captured_row(card: str, key, args, launches: int, route: str,
                  tag: str = "[13]", path: str | None = None) -> dict:
    """One kernel at the arguments an artifact (or ``path``) gave it: the
    operator's CUDA implementation against its plain version (exact, or
    the resblock's 2e-2), times of both, the library call and the bound.
    Returns the kernels-line row."""
    path = path or f"phase 13 {route} artifact"
    from sr_torch.kernels import ops

    name, shape, dtype, _ = key
    op = getattr(torch.ops.sr_torch, name)
    if name == "depth_to_space":
        x, r, act, bias = args
        plain = functools.partial(ops.depth_to_space_plain, x, r, act, bias)
        xc = (x if bias is None else x + bias).permute(0, 3, 1, 2)
        library = functools.partial(F.pixel_shuffle, xc, r)
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        by, tol = "bytes", 0.0
        source, replaces = ("sr_torch/kernels/csrc/depth_to_space.cu",
                            "sr/kernels/depth_to_space.py:73")
        desc = f"r={r} bias={bias is not None}"
    elif name == "fused_resblock":
        x, w1, b1, w2, b2, res = args
        plain = functools.partial(ops.fused_resblock_plain, *args)
        c = x.shape[-1]
        u1, u2 = (ops.unpack_wgmma_weights(w, c) for w in (w1, w2))
        library = _resblock_library(x, u1, b1, u2, b2, res)
        bound, by = _resblock_bound(x)
        tol = TOL[x.dtype]
        source, replaces = ("sr_torch/kernels/csrc/fused_resblock.cu",
                            "sr/kernels/fused_resblock.py:119")
        desc = f"res_scale={res}"
    else:
        x, q_w, scale, dequant, bias, rec, packed = args
        plain = functools.partial(ops.conv_int8_fused_plain, x, q_w, scale,
                                  dequant, bias, rec)
        b, h, w, c = x.shape
        k, n = q_w.shape[0], q_w.shape[-1]
        q_x = torch.clamp(torch.round(x * scale if rec else x / scale),
                          -127, 127).to(torch.int8)
        a, wm = _int_mm_operands(q_x, q_w)
        library = functools.partial(torch._int_mm, a, wm)
        t_ops = 2 * b * h * w * k * k * c * n / PEAK_FLOPS[torch.int8] * 1e3
        t_bytes = ((4 * b * h * w * c + k * k * c * n + 4 * b * h * w * n)
                   / HBM_BYTES_PER_S * 1e3)
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        tol = 0.0
        source, replaces = ("sr_torch/kernels/csrc/int8_conv.cu",
                            "sr/kernels/int8_conv.py:75")
        desc = f"->{n} k={k} reciprocal={rec}"
    got, want = op(*args), plain()
    err = float((got.double() - want.double()).abs().max())
    check(got.dtype == want.dtype and err <= tol,
          f"{name} {shape} in the {path} differs from its plain "
          f"version: {err} (tol {tol})")
    del got, want
    t_k = kernel_ms(lambda: op(*args))
    t_p = kernel_ms(plain, n=5, reps=3)
    t_l = kernel_ms(library, n=10, reps=3)
    print(f"{tag} {name} {shape} {str(dtype)[6:]} {desc} ({path}, "
          f"{launches} launches on the path): kernel {t_k:.4f} ms, plain "
          f"{t_p:.4f} ms, library {t_l:.4f} ms, bound {bound:.4f} ms ({by}); "
          f"max |kernel - plain| {err:.3g} (tol {tol}) | {card}")
    return dict(name="int8_conv" if name == "conv_int8_fused" else name,
                route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=t_k, plain_ms=t_p,
                bound_ms=bound, bound_by=by, library_ms=t_l,
                shape=list(shape) + ([n, k] if name == "conv_int8_fused"
                                     else []),
                dtype=str(dtype)[6:], path=path)


def _art_export_start(out_dir: Path, path: Path, calib_pngs) -> dict:
    """(a) Every bundle of ART_ROUTES through ``python -m
    sr_torch.export`` on the card, the processes at once (tracing is host
    work); the int8 one calibrated on ``calib_pngs``. Returns ``{file
    name: (process, bundle path)}``."""
    procs = {}
    for slug, _, fused, quant, ens, _ in ART_ROUTES:
        art = out_dir / f"{slug}.srtbundle"
        cmd = [sys.executable, "-m", "sr_torch.export", "--model_name",
               "EDSR", "--params", str(path), "--out", str(art),
               "--lr_size", *map(str, ART_BUCKETS), "--device", "cuda"]
        cmd += ["--fused"] if fused else []
        cmd += (["--quantize", quant, "--calib_image", *map(str, calib_pngs)]
                if quant else [])
        cmd += ["--self_ensemble"] if ens else []
        procs[slug] = (subprocess.Popen(cmd, cwd=ROOT, text=True,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE), art)
    return procs


def _art_export_wait(procs: dict, t0: float) -> dict:
    """Wait for :func:`_art_export_start`'s processes; every one must
    have written its bundle. Returns ``{file name: bundle path}``."""
    from sr_torch.export import _BUNDLE_MAGIC

    arts = {}
    for slug, route, *_ in ART_ROUTES:
        proc, art = procs[slug]
        out, err = proc.communicate(timeout=900)
        check(proc.returncode == 0 and art.exists(),
              f"python -m sr_torch.export ({route}) failed:\n{out}\n"
              f"{err[-4000:]}")
        check(art.read_bytes()[:len(_BUNDLE_MAGIC)] == _BUNDLE_MAGIC,
              f"{art} is not a bundle")
        arts[slug] = art
        print(f"[13] python -m sr_torch.export ({route}): "
              f"{out.strip().splitlines()[-1]}; "
              f"{art.stat().st_size / 2 ** 20:.1f} MiB")
    print(f"[13] the {len(procs)} export processes ran at once: "
          f"{time.perf_counter() - t0:.1f} s")
    return arts


def _art_eager(path: Path, calib) -> dict:
    """The eager predict of each route, on the card, from the same .npz."""
    from sr_torch.eval.ensemble import make_self_ensemble_predict
    from sr_torch.infer import make_serving_predict
    from sr_torch.utils.checkpoint import load_params
    from sr_torch.utils.interop import from_jax_params

    _, model = _seeded_edsr("bfloat16")
    model = from_jax_params(model, load_params(str(path))[0]).cuda().eval()
    calib_t = [torch.from_numpy(c).cuda() for c in calib]
    eager = {}
    for slug, _, fused, quant, ens, _ in ART_ROUTES:
        fn = make_serving_predict(model, fused, quant, calib_headroom=1.0,
                                  calib_batches=calib_t if quant else None)
        eager[slug] = make_self_ensemble_predict(fn) if ens else fn
    return eager


def _art_isolated_start(out_dir: Path, xs: dict):
    """(b) A fresh process loads every bundle with no model code and runs
    it at b1 and b16 (:data:`_ART_CHILD`); returns the process."""
    torch.save(xs, out_dir / "inputs.pt")
    slugs = [r[0] for r in ART_ROUTES]
    return subprocess.Popen([sys.executable, "-c", _ART_CHILD, str(out_dir),
                             json.dumps(slugs)], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _art_isolated_check(proc, out_dir: Path, xs: dict, eager: dict,
                        t0: float) -> None:
    """The fresh process's outputs against the eager routes (bit for bit,
    else at most 1 u8 level, said), its launches per call the eager
    route's and the expected ones."""
    from sr_torch.kernels import ops
    from sr_torch.quant import to_u8

    stdout, stderr = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"the artifact loader failed:\n{stdout}"
          f"\n{stderr[-4000:]}")
    rec = json.loads(stdout.strip().splitlines()[-1])
    print(f"[13] fresh process: loaded {len(ART_ROUTES)} bundles and ran "
          f"b1/b16 in {time.perf_counter() - t0:.1f} s; model modules "
          f"imported: {rec['model_modules']}")
    check(rec["model_modules"] == [],
          f"loading an artifact imported model code: {rec['model_modules']}")
    outs = torch.load(out_dir / "outputs.pt")
    counters = (ops.depth_to_space, ops.fused_resblock, ops.conv_int8_fused)
    for slug, route, *_, want_counts in ART_ROUTES:
        for b, x in xs.items():
            got = outs[f"{slug} b{b}"]
            for c in counters:
                c.launches = 0
            with torch.inference_mode():
                want = eager[slug](x.cuda()).cpu()
            eager_counts = [c.launches for c in counters]
            art_counts = rec["counts"][f"{slug} b{b}"]
            exact = torch.equal(got, want)
            lv = int((to_u8(got).int() - to_u8(want).int()).abs().max())
            err = float((got.float() - want.float()).abs().max())
            print(f"[13] {route} b{b}: artifact vs eager "
                  f"{'bit for bit' if exact else f'max |diff| {err:.3g}'}, "
                  f"{lv} u8 levels; launches a call (shuffle, resblock, "
                  f"int8) artifact {art_counts}, eager {eager_counts}")
            top = 4 * ART_BUCKETS[-1]
            check(got.shape == want.shape == (b, top, top, 3)
                  and got.dtype == want.dtype and lv <= 1,
                  f"{route} artifact differs from eager at b{b}: {lv}")
            check(art_counts == eager_counts == list(want_counts),
                  f"{route} launches {art_counts} / {eager_counts}, want "
                  f"{list(want_counts)}")


def _art_main_path(loaded: dict, xs: dict) -> dict:
    """(c) The phase's main path in this process: each loaded bundle's 128
    bucket at b1 and b16, the counts zeroed just before and read just
    after; each kernel must have run."""
    from sr_torch.kernels import ops

    counters = {"depth_to_space": ops.depth_to_space,
                "fused_resblock": ops.fused_resblock,
                "int8_conv": ops.conv_int8_fused}
    for c in counters.values():
        c.launches = 0
    for slug, *_ in ART_ROUTES:
        for x in xs.values():
            loaded[slug][-1][2](x.cuda())
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"[13] main path (4 artifacts x b1, b16) launches: {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel did not run inside the artifacts: {launches}")
    return launches


def _art_kernel_rows(card: str, loaded: dict, x16, launches: dict):
    """(d) Each kernel at the arguments the artifacts give it at b16
    (captured inside the programs), against its plain version, timed."""
    rows, done = [], set()
    for slug, route, *_ in ART_ROUTES[:3]:
        cap = _OpCapture()
        with cap, torch.inference_mode():
            loaded[slug][-1][2](x16)
        for key, args in cap.seen.items():
            if key in done:
                continue
            done.add(key)
            name = "int8_conv" if key[0] == "conv_int8_fused" else key[0]
            rows.append(_captured_row(card, key, args, launches[name],
                                      route))
        del cap
        torch.cuda.empty_cache()
    return rows


def _art_cpu_export(card: str, path: Path, out_dir: Path) -> None:
    """(e) bf16 exact exported on the CPU at the smallest bucket, for
    :func:`_art_cpu_vs_card`."""
    from sr_torch.export import export_bundle, save_bundle

    t0 = time.perf_counter()
    meta, programs = export_bundle("EDSR", str(path), dtype="bfloat16",
                                   lr_sizes=(ART_BUCKETS[0],), device="cpu")
    save_bundle(str(out_dir / "bf16_exact_cpu.srtbundle"), meta, programs)
    print(f"[13] bf16 exact exported on the CPU in "
          f"{time.perf_counter() - t0:.1f} s")


def _art_cpu_vs_card(card: str, arts: dict) -> None:
    """The CPU's bf16 exact program loaded onto the card (moved): the same
    constants, so equal to the card's export bit for bit."""
    from sr_torch.export import load_bundle

    cpu_art = arts["bf16_exact"].with_name("bf16_exact_cpu.srtbundle")
    moved = load_bundle(str(cpu_art), device="cuda")[1][0][2]
    native = load_bundle(str(arts["bf16_exact"]), device="cuda")[1][0][2]
    side = ART_BUCKETS[0]
    g = torch.Generator(device="cuda").manual_seed(131)
    for b in ART_BATCHES:
        x = torch.rand((b, side, side, 3), device="cuda", generator=g)
        check(torch.equal(moved(x), native(x)),
              f"the CPU export moved to the card differs at b{b}")
    print(f"[13] bf16 exact exported on the CPU, moved to the card: == the "
          f"card's export at b{ART_BATCHES[0]}, b{ART_BATCHES[-1]} | {card}")


def _art_http(card: str, arts: dict) -> None:
    """(f) The int8 bundle over HTTP: 16 concurrent requests in the 128
    bucket share fewer program calls than requests, each response equal
    to a direct call of the program."""
    import threading

    from PIL import Image

    from sr_torch.export import load_bundle
    from sr_torch.serve import SRService, serve_background

    service = SRService(artifact=str(arts["int8_static_fused"]),
                        linger_ms=100.0, device="cuda")
    fn = load_bundle(str(arts["int8_static_fused"]), device="cuda")[1][-1][2]
    rng = np.random.default_rng(132)
    top = ART_BUCKETS[-1]
    sizes = [(top, top), (top - top // 16, top - top // 5),
             (top - top // 4, top), (top, ART_BUCKETS[-2] + 1)] * 4
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in sizes]
    httpd, port = serve_background(service)
    results = [None] * len(imgs)

    def post(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/upscale", body=_png(imgs[i]))
        resp = conn.getresponse()
        results[i] = (resp.status, resp.read())
        conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    seconds = time.perf_counter() - t0
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/metrics")
    metrics = json.loads(conn.getresponse().read())
    conn.close()
    httpd.shutdown()
    httpd.server_close()
    check(all(r is not None and r[0] == 200 for r in results),
          f"HTTP artifact requests failed: "
          f"{[r if r is None else (r[0], r[1][:200]) for r in results]}")
    for img, (_, body) in zip(imgs, results):
        h, w = img.shape[:2]
        x = np.pad(img.astype(np.float32) / 255.0,
                   ((0, top - h), (0, top - w), (0, 0)), mode="edge")
        direct = fn(x[None])[0, :4 * h, :4 * w].cpu().numpy()
        direct = np.clip(np.round(direct * 255.0), 0, 255).astype(np.uint8)
        check(np.array_equal(np.asarray(Image.open(io.BytesIO(body))),
                             direct),
              "an HTTP response differs from a direct artifact call")
    print(f"[13] HTTP int8 bundle: {len(imgs)} concurrent requests in the "
          f"{top} bucket took {service.batcher.dispatches} program calls "
          f"({service.batcher.batched_requests} batched) in {seconds:.2f} s; "
          f"each == a direct call; /metrics {metrics} | {card}")
    check(service.batcher.dispatches < len(imgs),
          f"micro-batching made {service.batcher.dispatches} calls for "
          f"{len(imgs)} requests")


def _art_espcn(card: str, out_dir: Path) -> None:
    """(g) ESPCN ×4 on Y, int8 static, as a bundle served over HTTP: an
    RGB request's luma through the program, its chroma
    ``resize_bicubic_u8``'s, the output equal to model mode's ``upscale``
    calibrated on the same luma."""
    from PIL import Image

    from sr_torch.data.native import resize_bicubic_u8
    from sr_torch.eval.metrics import rgb_to_ycbcr, ycbcr_to_rgb
    from sr_torch.export import export_bundle, load_bundle, save_bundle
    from sr_torch.infer import upscale
    from sr_torch.models.registry import get_spec
    from sr_torch.serve import SRService, serve_background
    from sr_torch.utils.checkpoint import save_params
    from sr_torch.utils.config import SRConfig
    from sr_torch.utils.interop import to_jax_params

    model = get_spec("ESPCN").make_model(
        SRConfig(model_name="ESPCN", num_channels=1),
        torch.Generator().manual_seed(133))
    gen = torch.Generator().manual_seed(134)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.02)
    path = str(out_dir / "ESPCN_x4_seed133.npz")
    save_params(path, to_jax_params(model))

    def u8(v):
        return np.clip(np.round(np.asarray(v)), 0, 255).astype(np.uint8)

    img = np.random.default_rng(135).integers(0, 256, (64, 64, 3), np.uint8)
    ycc = u8(rgb_to_ycbcr(img.astype(np.float32)).numpy())
    luma = ycc[None, ..., :1].astype(np.float32) / 255.0
    meta, programs = export_bundle("ESPCN", path, num_channels=1,
                                   lr_sizes=(32, 64), quantize="static",
                                   calib_input=[luma], device="cuda")
    art = out_dir / "espcn_int8_static.srtbundle"
    save_bundle(str(art), meta, programs)
    from sr_torch.kernels import ops

    c0, d0 = ops.conv_int8_fused.launches, ops.depth_to_space.launches
    service = SRService(artifact=str(art), device="cuda")
    httpd, port = serve_background(service)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/upscale", body=_png(img))
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    httpd.shutdown()
    httpd.server_close()
    check(resp.status == 200, f"ESPCN artifact POST: {resp.status} {body}")
    launches = (ops.conv_int8_fused.launches - c0,
                ops.depth_to_space.launches - d0)
    got = np.asarray(Image.open(io.BytesIO(body)))
    fn = load_bundle(str(art), device="cuda")[1][-1][2]
    merged = np.concatenate([u8(fn(luma)[0].cpu().numpy() * 255.0),
                             resize_bicubic_u8(ycc, (256, 256))[..., 1:]],
                            axis=-1)
    check(np.array_equal(got, u8(ycbcr_to_rgb(
        merged.astype(np.float32)).numpy())),
        "the ESPCN artifact's output is not its luma with the bicubic "
        "chroma")
    want = upscale(img, "ESPCN", path, quantize="static", calib_headroom=1.0,
                   device="cuda")
    print(f"[13] ESPCN x4 Y int8-static bundle over HTTP: (64, 64) RGB -> "
          f"{got.shape}, {launches[0]} int8 convs and {launches[1]} shuffle "
          f"a request; chroma == resize_bicubic_u8; == model mode upscale: "
          f"{np.array_equal(got, want)} | {card}")
    check(launches == (3, 1), f"ESPCN artifact launches {launches}")
    check(np.array_equal(got, want),
          "the ESPCN artifact differs from model mode's upscale")


def _art_upscale_ensemble(card: str, path: Path) -> None:
    """(h) f32 ``upscale(self_ensemble=True)`` of EDSR on the card against
    the CPU, and tiled against whole: at most 1 u8 level each."""
    from sr_torch.infer import upscale
    from sr_torch.utils.precision import no_tf32

    rng = np.random.default_rng(136)
    img = rng.integers(0, 256, (44, 36, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    with no_tf32():
        card_out = upscale(img, "EDSR", str(path), dtype="float32",
                           self_ensemble=True, tile=None, device="cuda")
    cpu_out = upscale(img, "EDSR", str(path), dtype="float32",
                      self_ensemble=True, tile=None, device="cpu")
    lv = int(np.abs(card_out.astype(int) - cpu_out).max())
    big = rng.integers(0, 256, (150, 120, 3), dtype=np.uint8)
    with no_tf32():
        whole = upscale(big, "EDSR", str(path), dtype="float32",
                        self_ensemble=True, tile=None, device="cuda")
        tiled = upscale(big, "EDSR", str(path), dtype="float32",
                        self_ensemble=True, tile=64, device="cuda")
    lv_t = int(np.abs(whole.astype(int) - tiled).max())
    print(f"[13] f32 upscale(self_ensemble=True) EDSR x4: card vs CPU "
          f"{img.shape[:2]} {lv} u8 levels; tiled (64) vs whole "
          f"{big.shape[:2]} {lv_t} levels (tol 1 each; "
          f"{time.perf_counter() - t0:.1f} s)")
    check(lv <= 1 and lv_t <= 1, "the self-ensemble differs")


def _art_throughput(card: str, loaded: dict, eager: dict) -> dict:
    """(i) MP/s at b16 128² → 512²: each artifact against its eager route
    in turns (eager, artifact, artifact, eager), and the ensemble's cost
    against the plain fused route."""
    b, top = ART_BATCHES[-1], ART_BUCKETS[-1]
    x = torch.rand((b, top, top, 3), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(137))
    mp = b * (4 * top) ** 2 / 1e6
    out = {}
    with torch.inference_mode():
        for slug, route, *_ in ART_ROUTES[1:]:
            art = loaded[slug][-1][2]
            eag = eager[slug]
            ms = [time_ms(lambda f=f: f(x), n=10)
                  for f in (eag, art, art, eag)]
            e, a = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
            out[route] = (mp / e * 1e3, mp / a * 1e3)
            print(f"[13] {route} b{b} {top}->{4 * top}: eager {ms[0]:.3f} / "
                  f"{ms[3]:.3f} ms ({mp / e * 1e3:.1f} MP/s), artifact "
                  f"{ms[1]:.3f} / {ms[2]:.3f} ms ({mp / a * 1e3:.1f} MP/s), "
                  f"artifact / eager {e / a:.3f} | {card}")
    fused, ens = out["bf16 fused"][1], out["bf16 fused + ensemble"][1]
    print(f"[13] the ensemble costs {fused / ens:.2f}x the fused artifact's "
          f"time (8 forwards) | {card}")
    return out


def phase_artifacts(card: str) -> list[dict]:
    """Phase 13: EDSR ×4 at full width exported as multi-bucket bundles
    (bf16 exact, bf16 fused, int8 static fused, bf16 fused with the
    ensemble baked in), loaded without model code, served, micro-batched
    over HTTP and run as the D4 self-ensemble; ESPCN ×4 on Y as an int8
    static bundle through the server's luma and chroma path. Returns the
    kernels-line rows at the artifacts' shapes."""
    from sr_torch.data.datasets import SyntheticDataset
    from sr_torch.export import load_bundle
    from sr_torch.utils.checkpoint import save_params
    from sr_torch.utils.interop import to_jax_params

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke" / "artifacts"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    path = out_dir / "EDSR_x4_seed0.npz"
    _, model = _seeded_edsr("bfloat16")
    save_params(str(path), to_jax_params(model))
    del model
    # two synthetic images at the smallest bucket calibrate the int8
    # bundle (the CLI reads them with Pillow; at that size they load as
    # they are) and the eager int8 route
    from PIL import Image

    corpus = SyntheticDataset(2, (ART_BUCKETS[0],) * 2, 3, seed=13)
    pngs = [out_dir / f"calib{i}.png" for i in range(2)]
    for i, png in enumerate(pngs):
        Image.fromarray(corpus[i]).save(png)
    calib = [(np.asarray(Image.open(png), np.float32) / 255.0)[None]
             for png in pngs]
    t_exp = time.perf_counter()
    procs = _art_export_start(out_dir, path, pngs)
    # while they trace: what needs no bundle of theirs
    eager = _art_eager(path, calib)
    _art_cpu_export(card, path, out_dir)
    _art_espcn(card, out_dir)
    _art_upscale_ensemble(card, path)
    arts = _art_export_wait(procs, t_exp)
    _art_cpu_vs_card(card, arts)
    gen = torch.Generator().manual_seed(138)
    top = ART_BUCKETS[-1]
    xs = {b: torch.rand((b, top, top, 3), generator=gen)
          for b in ART_BATCHES}
    t_child = time.perf_counter()
    child = _art_isolated_start(out_dir, xs)
    # while a fresh process loads them: this process's main path and HTTP
    loaded = {slug: load_bundle(str(arts[slug]), device="cuda")[1]
              for slug, *_ in ART_ROUTES}
    launches = _art_main_path(loaded, xs)
    _art_http(card, arts)
    _art_isolated_check(child, out_dir, xs, eager, t_child)
    # alone on the card: the kernels' rows and the throughput
    rows = _art_kernel_rows(card, loaded, xs[ART_BATCHES[-1]].cuda(),
                            launches)
    _art_throughput(card, loaded, eager)
    print(f"[13] phase seconds {time.perf_counter() - t0:.1f}")
    return rows


# ----------------------------------------------------------------------
# phase 14: the CLI and the reference-style wrappers
# ----------------------------------------------------------------------

#: phase 14's inputs: the procedural train and test splits the CLI reads
#: (640 images at 384², minutes of host work on one core) and the
#: synthetic VGG19. Kept between runs, as the kernels' build cache is, and
#: made only where missing (:func:`_cli_setup`)
CLI_DATA = ROOT / "build" / "chip_smoke" / "cli_data"
#: (a)'s training: EDSR ×4 at full width, bf16, crop 64, b32, two epochs
#: of 40 steps in dispatches of 20 (bench.py's flagship)
CLI_STEPS, CLI_K, CLI_EPOCHS = 40, 20, 2
CLI_TEST_IMAGES = 128  # get_test_set('procedural'), 384², by direct forward
CLI_WORKERS = 8  # processes generating the procedural splits


#: run as ``python -c``: the procedural splits through the path
#: ``get_training_set`` and ``get_test_set`` take, in ``argv[2]`` spawned
#: workers. A process of its own because the workers import their
#: parent's main module, and this script's imports torch in each of them
_CLI_DATA_CHILD = r"""
import sys
from sr_torch.data.datasets import procedural_cache, procedural_split
for split in ("test", "train"):
    procedural_split(split, "rgb").materialize(
        procedural_cache(sys.argv[1]), int(sys.argv[2]))
"""


def _cli_setup(card: str) -> tuple[float, list[str]]:
    """Phase 14's inputs, before anything of the phase is timed and with
    nothing else running, made only where ``CLI_DATA`` lacks them: the
    procedural splits (:data:`_CLI_DATA_CHILD`, :data:`CLI_WORKERS`
    workers), then their files held to the paths the getters read and
    the first and last image of each to a fresh generation; the synthetic
    VGG19 as phase 11 makes it (``scripts/make_synthetic_vgg.py``).
    Returns the seconds and what was made."""
    from sr_torch.data.datasets import procedural_cache, procedural_split

    t0 = time.perf_counter()
    cache = procedural_cache(str(CLI_DATA))
    splits = {s: procedural_split(s, "rgb") for s in ("test", "train")}
    made = [Path(ds.cache_path(cache)).name for ds in splits.values()
            if not Path(ds.cache_path(cache)).is_file()]
    if made:
        subprocess.run([sys.executable, "-c", _CLI_DATA_CHILD, str(CLI_DATA),
                        str(CLI_WORKERS)], cwd=ROOT, check=True,
                       capture_output=True, timeout=900)
    for split, ds in splits.items():
        check(Path(ds.cache_path(cache)).is_file(),
              f"[14] no cached procedural {split} split at "
              f"{ds.cache_path(cache)}")
        ds.materialize(cache)
        fresh = procedural_split(split, "rgb")
        for i in (0, len(ds) - 1):
            check(np.array_equal(ds[i], fresh[i]),
                  f"[14] procedural {split} image {i} differs from a fresh "
                  "generation")
    del splits, ds
    vgg = CLI_DATA / "vgg19_synthetic.pth"
    if not vgg.is_file():
        tmp = vgg.with_suffix(".tmp")
        subprocess.run([sys.executable, str(ROOT / "scripts" /
                                            "make_synthetic_vgg.py"),
                        str(tmp)], check=True, capture_output=True,
                       timeout=300)
        tmp.replace(vgg)
        made.append(vgg.name)
    seconds = time.perf_counter() - t0
    print(f"[14] setup: {seconds:.1f} s, made {made or 'nothing (cached)'} "
          f"with {CLI_WORKERS} workers | {card}")
    return seconds, made


class _Timed:
    """Inside ``with``, the wall seconds of every call of each
    ``(owner, attribute)`` (a module's function or a class's method), the
    card synchronised at its end."""

    def __init__(self, *targets):
        self.targets, self.seconds = targets, {}

    def __enter__(self):
        self._orig = [(o, n, getattr(o, n)) for o, n in self.targets]
        for owner, name, fn in self._orig:
            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    self.seconds.setdefault(_name, []).append(
                        time.perf_counter() - t0)
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


def _cli_argv(save_dir: Path, *extra, epochs: int = CLI_EPOCHS,
              test: str = "procedural") -> list[str]:
    return ["--model_name", "EDSR", "--scale_factor", "4", "--crop_size",
            "64", "--batch_size", "32", "--dtype", "bfloat16",
            "--train_dataset", "procedural", "--test_dataset", test,
            "--num_epochs", str(epochs), "--save_epochs", "1",
            "--steps_per_epoch", str(CLI_STEPS), "--steps_per_dispatch",
            str(CLI_K), "--data_dir", str(CLI_DATA), "--save_dir",
            str(save_dir), *extra]


def _cli_records(run_dir: Path) -> tuple[list[dict], list[dict]]:
    """(train records, eval records) of a run's metrics.jsonl."""
    with open(run_dir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return ([r for r in recs if "loss" in r],
            [r for r in recs if r.get("event") == "eval"])


def _cli_run(argv: list[str], what: str,
             tag: str = "[14]") -> tuple[dict, dict, float]:
    """``sr_torch.main.main(argv)`` in this process, the kernels' counts
    zeroed just before and read just after, and the wall seconds of the
    run, of its fit, its eval and its export. Returns (launches, seconds,
    wall)."""
    from sr_torch import main as cli
    from sr_torch.kernels import ops
    from sr_torch.train import gan, trainer

    counters = {"depth_to_space": ops.depth_to_space,
                "fused_resblock": ops.fused_resblock}
    with _Timed((trainer.Trainer, "fit"), (gan.GANTrainer, "fit"),
                (cli, "run_eval"), (cli, "export_artifact")) as timed:
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
    check(rc == 0, f"{tag} {what}: main returned {rc}")
    seconds = {k: sum(v) for k, v in timed.seconds.items()}
    print(f"{tag} {what}: {wall:.1f} s, launches {launches}, "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    return launches, seconds, wall


def _npz_equal(a: Path, b: Path) -> bool:
    with np.load(a) as za, np.load(b) as zb:
        return set(za.files) == set(zb.files) and all(
            np.array_equal(za[k], zb[k]) for k in za.files)


def _cli_train(card: str, runs: Path) -> dict:
    """(a) The flagship through the CLI: train with checkpoints, sample
    renders, loss.png, eval on the procedural test set with panels and SR
    PNGs, export the .pt2 and the reference .pkl. 2 shuffles a step, 2
    shuffles and 16 resblocks a predict (2 sample renders, the test set
    and the export's warm-up call). Returns the run's numbers."""
    run = runs / "a" / "EDSR_x4"
    launches, sec, wall = _cli_run(
        _cli_argv(runs / "a", "--export", "--export_torch"),
        "(a) train, eval, export")
    steps = CLI_EPOCHS * CLI_STEPS
    predicts = CLI_EPOCHS + CLI_TEST_IMAGES + 1
    want = {"depth_to_space": 2 * steps + 2 * predicts,
            "fused_resblock": 16 * predicts}
    check(launches == want, f"(a) launches {launches}, want {want} (2 a "
          f"step, 2 + 16 a predict, {steps} steps, {predicts} predicts)")
    train, (ev,) = _cli_records(run)
    losses = [r["loss"] for r in train]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(a) the loss did not fall: {losses}")
    for rel in ("EDSR_params.npz", "EDSR_x4.pt2", "EDSR_param.pkl",
                "loss.png", "samples/epoch_0001.png",
                "samples/epoch_0002.png"):
        check((run / rel).is_file(), f"(a) wrote no {rel}")
    for sub in ("panels", "images"):
        n = len(list((run / sub).glob("*.png")))
        check(n == CLI_TEST_IMAGES, f"(a) {n} {sub}, want {CLI_TEST_IMAGES}")
    check(ev["num_images"] == CLI_TEST_IMAGES and np.isfinite(ev["psnr_sr"])
          and np.isfinite(ev["ssim_sr"]), f"(a) eval record {ev}")
    out = {"launches": launches, "wall": wall, "train_s": sec["fit"],
           "steps_per_s": steps / sec["fit"], "eval_s": sec["run_eval"],
           "images_per_s": CLI_TEST_IMAGES / sec["run_eval"],
           "export_s": sec["export_artifact"], "eval": ev,
           "loss": (losses[0], losses[-1])}
    print(f"[14] (a) EDSR x4 bf16 crop 64 b32: {steps} steps in "
          f"{sec['fit']:.2f} s ({out['steps_per_s']:.1f} steps/s with 2 "
          f"sample renders), loss {losses[0]:.5f} -> {losses[-1]:.5f}; eval "
          f"{CLI_TEST_IMAGES} procedural 384^2 with panels and SR PNGs "
          f"{sec['run_eval']:.2f} s ({out['images_per_s']:.1f} images/s), "
          f"SR {ev['psnr_sr']:.4f} dB / SSIM {ev['ssim_sr']:.4f} vs bicubic "
          f"{ev['psnr_bicubic']:.4f}; export {sec['export_artifact']:.2f} s "
          f"| {card}")
    return out


def _cli_resume(card: str, runs: Path, a_run: Path) -> float:
    """(b) One epoch, then the same command to two: the resumed run ends
    with (a)'s params bit for bit. Returns the wall seconds."""
    walls = []
    for epochs in (1, CLI_EPOCHS):
        _, _, wall = _cli_run(
            _cli_argv(runs / "b", epochs=epochs, test="synthetic"),
            f"(b) resume, {epochs} epoch(s)")
        walls.append(wall)
    run = runs / "b" / "EDSR_x4"
    check(_npz_equal(run / "EDSR_params.npz", a_run / "EDSR_params.npz"),
          "(b) the resumed run's params differ from (a)'s")
    steps = [r["step"] for r in _cli_records(run)[0]]
    check(steps[-1] == CLI_EPOCHS * CLI_STEPS and steps == sorted(steps),
          f"(b) steps {steps}")
    print(f"[14] (b) 1 epoch, then resumed to {CLI_EPOCHS}: params == (a)'s "
          f"bit for bit ({' + '.join(f'{w:.1f}' for w in walls)} s) | {card}")
    return sum(walls)


def _cli_eval_only(card: str, runs: Path, a: dict) -> tuple[dict, dict]:
    """(c) --eval_only on (a)'s run: (a)'s summary bit for bit, 2 + 16
    launches a predict. (d) with --self_ensemble (and --fast_eval): 8×
    (c)'s launches. Returns (c)'s and (d)'s numbers."""
    run = runs / "a" / "EDSR_x4"
    launches, sec, wall = _cli_run(_cli_argv(runs / "a", "--eval_only"),
                                   "(c) --eval_only")
    want = {"depth_to_space": 2 * CLI_TEST_IMAGES,
            "fused_resblock": 16 * CLI_TEST_IMAGES}
    check(launches == want, f"(c) launches {launches}, want {want}")
    ev = _cli_records(run)[1][-1]
    strip = lambda r: {k: v for k, v in r.items() if k != "ts"}  # noqa: E731
    check(strip(ev) == strip(a["eval"]),
          f"(c) summary {ev} differs from (a)'s {a['eval']}")
    c = {"launches": launches, "wall": wall,
         "images_per_s": CLI_TEST_IMAGES / sec["run_eval"]}
    print(f"[14] (c) --eval_only: summary == (a)'s bit for bit; eval "
          f"{sec['run_eval']:.2f} s ({c['images_per_s']:.1f} images/s) "
          f"| {card}")
    launches, sec, wall = _cli_run(
        _cli_argv(runs / "a", "--eval_only", "--self_ensemble",
                  "--fast_eval"), "(d) --eval_only --self_ensemble")
    check(launches == {k: 8 * v for k, v in c["launches"].items()},
          f"(d) launches {launches}, want 8x (c)'s {c['launches']}")
    ens = _cli_records(run)[1][-1]
    check(ens.get("self_ensemble") is True and np.isfinite(ens["psnr_sr"]),
          f"(d) eval record {ens}")
    d = {"launches": launches, "wall": wall,
         "images_per_s": CLI_TEST_IMAGES / sec["run_eval"], "eval": ens}
    print(f"[14] (d) --self_ensemble --fast_eval: 8x (c)'s launches; SR "
          f"{ens['psnr_sr']:.4f} dB (device metrics) against (c)'s "
          f"{ev['psnr_sr']:.4f} (host); eval {sec['run_eval']:.2f} s "
          f"({d['images_per_s']:.1f} images/s) | {card}")
    return c, d


def _cli_artifacts(card: str, a_run: Path) -> None:
    """(e) (a)'s .pt2 (load_artifact) equals the eager predict of (a)'s
    params bit for bit at b1 and b4; its .pkl loaded into a fresh port
    EDSR gives the same tensors, and that model's predict is the same."""
    from sr_torch.export import load_artifact
    from sr_torch.models.registry import get_spec
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.checkpoint import load_params
    from sr_torch.utils.config import SRConfig
    from sr_torch.utils.interop import from_jax_params, to_jax_params
    from sr_torch.utils.refckpt import load_reference_checkpoint

    cfg = SRConfig(model_name="EDSR", num_channels=3, dtype="bfloat16")
    params, _ = load_params(str(a_run / "EDSR_params.npz"))
    eager = from_jax_params(get_spec("EDSR").make_model(cfg), params).cuda()
    fresh = load_reference_checkpoint("EDSR", get_spec("EDSR").make_model(
        cfg), str(a_run / "EDSR_param.pkl"))
    check(_trees_equal(to_jax_params(fresh), params),
          "(e) the .pkl does not load back (a)'s params")
    fresh = fresh.cuda()
    art = load_artifact(str(a_run / "EDSR_x4.pt2"), device="cuda")
    predict = Trainer(cfg).make_predict_fn()
    size = 64 // 4
    for b in (1, 4):
        x = torch.rand((b, size, size, 3), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(b))
        want = predict(eager, x)
        check(torch.equal(art(x), want),
              f"(e) the .pt2 differs from eager at b{b}")
        check(torch.equal(predict(fresh, x), want),
              f"(e) the .pkl's model differs from eager at b{b}")
    print(f"[14] (e) EDSR_x4.pt2 == eager predict at b1 and b4 "
          f"({size}^2 LR); EDSR_param.pkl -> fresh EDSR == (a)'s params, "
          f"its predict == eager | {card}")


def _cli_compat(card: str, runs: Path) -> float:
    """(f) ``sr_torch.compat.ESPCN`` on Y: train a few steps, test on a
    PNG folder (static route, YCbCr panels), write the reference .pkl, and
    a fresh wrapper loads it with no .npz beside it. Returns seconds."""
    import types

    from PIL import Image

    from sr_torch import compat
    from sr_torch.data.datasets import SyntheticDataset
    from sr_torch.kernels import ops
    from sr_torch.utils.interop import to_jax_params
    from sr_torch.utils.refckpt import export_reference_checkpoint

    t0 = time.perf_counter()
    folder = CLI_DATA / "test" / "cli_y"
    folder.mkdir(parents=True, exist_ok=True)
    imgs = SyntheticDataset(3, (100, 84), 3, seed=21)
    for i in range(len(imgs)):
        Image.fromarray(imgs[i]).save(folder / f"y{i}.png")
    args = types.SimpleNamespace(
        train_dataset="synthetic", test_dataset="cli_y",
        data_dir=str(CLI_DATA), save_dir=str(runs / "f"), num_epochs=1,
        steps_per_epoch=20, batch_size=32, crop_size=64, scale_factor=4,
        dtype="bfloat16", device="cuda", num_channels=None, lr=None,
        save_epochs=None, test_batch_size=None, num_threads=None, seed=None)
    ops.depth_to_space.launches = 0
    w = compat.ESPCN(args)
    losses = w.train()
    trained = ops.depth_to_space.launches
    res = w.test()
    check(trained == 20 and ops.depth_to_space.launches > trained
          and all(np.isfinite(losses)) and np.isfinite(res.avg_psnr_sr)
          and len(res.images) == 3,
          f"(f) ESPCN: {trained} / {ops.depth_to_space.launches} shuffles, "
          f"losses {losses}, {len(res.images)} images")
    run = runs / "f" / "ESPCN_x4"
    check(len(list((run / "panels").glob("*.png"))) == 3, "(f) no panels")
    export_reference_checkpoint("ESPCN", w.state.model,
                                str(run / "ESPCN_param.pkl"))
    (run / "ESPCN_params.npz").unlink()
    w2 = compat.ESPCN(args)
    check(w2.load_model(), "(f) load_model found no .pkl")
    a, b = to_jax_params(w.state.model), to_jax_params(w2.state.model)
    check(_trees_equal(a, b),
        "(f) the .pkl did not load the trained params")
    x = torch.rand((2, 24, 20, 1), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(5))
    fn = w.trainer.make_predict_fn()
    check(torch.equal(fn(w.state.model, x), fn(w2.state.model, x)),
          "(f) the .pkl's model predicts otherwise")
    seconds = time.perf_counter() - t0
    print(f"[14] (f) compat.ESPCN on Y: train 20 steps (20 shuffles), "
          f"test 3 folder images, SR {res.avg_psnr_sr:.4f} dB with YCbCr "
          f"panels; load_model from ESPCN_param.pkl alone == trained; "
          f"{seconds:.1f} s | {card}")
    return seconds


def _trees_equal(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    return all(_trees_equal(a[k], b[k]) if isinstance(a[k], dict)
               else np.array_equal(a[k], b[k]) for k in a)


def _cli_srgan(card: str, runs: Path, vgg: Path) -> float:
    """(g) ``python -m sr_torch.main --model_name SRGAN``: one pretrain and
    one adversarial epoch of 4 steps (dispatches of 2), VGG19 from the
    synthetic weights. 2 shuffles a pretrain step, 4 an adversarial one, 2
    a predict (2 sample renders, 5 test images); no resblock. Returns the
    wall seconds."""
    launches, sec, wall = _cli_run([
        "--model_name", "SRGAN", "--num_epochs", "2", "--pretrain_epochs",
        "1", "--steps_per_epoch", "4", "--steps_per_dispatch", "2",
        "--crop_size", "64", "--batch_size", "16", "--save_epochs", "1",
        "--train_dataset", "synthetic", "--test_dataset", "synthetic",
        "--vgg_weights_path", str(vgg), "--data_dir", str(CLI_DATA),
        "--save_dir", str(runs / "g")], "(g) SRGAN")
    want = {"depth_to_space": 2 * 4 + 4 * 4 + 2 * (2 + 5),
            "fused_resblock": 0}
    check(launches == want, f"(g) launches {launches}, want {want}")
    run = runs / "g" / "SRGAN_x4"
    with open(run / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    adv = [r for r in recs if r.get("phase") == "adversarial"]
    check(adv and all(np.isfinite(r[k]) for r in adv
                      for k in ("d_loss", "g_loss", "g_vgg_loss")),
          f"(g) adversarial records {adv}")
    check((run / "ckpt_d" / "run_meta.json").is_file()
          and np.isfinite(recs[-1]["psnr_sr"]), "(g) no D checkpoint / eval")
    print(f"[14] (g) SRGAN: pretrain + adversarial epoch, d_loss "
          f"{adv[-1]['d_loss']:.4f}, g_loss {adv[-1]['g_loss']:.4f}, eval SR "
          f"{recs[-1]['psnr_sr']:.4f} dB; fit {sec['fit']:.2f} s | {card}")
    return wall


def _cli_blocks(card: str) -> None:
    """(h) Full-width ``Upsample2xBlock('ps')`` and an instance-norm
    ``ConvBlock`` on the card against the CPU, f32, TF32 off, 1e-3."""
    from sr_torch.kernels import ops
    from sr_torch.nn.blocks import ConvBlock, Upsample2xBlock
    from sr_torch.utils.precision import no_tf32

    gen = torch.Generator().manual_seed(14)
    x = torch.rand((4, 64, 64, 64), generator=gen)
    errs = {}
    for name, blk in (
            ("Upsample2xBlock('ps')", Upsample2xBlock(64, 64, "ps",
                                                      generator=gen)),
            ("ConvBlock(norm='instance')", ConvBlock(
                64, 64, 3, norm="instance", generator=gen))):
        with torch.no_grad(), no_tf32():
            want = blk(x)
            before = ops.depth_to_space.launches
            got = blk.cuda()(x.cuda().contiguous(
                memory_format=torch.channels_last)).cpu()
            shuffles = ops.depth_to_space.launches - before
        errs[name] = float((got - want).abs().max())
        check(got.shape == want.shape and errs[name] <= 1e-3
              and shuffles == (1 if "ps" in name else 0),
              f"(h) {name}: card vs CPU {errs[name]}, {shuffles} shuffles")
    print(f"[14] (h) card vs CPU (4,64,64,64) f32: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol 1e-3) | {card}")


def _cli_kernel_rows(card: str, a_run: Path, launches: dict) -> list[dict]:
    """(i) The shuffle and the resblock at the arguments (a)'s path gives
    them, captured in one train step (crop 64, b32) and one predict of a
    procedural test image (96² LR), against their plain versions and
    timed as phase 13 times them. Returns the kernels-line rows."""
    from sr_torch.data.datasets import get_training_set
    from sr_torch.data.pipeline import build_patch_pipeline
    from sr_torch.models.registry import get_spec
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.checkpoint import load_params
    from sr_torch.utils.config import SRConfig
    from sr_torch.utils.interop import from_jax_params

    cfg = SRConfig(model_name="EDSR", num_channels=3, dtype="bfloat16",
                   crop_size=64, batch_size=32)
    tr = Trainer(cfg)
    state = tr.init_state(cfg.seed)
    from_jax_params(state.model, load_params(str(a_run /
                                                 "EDSR_params.npz"))[0])
    train = get_training_set(str(CLI_DATA), "procedural", "rgb")
    pipe = build_patch_pipeline(cfg, get_spec("EDSR"), [train[i] for i in
                                                        range(4)])
    batch = pipe(torch.Generator(device="cuda").manual_seed(14))
    x = torch.rand((1, 96, 96, 3), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(15))
    predict = tr.make_predict_fn()
    caps = {}
    for route, run in (("train step", lambda: tr.train_step(state, batch)),
                       ("eval predict", lambda: predict(state.model, x))):
        with _OpCapture() as cap:
            run()
        caps[route] = cap.seen
    rows = []
    for route, seen in caps.items():
        for key, args in seen.items():
            rows.append(_captured_row(
                card, key, args, launches[key[0]], route, tag="[14]",
                path=f"phase 14 CLI {route}"))
    names = sorted({(r["name"], tuple(r["shape"])) for r in rows})
    check(len(names) == 5, f"(i) captured {names}: want 2 train shuffles, "
          "2 predict shuffles and the resblock")
    return rows


def phase_cli(card: str) -> list[dict]:
    """Phase 14: EDSR ×4 at full width through ``sr_torch.main.main`` in
    this process (so the kernels' counts can be read), in the CLI's own
    cuDNN mode (deterministic algorithms, so a resumed run can equal an
    uninterrupted one bit for bit): (a) train → eval → export, (b) resume,
    (c) --eval_only, (d) --self_ensemble, (e) the .pt2 and .pkl, (f) the
    ESPCN compat wrapper on Y, (g) the SRGAN CLI, (h) the rest of the
    block menu on the card, (i) the kernels at this phase's shapes, (j)
    the timings. Its inputs are made first (:func:`_cli_setup`). Returns
    the kernels-line rows."""
    setup_s, _ = _cli_setup(card)
    t0 = time.perf_counter()
    runs = ROOT / "build" / "chip_smoke" / "cli_runs"
    shutil.rmtree(runs, ignore_errors=True)
    a = _cli_train(card, runs)
    b_wall = _cli_resume(card, runs, runs / "a" / "EDSR_x4")
    c, d = _cli_eval_only(card, runs, a)
    _cli_artifacts(card, runs / "a" / "EDSR_x4")
    f_s = _cli_compat(card, runs)
    g_wall = _cli_srgan(card, runs, CLI_DATA / "vgg19_synthetic.pth")
    _cli_blocks(card)
    torch.cuda.empty_cache()
    rows = _cli_kernel_rows(card, runs / "a" / "EDSR_x4", a["launches"])
    print(f"[14] (j) wall s: (a) {a['wall']:.1f}, (b) {b_wall:.1f}, (c) "
          f"{c['wall']:.1f}, (d) {d['wall']:.1f}, (f) {f_s:.1f}, (g) "
          f"{g_wall:.1f}; (a) {a['steps_per_s']:.1f} steps/s, eval "
          f"{a['images_per_s']:.1f} / (c) {c['images_per_s']:.1f} / (d) "
          f"{d['images_per_s']:.1f} images/s, export {a['export_s']:.2f} s "
          f"(cuDNN deterministic, as the CLI runs it) | {card}")
    print(f"[14] phase seconds {time.perf_counter() - t0:.1f} after "
          f"{setup_s:.1f} s of setup")
    return rows


# ----------------------------------------------------------------------
# phase 15: data parallel over processes and the sharded forward
# ----------------------------------------------------------------------

#: phase 15's files: the seeded EDSR's params, the LR image, each child's
#: results and the CLI runs
P15_DIR = ROOT / "build" / "chip_smoke" / "p15"
#: (a): DDP steps of one dispatch, full-width EDSR ×4 bf16, crop 64, b32
P15_K = 20
#: (b): the steps held to the one-process run, then the steps timed
P15_STEPS, P15_TIMED = 3, 5
#: (c): the LR image (rows, columns) and the bands' halo (EDSR's
#: receptive field, ``sr_torch.eval.tiling.RECEPTIVE_FIELD``)
P15_LR, P15_HALO = (384, 256), 40
#: seconds a child may take, and its group's collective timeout
P15_TIMEOUT = 600
#: (a): timed dispatches of each kind, after one warm-up dispatch
P15_REPS = 5


def _p15_pipe():
    """The phase's sampler: 8 seeded 160² RGB images on the card, the
    'matrix' ``PatchPipeline`` at crop 64, b32 (phase 6's)."""
    from sr_torch.data.pipeline import PatchPipeline

    corpus = np.random.default_rng(15).integers(0, 256, (8, 160, 160, 3),
                                                np.uint8)
    return PatchPipeline(list(corpus), crop_size=TRAIN_CROP, scale_factor=4,
                         batch_size=TRAIN_BATCH, channels=3)


def _p15_cfg(model: str, dtype: str, **kw):
    from sr_torch.utils.config import SRConfig

    return SRConfig(model_name=model, num_channels=3, scale_factor=4,
                    crop_size=TRAIN_CROP, batch_size=TRAIN_BATCH,
                    dtype=dtype, **kw)


def _p15_batches(pipe, n: int, seed: int) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [pipe(gen) for _ in range(n)]


def _p15_gan_cfg():
    """Full-width SRGAN ×4 in f32 with phase 14's synthetic VGG19."""
    return _p15_cfg("SRGAN", "float32",
                    vgg_weights_path=str(CLI_DATA / "vgg19_synthetic.pth"),
                    vgg_output_layer="relu2_2")


def _p15_probe() -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(153)
    return torch.rand((2, 32, 32, 3), device="cuda", generator=gen)


def _p15_edsr():
    """Phase 4's seeded EDSR ×4 (bf16), from the params phase 15 saved."""
    from sr_torch.models.registry import get_spec
    from sr_torch.utils.checkpoint import load_params
    from sr_torch.utils.interop import from_jax_params

    model = get_spec("EDSR").make_model(_p15_cfg("EDSR", "bfloat16"))
    from_jax_params(model, load_params(str(P15_DIR / "edsr.npz"))[0])
    return model.cuda().eval()


def _p15_counts() -> dict:
    from sr_torch.kernels import ops

    return {"depth_to_space": ops.depth_to_space.launches,
            "fused_resblock": ops.fused_resblock.launches,
            "int8_conv": ops.conv_int8_fused.launches}


def _p15_zero() -> None:
    from sr_torch.kernels import ops

    for c in (ops.depth_to_space, ops.fused_resblock, ops.conv_int8_fused):
        c.launches = 0


def _p15_per_shape(cap: _OpCapture, counts: dict) -> dict:
    """The launches a path made at each shape (``cap``'s calls, by
    ``str`` of the key), checked against the wrappers' ``counts`` of the
    same run: every launch is at one shape or another."""
    by_name: collections.Counter = collections.Counter()
    for key, n in cap.calls.items():
        by_name["int8_conv" if key[0] == "conv_int8_fused" else key[0]] += n
    check(all(by_name[k] == n for k, n in counts.items()),
          f"launches by shape {dict(by_name)}, the wrappers' {counts}")
    return cap.counts()


def _p15_child_a(out: str) -> int:
    """(a) One process, alone on the card: K steps of the plain
    ``Trainer``, then the group of one through the ``SR_*`` environment
    (NCCL) and K steps of the DDP ``Trainer`` from the same seed, its
    counts zeroed just before and read just after, by kernel and by
    shape; cuDNN deterministic. Each kind of dispatch is then timed, the
    plain one before the group is up: one warm-up dispatch, then the
    median of ``P15_REPS``. Writes the comparison, the counts and the
    times."""
    import torch.distributed as dist

    from sr_torch.parallel.multihost import initialize_multihost
    from sr_torch.train.trainer import Trainer

    pipe, cfg = _p15_pipe(), _p15_cfg("EDSR", "bfloat16")
    plain = Trainer(cfg)
    ps = plain.init_state(0)
    plain_multi = plain.make_multi_step(pipe, P15_K)
    pm = float(plain_multi(ps)["loss"])
    want = ([v.clone() for v in ps.model.state_dict().values()],
            ps.generator.get_state())
    ms = {"plain": time_ms(lambda: plain_multi(ps), n=P15_REPS, warmup=1)}
    check(initialize_multihost(), "(a) no SR_* environment")
    tr = Trainer(cfg)
    check(tr.mesh.distributed and tr.mesh.world == 1
          and dist.get_backend() == "nccl",
          f"(a) the group: {tr.mesh}, {dist.get_backend()}")
    state = tr.init_state(0)
    multi = tr.make_multi_step(pipe, P15_K)
    torch.cuda.synchronize()
    _p15_zero()
    with _OpCapture() as cap:
        m = multi(state)
    torch.cuda.synchronize()
    launches = _p15_counts()
    per_shape = _p15_per_shape(cap, launches)
    equal = (float(m["loss"]) == pm and all(
        torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                          want[0]))
        and torch.equal(state.generator.get_state(), want[1]))
    ms["ddp"] = time_ms(lambda: multi(state), n=P15_REPS, warmup=1)
    dist.destroy_process_group()
    Path(out).write_text(json.dumps({
        "equal": equal, "loss": pm, "launches": launches,
        "per_shape": per_shape, "ms": ms}))
    return 0


def _p15_child_bc(rank: int, rendezvous: str, out: str) -> int:
    """(b) and (c) on one of two processes sharing the card (gloo): EDSR
    f32 steps and SRGAN's pretrain and adversarial steps on the global
    batch (TF32 off), then ``sharded_predict`` by the bf16 exact and
    int8-static fused routes, each path's counts zeroed just before and
    read just after."""
    import torch.distributed as dist

    from sr_torch.eval.tiling import sharded_predict
    from sr_torch.infer import make_serving_predict
    from sr_torch.parallel.multihost import initialize_multihost
    from sr_torch.train.gan import GANTrainer
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.precision import no_tf32

    initialize_multihost(f"file://{rendezvous}", 2, rank, backend="gloo",
                         timeout_s=P15_TIMEOUT)
    res: dict = {"rank": rank}
    pipe = _p15_pipe()
    with no_tf32():
        tr = Trainer(_p15_cfg("EDSR", "float32"))
        state = tr.init_state(0)
        batches = _p15_batches(pipe, P15_STEPS + P15_TIMED, 151)
        torch.cuda.synchronize()
        _p15_zero()
        with _OpCapture() as cap:
            res["edsr_loss"] = [float(tr.train_step(state, b)[1]["loss"])
                                for b in batches[:P15_STEPS]]
        res["edsr_launches"] = _p15_counts()
        res["edsr_per_shape"] = _p15_per_shape(cap, res["edsr_launches"])
        edsr = {k: v.cpu() for k, v in state.model.state_dict().items()}
        edsr_fn = tr.predict(state, _p15_probe()).cpu()
        t0 = time.perf_counter()
        for b in batches[P15_STEPS:]:
            tr.train_step(state, b)
        torch.cuda.synchronize()
        res["edsr_steps_per_s"] = P15_TIMED / (time.perf_counter() - t0)
        gtr = GANTrainer(_p15_gan_cfg())
        g, d = gtr.init_states(0)
        b0, b1 = _p15_batches(pipe, 2, 152)
        torch.cuda.synchronize()
        _p15_zero()
        t0 = time.perf_counter()
        m0 = gtr.pretrain_step(g, b0)[1]
        m1 = gtr.adversarial_step(g, d, b1)[2]
        torch.cuda.synchronize()
        res["gan_s"] = time.perf_counter() - t0
        res["gan_launches"] = _p15_counts()
        res["gan"] = {k: float(v) for k, v in {**m0, **m1}.items()}
        torch.save({"edsr": edsr, "edsr_fn": edsr_fn,
                    "fn": gtr.predict(g, _p15_probe()).cpu(),
                    "g_stats": g.batch_stats, "d_stats": d.batch_stats},
                   f"{out}.pt")
    del tr, state, gtr, g, d, batches
    model = _p15_edsr()
    x = torch.load(P15_DIR / "x.pt").cuda()
    routes = {"exact": make_serving_predict(model, fused=False),
              "static": make_serving_predict(model, fused=True,
                                             quantize="static",
                                             calib_batches=[x])}
    outs = {}
    with torch.inference_mode():
        for route, fn in routes.items():
            torch.cuda.synchronize()
            _p15_zero()
            with _OpCapture() as cap:
                outs[route] = sharded_predict(fn, x, halo=P15_HALO).cpu()
            torch.cuda.synchronize()
            res[f"{route}_launches"] = _p15_counts()
            res[f"{route}_per_shape"] = _p15_per_shape(
                cap, res[f"{route}_launches"])
    torch.save(outs, f"{out}.sharded.pt")
    dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))
    return 0


def _p15_child(argv: list[str]) -> int:
    """Entry point of phase 15's children (:data:`_P15_RUN`)."""
    torch.backends.cudnn.deterministic = True
    if argv[0] == "a":
        return _p15_child_a(argv[1])
    return _p15_child_bc(int(argv[1]), argv[2], argv[3])


#: run as ``python -c``: this script imported as a module, then one child
#: of phase 15
_P15_RUN = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "sys.exit(chip_smoke._p15_child(sys.argv[2:]))")


def _p15_start(args: list[str], env: dict | None = None):
    return subprocess.Popen(
        [sys.executable, "-c", _P15_RUN, str(ROOT), *args], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, **(env or {})})


def _p15_wait(procs: dict) -> None:
    """Wait for every child (``P15_TIMEOUT`` s each at most); a child that
    fails fails the phase, and the others are killed."""
    try:
        for name, proc in procs.items():
            log = proc.communicate(timeout=P15_TIMEOUT)[0]
            check(proc.returncode == 0, f"[15] child {name} exited "
                  f"{proc.returncode}:\n{log[-4000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _p15_reference() -> dict:
    """The one-process runs (b) and (c) are held to, in this process while
    the children run: the same seeds, batches and image."""
    from sr_torch.infer import make_serving_predict
    from sr_torch.quant import to_u8
    from sr_torch.train.gan import GANTrainer
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.device import deterministic_cudnn
    from sr_torch.utils.precision import no_tf32

    ref: dict = {}
    pipe = _p15_pipe()
    # the children's cuDNN mode: the same algorithms, so the steps on the
    # same halves can agree bit for bit
    with deterministic_cudnn(), no_tf32():
        tr = Trainer(_p15_cfg("EDSR", "float32"))
        state = tr.init_state(0)
        batches = _p15_batches(pipe, P15_STEPS, 151)
        ref["edsr_loss"] = [float(tr.train_step(state, b)[1]["loss"])
                            for b in batches]
        ref["edsr"] = {k: v.cpu() for k, v in
                       state.model.state_dict().items()}
        ref["edsr_fn"] = tr.predict(state, _p15_probe()).cpu()
        # the same steps with each batch's gradient summed from its two
        # halves, the rows each process holds: the arithmetic DDP does
        state = tr.init_state(0)
        for b in batches:
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            for rows in (slice(0, TRAIN_BATCH // 2),
                         slice(TRAIN_BATCH // 2, None)):
                loss = tr.loss_fn(state.model, {k: v[rows] for k, v in
                                                b.items()}, state.step)[0]
                (loss / 2).backward()
            state.tx.step(state.optimizer, state.step)
            state.step += 1
        ref["edsr_halves"] = {k: v.cpu() for k, v in
                              state.model.state_dict().items()}
        gtr = GANTrainer(_p15_gan_cfg())
        g, d = gtr.init_states(0)
        b0, b1 = _p15_batches(pipe, 2, 152)
        m0 = gtr.pretrain_step(g, b0)[1]
        m1 = gtr.adversarial_step(g, d, b1)[2]
        ref["gan"] = {k: float(v) for k, v in {**m0, **m1}.items()}
        ref["fn"] = gtr.predict(g, _p15_probe()).cpu()
        ref["g_stats"], ref["d_stats"] = g.batch_stats, d.batch_stats
    del tr, state, gtr, g, d
    model = _p15_edsr()
    x = torch.load(P15_DIR / "x.pt").cuda()
    with torch.inference_mode():
        ref["exact"] = to_u8(model(x)).cpu()
        static = make_serving_predict(model, fused=True, quantize="static",
                                      calib_batches=[x])
        ref["static"] = static(x).cpu()
    return ref


def _tree_rel(a: dict, b: dict) -> tuple[float, float, float]:
    """Three relative errors over two dicts of tensors, each the largest
    over the tensors: ‖a − b‖₂ / ‖b‖₂; max |a − b| / max |b|; and
    ``dryrun_multichip``'s elementwise max |a − b| / (|b| + 1e-6). After
    Adam steps the last two see single weights whose gradient is near
    zero, which either run may step by ±lr (Adam's g / (√v + ε) turns the
    reduction order's noise into a whole step); the first does not."""
    l2, per, elem = 0.0, 0.0, 0.0
    for k, w in b.items():
        g, w = a[k].double(), w.double()
        diff = (g - w).abs()
        l2 = max(l2, float(diff.norm() / w.norm().clamp_min(1e-30)))
        per = max(per, float(diff.max() / w.abs().max().clamp_min(1e-30)))
        elem = max(elem, float((diff / (w.abs() + 1e-6)).max()))
    return l2, per, elem


def _stats_diff(a, b) -> float:
    """max |a − b| over two nested dicts of arrays (batch statistics;
    absolute, as a running mean near 0 makes a relative one ill-posed)."""
    if isinstance(b, dict):
        return max(_stats_diff(a[k], v) for k, v in b.items())
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _p15_check_b(card: str, res: list[dict], outs: list[dict],
                 ref: dict) -> None:
    """(b) Each process against the one-process run: the losses with
    ``dryrun_multichip``'s bounds, and EDSR's params bit for bit against
    one process stepping on the same two halves, the arithmetic DDP does
    (the same cuDNN algorithms at the same shapes; the average of two is
    exact); SRGAN with ``dryrun_multichip``'s bounds, the probe's
    tightened; the processes against each other.
    EDSR's distances to the one-process b32 steps are printed beside that
    run's own distance from its steps on the two halves: Adam turns the
    summation order's noise on near-zero gradients into whole ±lr steps,
    so three steps apart the b32 and the two-halves runs differ by what
    the DDP run differs from the b32 one. Everything is measured, then
    checked."""
    loss_rel = max(abs(a - b) / abs(b) for r in res for a, b in zip(
        r["edsr_loss"], ref["edsr_loss"]))
    gan_rel = {k: max(abs(r["gan"][k] - ref["gan"][k]) / abs(ref["gan"][k])
                      for r in res) for k in ("d_loss", "g_loss",
                                              "g_content_loss")}
    halves = _tree_rel(outs[0]["edsr"], ref["edsr_halves"])
    halves_equal = all(torch.equal(outs[0]["edsr"][k], w)
                       for k, w in ref["edsr_halves"].items())
    b32 = _tree_rel(outs[0]["edsr"], ref["edsr"])
    own = _tree_rel(ref["edsr_halves"], ref["edsr"])
    fn_b32 = float((outs[0]["edsr_fn"] - ref["edsr_fn"]).abs().max())
    fn = float((outs[0]["fn"] - ref["fn"]).abs().max())
    g_st = _stats_diff(outs[0]["g_stats"], ref["g_stats"])
    d_st = _stats_diff(outs[0]["d_stats"], ref["d_stats"])
    same = (all(torch.equal(a, b) for a, b in zip(
        outs[0]["edsr"].values(), outs[1]["edsr"].values()))
        and _stats_diff(outs[0]["g_stats"], outs[1]["g_stats"]) == 0
        and _stats_diff(outs[0]["d_stats"], outs[1]["d_stats"]) == 0)
    print(f"[15] (b) two processes (gloo) on one card against one process, "
          f"f32, TF32 off, cuDNN deterministic, global b{TRAIN_BATCH} crop "
          f"{TRAIN_CROP}: EDSR {P15_STEPS} steps loss rel {loss_rel:.3g} "
          f"(1e-5); params against one process on the same halves: bit for "
          f"bit {halves_equal} (relative L2 {halves[0]:.3g}, {halves[1]:.3g} "
          f"of a tensor's largest, elementwise {halves[2]:.3g}); against the "
          f"b32 "
          f"steps (reported): relative L2 {b32[0]:.3g}, {b32[1]:.3g} of a "
          f"tensor's largest, elementwise {b32[2]:.3g}, on a probe "
          f"{fn_b32:.3g}, where the one-process halves run is {own[0]:.3g}, "
          f"{own[1]:.3g}, {own[2]:.3g} from it; SRGAN pretrain + "
          f"adversarial loss rel d {gan_rel['d_loss']:.3g} g "
          f"{gan_rel['g_loss']:.3g} (1e-4), G on a probe {fn:.3g} (1e-4), "
          f"running statistics G {g_st:.3g} D {d_st:.3g} (1e-4); the "
          f"processes' params and statistics bit-equal: {same} | {card}")
    print("[15] (b) per process on one shared card (ungated, not multi-GPU "
          "speed): EDSR f32 "
          + " / ".join(f"{r['edsr_steps_per_s']:.2f}" for r in res)
          + " steps/s; SRGAN pretrain + adversarial step "
          + " / ".join(f"{r['gan_s']:.3f}" for r in res) + f" s | {card}")
    for r in res:
        want = {"depth_to_space": 2 * P15_STEPS, "fused_resblock": 0,
                "int8_conv": 0}
        check(r["edsr_launches"] == want, f"(b) EDSR launches "
              f"{r['edsr_launches']}, want {want}")
        want = {"depth_to_space": 2 + 4, "fused_resblock": 0,
                "int8_conv": 0}
        check(r["gan_launches"] == want, f"(b) SRGAN launches "
              f"{r['gan_launches']}, want {want} (2 a pretrain step, 4 an "
              "adversarial one)")
    check(loss_rel <= 1e-5, f"(b) EDSR loss rel {loss_rel:.3g}")
    check(halves_equal, f"(b) EDSR params differ from one process's on "
          f"the same halves: {halves}")
    check(max(gan_rel.values()) <= 1e-4, f"(b) SRGAN losses {gan_rel}")
    # G on the probe at 1e-4, not dryrun_multichip's 3e-4: per-process
    # batch statistics move it by less than 3e-4 after these two steps
    check(fn <= 1e-4 and g_st <= 1e-4 and d_st <= 1e-4,
          f"(b) SRGAN after its steps: G on the probe {fn:.3g} (1e-4), "
          f"running statistics G {g_st:.3g} D {d_st:.3g} (1e-4)")
    check(same, "(b) the two processes' EDSR params or SRGAN running "
          "statistics differ")


def _p15_check_c(card: str, res: list[dict], outs: list[dict],
                 ref: dict) -> None:
    """(c) Each process holds the whole output: the exact route within one
    u8 level of the whole-image forward, the int8-static fused route bit
    for bit (else its measured bound, within one level)."""
    from sr_torch.quant import to_u8

    want = {"exact": {"depth_to_space": 2, "fused_resblock": 16,
                      "int8_conv": 0},
            "static": {"depth_to_space": 1, "fused_resblock": 0,
                       "int8_conv": 35}}
    for r in res:
        for route, w in want.items():
            check(r[f"{route}_launches"] == w,
                  f"(c) {route} band launches {r[f'{route}_launches']}, "
                  f"want {w}")
    for route in ("exact", "static"):
        check(torch.equal(outs[0][route], outs[1][route]),
              f"(c) the processes' {route} outputs differ")
    got = to_u8(outs[0]["exact"])
    hr = tuple(4 * s for s in P15_LR)
    check(tuple(got.shape) == (1, *hr, 3), f"(c) shape {tuple(got.shape)}")
    exact = int((got.int() - ref["exact"].int()).abs().max())
    check(exact <= 1, f"(c) bf16 exact sharded vs whole: {exact} levels")
    static = outs[0]["static"]
    bit = torch.equal(static, ref["static"])
    err = float((static.double() - ref["static"].double()).abs().max())
    levels = int((to_u8(static).int() - to_u8(ref["static"]).int())
                 .abs().max())
    check(bit or levels <= 1, f"(c) int8 static fused sharded vs whole: "
          f"max {err:.3g}, {levels} u8 levels")
    print(f"[15] (c) sharded_predict over 2 processes (gloo) on one card, "
          f"EDSR x4 bf16 on a {P15_LR[0]}x{P15_LR[1]} LR image, 2 bands of "
          f"{P15_LR[0] // 2} rows + halo {P15_HALO}: bf16 exact within "
          f"{exact} u8 level of the whole-image forward; int8 static fused "
          + ("bit for bit" if bit else
             f"NOT bit for bit: max |sharded - whole| {err:.3g}, {levels} "
             "u8 levels") + f"; per band 2 + 16 and 1 + 35 launches | {card}")


def _p15_kernel_rows(card: str, measured: dict) -> list[dict]:
    """The kernels at the arguments phase 15's paths give them, captured in
    this process at the same shapes: (a)'s DDP step (bf16, b32), a (b)
    process's step (f32, b16), a band of (c) by each route. Each against
    its plain version and timed as phase 13 times them; each row with the
    launches its shape made on its path, as the children counted them
    (``measured``: path → ``str`` of the key → launches). The shapes
    captured here must be the shapes the path launched."""
    from sr_torch.infer import make_serving_predict
    from sr_torch.train.trainer import Trainer
    from sr_torch.utils.precision import no_tf32

    def rows_of(cap, path, route, desc):
        got = {str(k) for k in cap.seen}
        check(got == set(measured[path]), f"[15] {desc}: shapes captured "
              f"here {sorted(got)}, launched on the path "
              f"{sorted(measured[path])}")
        return [_captured_row(card, key, args, measured[path][str(key)],
                              route, tag="[15]", path=f"phase 15 {desc}")
                for key, args in cap.seen.items()]

    rows = []
    batch = _p15_batches(_p15_pipe(), 1, 154)[0]
    half = {k: v[:TRAIN_BATCH // 2] for k, v in batch.items()}
    for dtype, b, path, desc in (
            ("bfloat16", batch, "a", "(a) DDP step, NCCL world 1"),
            ("float32", half, "b",
             "(b) DDP step of one of 2 gloo processes")):
        with no_tf32():
            tr = Trainer(_p15_cfg("EDSR", dtype))
            state = tr.init_state(0)
            with _OpCapture() as cap:
                tr.train_step(state, b)
            rows += rows_of(cap, path, "train step", desc)
    del tr, state
    model = _p15_edsr()
    x = torch.load(P15_DIR / "x.pt").cuda()
    window = x[:, :P15_LR[0] // 2 + P15_HALO]  # each band's window
    for route, fn in (("exact", make_serving_predict(model, fused=False)),
                      ("static", make_serving_predict(
                          model, fused=True, quantize="static",
                          calib_batches=[x]))):
        with torch.inference_mode(), _OpCapture() as cap:
            fn(window)
        rows += rows_of(cap, route, f"{route} band",
                        f"(c) sharded_predict {route} band")
    return rows


#: (d)'s child: ``python -m sr_torch.main ARGV`` (``runpy``), the kernels'
#: counts zeroed just before and printed just after
_P15_CLI_CHILD = r"""
import json, runpy, sys
from sr_torch.kernels import ops
counters = {"depth_to_space": ops.depth_to_space,
            "fused_resblock": ops.fused_resblock}
for c in counters.values():
    c.launches = 0
sys.argv = ["sr_torch.main", *json.loads(sys.argv[1])]
try:
    runpy.run_module("sr_torch.main", run_name="__main__", alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "launches": {n: c.launches
                                         for n, c in counters.items()}}))
"""


def _p15_cli(card: str) -> float:
    """(d) ``python -m sr_torch.main --mesh 1`` with ``SR_COORDINATOR``
    (NCCL, world 1), EDSR ×4 at full width, 2 × 20 steps on the procedural
    split phase 14 made, the synthetic test set, both exports; against the
    one-process CLI in this process with the same flags: the same files,
    the same launches, the params bit for bit. Returns the seconds."""
    t0 = time.perf_counter()
    runs = P15_DIR / "cli"

    def argv(save):
        return _cli_argv(save, "--export", "--export_torch",
                         test="synthetic") + ["--steps_per_epoch", "20",
                                              "--mesh", "1"]

    one, _, one_wall = _cli_run(argv(runs / "one"), "(d) one process",
                                tag="[15]")
    proc = subprocess.run(
        [sys.executable, "-c", _P15_CLI_CHILD, json.dumps(argv(runs / "mh"))],
        cwd=ROOT, capture_output=True, text=True, timeout=P15_TIMEOUT,
        env={**os.environ,
             "SR_COORDINATOR": f"file://{P15_DIR / 'cli_rendezvous'}",
             "SR_NUM_PROCESSES": "1", "SR_PROCESS_ID": "0"})
    check(proc.returncode == 0, f"(d) the CLI child exited "
          f"{proc.returncode}:\n{(proc.stdout + proc.stderr)[-4000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    check(child["rc"] == 0 and "[multihost] process 0/1" in proc.stdout,
          f"(d) the CLI child: rc {child['rc']}, or no '[multihost] "
          "process 0/1' line")
    check(child["launches"] == one and one["depth_to_space"] > 0,
          f"(d) launches {child['launches']}, the one-process CLI's {one}")

    def tree(run):  # TensorBoard's event files carry a host, time and pid
        return sorted(re.sub(r"events\.out\.tfevents\..*", "events", str(
            p.relative_to(run))) for p in run.rglob("*") if p.is_file())

    a, b = runs / "one" / "EDSR_x4", runs / "mh" / "EDSR_x4"
    check(tree(a) == tree(b), f"(d) run directories differ: {tree(a)} vs "
          f"{tree(b)}")
    check(_npz_equal(a / "EDSR_params.npz", b / "EDSR_params.npz"),
          "(d) the params differ from the one-process CLI's")
    seconds = time.perf_counter() - t0
    print(f"[15] (d) python -m sr_torch.main --mesh 1 with SR_COORDINATOR "
          f"(NCCL, world 1): {len(tree(b))} files, as the one-process "
          f"CLI's, params bit for bit, launches {child['launches']}; "
          f"one-process run {one_wall:.1f} s, (d) {seconds:.1f} s | {card}")
    return seconds


def phase_multigpu(card: str) -> list[dict]:
    """Phase 15: the port's data parallelism over processes and its
    sharded forward, the counterpart of ``dryrun_multichip``: (a) NCCL,
    one process through the ``SR_*`` environment, K DDP steps == the plain
    trainer's bit for bit; (b) two processes on the one card (gloo), EDSR
    f32 and SRGAN steps against the one-process run; (c)
    ``sharded_predict`` over the same two processes against the
    whole-image forward; the kernels at these paths' shapes; (d) ``python
    -m sr_torch.main --mesh 1`` with ``SR_COORDINATOR`` against the
    one-process CLI. NCCL across two or more cards needs a machine with
    them; this card runs one. Returns the kernels-line rows."""
    from sr_torch.utils.checkpoint import save_params
    from sr_torch.utils.interop import to_jax_params

    t0 = time.perf_counter()
    shutil.rmtree(P15_DIR, ignore_errors=True)
    P15_DIR.mkdir(parents=True)
    _, model = _seeded_edsr("bfloat16")
    save_params(str(P15_DIR / "edsr.npz"), to_jax_params(model))
    del model
    torch.save(torch.rand((1, *P15_LR, 3), generator=torch.Generator()
                          .manual_seed(155)), P15_DIR / "x.pt")
    a_out = P15_DIR / "a.json"
    # (a) alone on the card, so its dispatch times share it with nothing
    _p15_wait({"a": _p15_start(["a", str(a_out)], env={
        "SR_COORDINATOR": f"localhost:{_free_port()}",
        "SR_NUM_PROCESSES": "1", "SR_PROCESS_ID": "0"})})
    procs = {}
    for rank in range(2):
        procs[f"bc{rank}"] = _p15_start(
            ["bc", str(rank), str(P15_DIR / "rendezvous"),
             str(P15_DIR / f"bc{rank}")])
    try:
        ref = _p15_reference()
    finally:
        _p15_wait(procs)
    res_a = json.loads(a_out.read_text())
    check(res_a["equal"], f"(a) {P15_K} DDP steps (NCCL, world 1) differ "
          "from the plain trainer's: loss, params or generator")
    want = {"depth_to_space": 2 * P15_K, "fused_resblock": 0,
            "int8_conv": 0}
    check(res_a["launches"] == want, f"(a) launches {res_a['launches']}, "
          f"want {want}")
    print(f"[15] (a) EDSR x4 bf16 crop {TRAIN_CROP} b{TRAIN_BATCH}, NCCL "
          f"world 1 through SR_COORDINATOR: {P15_K} DDP steps == the plain "
          f"trainer's bit for bit (loss {res_a['loss']:.6f}, params, "
          f"generator), {res_a['launches']['depth_to_space']} shuffles; a "
          f"K={P15_K} dispatch alone on the card, the median of {P15_REPS} "
          f"after one warm-up: {res_a['ms']['plain']:.1f} ms plain, "
          f"{res_a['ms']['ddp']:.1f} ms DDP | {card}")
    res = [json.loads((P15_DIR / f"bc{r}").read_text()) for r in range(2)]
    outs = [torch.load(P15_DIR / f"bc{r}.pt", weights_only=False)
            for r in range(2)]
    _p15_check_b(card, res, outs, ref)
    outs = [torch.load(P15_DIR / f"bc{r}.sharded.pt") for r in range(2)]
    _p15_check_c(card, res, outs, ref)
    del ref, outs
    torch.cuda.empty_cache()
    check(res[0]["edsr_per_shape"] == res[1]["edsr_per_shape"],
          "(b) the processes launched at different shapes")
    measured = {"a": res_a["per_shape"]}  # (b), (c): both processes'
    for path, key in (("b", "edsr"), ("exact", "exact"),
                      ("static", "static")):
        measured[path] = dict(sum((collections.Counter(
            r[f"{key}_per_shape"]) for r in res), collections.Counter()))
    rows = _p15_kernel_rows(card, measured)
    d_s = _p15_cli(card)
    print(f"[15] phase seconds {time.perf_counter() - t0:.1f} ((d) "
          f"{d_s:.1f}) | {card}")
    return rows


BENCH_KEYS = ("value", "vs_baseline", "bf16_exact_mps", "bf16_fused_mps",
              "bf16_fused_vs_baseline", "bf16_best_mps")


def _bench_shapes_exact(card: str) -> None:
    """Each kernel at the bench's large batch and the shapes its serving
    variants give it, against its plain version on the card: the shuffle
    (bf16) at the exact graph's two r=2 stages and the fused tails' r=4,
    with and without bias (the second stage's 3.2e9 elements pass 2^31);
    the resblock within phase 3's tolerance; the fused int8 entry at the
    int8-static fused path's head, body and collapsed-tail sites, bit for
    bit (:func:`_int8_exact`)."""
    from sr_torch import bench
    from sr_torch.kernels.fused_resblock import (
        fused_resblock, fused_resblock_plain)

    gen = torch.Generator(device="cuda").manual_seed(9)
    b, n = bench.B_LARGE, bench.LR_SIZE
    for h, cin, r in D2S_SHAPES:
        x, bias = _d2s_operands((b, h, h, cin), torch.bfloat16, gen, True)
        _d2s_exact(x, r, bias)
        del x, bias
        torch.cuda.empty_cache()
    ops = _resblock_operands((b, n, n, 64), torch.bfloat16, gen)
    got = fused_resblock(*_kernel_operands(ops))
    err = float((got.float() - fused_resblock_plain(*ops).float())
                .abs().max())
    check(err <= TOL[torch.bfloat16],
          f"fused_resblock disagrees at {(b, n, n, 64)}: {err}")
    del ops, got
    sites = [s for s in INT8_SHAPES
             if s[0] in ("head", "body", "fused-quant tail")]
    for name, _, _, _, c, n_out, k in sites:
        _int8_exact(gen, name, (b, n, n, c), n_out, k)
        torch.cuda.empty_cache()
    print(f"[9] at b{b}: depth_to_space == plain at "
          f"{[(b, h, h, cin, r) for h, cin, r in D2S_SHAPES]} bf16 with and "
          f"without bias; fused_resblock {(b, n, n, 64)} bf16 max |kernel - "
          f"plain| {err:.3g} (tol {TOL[torch.bfloat16]}); int8_conv fused "
          f"entry == plain at {[s[0] for s in sites]} | {card}")


def phase_bench(card: str, entries: list[dict]) -> None:
    """Phase 9: ``sr_torch.bench``'s whole measurement in process, with its
    own constants, the counts zeroed just before and read just after (all
    three kernels must run); its JSON line on a line of its own, every key
    present and positive. Each kernel is first held against its plain
    version at the bench's b192 shapes."""
    from sr_torch import bench
    from sr_torch.kernels.depth_to_space import depth_to_space
    from sr_torch.kernels.fused_resblock import fused_resblock
    from sr_torch.kernels.int8_conv import conv_int8_fused

    t0 = time.perf_counter()
    _bench_shapes_exact(card)
    torch.cuda.empty_cache()
    kernels = {"depth_to_space": depth_to_space,
               "fused_resblock": fused_resblock, "int8_conv": conv_int8_fused}
    for fn in kernels.values():
        fn.launches = 0
    record = bench.run()
    launches = {name: fn.launches for name, fn in kernels.items()}
    seconds = time.perf_counter() - t0
    print(json.dumps(record))
    print(f"[9] bench launches: {launches}; phase seconds {seconds:.1f} "
          f"| {card}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel did not run in the bench: {launches}")
    for name, n in launches.items():  # on each kernel's first row
        next(e for e in entries if e["name"] == name)["bench_launches"] = n
    check(record["unit"] == "MP/s" and isinstance(record["metric"], str)
          and all(record[k] > 0 for k in BENCH_KEYS),
          f"the bench record lacks a positive key: {record}")
    check(set(record["train"]) == {"EDSR", "ESPCN"} and all(
        v["steps_per_s"] > 0 and v["model_tflops"] > 0
        for v in record["train"].values()),
        f"the bench's train axis is incomplete: {record['train']}")


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
    rows, tr, state = phase_train(card, entries[0], entries[1])
    entries += rows
    entries += phase_eval(card, tr, state)
    del tr, state
    entries += phase_espcn(card)
    phase_bench(card, entries)
    torch.cuda.empty_cache()
    entries += phase_preupsample(card)
    torch.cuda.empty_cache()
    entries += phase_srresnet(card)
    torch.cuda.empty_cache()
    entries += phase_fsrcnn_lapsrn(card)
    torch.cuda.empty_cache()
    entries += phase_artifacts(card)
    torch.cuda.empty_cache()
    entries += phase_cli(card)
    torch.cuda.empty_cache()
    entries += phase_multigpu(card)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
