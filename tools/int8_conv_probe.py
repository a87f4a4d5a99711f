#!/usr/bin/env python3
"""Attribute the int8 conv kernel's device time by subtraction, on the card.

Builds copies of an ``int8_conv.cu`` with parts of the kernel switched off
at run time (behind a condition on a kernel argument that never holds, so
the compiler keeps the code it guards), calls each copy's fused entry
through ctypes on the same operands, and prints its time: CUDA events
around 20 launches queued behind a sleep kernel, median of 5, beside the
card's name and power limit. The parts left out are skipped, not replaced,
so a copy's output is wrong; the times say what each part costs.

    python3 tools/int8_conv_probe.py                   # this checkout's
    python3 tools/int8_conv_probe.py --former OLD.cu   # the former design
    python3 tools/int8_conv_probe.py --class-boundary  # both shape classes

``OLD.cu`` is ``sr_torch/kernels/csrc/int8_conv.cu`` as it was before the
warp-specialised design (one block an 8 x 32 tile, weights staged per tile,
mma.sync), e.g. ``git show c9a3338:sr_torch/kernels/csrc/int8_conv.cu``;
its weights are packed (k, k, N, C padded to 64). Builds go to
``build/int8_conv_probe/``. ``--class-boundary`` builds the whole kernel
twice, with the tap-packed class up to 16 and up to 8 bytes of channels a
pixel (``SR_TAP_PACK_BYTES``), packs the weights to match, and times convs
of 8 to 16 channels in both classes. Needs the card, ``nvcc`` and this
checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sr_torch.kernels import _build  # noqa: E402
from sr_torch.kernels.ops import conv_layout, pack_conv_weights  # noqa: E402

OUT = ROOT / "build" / "int8_conv_probe"
#: (name, B, H, W, C, N, k): EDSR's body and tail at b16 128², a 9x9 over
#: one channel, one whole 96x80 image
SHAPES = (("body", 16, 128, 128, 64, 64, 3),
          ("tail 7x7", 16, 128, 128, 64, 48, 7),
          ("9x9 over one channel", 4, 272, 260, 1, 64, 9),
          ("one 96x80 image", 1, 96, 80, 64, 64, 3))
NEVER = "p.k > 99"  # a condition no launch meets: k <= 17

# the current kernel: the quantizer's fill, the products, the stores
CURRENT = {
    "quantize": ("        fill_piece<T, LOAD>(p, sm, t, row, sm.stage(st), "
                 "pc, it.x0 - half,\n                            q0, q1, "
                 "m_s, d_s);"),
    "products": "        wgmma(acc, da, desc_b);",
    "stores": "    if (x >= p.W || n >= p.N) continue;",
}
# the former kernel: input staging, weight staging, products, stores
FORMER = {
    "input staging": ("  if (one_chunk) stage(0, pieces_of(0));",
                      "        stage(c0, pieces);"),
    "weight staging": ("        for (int i = threadIdx.x; i < wrows * k * "
                       "nstage * pieces;"),
    "products": "        for (int r = 0; r < wrows; ++r) {",
    "stores": ("    const int nn = min(NT, p.N - n0);  // output channels of "
               "this N tile"),
}


def _switch(src: str, anchor: str, part: str, former: bool) -> str:
    """Put ``anchor``'s code behind DO_<part> (a macro, 0 or 1)."""
    flag = f"(DO_{part} || {NEVER})"
    if src.count(anchor) != 1:
        raise SystemExit(f"anchor for {part!r} not found once: {anchor!r}")
    if former:
        if anchor.startswith("        for (int i"):
            new = anchor.replace("i < wrows * k * nstage * pieces;",
                                 f"i < (!{flag} ? 0 : wrows * k * nstage * "
                                 "pieces);")
        elif anchor.startswith("        for (int r"):
            new = anchor.replace("r < wrows", f"r < (!{flag} ? 0 : wrows)")
        elif anchor.startswith("    const int nn"):
            new = f"    if (!{flag}) continue;\n" + anchor
        else:
            new = anchor.replace("stage(", f"if ({flag}) stage(", 1)
    elif anchor.startswith("    if (x >= p.W"):
        new = anchor.replace(") continue;", f" || !{flag}) continue;")
    else:
        new = anchor.replace(anchor.lstrip(),
                             f"if ({flag}) " + anchor.lstrip(), 1)
    return src.replace(anchor, new)


def variants(src: str, former: bool) -> dict[str, str]:
    parts = FORMER if former else CURRENT
    names = [n.replace(" ", "_").upper() for n in parts]
    for part, anchors in parts.items():
        for anchor in (anchors if isinstance(anchors, tuple) else (anchors,)):
            src = _switch(src, anchor, part.replace(" ", "_").upper(),
                          former)
    sets = {"whole": set(names)}
    for n in names:
        sets[f"{n.lower()} only"] = {n}
        sets[f"without {n.lower()}"] = set(names) - {n}
    sets["none (the pipeline alone)"] = set()
    out = {}
    for label, on in sets.items():
        defs = "".join(f"#define DO_{n} {int(n in on)}\n" for n in names)
        out[label] = defs + src
    return out


#: few-channel convs for --class-boundary: FSRCNN's 3x3 map 12->12 on 4
#: halo tiles and on one 96x80 image, and 8 and 16 channels
BOUNDARY_SHAPES = (("3x3 12->12, 4 tiles", 4, 280, 280, 12, 12, 3),
                   ("3x3 12->12, 96x80", 1, 96, 80, 12, 12, 3),
                   ("3x3 8->64", 4, 280, 280, 8, 64, 3),
                   ("5x5 16->16", 4, 280, 280, 16, 16, 5))


def build(sources: dict[str, str],
          defines: dict[str, str] | None = None) -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, src) in enumerate(sources.items()):
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        cu.write_text(src)
        extra = [f"-D{defines[label]}"] if defines else []
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *extra, "-o",
               str(so), str(cu)]
        procs[label] = (so, subprocess.Popen(cmd))
    libs = {}
    for label, (so, proc) in procs.items():
        if proc.wait():
            raise SystemExit(f"nvcc failed for {label}")
        fn = ctypes.CDLL(str(so)).sr_conv_int8_fused
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[label] = fn
    return libs


def kernel_ms(fn, n: int = 20, reps: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(2e6))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end) / n)
    return statistics.median(spans)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--former", type=Path, default=None,
                    help="probe this former int8_conv.cu instead")
    ap.add_argument("--class-boundary", action="store_true",
                    help="time few-channel convs in both shape classes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_conv_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    former = args.former is not None
    src = (args.former if former else _build.CSRC / "int8_conv.cu"
           ).read_text()
    if args.class_boundary:
        return class_boundary(src)
    libs = build(variants(src, former))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for name, b, h, w, c, n, k in SHAPES:
        x = torch.randn((b, h, w, c), device="cuda", generator=gen) * 2
        q_w = torch.randint(-127, 128, (k, k, c, n), device="cuda",
                            generator=gen).to(torch.int8)
        if former:
            kp = -(-c // 64) * 64
            packed = q_w.new_zeros((k, k, n, kp))
            packed[..., :c] = q_w.permute(0, 1, 3, 2)
        else:
            kp = conv_layout(k, c, n, torch.int8).kp
            packed = pack_conv_weights(q_w)
        scale = torch.rand(c, device="cuda", generator=gen) * 0.05 + 0.01
        mul = torch.reciprocal(scale)
        dq = torch.rand(n, device="cuda", generator=gen) * 1e-3
        bias = torch.randn(n, device="cuda", generator=gen)
        out = torch.empty((b, h, w, n), device="cuda")
        times = {}
        for label, fn in libs.items():
            def call(fn=fn):
                err = fn(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                         mul.data_ptr(), scale.data_ptr(), 0, 1,
                         dq.data_ptr(), 0, bias.data_ptr(), b, h, w, c, kp,
                         n, k, stream)
                if err:
                    raise SystemExit(f"{label}: CUDA error {err}")
            times[label] = kernel_ms(call)
        print(f"[probe] {'former' if former else 'current'} {name} "
              f"({b},{h},{w},{c})->{n} k={k}: " + ", ".join(
                  f"{label} {t:.4f}" for label, t in times.items())
              + f" ms | {card}", flush=True)
        del x, out
    return 0


def class_boundary(src: str) -> int:
    """The whole kernel with the tap-packed class up to 16 bytes of
    channels a pixel (as shipped) and up to 8, at BOUNDARY_SHAPES."""
    from sr_torch.kernels import ops

    limits = {"tap-packed up to 16 bytes": 16, "tap-packed up to 8 bytes": 8}
    libs = build({label: src for label in limits},
                 {label: f"SR_TAP_PACK_BYTES={v}"
                  for label, v in limits.items()})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    shipped = ops._TAP_PACK_BYTES
    try:
        for name, b, h, w, c, n, k in BOUNDARY_SHAPES:
            x = torch.randn((b, h, w, c), device="cuda", generator=gen) * 2
            q_w = torch.randint(-127, 128, (k, k, c, n), device="cuda",
                                generator=gen).to(torch.int8)
            scale = torch.rand(c, device="cuda", generator=gen) * 0.05 + 0.01
            mul = torch.reciprocal(scale)
            dq = torch.rand(n, device="cuda", generator=gen) * 1e-3
            bias = torch.randn(n, device="cuda", generator=gen)
            out = torch.empty((b, h, w, n), device="cuda")
            want = ops.conv_int8_fused_plain(x, q_w, scale, dq, bias)
            cells = []
            for label, fn in libs.items():
                ops._TAP_PACK_BYTES = limits[label]
                ops.conv_layout.cache_clear()
                lay = conv_layout(k, c, n, torch.int8)
                packed = pack_conv_weights(q_w)

                def call(fn=fn, lay=lay, packed=packed):
                    err = fn(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                             mul.data_ptr(), scale.data_ptr(), 0, 1,
                             dq.data_ptr(), 0, bias.data_ptr(), b, h, w, c,
                             lay.kp, n, k, stream)
                    if err:
                        raise SystemExit(f"{label}: CUDA error {err}")
                call()
                exact = torch.equal(out, want)
                cls = "tap-packed" if lay.tap_packed else "per-tap"
                cells.append(f"{label} ({cls}, {lay.taps * lay.ks} K "
                             f"steps) {kernel_ms(call):.4f} ms, "
                             f"{'==' if exact else '!='} plain")
            print(f"[probe] class boundary {name} ({b},{h},{w},{c})->{n} "
                  f"k={k}: " + "; ".join(cells) + f" | {card}", flush=True)
    finally:
        ops._TAP_PACK_BYTES = shipped
        ops.conv_layout.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
