#!/usr/bin/env python3
"""Compare EDSR ×4 serving MP/s between checkouts, on one card.

Times the four routes of ``chip_smoke.py`` phase 5 (bf16 exact and fused,
int8-static exact and fused; b16 128² → 512², seeded random weights, one
CUDA event pair a batch, median of 20) for each checkout root given, each
in a process of its own that imports that checkout's ``chip_smoke`` and
``sr_torch`` and builds its kernels, in the order given. List them
interleaved to spread the card's drift over both:

    python3 tools/serving_ab.py PARENT . . PARENT
    python3 tools/serving_ab.py --convs 1,192,160,1,4,3 PARENT . . PARENT

``--convs`` times the fused int8 conv instead, at each B,H,W,C,N,k given
(device time as ``chip_smoke.kernel_ms`` takes it; per-channel scales and
a bias, weights packed by each checkout's ``pack_weights``). Prints one
line a route (or conv) and checkout, with the card's name and power
limit. Needs the card; writes the builds into each checkout's ``build/``.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile

_CONVS = r"""
import sys
from pathlib import Path
root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))
import torch
import chip_smoke as cs
from sr_torch.kernels.int8_conv import conv_int8_fused, pack_weights

cs.phase_build()
card = cs.card_line()
gen = torch.Generator(device="cuda").manual_seed(0)
for spec in sys.argv[2:]:
    b, h, w, c, n, k = (int(v) for v in spec.split(","))
    q_w = torch.randint(-127, 128, (k, k, c, n), device="cuda",
                        generator=gen).to(torch.int8)
    x, scale, dequant, bias = cs._fused_operands(gen, (b, h, w, c), n,
                                                 "per_channel")
    packed = pack_weights(q_w)
    ms = cs.kernel_ms(lambda: conv_int8_fused(x, q_w, scale, dequant, bias,
                                              packed=packed))
    print(f"[ab] {root.name or root} int8 conv ({b},{h},{w},{c})->{n} k{k}: "
          f"{ms:.4f} ms | {card}", flush=True)
"""

_CHILD = r"""
import sys
from pathlib import Path
root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))
import torch
import chip_smoke as cs
from sr_torch.infer import make_serving_predict
from sr_torch.utils.checkpoint import load_params, save_params
from sr_torch.utils.interop import from_jax_params, to_jax_params

cs.phase_build()
card = cs.card_line()
_, model = cs._seeded_edsr("bfloat16")
path = Path(sys.argv[2]) / "edsr.npz"
save_params(str(path), to_jax_params(model))
_, model = cs._seeded_edsr("bfloat16")
model = from_jax_params(model, load_params(str(path))[0]).cuda().eval()
x = torch.rand((16, 128, 128, 3), device="cuda",
               generator=torch.Generator(device="cuda").manual_seed(0))
mp = 16 * 512 * 512 / 1e6
with torch.inference_mode():
    routes = [("bf16 exact", dict(fused=False)),
              ("bf16 fused", dict(fused=True)),
              ("int8-static exact", dict(fused=False, quantize="static")),
              ("int8-static fused", dict(fused=True, quantize="static"))]
    for name, kw in routes:
        fused = kw.pop("fused")
        if kw:
            fn = make_serving_predict(model, fused, calib_headroom=1.25, **kw)
            fn.calibrate([x])
        else:
            fn = make_serving_predict(model, fused)
        ms = cs.time_ms(lambda: fn(x), n=20)
        print(f"[ab] {root.name or root} {name}: {ms:.3f} ms/batch, "
              f"{mp / ms * 1e3:.1f} MP/s | {card}", flush=True)
"""


def main(argv: list[str]) -> int:
    convs = []
    if argv[:1] == ["--convs"]:
        convs, argv = argv[1].split(), argv[2:]
    rc = 0
    with tempfile.TemporaryDirectory() as d:  # the seeded params
        for root in argv or ["."]:
            cmd = ([sys.executable, "-c", _CONVS, root, *convs] if convs
                   else [sys.executable, "-c", _CHILD, root, d])
            rc |= subprocess.run(cmd, check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
