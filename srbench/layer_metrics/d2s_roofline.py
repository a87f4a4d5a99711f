"""Layer: the kernel ``sr_torch/kernels/csrc/depth_to_space.cu``. The sum
of each launch's bytes bound (``srbench.counts.d2s_bound_s``: the input
read, the output written, the bias; the element type from the kernel's
template argument) over the sum of the kernel's time on the device, in
the traced segment."""

import re

from srbench.counts import d2s_bound_s
from srbench.trace import launches, roofline_pct

OP = "sr_torch::depth_to_space"
KERNEL = r"(^|\s|::)d2s_staged<"
ELEMENT = {"__nv_bfloat16": 2, "float": 4, "unsigned char": 1}


def _bound(shapes, name):
    t = re.search(r"d2s_staged<([^,>]+)", name)
    es = ELEMENT.get(t.group(1).strip()) if t else None
    return None if es is None else d2s_bound_s(shapes[0], es, bool(shapes[3]))


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(launches(ctx.trace, OP, KERNEL), _bound)
