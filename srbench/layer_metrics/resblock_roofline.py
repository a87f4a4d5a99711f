"""Layer: the kernel ``sr_torch/kernels/csrc/fused_resblock.cu``. The sum
of each bf16 launch's bound (``srbench.counts.resblock_bound_s`` at the
shape the operator was called with) over the sum of the kernel's time on
the device, in the traced segment."""

from srbench.counts import resblock_bound_s
from srbench.trace import launches, roofline_pct

OP = "sr_torch::fused_resblock"
KERNEL = r"(^|\s|::)resblock_bf16_kernel\b"


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(launches(ctx.trace, OP, KERNEL),
                        lambda shapes, name: resblock_bound_s(shapes[0]))
