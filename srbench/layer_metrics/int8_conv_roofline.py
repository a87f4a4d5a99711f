"""Layer: the kernel ``sr_torch/kernels/csrc/int8_conv.cu`` (its fused
entry). The sum of each launch's bound (``srbench.counts.
int8_conv_bound_s``: 2·B·H·W·k²·C·N operations at the int8 peak, or the
float32 input and output bytes) over the sum of the kernel's time on the
device, in the traced segment."""

from srbench.counts import int8_conv_bound_s
from srbench.trace import launches, roofline_pct

OP = "sr_torch::conv_int8_fused"
KERNEL = r"(^|\s|::)conv_kernel<"


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(
        launches(ctx.trace, OP, KERNEL),
        lambda shapes, name: int8_conv_bound_s(shapes[0], shapes[1]))
