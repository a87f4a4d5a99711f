"""Layer: ``sr_torch.infer.upscale`` with ``eval/tiling.py:tiled_predict``.
The program's ``sr_torch::upscale.pre`` span (from the call's entry to the
forward: the model's lookup, colour conversion, bicubic, the float
conversion and the copy to the card), the median over the traced
requests. None where the program opens no such span."""

import statistics

SPAN = "sr_torch::upscale.pre"


def read(ctx):
    if ctx.trace is None:
        return None
    us = [e - s for name, _, s, e in ctx.trace.ops if name == SPAN]
    return statistics.median(us) * 1e-3 if us else None
