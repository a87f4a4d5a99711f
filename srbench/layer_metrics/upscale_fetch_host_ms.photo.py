"""Layer: ``sr_torch.infer.upscale`` with ``eval/tiling.py:tiled_predict``.
The host's own share of the copy back: each ``sr_torch::upscale.fetch``
span (``out[0].cpu()``) less the union of device operations, kernels and
copies, inside it; the median over the traced requests. None where the
program opens no such span."""

import statistics

from srbench.trace import union_length

SPAN = "sr_torch::upscale.fetch"


def read(ctx):
    if ctx.trace is None:
        return None
    host = [(e - s) - union_length(ctx.trace.device, s, e)
            for name, _, s, e in ctx.trace.ops if name == SPAN]
    return statistics.median(host) * 1e-3 if host else None
