"""Layer: ``sr_torch.infer.upscale`` with ``eval/tiling.py:tiled_predict``
(host pre- and post-processing, copies, tiling and stitching). A
request's latency less the kernel time inside its span, the median over
the traced requests: what the host adds to the device's work."""

import statistics

from srbench.trace import union_length

SPAN = "srbench.request"


def read(ctx):
    if ctx.trace is None:
        return None
    host = [(e - s) - union_length(ctx.trace.kernels, s, e)
            for name, s, e in ctx.trace.spans if name == SPAN]
    return statistics.median(host) * 1e-3 if host else None
