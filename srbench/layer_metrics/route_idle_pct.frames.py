"""Layer: the serving route (``sr_torch.infer.make_serving_predict`` and
what it calls). The share of the traced segment in which a
``sr_torch::route.forward`` span is open on the host and no operation
runs on the card: the part of ``device_idle_pct`` that the program's
route leaves, against the benchmark's own steps (convert, copy, wait).
None where the program opens no such span."""

from srbench.trace import idle_gaps, union_length

SPAN = "sr_torch::route.forward"


def read(ctx):
    if ctx.trace is None:
        return None
    routes = [(name, s, e) for name, _, s, e in ctx.trace.ops if name == SPAN]
    lo, hi = ctx.trace.window
    if not routes or hi <= lo:
        return None
    idle = sum(union_length(routes, s, e)
               for s, e in idle_gaps(ctx.trace.device, lo, hi))
    return 100.0 * idle / (hi - lo)
