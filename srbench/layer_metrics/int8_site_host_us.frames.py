"""Layer: the serving route (``sr_torch.infer.make_serving_predict`` and
what it calls). The mean length of the program's ``sr_torch::int8.site``
spans in the traced segment: one int8 conv site's call on the host (its
layout and dtype casts, the scale, the fused operator's launch). None
where the program opens no such span."""

SPAN = "sr_torch::int8.site"


def read(ctx):
    if ctx.trace is None:
        return None
    us = [e - s for name, _, s, e in ctx.trace.ops if name == SPAN]
    return sum(us) / len(us) if us else None
