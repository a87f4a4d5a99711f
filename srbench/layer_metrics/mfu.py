"""Layer: the whole forward against the chip's peak. The model's
exact-graph conv operations (the published architecture at the cell's
shapes, ``srbench.counts.model_ops``; not the route's reduced work) done
in the window, over the window's length, over the dense peak of the
route's compute type."""

from srbench.counts import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
