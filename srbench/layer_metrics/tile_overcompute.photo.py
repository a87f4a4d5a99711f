"""Layer: ``sr_torch.infer.upscale`` with ``eval/tiling.py:tiled_predict``.
The LR pixels the forward ran (windows with their halos, padding tiles
included) over the LR pixels asked for, from the program's counters
``tiling.window_px`` and ``tiling.image_px`` over the process's life: a
ratio, so the set-up's and the traced segment's calls weigh as the
window's do. Read from the program's module where this process loaded
it (``sr_torch.utils.profiling.counters``); None where it has no such
counters."""

import sys


def read(ctx):
    counters = getattr(sys.modules.get("sr_torch.utils.profiling"),
                       "counters", None)
    if counters is None:
        return None
    c = counters()
    asked, run = c.get("tiling.image_px"), c.get("tiling.window_px")
    return run / asked if asked and run else None
