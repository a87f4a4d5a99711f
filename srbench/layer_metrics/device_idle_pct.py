"""Layer: the device. The share of the traced segment in which no
operation ran on the card: 100 × (1 − the union of device operations'
intervals over the segment's length)."""


def read(ctx):
    if ctx.trace is None:
        return None
    from srbench.trace import busy_idle

    busy, window = busy_idle(ctx.trace)
    return 100.0 * (1.0 - busy / window) if window > 0 else None
