"""The median latency of every request of the window, each timed by the
host's clock from the call to its return."""

import statistics


def read(ctx):
    lat = ctx.window.get("latencies_s")
    if not lat:
        return None
    return statistics.median(lat) * 1e3
