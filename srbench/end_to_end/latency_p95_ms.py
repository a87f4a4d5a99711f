"""The 95th percentile of the latency of every request of the window,
each timed by the host's clock from the call to its return."""

import statistics


def read(ctx):
    lat = ctx.window.get("latencies_s")
    if not lat or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
