"""``idle_pct``: the share of a profiled solve's wall time in which nothing
ran on the card (layer: device): 100 (1 - busy / window), busy the union of
the device's activity intervals in the trace."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["device_events"] == 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
