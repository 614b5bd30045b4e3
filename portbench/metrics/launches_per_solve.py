"""``launches_per_solve``: kernels that ran on the card in a profiled solve,
torch's and the port's alike, copies and sets left out (layer: device,
the host's enqueue).  From the trace."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["device_events"] == 0:
        return None
    return tr["launches"]
