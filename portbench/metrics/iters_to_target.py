"""``iters_to_target``: the mean of the iterations that the window's solves
took to reach their target (layer: solver), from each ``Result.niters``.
Nothing for a solve of a fixed count."""


def read(ctx):
    if ctx.cell.traffic["kind"] != "target":
        return None
    return sum(a.niters for _, a in ctx.solves) / len(ctx.solves)
