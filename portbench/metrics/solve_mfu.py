"""``solve_mfu``: the window's solves' share of the cards' float32-exact
peak (``common.PEAK_FP32_FLOPS`` times the cell's ``chips``): the
operations the solves' algorithm needs at these shapes
(``roofline.solve_flops``; on a mesh the whole matrix's, counted once, so
work that every card repeats shows as a low share) over their wall time.  It
bounds every kernel's gain: a kernel taken off the path leaves its roofline
silent, but not this."""

from portbench import roofline
from portbench.common import PEAK_FP32_FLOPS


def read(ctx):
    if not ctx.on_card:
        return None
    tr = ctx.cell.traffic
    reps = tr.get("replicates", 1)
    flops = sum(
        roofline.solve_flops(tr["alg"], ctx.shape, ctx.nnz, ctx.k, a.niters, reps, a.calls,
                             a.calls if tr["kind"] == "target" else 0)
        for _, a in ctx.solves)
    return 100.0 * flops / (sum(t for t, _ in ctx.solves) * PEAK_FP32_FLOPS * ctx.cell.chips)
