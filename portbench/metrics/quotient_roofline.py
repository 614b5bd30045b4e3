"""``quotient_roofline``: the dense KL update's quotient products' share of
their bound (layer: kernels, ``matops.wtq`` and ``matops.qht``: kernels 8
and 9), on the window's X with the last solve's factors, timed by CUDA
events; the bound from ``roofline.quotient``."""

from portbench import roofline
from portbench.reference.multdiv import DELTA


def read(ctx):
    if not ctx.on_card or ctx.nnz is not None:
        return None
    m = ctx.nt.ops.matops
    W, H, (p, n) = ctx.last.W, ctx.last.H, ctx.shape
    with ctx.nt.config.precision_scope():
        t_wtq = roofline.time_s(lambda: m.wtq(ctx.X, W, H, DELTA))
        t_qht = roofline.time_s(lambda: m.qht(ctx.X, W, H, DELTA))
    return roofline.share([(roofline.quotient(p, n, ctx.k, n), t_wtq),
                           (roofline.quotient(p, n, ctx.k, p), t_qht)])
