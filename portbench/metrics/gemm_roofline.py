"""``gemm_roofline``: the dense products' share of their bound (layer:
kernels, ``matops.mtm(W', X)`` and ``matops.mm(X, H')`` on a dense X, as
ProjectedALS makes them), inside the program's precision scope, on the
window's X with the last solve's factors, timed by CUDA events; the bound
from ``roofline.gemm``."""

from portbench import roofline


def read(ctx):
    if not ctx.on_card or ctx.nnz is not None:
        return None
    m = ctx.nt.ops.matops
    W, H, (p, n) = ctx.last.W, ctx.last.H, ctx.shape
    with ctx.nt.config.precision_scope():
        t_wtx = roofline.time_s(lambda: m.mtm(W.T, ctx.X))
        t_xht = roofline.time_s(lambda: m.mm(ctx.X, H.T))
    return roofline.share([(roofline.gemm(p, n, ctx.k, n), t_wtx),
                           (roofline.gemm(p, n, ctx.k, p), t_xht)])
