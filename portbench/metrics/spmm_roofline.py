"""``spmm_roofline``: the store product's share of its bound (layer:
kernels, ``matops.mm`` on a ``TiledCSR``: kernels 1, 2 and the band).
``X @ D`` and ``X' @ D`` at the width the solve's products have (k, or
k times the lanes of batched restarts), on the window's store with the
last solve's factors, each timed by CUDA events; the bound from
``roofline.spmm``."""

from portbench import roofline


def read(ctx):
    if not ctx.on_card or ctx.nnz is None:
        return None
    mm, tr = ctx.nt.ops.matops.mm, ctx.nt.ops.matops.transpose
    (p, n), nnz, w = ctx.shape, ctx.nnz, ctx.k * ctx.lanes
    Dn = ctx.last.H.T.repeat(1, ctx.lanes).contiguous()  # (n, w)
    Dp = ctx.last.W.repeat(1, ctx.lanes).contiguous()  # (p, w)
    Xt = tr(ctx.X)
    with ctx.nt.config.precision_scope():
        t_fwd = roofline.time_s(lambda: mm(ctx.X, Dn))
        t_bwd = roofline.time_s(lambda: mm(Xt, Dp))
    return roofline.share([(roofline.spmm(p, n, nnz, w), t_fwd),
                           (roofline.spmm(n, p, nnz, w), t_bwd)])
