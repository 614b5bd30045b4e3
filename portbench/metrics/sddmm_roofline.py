"""``sddmm_roofline``: the store's sampled product's share of its bound
(layer: kernels, ``matops.sddmm`` on a ``TiledCSR``: kernel 4 and
``dense_sample``), on the window's store with the last solve's factors,
timed by CUDA events; the bound from ``roofline.sddmm``."""

from portbench import roofline


def read(ctx):
    if not ctx.on_card or ctx.nnz is None:
        return None
    W, H = ctx.last.W, ctx.last.H
    sddmm = ctx.nt.ops.matops.sddmm
    with ctx.nt.config.precision_scope():
        t = roofline.time_s(lambda: sddmm(W, H, ctx.X))
    return roofline.share([(roofline.sddmm(*ctx.shape, ctx.nnz, ctx.k), t)])
