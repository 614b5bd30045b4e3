"""``store_build_s``: seconds of ``build_tiled`` in set-up, the store's
options as the configuration gives them (layer: store).  Host clock around
the call, which ends in a synchronize.  Nothing for a dense X."""


def read(ctx):
    return ctx.spans.get("store_build_s")
