"""``setup_s``: seconds from the process's start to the window's: loading
the kernels (and building them, in a checkout's first run), drawing the
data, building the store, and the warm-up solve.  Host clock."""


def read(ctx):
    return ctx.setup_s
