"""``kernels_load_s``: seconds of the first ``load_kernels()`` (layer:
build): the shared library loaded from the checkout's build directory, or
built with ``nvcc`` in a checkout's first run.  Host clock."""


def read(ctx):
    return ctx.spans.get("kernels_load_s")
