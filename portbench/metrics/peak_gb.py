"""``peak_gb``: ``torch.cuda.max_memory_allocated()`` over the window, X or
its store included, in GB (1e9 bytes)."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.on_card else None
