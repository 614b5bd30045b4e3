"""``solve_s``: the window's solve time over the solves it completed: what
a user of ``nnmf`` waits for a solve.  Host clock around each solve, which
ends in a synchronize."""


def read(ctx):
    return sum(t for t, _ in ctx.solves) / len(ctx.solves)
