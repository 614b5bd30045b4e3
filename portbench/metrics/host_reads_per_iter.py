"""``host_reads_per_iter``: the program's deliberate reads of the card
(``utils.spans.host_read``: the stop test, HALS's Hessian diagonals,
GreedyCD's active rows, the front door's checks, the objective that builds
a ``Result``) over its iterations (``iter`` spans), summed over the
``nnmf`` calls of one recorded solve (layer: solver).  Counted by the
program's recorder."""

from portbench import program_spans


def read(ctx):
    r = program_spans.readings(ctx)
    return None if r is None else r["host_reads_per_iter"]
