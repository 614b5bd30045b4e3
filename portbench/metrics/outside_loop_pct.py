"""``outside_loop_pct``: the share of one recorded solve's ``nnmf`` calls
spent outside their iterations (layer: front door): 100 (the ``nnmf``
spans' wall - their ``iter`` spans' wall) / the ``nnmf`` spans' wall.  The
checks, the init, the restarts' draws, the prepare and renumbering, the
final objective.  The host clock of the program's spans; nothing off the
card."""

from portbench import program_spans


def read(ctx):
    r = program_spans.readings(ctx) if ctx.on_card else None
    return None if r is None else r["outside_loop_pct"]
