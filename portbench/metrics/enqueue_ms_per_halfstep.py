"""``enqueue_ms_per_halfstep``: the host's time in a half-step (the mean of
the ``half.W`` and ``half.H`` spans of one recorded solve, without the
time their ``host_read`` children wait for the card), in ms (layer:
solver).  The host clock of the program's spans; nothing off the card."""

from portbench import program_spans


def read(ctx):
    r = program_spans.readings(ctx) if ctx.on_card else None
    return None if r is None else r["enqueue_ms_per_halfstep"]
