"""``seam_device_pct``: the share of a profiled, recorded solve's device
time launched inside the product seam's spans (``seam.mm``, ``seam.mtm``,
``seam.sddmm``, ``seam.wtq``, ``seam.qht``; layer: kernels): how much of
the solve the rooflines' entry points cover.  From the device trace, each
interval put down to the span that holds its launch call."""

from portbench import program_spans


def read(ctx):
    r = program_spans.readings(ctx)
    return None if r is None else r["seam_device_pct"]
