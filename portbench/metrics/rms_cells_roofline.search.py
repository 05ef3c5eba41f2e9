"""Share of its roofline that csrc/rms_cells.cu reaches over the window:
the least time of its launches (rooflines/rms_cells.py) over its device
time in the trace."""

from ._budget import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "rms_cells")
