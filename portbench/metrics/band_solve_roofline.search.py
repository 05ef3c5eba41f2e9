"""Share of its roofline that the batched step's band x band solve
reaches over the window: the least time of its calls
(rooflines/band_solve.py) over the device time of its library kernels in
the trace."""

from ._budget import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "band_solve")
