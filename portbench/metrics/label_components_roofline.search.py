"""Share of its roofline that csrc/label_components.cu reaches over the
window: the least time of its calls (rooflines/label_components.py)
over its device time in the trace."""

from ._budget import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "label_components")
