"""Share of the window in which the device is idle during a chunk's host
emission and catalog work (the main thread's ``chunk.emit`` spans)."""

from ._spans import idle_pct_inside


def read(ctx):
    return idle_pct_inside(ctx, "chunk.emit")
