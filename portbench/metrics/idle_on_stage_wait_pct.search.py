"""Share of the window in which the device is idle while the tile loop
waits on the staging worker (the main thread's ``loop.stage_wait``
spans)."""

from ._spans import idle_pct_inside


def read(ctx):
    return idle_pct_inside(ctx, "loop.stage_wait")
