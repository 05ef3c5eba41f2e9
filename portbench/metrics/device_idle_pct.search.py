"""Share of the traced window in which no kernel, copy or set ran on the
device (the union of the device intervals, not their sum)."""


def read(ctx):
    from ..trace import busy_seconds
    events = ctx.get("events")
    if not events:
        return None
    lo, hi = ctx["window"]
    return 100.0 * (1.0 - busy_seconds(events, lo, hi) / (hi - lo))
