"""Share of the staging worker's ``stage.tile`` wall seconds in which its
thread ran on a CPU (``thread_time_ns``); the rest it waited, on the
interpreter lock or on I/O."""

from ._spans import spans, wall


def read(ctx):
    found = spans(ctx, "stage.tile")
    if not found or wall(found) <= 0:
        return None
    return 100.0 * sum(r["cpu"] for r in found) / 1e9 / wall(found)
