"""Beam files read a staged tile: the session's ``stage.beam_reads`` over
its ``stage.tiles``."""

from ._spans import session


def read(ctx):
    s = session(ctx)
    if s is None or not s.counts.get("stage.tiles"):
        return None
    return s.counts.get("stage.beam_reads", 0) / s.counts["stage.tiles"]
