"""Shared arithmetic of the readers of the program's own spans and
counters (``nemo_tpu_torch.utils.timing``): the recorder's session of
the traced window, its span records on the realtime clock inside
``ctx["window"]``, and the device's idle seconds inside spans.

A program without the recorder, or a run in which no session began in
the window, gives no session, and every reader then gives None."""

from ..trace import busy_seconds, union

# the main thread's spans that account for a pass: what the tile loop,
# a chunk and the pass's tail do (the stage report's wrappers, such as
# ``filterMapsBatched``, are left out)
PASS_PARTS = ("loop.stage_wait", "chunk.upload", "chunk",
              "loop.writer_flush", "pass.catalog_merge", "pass.mask_files")


def session(ctx):
    """The recorder's session if it began inside the window, else None."""
    try:
        from nemo_tpu_torch.utils import timing
    except ImportError:
        return None
    s = getattr(getattr(timing, "RECORDER", None), "session", None)
    lo, hi = ctx["window"]
    if s is None or not lo <= s.start <= hi:
        return None
    return s


def spans(ctx, *names):
    """The session's records named ``names`` that lie inside the window
    (None without a session)."""
    s = session(ctx)
    if s is None:
        return None
    lo, hi = ctx["window"]
    return [r for r in s.records() if r["name"] in names
            and lo <= r["start"] and r["end"] <= hi]


def wall(records):
    return sum(r["end"] - r["start"] for r in records)


def idle_inside(ctx, *names):
    """Device-idle seconds inside the union of the spans ``names``,
    clipped to the window; None without a session or a device trace."""
    found = spans(ctx, *names)
    events = ctx.get("events")
    if found is None or not events:
        return None
    lo, hi = ctx["window"]
    return sum((b - a) - busy_seconds(events, a, b)
               for a, b in union([(r["start"], r["end"]) for r in found],
                                 lo, hi))


def idle_pct_inside(ctx, *names):
    """100 x :func:`idle_inside` over the window's length."""
    idle = idle_inside(ctx, *names)
    if idle is None:
        return None
    lo, hi = ctx["window"]
    return 100.0 * idle / (hi - lo)


def idle_breakdown(ctx):
    """Device-idle seconds of the window by what the main thread was in:
    each name of :data:`PASS_PARTS` (and a chunk's idle time under its
    child spans ``chunk.step`` and ``chunk.emit``), the rest of the
    ``pass`` spans (``pass, in no part``) and the window outside every
    pass; None without a session or a device trace."""
    inPass = idle_inside(ctx, "pass")
    if inPass is None:
        return None
    lo, hi = ctx["window"]
    window = (hi - lo) - busy_seconds(ctx["events"], lo, hi)
    out = {"window": window, "outside any pass": window - inPass,
           "pass, in no part": inPass - idle_inside(ctx, *PASS_PARTS)}
    for name in PASS_PARTS + ("chunk.step", "chunk.emit"):
        out[name] = idle_inside(ctx, name)
    out["chunk, in no step or emission"] = out["chunk"] \
        - idle_inside(ctx, "chunk.step", "chunk.emit")
    return out
