"""Shared arithmetic of the per-layer readers: a per-chunk metric is its
sum over the window's chunks divided by their count; a roofline share
takes its kernel's work from ``rooflines/<kernel>.py``."""

import importlib


def per_chunk(ctx, *keys):
    recs = ctx.get("budgets") or []
    if not recs or any(k not in r for r in recs for k in keys):
        return None
    return sum(sum(r[k] for k in keys) for r in recs) / len(recs)


def roofline_pct(ctx, kernel):
    """100 x the least time of the window's launches of ``kernel``
    (``rooflines/<kernel>.py``: its ``work(ctx)`` and the ``KERNEL_TOKEN``
    of its device name) over its device time in the trace; None where
    either is absent."""
    from ..rooflines import bound
    roof = importlib.import_module("portbench.rooflines." + kernel)
    events = ctx.get("events")
    if not events or not ctx.get("budgets") or not ctx.get("refs"):
        return None
    secs = sum(e - s for n, s, e in events if roof.KERNEL_TOKEN in n)
    work = roof.work(ctx)
    if secs <= 0 or not work:
        return None
    least = sum(bound(b, o, t)[0] for b, o, t in work)
    return 100.0 * least / secs
