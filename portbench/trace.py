"""The device trace of a ``--trace 1`` run: torch.profiler (CUPTI) over
the window, reduced to device intervals.

Only device activity is recorded (kernels, copies, sets), so the
trace's cost on the host stays small.  The host side of the idle gaps
comes from the harness's own spans around each pass's calls into the
program and from the engine's chunk records (``chunk_budgets.jsonl``,
host wall clock).
"""

import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def device_events(prof, workdir, hostStart):
    """[(name, start_s, end_s)] of every device activity, on the host's
    ``time.time()`` clock (``hostStart``: time.time() when the profiler
    started, used where the trace's own clock is relative)."""
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    base = data.get("baseTimeNanoseconds") if isinstance(data, dict) \
        else None
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    if base is not None:
        off = base / 1e9
    elif dev and min(e["ts"] for e in dev) > 1e14:
        off = 0.0
    else:
        off = hostStart - (min(e["ts"] for e in dev) / 1e6 if dev else 0.0)
    return [(e["name"], off + e["ts"] / 1e6, off + (e["ts"] + e["dur"]) / 1e6)
            for e in dev]


def union(intervals, lo=None, hi=None):
    """Merged [start, end] intervals, clipped to [lo, hi]."""
    out = []
    for s, e in sorted((s, e) for s, e in intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(events, lo, hi):
    """Seconds in [lo, hi] in which any device activity ran."""
    return sum(e - s for s, e in union([(s, e) for _, s, e in events],
                                       lo, hi))


def top_ops(events, n=10):
    tot = {}
    for name, s, e in events:
        tot[name[:120]] = tot.get(name[:120], 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:n]]


def idle_gaps(events, lo, hi, spans, n=10):
    """Idle device seconds in [lo, hi], summed by what the host was doing
    at each gap's midpoint: the innermost of ``spans`` [(label, start,
    end)] that holds it."""
    busy = union([(s, e) for _, s, e in events], lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    tot = {}
    for s, e in gaps:
        mid = (s + e) / 2
        holding = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        label = min(holding, key=lambda sp: sp[2] - sp[1])[0] \
            if holding else "outside any span"
        tot[label] = tot.get(label, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:n]]
