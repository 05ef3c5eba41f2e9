"""The port's recorder of spans and counters (``utils/timing.py``): span
totals and budget fields at all times; a timeline of span records, with
parents, per-thread stacks and inherited attributes, only while a torch
profiler runs; the realtime export; the stage report's JSON."""

import json
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nemo_tpu_torch.utils import timing


def cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_without_a_profiler_keep_totals_and_no_record():
    rec = timing.Recorder()
    budget = {"step": 1.0}
    with rec.span("outer"):
        with rec.span("inner", into=(budget, "step"), tile="T"):
            time.sleep(0.002)
        rec.count("things", 3)
    assert rec.session is None
    assert set(rec.totals) == {"outer", "inner"}
    assert rec.totals["outer"] >= rec.totals["inner"] >= 0.002
    assert budget["step"] == pytest.approx(1.0 + rec.totals["inner"],
                                           abs=1e-12)
    assert rec.counters == {"things": 3}


def test_spans_under_a_profiler_are_recorded_with_parents():
    rec = timing.Recorder()
    rec.count("before")
    with cpu_profiler():
        rec.begin_pass()
        with rec.span("chunk", chunk=4):
            with rec.span("chunk.emit", label="L") as attrs:
                with rec.span("emit.catalog", tile="T"):
                    pass
                attrs["extra"] = 1
            rec.count("c", 2)
        assert timing._recording()
    assert not timing._recording()
    with rec.span("after"):
        rec.count("c")
    session = rec.session
    assert session.closed
    assert session.counts == {"c": 2}
    assert rec.counters == {"before": 1, "c": 3}
    recs = {r["name"]: r for r in session.records()}
    assert set(recs) == {"chunk", "chunk.emit", "emit.catalog"}
    assert recs["chunk"]["parent"] is None
    assert recs["chunk.emit"]["parent"] == recs["chunk"]["id"]
    assert recs["emit.catalog"]["parent"] == recs["chunk.emit"]["id"]
    assert recs["chunk"]["attrs"] == {"pass": 1, "chunk": 4}
    assert recs["chunk.emit"]["attrs"] == {"pass": 1, "chunk": 4,
                                          "label": "L", "extra": 1}
    assert recs["emit.catalog"]["attrs"] == {"pass": 1, "chunk": 4,
                                            "label": "L", "tile": "T"}
    for r in recs.values():
        assert r["thread"] == threading.current_thread().name
        assert r["t0"] <= r["t1"] and r["cpu"] >= 0
    c, e = recs["chunk"], recs["emit.catalog"]
    assert c["t0"] <= e["t0"] <= e["t1"] <= c["t1"]


def test_each_thread_keeps_its_own_stack():
    """A worker's spans are not children of the main thread's open span,
    and take neither its attributes nor its thread name."""
    rec = timing.Recorder()
    out = {}

    def work():
        with rec.span("stage.tile", tile="W"):
            with rec.span("stage.filter", label="L"):
                out["name"] = threading.current_thread().name

    with cpu_profiler():
        with rec.span("loop.stage_wait", tile="M", chunk=0):
            t = threading.Thread(target=work, name="stage_0")
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    recs = {r["name"]: r for r in rec.session.records()}
    wait, tile, filt = (recs["loop.stage_wait"], recs["stage.tile"],
                        recs["stage.filter"])
    assert tile["parent"] is None and filt["parent"] == tile["id"]
    assert tile["thread"] == filt["thread"] == out["name"] == "stage_0"
    assert wait["thread"] != "stage_0"
    assert filt["attrs"] == {"pass": 0, "tile": "W", "label": "L"}


def test_thread_cpu_time_is_the_spans_own_thread():
    """A span's ``cpu`` is its own thread's CPU time: at least what the
    thread burned inside it, and next to nothing across a sleep."""
    rec = timing.Recorder()
    with cpu_profiler():
        with rec.span("sleep"):
            time.sleep(0.05)
        with rec.span("spin"):
            c = time.thread_time_ns()
            while time.thread_time_ns() - c < 50_000_000:
                pass
    recs = {r["name"]: r for r in rec.session.records()}
    assert recs["spin"]["cpu"] >= 50_000_000
    assert recs["sleep"]["cpu"] < 25_000_000
    assert recs["sleep"]["t1"] - recs["sleep"]["t0"] >= 50_000_000


def test_exported_start_is_on_the_realtime_clock():
    """A span's start, exported through the session's clock pairs, lies
    within 2 ms of a ``time.time()`` read taken first thing inside it;
    so does a span after a pass's new pair."""
    rec = timing.Recorder()
    inside = []
    with cpu_profiler():
        for i in range(3):
            rec.begin_pass()
            with rec.span("s%d" % i):
                inside.append(time.time())
                time.sleep(0.01)
    recs = {r["name"]: r for r in rec.session.records()}
    assert len(rec.session.clock) == 4
    for i, t in enumerate(inside):
        r = recs["s%d" % i]
        assert abs(r["start"] - t) < 2e-3
        assert r["end"] - r["start"] == pytest.approx(
            (r["t1"] - r["t0"]) / 1e9, abs=1e-6)


def test_a_closed_session_leaves_out_spans_that_end_later():
    rec = timing.Recorder()
    with cpu_profiler():
        session = rec.begin_session()
        span = rec.span("open")
        span.__enter__()
        with rec.span("done"):
            pass
        session.close()
        span.__exit__(None, None, None)
    assert [r["name"] for r in session.records()] == ["done"]
    assert [r["name"] for r in session.spans] == ["done", "open"]


def test_a_new_profiler_opens_a_new_session():
    rec = timing.Recorder()
    sessions = []
    for k in range(2):
        with cpu_profiler():
            with rec.span("s", k=k):
                pass
            sessions.append(rec.session)
        rec.count("off")        # notices the flag is down
    assert sessions[0] is not sessions[1]
    assert [[r["attrs"]["k"] for r in s.records()] for s in sessions] \
        == [[0], [1]]


def test_report_and_json_keep_their_shape():
    rec = timing.Recorder()
    with rec.span("filterMaps"):
        pass
    rec.count("stage.beam_reads", 2)
    d = json.loads(rec.to_json())
    assert set(d) == {"total", "stages", "counters"}
    assert set(d["stages"]) == {"filterMaps"}
    assert d["counters"] == {"stage.beam_reads": 2}
    lines = rec.report().splitlines()
    assert lines[0].startswith("... stage timings (total ")
    assert lines[1].split()[0] == "filterMaps"
    rec.reset()
    assert rec.totals == {} and rec.counters == {}


def test_chrome_events_one_track_a_thread():
    rec = timing.Recorder()

    def work():
        with rec.span("b"):
            pass

    with cpu_profiler():
        with rec.span("a", tile="T"):
            pass
        t = threading.Thread(target=work, name="w")
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    session = rec.session
    (a,) = [r for r in session.spans if r["name"] == "a"]
    base = session.realtime_ns(a["t0"]) - 10_000_000
    events = session.chrome_events(base)
    xs = {e["name"]: e for e in events if e["ph"] == "X"}
    meta = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert set(xs) == {"a", "b"}
    assert xs["a"]["args"]["tile"] == "T"
    assert xs["a"]["ts"] == pytest.approx(10_000, abs=1e-3)
    assert xs["a"]["dur"] == pytest.approx((a["t1"] - a["t0"]) / 1e3)
    assert xs["a"]["tid"] != xs["b"]["tid"]
    assert meta == {xs["a"]["tid"]: threading.current_thread().name,
                    xs["b"]["tid"]: "w"}


def test_profile_trace_writes_spans_on_the_trace_clock(tmp_path):
    timing.RECORDER.reset()
    with timing.profile_trace(str(tmp_path)):
        with timing.span("region", chunk=1):
            (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)
    assert spans["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    lo = min(e["ts"] for e in xs)
    hi = max(e["ts"] + e["dur"] for e in xs)
    (ev,) = [e for e in spans["traceEvents"] if e["ph"] == "X"]
    assert ev["name"] == "region" and ev["args"]["chunk"] == 1
    # the profiler's clock and the recorder's realtime export agree to
    # well under a millisecond
    tol = 1000.0
    assert lo - tol <= ev["ts"] and ev["ts"] + ev["dur"] <= hi + tol
    mm = [e for e in xs if e["name"] == "aten::mm"]
    assert mm and ev["ts"] - tol <= mm[0]["ts"] \
        <= ev["ts"] + ev["dur"] + tol


def test_many_threads_lose_no_update():
    """Totals, counters, budget fields and records from more threads
    than cores, with a short switch interval, add up exactly."""
    rec = timing.Recorder()
    nThreads, nSpans = 16, 300
    budgets = [{} for _ in range(nThreads)]

    def work(k):
        for i in range(nSpans):
            with rec.span("w", into=(budgets[k], "t"), tile=k):
                rec.count("n")
                with rec.span("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profiler():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(nThreads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters["n"] == rec.session.counts["n"] == nThreads * nSpans
    recs = rec.session.records()
    assert len(recs) == 2 * nThreads * nSpans
    assert len({r["id"] for r in recs}) == len(recs)
    ws = {r["id"]: r for r in recs if r["name"] == "w"}
    for r in recs:
        if r["name"] == "inner":
            parent = ws[r["parent"]]
            assert parent["thread"] == r["thread"]
            assert parent["attrs"]["tile"] == r["attrs"]["tile"]
    total = sum(b["t"] for b in budgets)
    assert rec.totals["w"] == pytest.approx(total, rel=1e-9)
    assert total == pytest.approx(sum((r["t1"] - r["t0"]) / 1e9
                                      for r in ws.values()), rel=1e-9)
