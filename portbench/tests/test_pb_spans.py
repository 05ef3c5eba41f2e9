"""The readers of the program's own spans and counters: a recorded session
of the recorder (``nemo_tpu_torch.utils.timing``) and a recorded device
trace give each reader a value computed by hand; without a session, or
with one that began outside the window, each gives None; and a CPU
rehearsal of the tiny cell under a CPU profiler gives every reader a
value."""

import pytest
import torch

from nemo_tpu_torch.utils import timing
from portbench import harness
from portbench.metrics import _spans
from portbench.tests import tiny

NEW = ("stage_s_per_tile.search", "stage_cpu_pct.search",
       "idle_on_stage_wait_pct.search", "idle_in_emit_pct.search",
       "pass_tail_s_per_pass.search", "beam_reads_per_tile.search")
WINDOW = (10.0, 20.0)
# (name, thread, start, end, cpu seconds) on the realtime clock
SPANS = [("pass", "MainThread", 10.5, 19.5, 5.0),
         ("stage.tile", "stage_0", 11.0, 12.0, 0.6),
         ("stage.tile", "stage_0", 12.0, 14.0, 0.4),
         ("stage.tile", "stage_0", 19.8, 20.5, 0.1),   # ends after it
         ("loop.stage_wait", "MainThread", 11.0, 12.5, 0.0),
         ("loop.stage_wait", "MainThread", 13.0, 14.0, 0.0),
         ("chunk", "MainThread", 14.5, 18.0, 3.0),
         ("chunk.emit", "MainThread", 15.0, 16.0, 1.0),
         ("chunk.emit", "MainThread", 17.0, 18.0, 1.0),
         ("loop.writer_flush", "MainThread", 18.0, 18.5, 0.1),
         ("pass.catalog_merge", "MainThread", 18.5, 19.0, 0.5),
         ("pass.mask_files", "MainThread", 19.0, 19.2, 0.2)]
EVENTS = [("k1", 11.5, 12.0), ("k2", 15.5, 16.5)]


def recorded(startS=WINDOW[0]):
    """A session whose perf_counter 0 is realtime ``startS``."""
    s = timing.Session()
    s.clock = [(0, int(startS * 1e9))]
    for i, (name, thread, a, b, cpu) in enumerate(SPANS):
        s.spans.append({"id": i, "parent": None, "name": name,
                        "thread": thread,
                        "tid": 1 + (thread != "MainThread"),
                        "t0": int((a - startS) * 1e9),
                        "t1": int((b - startS) * 1e9),
                        "cpu": int(cpu * 1e9), "attrs": {"pass": 1}})
    s.counts = {"stage.tiles": 2, "stage.beam_reads": 64}
    return s


@pytest.fixture
def session(monkeypatch):
    s = recorded()
    monkeypatch.setattr(timing.RECORDER, "session", s)
    return s


@pytest.mark.parametrize("name,value", [
    ("stage_s_per_tile.search", 1.5),
    ("stage_cpu_pct.search", 100 * 1.0 / 3.0),
    # waits [11, 12.5] and [13, 14]: 2.5 s, 0.5 of it busy
    ("idle_on_stage_wait_pct.search", 100 * 2.0 / 10.0),
    # emissions [15, 16] and [17, 18]: 2 s, 0.5 of it busy
    ("idle_in_emit_pct.search", 100 * 1.5 / 10.0),
    ("pass_tail_s_per_pass.search", 1.2),
    ("beam_reads_per_tile.search", 32.0)])
def test_reader_of_a_recorded_session(session, name, value):
    got = harness.reader(name)({"events": EVENTS, "window": WINDOW})
    assert got == pytest.approx(value, rel=1e-6)


def test_idle_breakdown_of_a_recorded_session(session):
    out = _spans.idle_breakdown({"events": EVENTS, "window": WINDOW})
    assert out["window"] == pytest.approx(10.0 - 1.5)
    # the pass [10.5, 19.5] is idle 7.5 s; its parts cover [11, 12.5],
    # [13, 14], [14.5, 19.2]: 7.2 s, 1.5 s of it busy
    assert out["outside any pass"] == pytest.approx(1.0)
    assert out["pass, in no part"] == pytest.approx(7.5 - 5.7)
    assert out["chunk"] == pytest.approx(3.5 - 1.0)
    assert out["chunk, in no step or emission"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_a_session(monkeypatch, name):
    monkeypatch.setattr(timing.RECORDER, "session", None)
    assert harness.reader(name)({"events": EVENTS,
                                 "window": WINDOW}) is None
    # a session that began outside the window is not the window's
    monkeypatch.setattr(timing.RECORDER, "session", recorded(5.0))
    assert harness.reader(name)({"events": EVENTS,
                                 "window": WINDOW}) is None


def test_readers_of_a_cpu_rehearsal(tmp_path):
    """The tiny cell's window under a CPU profiler: every new reader
    finds its spans and counters (with one recorded device interval for
    the idle shares, as the CPU has none)."""
    cell = tiny.tiny_cell(tmp_path, str(tmp_path))
    win = harness.window(cell.traffic["window"], cell.root)
    state = win.setup(cell, 2 ** 31 + 11)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    out = win.run(state, 0.0, prof)
    lo, hi = out.bounds
    ctx = {"events": [("k", lo, lo + 1e-3)], "window": (lo, hi)}
    got = {n: harness.reader(n, cell.root)(ctx) for n in NEW}
    assert all(v is not None for v in got.values()), got
    found = _spans.spans(ctx, "stage.tile")
    assert len(found) == len(state.survey.tiles)
    assert got["stage_s_per_tile.search"] > 0
    assert 0 < got["stage_cpu_pct.search"] <= 100
    assert 0 < got["idle_on_stage_wait_pct.search"] \
        + got["idle_in_emit_pct.search"] < 100
    assert got["beam_reads_per_tile.search"] > 0
    parts = _spans.idle_breakdown(ctx)
    assert parts["window"] == pytest.approx(hi - lo - 1e-3)
