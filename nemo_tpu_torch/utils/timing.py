"""The port's one recorder of spans and counters, and its profiler hook.

``span(name, into=None, **attrs)`` times a region of one thread;
``count(name, n=1)`` adds to a counter.  Every span adds its wall
seconds to a per-name total (the ``nemo`` stage report and
``diagnostics/timings.json``) and, given ``into=(budget, field)``, to
that field of a budget dict (the batched engine's chunk budgets).

While a torch profiler is running in the process (the process-wide flag
``torch.autograd.profiler._is_profiler_enabled``, which every thread
reads), each span is also appended to an in-memory timeline, the
recorder's :class:`Session`, and each count to the session's tally.  A
span record holds its name, its thread's name, start and end on
``time.perf_counter_ns()``, the CPU nanoseconds its thread spent
(``time.thread_time_ns()``), its parent on the thread's stack of open
spans and its attributes: ``pass`` (the process-wide pass number that
:func:`begin_pass` bumps) on every span, ``chunk``, ``tile`` and
``label`` inherited from the parent, and its own.  The session keeps
pairs of (``time.time_ns()``, ``perf_counter_ns()``) readings, one when
it starts and one at each pass, and exports its spans on the realtime
clock the profiler's chrome trace uses (``baseTimeNanoseconds`` +
``ts``).  A session starts at the first span or count seen under a
running profiler (or at :meth:`Recorder.begin_session`) and ends at the
first seen after it stops, so two profilers with no span between share
one.  Nothing is written until asked: :func:`profile_trace` writes the
spans of its region beside its ``trace.json``.
"""

import bisect
import contextlib
import itertools
import json
import os
import threading
import time

import torch.autograd.profiler as _autograd_profiler

# attributes a span takes from the span that holds it on its thread
INHERITED = ("chunk", "tile", "label")


def _recording():
    """True while a torch profiler runs anywhere in the process."""
    return _autograd_profiler._is_profiler_enabled


class Session:
    """The timeline recorded while one profiler ran: span records (dicts
    with ``id``, ``parent``, ``name``, ``thread`` and its native ``tid``,
    ``t0``, ``t1``, ``cpu`` in nanoseconds and ``attrs``), the counts
    made meanwhile, and the clock pairs that put ``perf_counter_ns``
    readings on the realtime clock."""

    def __init__(self):
        self.spans = []
        self.counts = {}
        self.clock = []
        self.end = None
        self.mark()

    @property
    def closed(self):
        return self.end is not None

    def close(self):
        """End the session now: spans that end later are left out of
        :meth:`records`."""
        if self.end is None:
            self.end = time.perf_counter_ns()

    def mark(self):
        """Take a (perf_counter_ns, time_ns) pair."""
        self.clock.append((time.perf_counter_ns(), time.time_ns()))

    @property
    def start(self):
        """Realtime seconds at which the session started."""
        return self.clock[0][1] / 1e9

    def realtime_ns(self, perfNs):
        """A ``perf_counter_ns`` reading on the realtime clock, through
        the latest pair taken before it (the first for earlier ones)."""
        i = max(bisect.bisect_right(self.clock, (perfNs, 1 << 63)) - 1, 0)
        p, w = self.clock[i]
        return w + (perfNs - p)

    def records(self):
        """The span records that ended within the session, each with
        ``start`` and ``end`` in realtime seconds."""
        return [dict(r, start=self.realtime_ns(r["t0"]) / 1e9,
                     end=self.realtime_ns(r["t1"]) / 1e9)
                for r in list(self.spans)
                if self.end is None or r["t1"] <= self.end]

    def chrome_events(self, baseNs):
        """The spans as chrome-trace ``X`` events, one track a thread,
        ``ts`` and ``dur`` in microseconds after ``baseNs`` on the
        realtime clock."""
        pid = os.getpid()
        threads = {}
        events = []
        for r in self.records():
            threads[r["tid"]] = r["thread"]
            events.append({"ph": "X", "cat": "host_span", "name": r["name"],
                           "pid": pid, "tid": r["tid"],
                           "ts": (self.realtime_ns(r["t0"]) - baseNs) / 1e3,
                           "dur": (r["t1"] - r["t0"]) / 1e3,
                           "args": dict(r["attrs"], cpu_ms=r["cpu"] / 1e6)})
        events += [{"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": name}}
                   for tid, name in threads.items()]
        return events


class _Span:
    __slots__ = ("rec", "name", "into", "attrs", "t0", "c0", "id",
                 "parent", "session")

    def __init__(self, rec, name, into, attrs):
        self.rec = rec
        self.name = name
        self.into = into
        self.attrs = attrs

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        top = stack[-1] if stack else None
        self.session = rec._session_if_recording()
        if self.session is not None:
            attrs = {"pass": rec.passes}
            if top is not None:
                attrs.update((k, top.attrs[k]) for k in INHERITED
                             if k in top.attrs)
            attrs.update(self.attrs)
            self.attrs = attrs
            self.parent = top.id if top is not None else None
            self.id = next(rec._ids)
            self.c0 = time.thread_time_ns()
        else:
            self.id = None
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self.attrs

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec._stack().pop()
        seconds = (t1 - self.t0) / 1e9
        with rec._lock:
            rec.totals[self.name] = rec.totals.get(self.name, 0.0) + seconds
        if self.into is not None:
            budget, field = self.into
            budget[field] = budget.get(field, 0.0) + seconds
        if self.session is not None:
            self.session.spans.append({
                "id": self.id, "parent": self.parent, "name": self.name,
                "thread": threading.current_thread().name,
                "tid": threading.get_native_id(), "t0": self.t0,
                "t1": t1, "cpu": time.thread_time_ns() - self.c0,
                "attrs": self.attrs})
        return False


class Recorder:
    """Per-name span totals, process counters, and the session of the
    profiler that is running (or ran last).  One per process
    (:data:`RECORDER`); safe under any number of threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self.passes = 0
        self.session = None
        self.reset()

    def reset(self):
        """Zero the totals and counters and restart the report's clock
        (the session and the pass number stay)."""
        with self._lock:
            self.totals = {}
            self.counters = {}
            self._t0 = time.perf_counter()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _session_if_recording(self):
        """The open session while a profiler runs (a new one if the last
        has closed); None otherwise, closing the last."""
        session = self.session
        if not _recording():
            if session is not None:
                session.close()
            return None
        if session is None or session.closed:
            with self._lock:
                if self.session is session:
                    self.session = Session()
                session = self.session
        return session

    def begin_session(self):
        """Start a new session now (the profiler has just started)."""
        with self._lock:
            self.session = Session()
        return self.session

    def span(self, name, into=None, **attrs):
        """Context manager timing a region of the calling thread; it
        yields the span's attributes (its record's, while recording)."""
        return _Span(self, name, into, attrs)

    def count(self, name, n=1):
        """Add ``n`` to counter ``name`` (and to the session's tally
        while recording)."""
        session = self._session_if_recording()
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if session is not None:
                session.counts[name] = session.counts.get(name, 0) + n

    def begin_pass(self):
        """Bump the process-wide pass number (one a
        ``filterMapsAndMakeCatalogs``); returns it."""
        with self._lock:
            self.passes += 1
        session = self._session_if_recording()
        if session is not None:
            session.mark()
        return self.passes

    def report(self):
        """The stage report: every span name's total seconds."""
        total = time.perf_counter() - self._t0
        lines = ["... stage timings (total %.1f s):" % total]
        for name, secs in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append("      %-40s %8.2f s (%4.1f%%)"
                         % (name, secs, 100 * secs / max(total, 1e-9)))
        return "\n".join(lines)

    def to_json(self):
        return json.dumps({"total": time.perf_counter() - self._t0,
                           "stages": self.totals,
                           "counters": self.counters})


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
begin_pass = RECORDER.begin_pass


@contextlib.contextmanager
def profile_trace(logdir):
    """Capture a torch.profiler trace around a region into
    ``logdir/trace.json`` (None = no-op), and the recorder's spans of the
    region into ``logdir/spans.json``: chrome-trace ``X`` events on the
    trace's own clock (its ``baseTimeNanoseconds``), one track a thread.
    CUDA activity is traced when a card is present."""
    if logdir is None:
        yield
        return
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        session = RECORDER.begin_session()
        try:
            yield
        finally:
            session.close()
    os.makedirs(logdir, exist_ok=True)
    tracePath = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(tracePath)
    with open(tracePath) as f:
        base = json.load(f).get("baseTimeNanoseconds", 0)
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"traceEvents": session.chrome_events(base),
                   "baseTimeNanoseconds": base,
                   "counters": session.counts}, f)
