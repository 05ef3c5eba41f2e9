"""Structured per-stage timing and profiling.

The reference only has scattered wall-clock prints on rank 0
(``nemo/startUp.py:282-284``, ``pipelines.py:106-107``).  Here every
pipeline stage can be timed through one registry, and a torch.profiler
trace can be captured around any region (Chrome/Perfetto trace format).
"""

import contextlib
import json
import os
import time


class StageTimer:
    """Accumulates wall-clock per named stage; printable / JSON-able."""

    def __init__(self):
        self.stages = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name):
        start = time.time()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) \
                + (time.time() - start)

    def report(self):
        total = time.time() - self._t0
        lines = ["... stage timings (total %.1f s):" % total]
        for name, secs in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            lines.append("      %-40s %8.2f s (%4.1f%%)"
                         % (name, secs, 100 * secs / max(total, 1e-9)))
        return "\n".join(lines)

    def to_json(self):
        return json.dumps({"total": time.time() - self._t0,
                           "stages": self.stages})


GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def profile_trace(logdir):
    """Capture a torch.profiler trace around a region into
    ``logdir/trace.json`` (None = no-op).  CUDA activity is traced when a
    card is present."""
    if logdir is None:
        yield
        return
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
