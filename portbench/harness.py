"""One run of one benchmark cell, driven by ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<mix>.json``, a data file); the mix names its window
(``windows/<window>.py``), which makes the inputs, warms up, runs the
measured window, reports its end-to-end values and judges what the
window produced.  Each per-layer metric is a reader of its own
(``metrics/<metric>.py``, a ``read(ctx)``).  The harness finds each by
its name and only dispatches, so a new configuration, mix, window or
metric is a new file and a new entry, with no edit here.

A window module has ``setup(cell, seed) -> state`` (its bytes written in
``state.written``), ``run(state, seconds, profiler) -> outcome`` (with
``values``, ``attempted``, ``failed``, ``written``, ``bounds`` on the
host's ``time.time()`` clock, ``spans`` and ``summary``),
``release(state, outcome)`` and ``check(state, outcome) -> (correct,
[(name, value, limit)], ctx)``.
"""

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "nemo_tpu")


class CellError(RuntimeError):
    pass


def load_bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration and
    traffic mix read, the device it runs on and its work directory."""

    def __init__(self, bench, name, root=ROOT, device="cuda", workdir=None):
        wl = next((w for w in bench["workloads"] if w["name"] == name),
                  None)
        if wl is None:
            raise CellError("no workload %r in BENCHMARK.json" % name)
        self.workload = wl
        self.name = name
        self.chips = int(wl["chips"])
        self.entry = next(c for c in bench["configs"]
                          if c["name"] == wl["config"])
        with open(os.path.join(root, self.entry["file"])) as f:
            self.cfg = json.load(f)
        with open(os.path.join(root, "portbench", "traffic",
                               wl["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.root = root
        self.device = device
        self.workdir = workdir


def metrics_of(bench, wl, trace):
    """The cell's metric entries: its end-to-end metrics with ``--trace
    0``, its per-layer ones with ``--trace 1``."""
    group = "per_layer" if trace else "end_to_end"
    e2e = {m["name"] for m in bench["end_to_end"]
           if wl["name"] in m.get("workloads", [wl["name"]])}
    out = []
    for m in bench[group]:
        if "workloads" in m:
            if wl["name"] in m["workloads"]:
                out.append(m)
        elif trace and m["moves"] in e2e or not trace:
            out.append(m)
    return out


def _module(kind, name, root):
    path = os.path.join(root, "portbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.%s.%s" % (kind, name.replace(".", "_")), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name, root=ROOT):
    """The ``read`` of ``metrics/<name>.py``."""
    return _module("metrics", name, root).read


def window(name, root=ROOT):
    """The module ``windows/<name>.py``."""
    return _module("windows", name, root)


def forbidden_modules(names=None):
    """Top-level names of the loaded modules (or of ``names``) that are
    JAX's or the JAX package's, compared whole."""
    names = sys.modules if names is None else names
    return sorted({k.split(".")[0] for k in names} & set(FORBIDDEN))


def run(workload, seed, seconds, trace, device="cuda", root=ROOT,
        started=None):
    """Run one cell once; returns the result dict (the last line of the
    run's output).  ``device="cpu"`` (tests) runs the program's plain
    versions on the CPU and reports no device numbers."""
    import torch
    from . import trace as tracemod

    started = started if started is not None else time.perf_counter()
    bench = load_bench(root)
    cell = Cell(bench, workload, root, device)
    if device == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            raise CellError("the cell needs %d CUDA device(s); %d visible"
                            % (cell.chips, torch.cuda.device_count()
                               if torch.cuda.is_available() else 0))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    win = window(cell.traffic["window"], root)
    cell.workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        state = win.setup(cell, seed)
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - started
        prof = tracemod.profiler() if trace else None
        out = win.run(state, seconds, prof)
        memPeak = int(torch.cuda.max_memory_allocated()) \
            if device == "cuda" else 0
        lo, hi = out.bounds
        events = tracemod.device_events(prof, cell.workdir, lo) \
            if trace else None
        win.release(state, out)

        # the reference, once the window has closed
        correct, checks, ctx = win.check(state, out)
        ctx.update(events=events, window=(lo, hi))
        vals = dict(out.values, setup_s=setup_s)
        metrics = {}
        for m in metrics_of(bench, cell.workload, trace):
            if trace:
                v = reader(m["name"], root)(ctx)
            elif m["name"] in vals:
                v = vals[m["name"]]
            else:
                raise CellError("window %r reports no %s"
                                % (cell.traffic["window"], m["name"]))
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev = {"platform": "gpu" if device == "cuda" else "cpu",
               "kind": torch.cuda.get_device_name(0) if device == "cuda"
               else "cpu", "count": cell.chips,
               "memory_peak_bytes": memPeak}
        result = {"correct": bool(correct), "attempted": out.attempted,
                  "failed": out.failed, "metrics": metrics, "device": dev}
        if trace:
            dev["busy_s"] = tracemod.busy_seconds(events, lo, hi)
            dev["window_s"] = hi - lo
            result["breakdown"] = {
                "device_ops": tracemod.top_ops(events),
                "idle_gaps": tracemod.idle_gaps(events, lo, hi, out.spans)}
        result["checks"] = {n: {"value": v, "limit": lim}
                            for n, v, lim in checks}
        print("portbench: %s, %d bytes written"
              % (out.summary, state.written + out.written), file=sys.stderr)
        return result
    finally:
        shutil.rmtree(cell.workdir, ignore_errors=True)


def main(argv=None, started=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, args.trace,
                     started=started)
    except CellError as exc:
        print("portbench: %s" % exc, file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print("portbench: the run loaded %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result):
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print("check %s %.6g limit %s" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
