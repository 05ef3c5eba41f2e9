"""A CPU rehearsal of a run (the plain kernels, the tiny configuration):
the last line is the contract's one JSON object, and each per-layer
reader gives the right number from a small recorded chunk_budgets.jsonl
and device trace.  Device numbers themselves come only from the card."""

import io
import json
from contextlib import redirect_stdout, redirect_stderr

import numpy as np
import pytest

from portbench import harness, trace
from portbench.rooflines import bound, label_components, rms_cells
from portbench.tests import tiny

BUDGETS = [
    {"stageWait": 1.0, "upload": 0.1, "step": 0.5, "download": 0.2,
     "consume": 1.5, "hostOther": 0.3, "nTiles": 16, "nLabels": 16,
     "padShape": [900, 1536], "detectLabels": 16},
    {"stageWait": 3.0, "upload": 0.1, "step": 0.7, "download": 0.4,
     "consume": 2.5, "hostOther": 0.1, "nTiles": 16, "nLabels": 16,
     "padShape": [900, 1536], "detectLabels": 16}]
# a recorded device trace: (name, start, end) on the host clock
EVENTS = [("void rms_cells_staged_kernel<float>(...)", 10.0, 10.002),
          ("label_kernel(unsigned char const*, ...)", 10.5, 10.501),
          ("Memcpy HtoD (Pageable -> Device)", 10.0015, 10.003),
          ("void fft_kernel(...)", 12.0, 12.5)]


def ctx():
    """The recorded window, with the dr5 configuration and the
    reference's clip stages and S/N maps of two judged tiles."""
    cfg = harness.Cell(harness.load_bench(), "dr5_mmf_search").cfg
    cells = rms_cells.geometry((896, 1536), (900, 1536), 80)[0].size
    sn = np.zeros((896, 1536))
    sn[:10, :10] = 5.0
    refs = {t: {f["label"]: {"stages": np.full(cells, 3.0 + i), "SN": sn}
                for f in cfg["nemo"]["mapFilters"]}
            for i, t in enumerate(("T01", "T20"))}
    return {"cfg": cfg, "budgets": BUDGETS, "events": EVENTS,
            "window": (10.0, 14.0), "refs": refs}


def least(kernel):
    """The least time of the recorded chunks' launches, in seconds."""
    return sum(bound(b, o, t)[0] for b, o, t in kernel.work(ctx()))


def test_roofline_work_of_the_recorded_chunks():
    work = rms_cells.work(ctx())
    assert len(work) == 32
    assert work[0] == rms_cells.launch(16, (896, 1536), (900, 1536), 80,
                                       3.5, 8) + ("float64",)
    work = label_components.work(ctx())
    assert len(work) == 32
    assert work[0] == label_components.call(16, (900, 1536), 16 * 100.0) \
        + ("int32",)


@pytest.mark.parametrize("name,value", [
    ("stage_wait_s_per_chunk.search", lambda: 2.0),
    ("step_s_per_chunk.search", lambda: 0.6),
    ("host_emit_s_per_chunk.search", lambda: 2.5),
    ("rms_cells_roofline.search",
     lambda: 100 * least(rms_cells) / 0.002),
    ("label_components_roofline.search",
     lambda: 100 * least(label_components) / 0.001),
    ("device_idle_pct.search", lambda: 100 * (1 - 0.504 / 4.0))])
def test_reader(name, value):
    got = harness.reader(name)(ctx())
    assert got == pytest.approx(value(), rel=1e-9)


def test_readers_of_an_empty_window():
    for m in harness.load_bench()["per_layer"]:
        assert harness.reader(m["name"])({"budgets": [], "events": None,
                                          "window": (0, 1)}) is None


def test_trace_file_to_device_events(tmp_path):
    class Prof:
        def export_chrome_trace(self, path):
            json.dump({"traceEvents": [
                {"ph": "X", "cat": "kernel", "name": "k", "ts": 1000.0,
                 "dur": 500.0},
                {"ph": "X", "cat": "cpu_op", "name": "c", "ts": 0.0,
                 "dur": 9.0},
                {"ph": "X", "cat": "gpu_memcpy", "name": "m",
                 "ts": 1250.0, "dur": 500.0}],
                "baseTimeNanoseconds": 5e9}, open(path, "w"))
    ev = trace.device_events(Prof(), str(tmp_path), 0.0)
    assert [e[0] for e in ev] == ["k", "m"]
    assert trace.busy_seconds(ev, 5.0, 6.0) == pytest.approx(750e-6)
    gaps = trace.idle_gaps(ev, 5.0, 5.002, [("host", 5.0, 5.01)])
    assert gaps[0][0] == "host"
    assert gaps[0][1] == pytest.approx(0.002 - 750e-6)


def test_cpu_rehearsal_prints_the_contract_line(tmp_path):
    root = tiny.tiny_root(tmp_path)
    cell = harness.load_bench(root)["workloads"][0]["name"]
    res = harness.run(cell, 2 ** 31 + 11, 0.0, 0, device="cpu", root=root)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(res)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(last) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(last)[-1] == "checks"
    assert last["correct"] is True
    assert set(last["metrics"]) == {"search_tiles_per_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(last["device"])
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
