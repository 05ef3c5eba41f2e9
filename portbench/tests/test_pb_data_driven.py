"""A new configuration, traffic mix, window and per-layer metric are new
files and new entries: the harness finds them with no edit to a file it
has."""

import json
import os
import shutil

from portbench import harness
from portbench.tests import tiny

# a window of its own: it times a sum and judges it
COUNT_WINDOW = '''
import time
from types import SimpleNamespace


def setup(cell, seed):
    return SimpleNamespace(n=int(cell.traffic["count"]), written=0)


def run(state, seconds, profiler=None):
    t0, h0 = time.perf_counter(), time.time()
    total = sum(range(state.n))
    dt = max(time.perf_counter() - t0, 1e-9)
    return SimpleNamespace(values={"counts_per_s": state.n / dt},
                           attempted=state.n, failed=0, written=0,
                           bounds=(h0, time.time()), spans=[],
                           summary="counted", total=total)


def release(state, outcome):
    pass


def check(state, outcome):
    err = abs(outcome.total - state.n * (state.n - 1) // 2)
    return err == 0, [("sum_err", err, 0)], {"budgets": []}
'''


def snapshot(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if "BENCHMARK.json" not in p:
                out[p] = open(p, "rb").read()
    return out


def test_new_config_mix_window_and_metric_need_no_edit(tmp_path):
    root = tiny.tiny_root(tmp_path)
    before = snapshot(root)
    pkg = os.path.join(root, "portbench")
    cfg = tiny.tiny_config()
    cfg["name"] = "act_dr5_other"
    with open(os.path.join(pkg, "configs", "act_dr5_other.json"), "w") as f:
        json.dump(cfg, f)
    mix = tiny.tiny_traffic()
    mix["clusters_per_tile"] = 2
    with open(os.path.join(pkg, "traffic", "sparse.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pkg, "traffic", "counting.json"), "w") as f:
        json.dump({"window": "count", "count": 1000}, f)
    with open(os.path.join(pkg, "windows", "count.py"), "w") as f:
        f.write(COUNT_WINDOW)
    with open(os.path.join(pkg, "metrics", "chunks.search.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx['budgets']) or None\n")
    bench = harness.load_bench(root)
    bench["configs"].append(dict(bench["configs"][0], name="act_dr5_other",
                                 file="portbench/configs/"
                                      "act_dr5_other.json"))
    bench["workloads"] += [
        {"name": "other.sparse", "config": "act_dr5_other",
         "traffic": "sparse", "chips": 1, "why": "test"},
        {"name": "other.counting", "config": "act_dr5_other",
         "traffic": "counting", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dr5_mmf_search" in m.get("workloads", []):
            m["workloads"].append("other.sparse")
    bench["end_to_end"].append({"name": "counts_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["other.counting"]})
    bench["per_layer"].append({"name": "chunks.search", "unit": "chunks",
                               "better": "higher", "source":
                               "program_counter", "layer": "tile loop",
                               "moves": "search_tiles_per_s",
                               "workloads": ["other.sparse"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    bench = harness.load_bench(root)
    cell = harness.Cell(bench, "other.sparse", root)
    assert (cell.cfg["name"], cell.traffic["clusters_per_tile"]) \
        == ("act_dr5_other", 2)
    names = [m["name"] for m in harness.metrics_of(bench, cell.workload,
                                                   True)]
    assert "chunks.search" in names
    assert harness.reader("chunks.search", root)({"budgets": [1, 2]}) == 2
    res = harness.run("other.sparse", 5, 0.0, 0, device="cpu", root=root)
    assert res["correct"] and res["attempted"] == 4
    assert set(res["metrics"]) == {"search_tiles_per_s", "setup_s"}
    res = harness.run("other.counting", 5, 0.0, 0, device="cpu", root=root)
    assert res["correct"] and res["attempted"] == 1000
    assert set(res["metrics"]) == {"counts_per_s", "setup_s"}
    assert res["checks"] == {"sum_err": {"value": 0, "limit": 0}}
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
    shutil.rmtree(root)
