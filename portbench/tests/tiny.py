"""A tiny copy of the benchmark for CPU tests: the dr5 configuration cut to
four 200 x 288 tiles in one chunk, a 10' noise grid and three filters,
under a mix of four clusters a tile."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
LABELS = ("Arnaud_M2e14_z0p4", "Arnaud_M4e14_z0p2", "Arnaud_M1e14_z0p8")
# Limits of the tiny cells: the port runs in float64 on the CPU, so its
# numbers sit near round-off (positions through RA/dec near 1e-5 px)
LIMITS = {"filter_rel_err": 1e-7, "signorm_rel_err": 1e-9,
          "snr_err": 1e-3, "fixed_snr_err": 1e-3,
          "fixed_y_err_sigma": 1e-3, "opt_snr_err": 1e-3,
          "pos_err_arcmin_median": 1e-3, "missed": 0, "spurious": 0}


def tiny_config(name="act_dr5_mmf"):
    """The configuration ``name`` cut to 2 x 2 tiles of 200 x 288 pixels
    in one engine chunk, with a 10' noise grid and three filters; two
    tiles judged, one from each half of the chunk."""
    with open(os.path.join(PKG, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["survey"]["tile_shape"] = [200, 288]
    cfg["survey"]["tile_grid"] = [2, 2]
    cfg["nemo"]["allFilters"]["params"]["noiseParams"][
        "noiseGridArcmin"] = 10.0
    cfg["nemo"]["mapFilters"] = [f for f in cfg["nemo"]["mapFilters"]
                                 if f["label"] in LABELS]
    cfg["nemo"]["deviceBatchSize"] = 4
    cfg["judge"]["tiles"] = 2
    cfg["limits"] = dict(LIMITS)
    return cfg


def tiny_traffic():
    with open(os.path.join(PKG, "traffic", "search.json")) as f:
        traffic = json.load(f)
    traffic.update(clusters_per_tile=4, cluster_inset_pix=64,
                   cluster_stamp_pix=64, cluster_jitter_pix=5,
                   warmup_tiles=2)
    return traffic


def tiny_root(tmp):
    """A copy of the benchmark under ``tmp`` whose cells run the tiny
    configuration; returns its root."""
    root = os.path.join(str(tmp), "bench")
    shutil.copytree(PKG, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(tiny_config(c["name"]), f)
    with open(os.path.join(root, "portbench", "traffic", "search.json"),
              "w") as f:
        json.dump(tiny_traffic(), f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def tiny_cell(tmp, workdir):
    """The first cell of a tiny copy under ``tmp`` on the CPU, working in
    ``workdir``."""
    from portbench import harness
    root = tiny_root(tmp)
    bench = harness.load_bench(root)
    return harness.Cell(bench, bench["workloads"][0]["name"], root, "cpu",
                        workdir=workdir)
