"""The control of the search cells' comparison, and the readings the
limits are set from.

The control is the reference put in the program's place and computed in
the precision below the configuration's: float32 below float64.  Its
outputs (the photometry filters, their calibration and the optimal
catalog of the judged tiles) are judged exactly as a pass of the
program is; it has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 3]

runs, in one process on the card, one whole pass of the program on each
seed's sky (the window's own entry and sizes) and the control on the
first ``--control-seeds`` of them, and prints every number of the
comparison for each, as JSON lines: the lower readings (the program) and
the upper ones (the control) of PERF.md's limits.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def control_precision(cfg):
    """The precision below the configuration's: float32 for float64."""
    return {"float64": "float32"}[cfg["precision"]]


def control_pass(cfg, survey, tiles, dev):
    """A pass-like record of the control on ``tiles``."""
    from portbench import judge
    from portbench.windows import search
    phot = cfg["nemo"]["photFilter"]
    filters, rows = {}, []
    for t in tiles:
        ref = judge.reference_tile(cfg, survey, t, dev,
                                   control=control_precision(cfg))
        filters[t] = (ref[phot]["filt"], ref[phot]["signalNorm"])
        for r in ref["rows"]:
            snr = r["fixed_SNR"] if r["fixed_SNR"] != 0 else 1e-9
            rows.append(dict(r, tileName=t,
                             fixed_err_y_c=r["fixed_y_c"] / snr))
    cat = {k: [r[k] for r in rows] for k in
           ("RADeg", "decDeg", "SNR", "template", "tileName", "fixed_y_c",
            "fixed_err_y_c")} if rows else []
    return search.Pass(cat, [], filters, [])


def readings(workload, seeds, controlSeeds, device="cuda", root=None):
    """Yield (seed, "program" or "control", numbers)."""
    import torch
    from portbench import harness, judge
    from portbench.windows import search
    root = root or harness.ROOT
    cell = harness.Cell(harness.load_bench(root), workload, root, device)
    cell.workdir = tempfile.mkdtemp(prefix="portbench-readings-")
    try:
        for i, seed in enumerate(seeds):
            t0 = time.time()
            state = search.setup(cell, seed) if i == 0 \
                else search.State(cell, seed)
            out = search.run(state, 0.0)
            search.release(state, out)
            if device == "cuda":
                torch.cuda.empty_cache()
            refs = {t: judge.reference_tile(cell.cfg, state.survey, t,
                                            device) for t in state.judged}
            nums = judge.judge(cell.cfg, state.survey, refs, out.passes)
            yield seed, "program", dict(
                nums, pass_s=out.attempted / out.values["search_tiles_per_s"],
                total_s=time.time() - t0)
            if i < controlSeeds:
                ctl = control_pass(cell.cfg, state.survey, state.judged,
                                   device)
                yield seed, "control", judge.judge(cell.cfg, state.survey,
                                                   refs, [ctl])
    finally:
        shutil.rmtree(cell.workdir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    for seed, side, nums in readings(args.workload, args.seeds,
                                     args.control_seeds):
        print(json.dumps({"seed": seed, "side": side, "numbers": nums}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
