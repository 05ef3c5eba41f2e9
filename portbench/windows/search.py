"""The ``search`` window: whole first passes of the survey through
``nemo``'s entry, back to back.

One pass is what ``nemo <config>`` does for the catalog: a fresh
``startup.NemoConfig`` over the survey's maps, on a mesh of the cell's
``chips`` cards, then ``pipelines.filterMapsAndMakeCatalogs`` (the
batched engine: staging worker, batched steps, device detection, host
catalog) and the optimal catalog's files, with the pass's photometry
filters written to their cache files as a run's exit writes them.

Each pass does all the work of a first pass, and nothing an earlier pass
made is reused:

* a new ``NemoConfig`` builds new map descriptors, so no tile carries a
  preprocessed state (``_preprocessedTile``);
* every pass writes to a new output directory, so no filter, kernel or
  RMS map file of an earlier pass can be found and reloaded;
* the device filter cache (``filtercache.DEVICE_CACHE``) is emptied at
  the end of each pass, after its deferred writes have landed.

After each pass the window checks that the pass built a photometry
filter on the device for every tile and applied no given (cached)
filter, and fails the run if not.  The program's process-wide memo
tables (geometry arrays, the GNFW profile shape, memory maps of the
input files) stay warm, as they do across the chunks of one survey run.

End-to-end: ``search_tiles_per_s``, the tiles of every whole pass over
the time from the window's start to the end of its last pass.
"""

import copy
import gc
import json
import os
import shutil
import time

import numpy as np

from .. import judge, sky


def x64(cfg):
    """The configuration runs the program in float64 (nemo's ``-x``)."""
    return cfg["precision"] == "float64"


def nemo_parameters(cfg, survey, names=None):
    """The nemo configuration dict of a pass over the survey's tiles
    (``names``: a subset, in survey order)."""
    d = copy.deepcopy(cfg["nemo"])
    d["unfilteredMaps"] = [{"mapFileName": mapPath, "obsFreqGHz": freq,
                            "units": "uK", "beamFileName": beamPath}
                           for freq, mapPath, beamPath in survey.bands]
    d["surveyMask"] = survey.maskPath
    d["useTiling"] = True
    d["tileOverlapDeg"] = cfg["tileOverlapDeg"]
    d["stitchTiles"] = cfg["stitchTiles"]
    d["tileDefinitions"] = survey.tile_definitions(names)
    return d


class Pass:
    """One finished pass: its catalog, chunk budgets, the photometry
    filters it built for the judged tiles, the harness's spans around its
    calls and the bytes it wrote."""

    def __init__(self, catalog, budgets, filters, spans, written=0):
        self.written = written
        self.catalog = catalog
        self.budgets = budgets
        self.filters = filters
        self.spans = spans


def mesh(chips, device):
    """The program's tile mesh over the cell's ``chips`` devices."""
    from nemo_tpu_torch.parallel.mesh import get_mesh
    return get_mesh(int(chips), device=device)


def run_pass(params, outDir, device, judged, phot, x64=False, chips=1):
    """Run one whole pass; ``judged`` names the tiles whose photometry
    filters are kept (device tensors, read after the window)."""
    import torch
    from nemo_tpu_torch import pipelines, startup
    from nemo_tpu_torch.cli import nemo_main
    from nemo_tpu_torch.parallel import filtercache

    spans, mark = [], [time.time()]

    def span(label):
        now = time.time()
        spans.append((label, mark[0], now))
        mark[0] = now

    parDict = startup.parseConfigDict(copy.deepcopy(params))
    parDict["outputDir"] = outDir
    config = startup.NemoConfig(parDict, device=device, writeTileInfo=True,
                                verbose=False, x64=x64,
                                mesh=mesh(chips, device))
    span("entry: NemoConfig")
    catalog = pipelines.filterMapsAndMakeCatalogs(
        config, writeAreaMask=True, writeFlagMask=True, verbose=False)
    span("tile loop outside chunks (staging wait)")
    nemo_main.writeOptimalCatalog(catalog, os.path.join(
        config.rootOutDir, "%s_optimalCatalog.csv"
        % os.path.basename(outDir)))
    kept, built = {}, 0
    for name in config.tileNames:
        path = os.path.join(config.diagnosticsDir, name,
                            "filter_%s#%s.fits" % (phot, name))
        ent = filtercache.DEVICE_CACHE.get(path)
        if ent is not None:
            built += 1
            if name in judged:
                kept[name] = (ent["filt"], ent["signalNorm"])
    span("optimal catalog files")
    filtercache.flush(materialize_deferred=True)
    filtercache.DEVICE_CACHE.clear()
    if device == "cuda":
        torch.cuda.synchronize()
    span("filter cache files")
    with open(os.path.join(config.diagnosticsDir,
                           "chunk_budgets.jsonl")) as f:
        budgets = [json.loads(line) for line in f]
    spans += [("chunk: steps and host emission", b["t_wall"] - b["wall_s"],
               b["t_wall"]) for b in budgets]
    if built != len(config.tileNames) \
            or any(b.get("givenLabels", 0) for b in budgets) \
            or sum(b["nTiles"] for b in budgets) != len(config.tileNames):
        raise RuntimeError("pass %s did not build every filter afresh "
                           "(%d of %d photometry filters built)"
                           % (outDir, built, len(config.tileNames)))
    return Pass(catalog, budgets, kept, spans, tree_bytes(outDir))


def tree_bytes(path):
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def judged_tiles(survey, cfg, seed):
    """The tiles whose outputs the reference judges, drawn from the seed:
    one from each half of each engine chunk (tiles go to the engine in
    survey order, ``deviceBatchSize`` a chunk), so a fault in either
    half of a chunk's batch reaches a judged tile; where there are more
    halves than judged tiles, a draw of the halves; where fewer, the rest
    drawn from the other tiles."""
    rng = np.random.default_rng([int(seed), 7])
    k = int(cfg["judge"]["tiles"])
    n = len(survey.tiles)
    batch = max(int(cfg["nemo"]["deviceBatchSize"]), 1)
    halves = []
    for c0 in range(0, n, batch):
        c1 = min(c0 + batch, n)
        mid = c0 + max((c1 - c0) // 2, 1)
        halves += [list(range(c0, mid)), list(range(mid, c1))]
    halves = [h for h in halves if h]
    if len(halves) > k:
        halves = [halves[i] for i in sorted(rng.choice(len(halves), k,
                                                       replace=False))]
    pick = [int(rng.choice(h)) for h in halves]
    rest = [i for i in range(n) if i not in pick]
    if len(pick) < k:
        pick += [int(i) for i in rng.choice(rest, min(k - len(pick),
                                                      len(rest)),
                                            replace=False)]
    return [survey.tiles[i][0] for i in sorted(pick)]


class State:
    """What set-up hands the window: the cell, its survey, the judged
    tiles, the work directory and the bytes written so far."""

    def __init__(self, cell, seed):
        self.cell = cell
        self.cfg = cell.cfg
        self.seed = seed
        self.survey = sky.make_survey(cell.cfg, cell.traffic, seed,
                                      os.path.join(cell.workdir, "inputs"),
                                      cell.device)
        self.judged = judged_tiles(self.survey, cell.cfg, seed)
        self.written = tree_bytes(os.path.join(cell.workdir, "inputs"))

    def one_pass(self, outDir, names=None, judged=()):
        cfg = self.cfg
        return run_pass(nemo_parameters(cfg, self.survey, names), outDir,
                        self.cell.device, judged, cfg["nemo"]["photFilter"],
                        x64(cfg), self.cell.chips)


class Outcome:
    """The window's passes, its end-to-end values, and its bounds on the
    host's ``time.time()`` clock."""

    def __init__(self, passes, seconds, bounds, nTiles):
        self.passes = passes
        self.bounds = bounds
        self.values = {"search_tiles_per_s": nTiles * len(passes) / seconds}
        self.attempted = nTiles * len(passes)
        self.failed = 0
        self.written = sum(p.written for p in passes)
        self.budgets = [b for p in passes for b in p.budgets]
        self.spans = [s for p in passes for s in p.spans]
        self.summary = "%d passes, %.1f s window" % (len(passes), seconds)


def setup(cell, seed):
    """The seeded survey on disk, and one chunk of the cell's own shapes
    through a whole pass of its first ``warmup_tiles`` tiles (kernel
    builds and loads, FFT plans); the warm-up's outputs are removed."""
    state = State(cell, seed)
    names = [n for n, _, _ in
             state.survey.tiles[:int(cell.traffic["warmup_tiles"])]]
    out = os.path.join(cell.workdir, "warmup")
    state.written += state.one_pass(out, names).written
    shutil.rmtree(out, ignore_errors=True)
    return state


def run(state, seconds, profiler=None):
    """Passes back to back until ``seconds`` have passed since the
    window opened; the last pass runs to its end."""
    import torch
    cell = state.cell
    passes = []
    if cell.device == "cuda":
        torch.cuda.synchronize()
    if profiler is not None:
        profiler.start()
    t0, host0 = time.perf_counter(), time.time()
    while not passes or time.perf_counter() - t0 < seconds:
        out = os.path.join(cell.workdir, "pass%03d" % len(passes))
        passes.append(state.one_pass(out, judged=state.judged))
    window = time.perf_counter() - t0
    host1 = time.time()
    if profiler is not None:
        profiler.stop()
    return Outcome(passes, window, (host0, host1), len(state.survey.tiles))


def release(state, outcome):
    """Free what the window left on the disk and the card."""
    import torch
    for i in range(len(outcome.passes)):
        shutil.rmtree(os.path.join(state.cell.workdir, "pass%03d" % i),
                      ignore_errors=True)
    gc.collect()
    if state.cell.device == "cuda":
        torch.cuda.empty_cache()


def check(state, outcome):
    """(correct, [(name, value, limit)], context for the per-layer
    readers): the reference, after the window, against every pass's
    outputs on the judged tiles (:mod:`portbench.judge`)."""
    cfg, survey = state.cfg, state.survey
    refs = {t: judge.reference_tile(cfg, survey, t, state.cell.device)
            for t in state.judged}
    numbers = judge.judge(cfg, survey, refs, outcome.passes)
    correct, checks = judge.verdict(numbers, cfg["limits"])
    ctx = {"cfg": cfg, "budgets": outcome.budgets, "refs": refs}
    return correct, checks, ctx
