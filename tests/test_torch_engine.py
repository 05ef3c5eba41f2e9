"""The port's batched engine (``useDeviceBatching: true``) through the
pipeline, float64 on the CPU, on a small seeded tiled survey: two bands,
four ragged tiles in one padded-shape bucket, a two-scale Arnaud bank.

* host detection in the batched engine against the port's per-tile host
  engine, and device detection against the JAX package's batched pipeline
  with device detection on: amplitudes and S/N within 1e-9, positions
  within 1e-3 arcsec, the same strong detections;
* device detection against the host engine at the JAX package's own
  tolerances (the pixel-window undo runs at the padded shape there);
* the overflow fallback, chunking invariance, bank painting, the
  calibration tripwire, the filter cache FITS read by the JAX package,
  and the CLI on a tiled config with stitching and quick-look maps.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from nemo_tpu import filters as jfilters
from nemo_tpu import pipelines as jpipelines
from nemo_tpu import startup as jstartup
from nemo_tpu_torch import catalogs, filters, pipelines, startup
from nemo_tpu_torch.models import beams, profiles, sz
from nemo_tpu_torch.ops import fourier, paint
from nemo_tpu_torch.parallel import engine, filtercache
from nemo_tpu_torch.utils import fits as nfits
from nemo_tpu_torch.utils import timing
from nemo_tpu_torch.utils import wcs as nwcs
from nemo_tpu_torch.utils.tables import Table

SHAPE = (330, 560)              # 2.75 x 4.7 deg at 0.5'
PIX_ARCMIN = 0.5
BANDS = (("f150", 149.6, 1.4, 20.0), ("f090", 97.8, 2.1, 30.0))
PHOT = "Arnaud_M2e14_z0p4"


def make_survey(work, seed=7, nClusters=16):
    """Seeded two-band survey map with injected Arnaud clusters and white
    noise, written as FITS; returns the config dict (four explicit tiles
    whose clipped shapes differ by 1-2 pixels)."""
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(seed)
    w = nwcs.makeWCS(SHAPE, PIX_ARCMIN / 60.0, centreRADeg=30.0,
                     centreDecDeg=0.0)
    ys = rng.uniform(30, SHAPE[0] - 30, nClusters)
    xs = rng.uniform(30, SHAPE[1] - 30, nClusters)
    yc = rng.uniform(3.0, 6.0, nClusters)
    pixRad = np.radians(PIX_ARCMIN / 60.0)
    prof = profiles.makeArnaudModelProfile(0.4, 2e14)
    entries = []
    for band, freq, fwhm, noiseUK in BANDS:
        beamFile = os.path.join(work, "beam_%s.txt" % band)
        beams.makeGaussianBeamFile(beamFile, fwhm)
        r, v, unit = profiles.signalTemplateTable(
            prof["rDeg"], prof["prof"], beam=beamFile, amplitude=1.0)
        model = torch.zeros(SHAPE, dtype=torch.float64)
        for y, x, y0 in zip(ys, xs, yc):
            model += float(unit) * y0 * 1e-4 * paint.paint_template_centered(
                SHAPE, (pixRad, pixRad), r, v, center=(y, x))
        model = fourier.apply_pixel_window(
            sz.convertToDeltaT(model, obsFrequencyGHz=freq), pow=1.0)
        path = os.path.join(work, "sim_%s.fits" % band)
        nfits.write_image(path, model.numpy()
                          + rng.normal(0, noiseUK, SHAPE), w.header)
        entries.append({"mapFileName": path, "obsFreqGHz": freq,
                        "units": "uK", "beamFileName": beamFile})
    maskPath = os.path.join(work, "surveyMask.fits")
    nfits.write_image(maskPath, np.ones(SHAPE, dtype=np.uint8), w.header)
    return {
        "unfilteredMaps": entries, "surveyMask": maskPath,
        "thresholdSigma": 4.0, "minObjPix": 1, "findCenterOfMass": True,
        "useInterpolator": True, "rejectBorder": 0, "removeRings": False,
        "useTiling": True, "tileOverlapDeg": 0.25,
        "tileDefinitions": [
            {"tileName": "A", "RADecSection": [27.70, 30.0, -1.375, 0.0]},
            {"tileName": "B", "RADecSection": [30.0, 32.31, -1.375, 0.0]},
            {"tileName": "C", "RADecSection": [27.70, 30.01, 0.0, 1.375]},
            {"tileName": "D", "RADecSection": [30.01, 32.31, 0.0, 1.375]}],
        "allFilters": {"class": "ArnaudModelMatchedFilter",
                       "params": {"noiseParams": {"method": "dataMap",
                                                  "noiseGridArcmin": 10.0},
                                  "outputUnits": "yc",
                                  "edgeTrimArcmin": 4.0}},
        "mapFilters": [
            {"label": PHOT, "params": {"M500MSun": 2e14, "z": 0.4}},
            {"label": "Arnaud_M4e14_z0p2",
             "params": {"M500MSun": 4e14, "z": 0.2}}],
        "photFilter": PHOT}


def torch_config(cfg, outDir, **over):
    d = startup.parseConfigDict(copy.deepcopy(cfg))
    d.update(over)
    d["outputDir"] = outDir
    return startup.NemoConfig(d, device="cpu", writeTileInfo=True)


def run_torch(cfg, outDir, **over):
    config = torch_config(cfg, outDir, **over)
    cat = pipelines.filterMapsAndMakeCatalogs(config, writeAreaMask=True,
                                              writeFlagMask=True,
                                              verbose=False)
    return cat, config


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("torch_engine"))
    cfg = make_survey(work)
    host, hostConfig = run_torch(cfg, os.path.join(work, "host"))
    lean, _ = run_torch(cfg, os.path.join(work, "lean"),
                        useDeviceBatching=True, useDeviceDetection=False)
    det, detConfig = run_torch(cfg, os.path.join(work, "det"),
                               useDeviceBatching=True,
                               useDeviceDetection=True, deviceBatchSize=4)
    jcfg = copy.deepcopy(cfg)
    jcfg.update(useDeviceBatching=True, useDeviceDetection=True,
                outputDir=os.path.join(work, "jax"))
    path = os.path.join(work, "jax.yml")
    with open(path, "w") as f:
        yaml.safe_dump(jcfg, f)
    jconfig = jstartup.NemoConfig(path, writeTileInfo=True)
    jdet = jpipelines.filterMapsAndMakeCatalogs(
        jconfig, writeAreaMask=True, writeFlagMask=True, verbose=False)
    return {"cfg": cfg, "work": work, "host": host, "hostConfig": hostConfig,
            "lean": lean, "det": det, "detConfig": detConfig, "jax": jdet,
            "jaxConfig": jconfig}


def compare(ref, cat, rtol=1e-9, sepArcsec=1e-3, snrMin=5.0,
            keys=("y_c", "fixed_y_c", "SNR", "fixed_err_y_c")):
    """Every ref object at SNR > snrMin recovered at the same position,
    amplitude and S/N; the same count of strong detections."""
    assert (np.asarray(ref["SNR"]) > 6).sum() == \
        (np.asarray(cat["SNR"]) > 6).sum()
    refM, catM, seps = catalogs.crossMatch(ref, cat, radiusArcmin=0.5)
    sel = np.asarray(refM["SNR"]) > snrMin
    assert sel.sum() >= 10 and sel.sum() == (np.asarray(ref["SNR"])
                                            > snrMin).sum()
    assert float(np.max(np.asarray(seps)[sel])) * 3600 < sepArcsec
    for k in keys:
        ratio = np.asarray(catM[k])[sel] / np.asarray(refM[k])[sel]
        assert np.max(np.abs(ratio - 1)) < rtol, (k, ratio)


def test_batched_matches_host_engine(survey):
    assert len(survey["hostConfig"].tileNames) == 4
    shapes = {tuple(np.diff(np.reshape(c["clippedSection"], (2, 2)))[:, 0])
              for c in survey["hostConfig"].tileCoordsDict.values()}
    assert len(shapes) >= 3             # ragged tiles, one bucket
    compare(survey["host"], survey["lean"])


def test_device_detection_matches_jax_batched(survey):
    assert len(survey["det"]) == len(survey["jax"])
    compare(survey["jax"], survey["det"])
    # every (tile, label) pair took device detection
    with open(os.path.join(survey["detConfig"].diagnosticsDir,
                           "chunk_budgets.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert sum(r["detectTiles"] for r in recs) == 8
    assert sum(r["overflowTiles"] for r in recs) == 0


def test_device_detection_matches_host_engine(survey):
    """The JAX package's tolerances for this comparison: the in-step
    pixel-window undo runs at the padded shape, the host engine's at the
    tile shape."""
    compare(survey["host"], survey["det"], rtol=0.01, sepArcsec=0.1,
            keys=("y_c", "fixed_y_c", "fixed_err_y_c"))
    compare(survey["host"], survey["det"], rtol=1e-6, sepArcsec=0.1,
            keys=("SNR",))


def test_overflow_falls_back_to_host_detection(survey, tmp_path):
    """A tiny object budget forces every tile through the host fallback:
    nothing is truncated, and the catalog is the host-detection one."""
    cat, config = run_torch(survey["cfg"], str(tmp_path / "ovf"),
                            useDeviceBatching=True, useDeviceDetection=True,
                            deviceDetectionMaxObjects=2)
    with open(os.path.join(config.diagnosticsDir,
                           "chunk_budgets.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert sum(r["overflowTiles"] for r in recs) == 8
    assert len(cat) == len(survey["lean"])
    compare(survey["lean"], cat, rtol=1e-9, keys=("SNR",))
    # the fallback's signal maps had their pixel window undone in the
    # step, at the padded shape
    compare(survey["lean"], cat, rtol=1e-4,
            keys=("y_c", "fixed_y_c", "fixed_err_y_c"))


def test_chunking_invariance(survey, tmp_path):
    config = torch_config(survey["cfg"], str(tmp_path / "chunks"))
    f = config.parDict["mapFilters"][1]
    one = engine.batchFilterTiles(config, f, verbose=False,
                                  deviceBatchSize=4)
    chunked = engine.batchFilterTiles(config, f, verbose=False,
                                      deviceBatchSize=1)
    assert set(one) == set(chunked) == set(config.tileNames)
    for t in one:
        for k in ("data", "SNMap", "surveyMask"):
            np.testing.assert_allclose(chunked[t][k], one[t][k], rtol=1e-12,
                                       atol=1e-15)


def test_bank_painting_matches_per_template(survey, tmp_path):
    config = torch_config(survey["cfg"], str(tmp_path / "bank"))
    tileName = config.tileNames[1]
    fList = config.parDict["mapFilters"]
    mapsList = engine._preprocessTileOnce(config, tileName)
    common = engine._stage_tile_common_from_maps(mapsList)
    stacks = {}
    for mode in (True, False):
        config.parDict["bankPaintBatch"] = mode
        cache = {}
        for f in fList:
            _, st = engine._prepare_tile(config, f, tileName,
                                         templateCache=cache,
                                         mapsList=mapsList, common=common,
                                         bank=fList)
            stacks[(mode, f["label"])] = st
    for f in fList:
        b, p = stacks[(True, f["label"])], stacks[(False, f["label"])]
        np.testing.assert_array_equal(b["template"].numpy(),
                                      p["template"].numpy())
        np.testing.assert_allclose(b["calib"].numpy(), p["calib"].numpy(),
                                   rtol=1e-13, atol=1e-25)
        assert b["unitsScale"] == p["unitsScale"]


def test_calibration_tripwire(survey, tmp_path):
    """A crop whose integer peak disagrees with the step's in-graph read
    (rtol 1e-3) raises; a consistent one gives the spline norms."""
    shape = (61, 85)
    st = {"T": (None, {"shape": shape})}
    pad = (64, 90)
    rng = np.random.default_rng(9)
    crops = rng.normal(size=(1, 2, 33, 33)) * 0.01
    crops[0, :, 14:19, 14:19] += 1.0
    summed = crops[0].sum(axis=0)
    y0c, x0c = shape[0] // 2 - 16, shape[1] // 2 - 16
    peak = summed[shape[0] // 2 - y0c, shape[1] // 2 - x0c]
    norms, fRel = engine._calibNormsFromCrops(crops, np.array([1 / peak]),
                                              st, ["T"], pad)
    assert np.isfinite(norms).all()
    np.testing.assert_allclose(fRel.sum(axis=1), 1.0, rtol=1e-12)
    bad = crops.copy()
    bad[0, 0, 16, 16] *= 1.2
    with pytest.raises(RuntimeError, match="calibration crop"):
        engine._calibNormsFromCrops(bad, np.array([1 / peak]), st, ["T"],
                                    pad)


def test_filter_cache_loads_in_jax_package(survey):
    """The photometry filter's cache FITS written by the port's batched
    engine loads in nemo_tpu's loadFilter and equals the one the port's
    host engine wrote for the same tile."""
    det, host = survey["detConfig"], survey["hostConfig"]
    jconfig = survey["jaxConfig"]
    f = next(f for f in jconfig.parDict["mapFilters"] if f["label"] == PHOT)
    # the photometry filter is device-resident with its FITS deferred to
    # the process's exit (or a reader's ensure_written): write it now
    filtercache.flush(materialize_deferred=True)
    for tileName in det.tileNames:
        loaders = []
        for diag in (det.diagnosticsDir, host.diagnosticsDir):
            loader = jfilters.getFilterClass(f["class"])(
                f["label"], jconfig.unfilteredMapsDictList, f["params"],
                tileName=tileName, diagnosticsDir=diag, geometryOnly=True)
            loader.loadFilter()
            loaders.append(loader)
        bat, ref = loaders
        filtB, filtR = np.asarray(bat.filt), np.asarray(ref.filt)
        assert filtB.shape == filtR.shape
        np.testing.assert_allclose(filtB, filtR, rtol=1e-9,
                                   atol=1e-9 * np.abs(filtR).max())
        assert abs(bat.signalNorm / ref.signalNorm - 1) < 1e-9
        # the batched engine reads the fRel weights at the sub-pixel
        # template centre, the host engine at its peak pixel
        assert abs(sum(bat.fRelWeights.values()) - 1) < 1e-9
        for k in ref.fRelWeights:
            assert abs(bat.fRelWeights[k] - ref.fRelWeights[k]) < 5e-3


def test_cli_tiled_batched_run(survey, tmp_path, capsys):
    """``python -m nemo_tpu_torch.cli.nemo_main cfg.yml --device cpu`` on a
    tiled config with useDeviceBatching and stitchTiles: the optimal
    catalog, the stitched maps and the quick-look maps are written (the
    saveFilteredMaps label takes the host-detection tail)."""
    from nemo_tpu_torch.cli import nemo_main
    cfg = copy.deepcopy(survey["cfg"])
    cfg["mapFilters"][1]["params"]["saveFilteredMaps"] = True
    cfg.update(useDeviceBatching=True, stitchTiles=True,
               makeQuickLookMaps=True, chunkPipelineDepth=2,
               outputDir=str(tmp_path / "cli"))
    path = str(tmp_path / "cli.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    nemo_main.main([path, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.count("chunkPipelineDepth: ignored") == 1
    out = str(tmp_path / "cli")
    cat = Table.read(os.path.join(out, "cli_optimalCatalog.fits"))
    compare(survey["host"], cat, rtol=1e-9)
    label = cfg["mapFilters"][1]["label"]
    for rel in ("filteredMaps/stitched_%s_SNMap.fits" % label,
                "filteredMaps/stitched_%s_filteredMap.fits" % label,
                "filteredMaps/quicklook_%s_SNMap.fits" % label,
                "selFn/stitched_areaMask.fits"):
        data, _ = nfits.read_image(os.path.join(out, rel))
        assert np.isfinite(data).all() and np.abs(data).max() > 0, rel
    stitched, _ = nfits.read_image(os.path.join(
        out, "filteredMaps/stitched_%s_SNMap.fits" % label))
    assert stitched.shape == SHAPE


def test_cli_profile_traces_one_warm_chunk(survey, tmp_path, monkeypatch):
    """``nemo --profile``: the process's Fourier-route chunk of index 1 (the
    second of two chunks of two tiles) runs under torch.profiler and its
    trace lands in ``diagnostics/profile/trace.json``; no other chunk is
    traced.  The counter is process-wide, as in the JAX package, so a
    second run in the process traces nothing; its catalog equals the
    profiled run's."""
    from nemo_tpu_torch.cli import nemo_main
    monkeypatch.setattr(engine, "PROFILE_CHUNK_DIR", None)
    monkeypatch.setattr(engine, "_chunkCounter", [0])
    traced = []
    real = engine.profile_trace

    def recording(logdir):
        traced.append((engine._chunkCounter[0] - 1, logdir))
        return real(logdir)

    monkeypatch.setattr(engine, "profile_trace", recording)
    cats = {}
    for name, extra in (("profiled", ["--profile"]), ("plain", [])):
        cfg = copy.deepcopy(survey["cfg"])
        cfg.update(useDeviceBatching=True, useDeviceDetection=False,
                   outputDir=str(tmp_path / name))
        path = str(tmp_path / (name + ".yml"))
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        nemo_main.main([path, "--device", "cpu"] + extra)
        cats[name] = Table.read(str(tmp_path / name
                                    / ("%s_optimalCatalog.fits" % name)))
    profileDir = str(tmp_path / "profiled" / "diagnostics" / "profile")
    assert traced == [(1, profileDir)]
    assert engine._chunkCounter[0] == 4
    with open(os.path.join(profileDir, "trace.json")) as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0
    # the chunk's host spans, beside the trace and on its clock
    with open(os.path.join(profileDir, "spans.json")) as f:
        spans = json.load(f)
    assert spans["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    lo = min(e["ts"] for e in xs)
    hi = max(e["ts"] + e["dur"] for e in xs)
    events = [e for e in spans["traceEvents"] if e["ph"] == "X"]
    assert {"chunk", "chunk.step", "chunk.emit"} \
        <= {e["name"] for e in events}
    # the profiler's clock and the recorder's realtime export agree to
    # well under a millisecond
    for e in events:
        assert lo - 1000.0 <= e["ts"] <= e["ts"] + e["dur"] <= hi + 1000.0, e
    assert len(cats["plain"]) == len(cats["profiled"]) > 0
    for col in cats["plain"].keys():
        np.testing.assert_array_equal(np.asarray(cats["profiled"][col]),
                                      np.asarray(cats["plain"][col]),
                                      err_msg=col)


def test_spans_of_a_traced_run(survey, tmp_path, monkeypatch):
    """A batched run (two chunks of two tiles, device detection) under a
    CPU profiler: the staging spans on the worker thread, one
    ``stage.tile`` a tile and one ``stage.filter`` a (tile, filter),
    ``pass`` and ``chunk`` on every span under a chunk, each budget
    field the sum of its spans, and one ``stage.beam_reads`` a read of a
    beam file."""
    beamFiles = {m["beamFileName"] for m in survey["cfg"]["unfilteredMaps"]}
    reads = []
    loadtxt = np.loadtxt

    def counting(fname, *a, **k):
        if fname in beamFiles:
            reads.append(fname)
        return loadtxt(fname, *a, **k)

    monkeypatch.setattr(np, "loadtxt", counting)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        cat, config = run_torch(survey["cfg"], str(tmp_path / "traced"),
                                useDeviceBatching=True,
                                useDeviceDetection=True, deviceBatchSize=2)
    compare(survey["det"], cat)
    session = timing.RECORDER.session
    recs = session.records()
    byId = {r["id"]: r for r in recs}
    nTiles, nFilters = len(config.tileNames), len(survey["cfg"]["mapFilters"])
    names = [r["name"] for r in recs]
    assert names.count("stage.tile") == nTiles == 4
    assert names.count("stage.filter") == nTiles * nFilters
    assert names.count("pass") == 1
    passNo = next(r for r in recs if r["name"] == "pass")["attrs"]["pass"]
    for r in recs:
        if r["name"].startswith("stage."):
            assert r["thread"].startswith("stage"), r

    def underChunk(r):
        while r["parent"] is not None:
            r = byId[r["parent"]]
            if r["name"] == "chunk":
                return True
        return False

    inChunk = [r for r in recs if underChunk(r)]
    assert {"chunk.step", "chunk.emit", "emit.download", "emit.calib",
            "emit.catalog"} <= {r["name"] for r in inChunk}
    for r in inChunk:
        assert r["attrs"]["pass"] == passNo and "chunk" in r["attrs"], r
    with open(os.path.join(config.diagnosticsDir,
                           "chunk_budgets.jsonl")) as f:
        budgets = [json.loads(line) for line in f]
    assert [b["chunk"] for b in budgets] == [0, 1]
    for b in budgets:
        assert b["pass"] == passNo and b["t0_ns"] < b["t1_ns"]
        for field, name in (("stageWait", "loop.stage_wait"),
                            ("upload", "chunk.upload"),
                            ("step", "chunk.step"),
                            ("download", "emit.download"),
                            ("consume", "emit.catalog")):
            total = sum((r["t1"] - r["t0"]) / 1e9 for r in recs
                        if r["name"] == name
                        and r["attrs"].get("chunk") == b["chunk"])
            assert b[field] == pytest.approx(total, abs=1e-6), field
    assert session.counts["stage.tiles"] == nTiles
    assert session.counts["stage.filter_objects"] == nTiles * nFilters
    assert session.counts["stage.beam_reads"] == len(reads) > 0


def test_bank_shares_tile_state(survey, tmp_path, monkeypatch):
    """The staging worker makes a tile's flag mask and beam solid angles
    once (``_stage_tile_common_from_maps``) and every filter of the bank
    takes them: one flag-mask array a tile, bitwise the per-filter sum,
    the solid angles ``BeamProfile`` reads, no beam file read while a
    filter object is built, and a catalog (flags included: each band has
    a flag mask) bitwise that of a run in which each filter makes its
    own."""
    cfg = copy.deepcopy(survey["cfg"])
    w = nwcs.makeWCS(SHAPE, PIX_ARCMIN / 60.0, centreRADeg=30.0,
                     centreDecDeg=0.0)
    rng = np.random.default_rng(5)
    for m in cfg["unfilteredMaps"]:
        m["flagMask"] = m["mapFileName"].replace(".fits", "_flags.fits")
        nfits.write_image(m["flagMask"],
                          (rng.random(SHAPE) < 0.2).astype(np.uint8),
                          w.header)
    built, counts, readsIn = [], {}, []
    prepare, count = engine._prepare_tile, timing.count

    def recording(config, f, tileName, **k):
        filterObj, stacks = prepare(config, f, tileName, **k)
        built.append((tileName, filterObj, stacks["common"]))
        return filterObj, stacks

    def counting(name, n=1):
        counts[name] = counts.get(name, 0) + n
        if name == "stage.beam_reads":
            readsIn.append([s.name for s in timing.RECORDER._stack()])
        return count(name, n)

    monkeypatch.setattr(engine, "_prepare_tile", recording)
    monkeypatch.setattr(timing, "count", counting)

    def run(name):
        built.clear()
        counts.clear()
        readsIn.clear()
        cat, config = run_torch(cfg, str(tmp_path / name),
                                useDeviceBatching=True,
                                useDeviceDetection=True, deviceBatchSize=2)
        return cat, config, list(built), dict(counts)

    sharedCat, config, sharedBuilt, sharedCounts = run("shared")
    nFilters = len(cfg["mapFilters"])
    assert sharedCounts["stage.tile_state_shared"] \
        == sharedCounts["stage.filter_objects"] == 4 * nFilters
    assert readsIn and not any("stage.filter_object" in st
                               for st in readsIn)
    init = filters.MapFilter.__init__
    monkeypatch.setattr(
        filters.MapFilter, "__init__",
        lambda self, *a, tileState=None, **k: init(self, *a, **k))
    ownCat, _, ownBuilt, ownCounts = run("own")
    assert "stage.tile_state_shared" not in ownCounts
    solidAngles = {m["obsFreqGHz"]: beams.BeamProfile(
        beamFileName=m["beamFileName"]).solidAngle_nsr
        for m in cfg["unfilteredMaps"]}
    assert all(sa > 0 for sa in solidAngles.values())
    own = {(t, fo.label): fo for t, fo, _ in ownBuilt}
    for tileName in config.tileNames:
        objs = [(fo, common) for t, fo, common in sharedBuilt
                if t == tileName]
        assert len(objs) == nFilters
        flagMask = objs[0][1]["flagMask"]
        assert not flagMask.flags.writeable
        mapsList = engine._preprocessTileOnce(config, tileName)
        perFilter = np.zeros(flagMask.shape, dtype=int)
        for i, m in enumerate(mapsList):
            perFilter = perFilter + np.asarray(m["flagMask"]) * (i + 1)
        assert perFilter.max() == 3
        for fo, _ in objs:
            assert fo.flagMask is flagMask
            assert fo.beamSolidAnglesDict == solidAngles
            ref = own[(tileName, fo.label)]
            assert ref.flagMask is not flagMask
            for mask in (perFilter, ref.flagMask):
                assert mask.dtype == flagMask.dtype
                np.testing.assert_array_equal(mask, flagMask)
            assert ref.beamSolidAnglesDict == solidAngles
    assert len(sharedCat) == len(ownCat) > 0
    assert np.asarray(sharedCat["flags"]).max() > 0
    for col in sharedCat.keys():
        np.testing.assert_array_equal(np.asarray(sharedCat[col]),
                                      np.asarray(ownCat[col]), err_msg=col)


def test_mixed_bank_streams_and_matches(survey, tmp_path):
    """A host-only filter (the percentile RMS estimator) in a batched run
    runs tile-locally inside the streaming sink; nothing accumulates in
    the engine and the catalog is the per-tile engine's."""
    cfg = copy.deepcopy(survey["cfg"])
    cfg["mapFilters"].append(
        {"label": "Arnaud_M4e14_z0p2_pct",
         "params": {"M500MSun": 4e14, "z": 0.2,
                    "noiseParams": {"method": "dataMap",
                                    "noiseGridArcmin": 10.0,
                                    "RMSEstimator": "percentile"}}})
    ref, _ = run_torch(cfg, str(tmp_path / "host"))
    captured = []
    orig = engine.batchFilterTilesMulti

    def spy(*a, **k):
        out = orig(*a, **k)
        captured.append(out)
        return out

    engine.batchFilterTilesMulti = spy
    try:
        cat, config = run_torch(cfg, str(tmp_path / "mixed"),
                                useDeviceBatching=True)
    finally:
        engine.batchFilterTilesMulti = orig
    assert captured and not any(captured[0].values())
    assert not engine.eligibleForBatch(config.parDict["mapFilters"][2],
                                       config.parDict)
    assert len(cat) == len(ref)
    compare(ref, cat)


@pytest.mark.parametrize("key,value", [
    ("deviceBatchSize", 0), ("deviceBatchSize", 2.5),
    ("deviceDetectionMaxObjects", True), ("useDeviceDetection", "yes"),
    ("bankPaintBatch", 1)])
def test_batched_config_keys_are_validated(survey, key, value):
    cfg = copy.deepcopy(survey["cfg"])
    cfg[key] = value
    with pytest.raises(ValueError, match=key):
        startup.parseConfigDict(cfg)


def test_selfn_files_match_the_copied_writer(survey, tmp_path, monkeypatch):
    """A detect-mode run writes its photometry filter's RMS maps and the
    area and flag masks (MEFs and stitched maps), its compressed images,
    with the whole-image encoder: each file is byte for byte what the JAX
    package's per-row writer writes for the same arrays, and every row of
    them took the whole-image path."""
    from nemo_tpu.utils import fits as jfits
    calls = []
    writeImage, writeMef = nfits.write_image, nfits.write_mef

    def image(path, data, header=None, compressionType=None, **k):
        if compressionType is not None:
            calls.append(("image", path, np.array(data),
                          dict(header or {}), compressionType))
        return writeImage(path, data, header, compressionType, **k)

    def mef(path, named, headers=None, compressionType=None, **k):
        if compressionType is not None:
            calls.append(("mef", path,
                          {n: np.array(a) for n, a in named.items()},
                          {n: dict(h) for n, h in (headers or {}).items()},
                          compressionType))
        return writeMef(path, named, headers, compressionType, **k)

    monkeypatch.setattr(nfits, "write_image", image)
    monkeypatch.setattr(nfits, "write_mef", mef)
    before = dict(timing.RECORDER.counters)
    _, config = run_torch(survey["cfg"], str(tmp_path / "det"),
                          useDeviceBatching=True, useDeviceDetection=True,
                          deviceBatchSize=4)
    counted = {k: timing.RECORDER.counters.get(k, 0) - before.get(k, 0)
               for k in ("fits.rows_native", "fits.rows_fallback")}
    names = sorted(os.path.relpath(c[1], config.selFnDir) for c in calls)
    assert names == ["%s/RMSMap_%s#%s.fits" % (t, PHOT, t)
                     for t in sorted(config.tileNames)] \
        + ["areaMask.fits", "flagMask.fits", "stitched_areaMask.fits",
           "stitched_flagMask.fits"]
    rows = 0
    for kind, path, data, headers, compressionType in calls:
        ref = str(tmp_path / "ref.fits")
        if kind == "image":
            assert compressionType == ("PLIO_1" if "stitched" in path
                                       else "RICE_1")
            jfits.write_image(ref, data, headers,
                              compressionType=compressionType)
            rows += data.shape[0]
        else:
            assert compressionType == "PLIO_1" and len(data) == 4
            jfits.write_mef(ref, data, headers=headers,
                            compressionType=compressionType)
            rows += sum(a.shape[0] for a in data.values())
        with open(path, "rb") as f, open(ref, "rb") as g:
            assert f.read() == g.read(), path
    assert counted == {"fits.rows_native": rows, "fits.rows_fallback": 0}
