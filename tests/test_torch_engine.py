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
from nemo_tpu_torch import catalogs, pipelines, startup
from nemo_tpu_torch.models import beams, profiles, sz
from nemo_tpu_torch.ops import fourier, paint
from nemo_tpu_torch.parallel import engine, filtercache
from nemo_tpu_torch.utils import fits as nfits
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
        assert len(json.load(f)["traceEvents"]) > 0
    assert len(cats["plain"]) == len(cats["profiled"]) > 0
    for col in cats["plain"].keys():
        np.testing.assert_array_equal(np.asarray(cats["profiled"][col]),
                                      np.asarray(cats["plain"][col]),
                                      err_msg=col)


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
