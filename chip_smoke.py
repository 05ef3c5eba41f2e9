#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the checkout, holds it against its plain
torch version at the main path's shapes, then runs the one-tile cluster
search (nemo_tpu_torch: config -> preprocess -> matched filters -> grid
RMS / S/N -> detection -> photometry -> optimal catalog) on a seeded
two-band 896 x 1536 tile on the card in float32, and again on the CPU in
float64, and checks that both recover the injected clusters alike.

Phases (each prints one line; any failure raises, so the script exits
non-zero and prints no result):
  1 card: name and power limit (nvidia-smi), torch and CUDA versions;
  2 build: nvcc build of nemo_tpu_torch/csrc/rms_cells.cu, seconds;
  3 kernel vs plain version on the card (f64 rtol 1e-10, f32 rtol 1e-4),
    timed with CUDA events in the order plain, kernel, kernel, plain;
  4 inputs: seeded CMB + white noise + ~20 Arnaud clusters, written as
    FITS with beam files under _smoke_work/;
  5 the main path on the card (cuda, float32), with the kernel's launch
    count > 0 and the plain version's 0;
  6 the same path on the CPU (float64): clusters, positions, fixed_y_c;
  7 survey inputs: a seeded two-band map cut into 16 DR5-like tiles of
    896 x 1536 by its tileDefinitions, ~20 clusters per tile, as FITS;
  8 the batched engine on the card (float32): the 16-scale Arnaud bank of
    examples/dr5-cluster-search.yml over one 16-tile chunk with device
    detection, run cold and warm; rms_cells launches and the largest tile
    batch it saw (16), plain calls (0), (tile, label) pairs on device
    detection and overflowed, seconds by phase, peak device memory, and
    the kernel against its plain version at the step's padded shape,
    and one more warm batched run under torch.profiler: the card's busy
    share and its largest device operations;
  9 batched against the per-tile host engine on the card, same 16 tiles,
    the photometry filter and one other scale.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.

Needs a CUDA device and nvcc; imports no JAX.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke_work")
SHAPE = (896, 1536)          # DR5-like tile: 7.5 x 12.8 deg at 0.5'
PIX_ARCMIN = 0.5
GRID_PIX = 80                # noiseGridArcmin 40 at 0.5'
N_TILES_META = 16            # the batched layout of one 16-tile step
BANDS = (("f150", 149.6, 1.4, 25.0), ("f090", 97.8, 2.1, 35.0))
N_CLUSTERS = 20
SEED = 20261016
SURVEY_GRID = (4, 4)         # rows x columns of SHAPE tiles in the survey
SURVEY_CLUSTERS = 20         # per tile
PHOT = "Arnaud_M2e14_z0p4"
# examples/dr5-cluster-search.yml: M500 (1e14 MSun) x z
DR5_BANK = [(m, z) for z in (0.2, 0.4, 0.8, 1.2) for m in (1, 2, 4, 8)]


def phase(n, msg):
    print("[phase %d] %s" % (n, msg), flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


# -- phase 3 -------------------------------------------------------------------

def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_case(noise, padded, tabs, window, rtol, reps):
    """Kernel vs plain on the card: (max_abs_err, kernel ms, plain ms)."""
    import torch
    got = noise.rms_cells(padded, *tabs, window)
    ref = noise._rms_cells_plain(padded, *tabs, window)
    torch.cuda.synchronize()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        raise RuntimeError("kernel output malformed")
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)
    err = float(np.max(np.abs(got - ref)))
    plain1 = time_ms(lambda: noise._rms_cells_plain(padded, *tabs, window),
                     reps)
    kern1 = time_ms(lambda: noise.rms_cells(padded, *tabs, window), reps)
    kern2 = time_ms(lambda: noise.rms_cells(padded, *tabs, window), reps)
    plain2 = time_ms(lambda: noise._rms_cells_plain(padded, *tabs, window),
                     reps)
    return err, (kern1 + kern2) / 2, (plain1 + plain2) / 2


def filtered_like_maps(nT):
    """Seeded maps shaped like filtered tiles: noise with a masked (zero)
    border and a zeroed corner block."""
    rng = np.random.default_rng(SEED)
    m = rng.normal(0, 1e-5, (nT,) + SHAPE)
    m[:, :20] = 0
    m[:, :, -20:] = 0
    m[:, 300:420, 500:700] = 0
    return m


def check_kernel(noise):
    import torch
    dev = torch.device("cuda")
    results = {}
    ny, nx = SHAPE
    # nT = 1, the host path's layout (grid_rms_map)
    ov, ye, xe, window, tables = noise._grid_geometry(ny, nx, GRID_PIX, None)
    m1 = filtered_like_maps(1)
    for dtype, rtol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        padded = torch.nn.functional.pad(
            torch.as_tensor(m1, dtype=dtype, device=dev),
            (ov, window[1], ov, window[0])).contiguous()
        tabs = [noise._int32_table(a, 1, dev) for a in tables]
        results[("nT1", dtype)] = kernel_case(noise, padded, tabs, window,
                                              rtol, reps=20)
    # nT = 16 on the same tile, the batched (meta) layout
    meta = noise.cell_meta_batch([SHAPE] * N_TILES_META, SHAPE, GRID_PIX)
    Wy, Wx, ov = noise.meta_window(GRID_PIX, SHAPE)
    m16 = filtered_like_maps(N_TILES_META)
    tabs = [noise._int32_table(a, N_TILES_META, dev) for a in (
        meta["startsY"], meta["startsX"],
        np.where(meta["lensY"] > 0, meta["lensY"] + 2 * ov, 0),
        np.where(meta["lensX"] > 0, meta["lensX"] + 2 * ov, 0))]
    for dtype, rtol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        padded = torch.nn.functional.pad(
            torch.as_tensor(m16, dtype=dtype, device=dev),
            (ov, Wx, ov, Wy)).contiguous()
        results[("nT16", dtype)] = kernel_case(noise, padded, tabs,
                                               (Wy, Wx), rtol, reps=3)
        del padded
    torch.cuda.empty_cache()
    return results


# -- phase 4 -------------------------------------------------------------------

def cmb_field(rng, pixRad, fwhmArcmin, shape=SHAPE):
    """Gaussian CMB-like field (uK) from the lensed D_l table, synthesised
    with numpy FFTs and beam-smoothed."""
    tab = np.loadtxt(os.path.join(ROOT, "nemo_tpu", "data",
                                  "lensed_cl_tt.txt"))
    lTab, logDl = tab[:, 0], np.log(tab[:, 1])
    ny, nx = shape
    ly = 2 * np.pi * np.fft.fftfreq(ny, d=pixRad)
    lx = 2 * np.pi * np.fft.rfftfreq(nx, d=pixRad)
    ell = np.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2)
    slope = (logDl[-1] - logDl[-2]) / (lTab[-1] - lTab[-2])
    logD = np.where(ell <= lTab[-1], np.interp(ell, lTab, logDl),
                    logDl[-1] + slope * (ell - lTab[-1]))
    safe = np.maximum(ell, 1.0)
    Cl = np.where(ell >= 2, np.exp(logD) * 2 * np.pi / (safe * (safe + 1)),
                  0.0)
    sigma = np.radians(fwhmArcmin / 60.0) / np.sqrt(8 * np.log(2))
    beam = np.exp(-0.5 * ell ** 2 * sigma ** 2)
    white = np.fft.rfft2(rng.normal(size=shape))
    return np.fft.irfft2(white * np.sqrt(Cl / pixRad ** 2) * beam, s=shape)


def make_inputs(device="cuda"):
    """Seeded two-band tile with injected clusters, painted on ``device``;
    returns (config dict, cluster table as arrays)."""
    import torch
    from nemo_tpu_torch.models import beams, profiles, sz
    from nemo_tpu_torch.ops import fourier, paint
    from nemo_tpu_torch.utils import fits as nfits
    from nemo_tpu_torch.utils import wcs as nwcs

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    rng = np.random.default_rng(SEED)
    w = nwcs.makeWCS(SHAPE, PIX_ARCMIN / 60.0, centreRADeg=30.0,
                     centreDecDeg=0.0)
    ny, nx = SHAPE
    edge = int(0.5 * 60 / PIX_ARCMIN) + 30        # >= 0.5 deg inside
    rows, cols = 4, 5                             # jittered grid
    ys = np.repeat(np.linspace(edge, ny - 1 - edge, rows), cols)
    xs = np.tile(np.linspace(edge, nx - 1 - edge, cols), rows)
    ys = ys + rng.uniform(-20, 20, ys.size)
    xs = xs + rng.uniform(-20, 20, xs.size)
    yc = rng.uniform(2.5, 5.5, N_CLUSTERS)        # 1e-4 Compton-y
    coords = np.array([w.pix2wcs(x, y) for x, y in zip(xs, ys)])
    pixRad = np.radians(PIX_ARCMIN / 60.0)
    scales = (pixRad, pixRad)
    prof = profiles.makeArnaudModelProfile(0.4, 2e14)
    cmbRng = np.random.default_rng(SEED + 1)
    cmbWhite = cmbRng.integers(0, 2 ** 31)
    entries = []
    for band, freq, fwhm, noiseUK in BANDS:
        beamFile = os.path.join(WORK, "beam_%s.txt" % band)
        beams.makeGaussianBeamFile(beamFile, fwhm)
        # one beam-convolved table per band; the painted map scales
        # linearly with the amplitude
        r, v, unitScale = profiles.signalTemplateTable(
            prof["rDeg"], prof["prof"], beam=beamFile, amplitude=1.0)
        model = torch.zeros(SHAPE, dtype=torch.float64, device=device)
        for y, x, y0 in zip(ys, xs, yc):
            model += float(unitScale) * y0 * 1e-4 \
                * paint.paint_template_centered(
                    SHAPE, scales, r, v, center=(y, x), device=device,
                    dtype=torch.float64)
        model = fourier.apply_pixel_window(
            sz.convertToDeltaT(model, obsFrequencyGHz=freq), pow=1.0)
        sky = cmb_field(np.random.default_rng(cmbWhite), pixRad, fwhm)
        sky += rng.normal(0, noiseUK, SHAPE) + model.cpu().numpy()
        path = os.path.join(WORK, "sim_%s.fits" % band)
        nfits.write_image(path, sky.astype(np.float64), w.header)
        entries.append({"mapFileName": path, "obsFreqGHz": freq,
                        "units": "uK", "beamFileName": beamFile})
    config = {
        "unfilteredMaps": entries,
        "allFilters": {"class": "ArnaudModelMatchedFilter",
                       "params": {"noiseParams": {"method": "dataMap",
                                                  "noiseGridArcmin": 40.0},
                                  "saveFilteredMaps": True,
                                  "outputUnits": "yc"}},
        "mapFilters": [
            {"label": "Arnaud_M2e14_z0p4",
             "params": {"M500MSun": 2.0e+14, "z": 0.4}},
            {"label": "Arnaud_M4e14_z0p2",
             "params": {"M500MSun": 4.0e+14, "z": 0.2}}],
        "photFilter": "Arnaud_M2e14_z0p4",
        "thresholdSigma": 4.0,
        "minObjPix": 1,
    }
    return config, {"RADeg": coords[:, 0], "decDeg": coords[:, 1],
                    "y_c": yc}


# -- phases 5 and 6 ----------------------------------------------------------------

def run_search(configDict, device, outName):
    """NemoConfig -> filterMapsAndMakeCatalogs -> catalog files, as the
    CLI runs it; returns (catalog, seconds, stage seconds)."""
    import copy
    from nemo_tpu_torch import pipelines, startup
    from nemo_tpu_torch.cli import nemo_main
    from nemo_tpu_torch.utils.timing import GLOBAL_TIMER

    parDict = startup.parseConfigDict(copy.deepcopy(configDict))
    parDict["outputDir"] = os.path.join(WORK, outName)
    GLOBAL_TIMER.__init__()
    t0 = time.perf_counter()
    config = startup.NemoConfig(parDict, device=device, writeTileInfo=True)
    catalog = pipelines.filterMapsAndMakeCatalogs(
        config, writeAreaMask=True, writeFlagMask=True, verbose=False)
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    catFile = os.path.join(config.rootOutDir, "%s_optimalCatalog.csv"
                           % outName)
    catalog = nemo_main.writeOptimalCatalog(catalog, catFile)
    secs = time.perf_counter() - t0
    if not os.path.exists(catFile) or len(catalog) == 0:
        raise RuntimeError("%s run wrote no catalog" % device)
    for key in ("RADeg", "decDeg", "SNR", "fixed_y_c", "fixed_err_y_c"):
        if not np.all(np.isfinite(np.asarray(catalog[key], dtype=float))):
            raise RuntimeError("non-finite %s in the %s catalog"
                               % (key, device))
    return catalog, secs, dict(GLOBAL_TIMER.stages)


def match(truth, catalog, radiusArcmin):
    """Index into catalog of each truth object's nearest detection within
    radiusArcmin (-1 if none)."""
    from nemo_tpu_torch import catalogs
    idx, sep = catalogs.nearestNeighbours(
        truth["RADeg"], truth["decDeg"],
        np.asarray(catalog["RADeg"], dtype=float),
        np.asarray(catalog["decDeg"], dtype=float))
    return np.where(sep * 60 < radiusArcmin, idx, -1)


def compare_runs(truth, gpuCat, cpuCat):
    """Every injected cluster recovered at fixed_SNR >= 5 by either run is
    recovered by both; positions within 0.1', fixed_y_c rtol 5e-3."""
    ig, ic = match(truth, gpuCat, 1.0), match(truth, cpuCat, 1.0)
    snrG = np.where(ig >= 0, np.asarray(gpuCat["fixed_SNR"])[ig], 0)
    snrC = np.where(ic >= 0, np.asarray(cpuCat["fixed_SNR"])[ic], 0)
    sel = (snrG >= 5) | (snrC >= 5)
    missing = np.nonzero(sel & ((ig < 0) | (ic < 0)))[0]
    if len(missing):
        raise RuntimeError("clusters %s recovered by one run only"
                           % missing.tolist())
    g, c = ig[sel], ic[sel]
    from nemo_tpu_torch.utils.wcs import calcAngSepDeg
    sepArcmin = 60 * calcAngSepDeg(
        np.asarray(gpuCat["RADeg"], dtype=float)[g],
        np.asarray(gpuCat["decDeg"], dtype=float)[g],
        np.asarray(cpuCat["RADeg"], dtype=float)[c],
        np.asarray(cpuCat["decDeg"], dtype=float)[c])
    if np.any(sepArcmin > 0.1):
        raise RuntimeError("cuda/cpu positions differ by up to %.3f arcmin"
                           % sepArcmin.max())
    yG = np.asarray(gpuCat["fixed_y_c"], dtype=float)[g]
    yC = np.asarray(cpuCat["fixed_y_c"], dtype=float)[c]
    np.testing.assert_allclose(yG, yC, rtol=5e-3)
    return int(sel.sum()), float(sepArcmin.max()), \
        float(np.max(np.abs(yG / yC - 1)))


# -- phases 7 to 9 ------------------------------------------------------------

def survey_inputs(work, device="cuda"):
    """Seeded two-band survey map of SURVEY_GRID tiles of SHAPE, with
    SURVEY_CLUSTERS clusters inside each tile's trimmed interior, written
    as float32 FITS; returns (config dict, truth)."""
    import torch
    from nemo_tpu_torch.models import beams, profiles, sz
    from nemo_tpu_torch.ops import fourier, paint
    from nemo_tpu_torch.utils import fits as nfits
    from nemo_tpu_torch.utils import wcs as nwcs

    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(SEED + 7)
    grid, ty, tx = SURVEY_GRID, SHAPE[0], SHAPE[1]
    shape = (grid[0] * ty, grid[1] * tx)
    w = nwcs.makeWCS(shape, PIX_ARCMIN / 60.0, centreRADeg=60.0,
                     centreDecDeg=0.0)
    tiles, ys, xs = [], [], []
    inset = 3 * GRID_PIX // 2 + 20 + 30     # trim half-width + apod + margin
    rows, cols = 4, SURVEY_CLUSTERS // 4
    for r in range(grid[0]):
        for c in range(grid[1]):
            y0, x0 = r * ty, c * tx
            ra0, dec0 = w.pix2wcs(x0, y0)
            ra1, dec1 = w.pix2wcs(x0 + tx, y0 + ty)
            tiles.append({"tileName": "T%d%d" % (r, c),
                          "RADecSection": [float(ra1), float(ra0),
                                           float(dec0), float(dec1)]})
            gy = np.repeat(np.linspace(y0 + inset, y0 + ty - inset, rows),
                           cols)
            gx = np.tile(np.linspace(x0 + inset, x0 + tx - inset, cols),
                         rows)
            ys.append(gy + rng.uniform(-15, 15, gy.size))
            xs.append(gx + rng.uniform(-15, 15, gx.size))
    ys, xs = np.concatenate(ys), np.concatenate(xs)
    yc = rng.uniform(2.5, 5.5, ys.size)
    coords = np.array([w.pix2wcs(x, y) for x, y in zip(xs, ys)])
    pixRad = np.radians(PIX_ARCMIN / 60.0)
    prof = profiles.makeArnaudModelProfile(0.4, 2e14)
    half = 128
    entries = []
    for band, freq, fwhm, noiseUK in BANDS:
        beamFile = os.path.join(work, "beam_%s.txt" % band)
        beams.makeGaussianBeamFile(beamFile, fwhm)
        r, v, unitScale = profiles.signalTemplateTable(
            prof["rDeg"], prof["prof"], beam=beamFile, amplitude=1.0)
        model = torch.zeros(shape, dtype=torch.float64, device=device)
        for y, x, y0 in zip(ys, xs, yc):
            iy, ix = int(y) - half, int(x) - half
            model[iy:iy + 2 * half, ix:ix + 2 * half] += \
                float(unitScale) * y0 * 1e-4 * paint.paint_template_centered(
                    (2 * half, 2 * half), (pixRad, pixRad), r, v,
                    center=(y - iy, x - ix), device=device,
                    dtype=torch.float64)
        sky = fourier.apply_pixel_window(
            sz.convertToDeltaT(model, obsFrequencyGHz=freq), pow=1.0)
        # one CMB realisation for both bands, as in phase 4
        sky = sky.cpu().numpy() + rng.normal(0, noiseUK, shape) \
            + cmb_field(np.random.default_rng(SEED + 8), pixRad, fwhm,
                        shape)
        path = os.path.join(work, "survey_%s.fits" % band)
        nfits.write_image(path, sky.astype(np.float32), w.header)
        entries.append({"mapFileName": path, "obsFreqGHz": freq,
                        "units": "uK", "beamFileName": beamFile})
        del model, sky
    maskPath = os.path.join(work, "surveyMask.fits")
    nfits.write_image(maskPath, np.ones(shape, dtype=np.uint8), w.header)
    config = {
        "unfilteredMaps": entries, "surveyMask": maskPath,
        "useTiling": True, "tileOverlapDeg": 0.0, "tileDefinitions": tiles,
        "stitchTiles": False,
        "thresholdSigma": 4.0, "minObjPix": 1, "findCenterOfMass": True,
        "useInterpolator": True, "rejectBorder": 0, "objIdent": "ACT-CL",
        # ring removal is host-detection only: with it on, the pipeline
        # keeps detection on the host (as the JAX package does)
        "removeRings": False, "photFilter": PHOT,
        "allFilters": {"class": "ArnaudModelMatchedFilter",
                       "params": {"noiseParams": {"method": "dataMap",
                                                  "noiseGridArcmin": 40.0},
                                  "saveFilteredMaps": False,
                                  "saveRMSMap": False, "savePlots": False,
                                  "outputUnits": "yc",
                                  "edgeTrimArcmin": 0.0}},
        "mapFilters": [
            {"label": "Arnaud_M%de14_z%s" % (m, str(z).replace(".", "p")),
             "params": {"M500MSun": m * 1e14, "z": z}}
            for m, z in DR5_BANK],
        "useDeviceBatching": True, "deviceBatchSize": 16,
        "useDeviceDetection": True}
    return config, {"RADeg": coords[:, 0], "decDeg": coords[:, 1],
                    "y_c": yc}


def with_filters(configDict, labels, **over):
    d = dict(configDict, **over)
    d["mapFilters"] = [f for f in configDict["mapFilters"]
                       if f["label"] in labels]
    return d


def chunk_budget(outDir):
    """Summed chunk budgets of a batched run (diagnostics/
    chunk_budgets.jsonl)."""
    with open(os.path.join(WORK, outDir, "diagnostics",
                           "chunk_budgets.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    keys = ("stageWait", "upload", "step", "download", "consume",
            "hostOther", "detectTiles", "overflowTiles", "detectLabels")
    out = {k: sum(r[k] for r in recs) for k in keys}
    out["devices"] = sorted({r["device"] for r in recs})
    out["chunks"] = len(recs)
    out["nTiles"] = [r["nTiles"] for r in recs]
    return out


def batched_run(configDict, outName, noise, device="cuda"):
    """One batched search with the kernel counters set to 0 just before it
    and read just after; returns (catalog, seconds, budget, launches,
    largest nT, plain calls)."""
    noise.rms_cells.launches = 0
    noise.rms_cells.largest_nT = 0
    noise._rms_cells_plain.calls = 0
    cat, secs, _ = run_search(configDict, device, outName)
    return (cat, secs, chunk_budget(outName), noise.rms_cells.launches,
            noise.rms_cells.largest_nT, noise._rms_cells_plain.calls)


def fixed_snr(cat):
    """fixed_SNR of every row (the device-detection catalog carries it
    as fixed_y_c / fixed_err_y_c, the host one also as a column)."""
    y = np.asarray(cat["fixed_y_c"], dtype=float)
    err = np.asarray(cat["fixed_err_y_c"], dtype=float)
    return np.divide(y, err, out=np.zeros_like(y), where=err != 0)


def step_kernel_case(noise, nT=16):
    """rms_cells at the batched step's real padded shape (good_fft_size of
    the 896 x 1536 tile, per-tile true-shape cells), float32."""
    import torch
    from nemo_tpu_torch.ops import fourier
    dev = torch.device("cuda")
    pad = (fourier.good_fft_size(SHAPE[0]), fourier.good_fft_size(SHAPE[1]))
    meta = noise.cell_meta_batch([SHAPE] * nT, pad, GRID_PIX)
    Wy, Wx, ov = noise.meta_window(GRID_PIX, pad)
    m = np.zeros((nT,) + pad)
    m[:, :SHAPE[0], :SHAPE[1]] = filtered_like_maps(nT)
    padded = torch.nn.functional.pad(
        torch.as_tensor(m, dtype=torch.float32, device=dev),
        (ov, Wx, ov, Wy)).contiguous()
    tabs = [noise._int32_table(a, nT, dev) for a in (
        meta["startsY"], meta["startsX"],
        np.where(meta["lensY"] > 0, meta["lensY"] + 2 * ov, 0),
        np.where(meta["lensX"] > 0, meta["lensX"] + 2 * ov, 0))]
    res = kernel_case(noise, padded, tabs, (Wy, Wx), 1e-4, reps=3)
    del padded
    torch.cuda.empty_cache()
    return pad, res


def profile_warm_run(configDict):
    """One more warm batched run under torch.profiler: (wall s, device
    busy s, top device operations).  Busy time sums the device-side
    events only (kernels and copies, on one stream, do not overlap); the
    CPU ops that launched them carry the same time and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_search(configDict, "cuda", "run_profile")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    onDevice = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in onDevice) / 1e6
    top = sorted(onDevice, key=dev_us, reverse=True)[:10]
    return wall, busy, [(e.key[:70], round(dev_us(e) / 1e3, 3), e.count)
                        for e in top]


def batched_phases(noise, card, device="cuda"):
    """Phases 7 to 9; returns (runs by tag, nT = 16 kernel case)."""
    import torch
    onCard = device == "cuda"
    t0 = time.perf_counter()
    surveyDict, surveyTruth = survey_inputs(os.path.join(WORK, "survey"),
                                            device=device)
    nTiles = SURVEY_GRID[0] * SURVEY_GRID[1]
    phase(7, "survey inputs: %d tiles of %d x %d, two bands, %d clusters, "
          "in %.1f s" % (nTiles, SHAPE[0], SHAPE[1], len(surveyTruth["y_c"]),
                         time.perf_counter() - t0))

    if onCard:
        torch.cuda.reset_peak_memory_stats()
    runs = {}
    for tag in ("cold", "warm"):
        runs[tag] = batched_run(surveyDict, "batched_%s" % tag, noise,
                                device)
        cat, secs, bud, nLaunch, largest, plain = runs[tag]
        nLabels = len(surveyDict["mapFilters"])
        # on the card every step launches the kernel once over all 16
        # tiles; a CPU rehearsal runs its plain version instead
        want = (nLabels, nTiles, 0) if onCard else (0, 0, nLabels)
        if (nLaunch, largest, plain) != want:
            raise RuntimeError(
                "batched %s run: rms_cells launches %d, largest nT %d, plain "
                "calls %d (want %s)" % (tag, nLaunch, largest, plain, want))
        if bud["detectTiles"] + bud["overflowTiles"] != nTiles * nLabels \
                or bud["detectLabels"] != nLabels or bud["nTiles"] != [nTiles]:
            raise RuntimeError("batched %s run: budget %s" % (tag, bud))
        if bud["devices"] != [str(torch.device(device, 0) if onCard
                                  else torch.device(device))]:
            raise RuntimeError("batched step ran on %s" % bud["devices"])
        phase(8, "batched %s, %d tiles x %d scales on %s: %.2f s "
              "(staging wait %.2f + upload %.2f, steps %.2f, downloads "
              "%.2f, host catalog %.2f, other host %.2f), %d objects" % (
                  tag, nTiles, nLabels, device, secs, bud["stageWait"],
                  bud["upload"], bud["step"], bud["download"],
                  bud["consume"], bud["hostOther"], len(cat)))
    cat, secs, bud, nLaunch, largest, plain = runs["warm"]
    phase(8, "rms_cells launches %d, largest nT %d, plain calls %d; step "
          "tensors on %s" % (nLaunch, largest, plain, bud["devices"]))
    phase(8, "(tile, label) pairs on device detection %d, overflowed to "
          "host detection %d" % (bud["detectTiles"], bud["overflowTiles"]))
    recovered = int(np.sum(match(surveyTruth, cat, 1.0) >= 0))
    peakMiB = torch.cuda.max_memory_allocated() / 2 ** 20 if onCard \
        else float("nan")
    phase(8, "%d/%d clusters within 1'; warm run (one chunk) %.3f s, %.4f "
          "s per (tile, filter); peak device memory %.0f MiB (%s)" % (
              recovered, len(surveyTruth["y_c"]), secs,
              secs / (nTiles * nLabels), peakMiB, card))
    if recovered < 0.9 * len(surveyTruth["y_c"]):
        raise RuntimeError("batched run recovered %d clusters" % recovered)
    kernel16 = (float("nan"),) * 3
    if onCard:
        pad, kernel16 = step_kernel_case(noise)
        phase(8, "rms_cells nT 16 at the step's padded shape %s f32: "
              "max_abs_err %.3e, kernel %.4f ms, plain %.4f ms (%s)"
              % ((pad,) + kernel16 + (card,)))

    pair = [PHOT, "Arnaud_M4e14_z0p2"]
    hostCat, hostSecs, _ = run_search(
        with_filters(surveyDict, pair, useDeviceBatching=False), device,
        "host_pair")
    batCat, batSecs, _ = run_search(with_filters(surveyDict, pair), device,
                                    "batched_pair")
    ih, ib = match(surveyTruth, hostCat, 1.0), match(surveyTruth, batCat,
                                                      1.0)
    snrH = np.where(ih >= 0, fixed_snr(hostCat)[ih], 0)
    snrB = np.where(ib >= 0, fixed_snr(batCat)[ib], 0)
    sel = (snrH >= 5) | (snrB >= 5)
    missing = np.nonzero(sel & ((ih < 0) | (ib < 0)))[0]
    if len(missing):
        raise RuntimeError("clusters %s found by one engine only"
                           % missing.tolist())
    from nemo_tpu_torch.utils.wcs import calcAngSepDeg
    h, b = ih[sel], ib[sel]
    sepArcmin = 60 * calcAngSepDeg(
        np.asarray(hostCat["RADeg"], dtype=float)[h],
        np.asarray(hostCat["decDeg"], dtype=float)[h],
        np.asarray(batCat["RADeg"], dtype=float)[b],
        np.asarray(batCat["decDeg"], dtype=float)[b])
    if np.any(sepArcmin > 0.1):
        raise RuntimeError("batched/host positions differ by up to %.3f'"
                           % sepArcmin.max())
    yH = np.asarray(hostCat["fixed_y_c"], dtype=float)[h]
    yB = np.asarray(batCat["fixed_y_c"], dtype=float)[b]
    np.testing.assert_allclose(yB, yH, rtol=5e-3)
    phase(9, "batched vs host engine on %s, all %d tiles, %s: %d "
          "clusters at fixed_SNR >= 5 in either run, found by both, max "
          "offset %.4f', max |fixed_y_c ratio - 1| %.2e; host %.2f s, "
          "batched %.2f s" % (device, nTiles, "+".join(pair), int(sel.sum()),
                              sepArcmin.max(), np.max(np.abs(yB / yH - 1)),
                              hostSecs, batSecs))
    if sel.sum() < 0.5 * len(surveyTruth["y_c"]):
        raise RuntimeError("too few clusters compared (%d)" % sel.sum())

    if onCard:
        wall, busy, top = profile_warm_run(surveyDict)
        phase(8, "profiled warm batched run: %.3f s wall, device busy %.3f "
              "s (%.1f%%); top device ops (name, ms, calls): %s (%s)"
              % (wall, busy, 100 * busy / wall, json.dumps(top), card))

    return runs, kernel16


def main():
    try:
        import torch
    except ImportError:
        sys.exit("chip_smoke: torch is not installed")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, ROOT)
    try:
        from nemo_tpu_torch import cuda_build
        from nemo_tpu_torch.ops import noise
    except ImportError as exc:
        sys.exit("chip_smoke: the port is not importable from %s (%s)"
                 % (ROOT, exc))
    tStart = time.perf_counter()

    card = nvidia_smi()
    phase(1, "card: %s | torch %s | CUDA %s | %d device(s)"
          % (card, torch.__version__, torch.version.cuda,
             torch.cuda.device_count()))

    t0 = time.perf_counter()
    noise.load_kernel()
    phase(2, "build: rms_cells.cu for sm_90a in %.2f s (nvcc %.2f s)"
          % (time.perf_counter() - t0,
             cuda_build.BUILD_SECONDS.get("rms_cells.cu", 0.0)))

    res = check_kernel(noise)
    for (layout, dtype), (err, ms, plainMs) in sorted(
            res.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        phase(3, "rms_cells %s %s: max_abs_err %.3e, kernel %.4f ms, "
              "plain %.4f ms (%s)" % (layout, str(dtype).split(".")[-1],
                                      err, ms, plainMs, card))

    t0 = time.perf_counter()
    configDict, truth = make_inputs("cuda")
    phase(4, "inputs: %d x %d two-band tile, %d clusters, in %.1f s"
          % (SHAPE[0], SHAPE[1], N_CLUSTERS, time.perf_counter() - t0))

    torch.cuda.reset_peak_memory_stats()
    noise.rms_cells.launches = 0
    noise._rms_cells_plain.calls = 0
    gpuCat, gpuSecs, gpuStages = run_search(configDict, "cuda", "run_cuda")
    launches = noise.rms_cells.launches
    plainCalls = noise._rms_cells_plain.calls
    if launches <= 0 or plainCalls != 0:
        raise RuntimeError("main path: kernel launches %d, plain calls %d"
                           % (launches, plainCalls))
    recovered = int(np.sum(match(truth, gpuCat, 1.0) >= 0))
    phase(5, "cuda float32 search: %d objects, %d/%d clusters within 1', "
          "%.2f s, peak device memory %.0f MiB, rms_cells launches %d, "
          "plain calls %d, stages %s (%s)"
          % (len(gpuCat), recovered, N_CLUSTERS, gpuSecs,
             torch.cuda.max_memory_allocated() / 2 ** 20, launches,
             plainCalls, json.dumps({k: round(v, 4)
                                     for k, v in gpuStages.items()}), card))

    cpuCat, cpuSecs, cpuStages = run_search(configDict, "cpu", "run_cpu")
    nCompared, maxSep, maxDy = compare_runs(truth, gpuCat, cpuCat)
    phase(6, "cpu float64 search: %d objects in %.2f s; %d clusters at "
          "fixed_SNR >= 5 in both runs, max offset %.4f', max |fixed_y_c "
          "ratio - 1| %.2e" % (len(cpuCat), cpuSecs, nCompared, maxSep,
                               maxDy))
    if recovered < N_CLUSTERS // 2 or nCompared < N_CLUSTERS // 2:
        raise RuntimeError("too few clusters recovered (%d, %d)"
                           % (recovered, nCompared))

    runs, kernel16 = batched_phases(noise, card)
    err16, ms16, plainMs16 = kernel16

    err, ms, plainMs = res[("nT1", torch.float32)]
    print(json.dumps({"kernels": [{
        "name": "rms_cells", "route": "cuda",
        "source": "nemo_tpu_torch/csrc/rms_cells.cu",
        "replaces": "nemo_tpu/ops/noise.py:212",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plainMs, "launches_batched": runs["warm"][3],
        "largest_nT_batched": runs["warm"][4], "ms_nT16": ms16,
        "plain_ms_nT16": plainMs16, "max_abs_err_nT16": err16}]}))
    print("total %.1f s" % (time.perf_counter() - tStart))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
