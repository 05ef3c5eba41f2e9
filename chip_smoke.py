#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 -c 'import chip_smoke; chip_smoke.legendre_only()'
                                        # phases 1, 2 and 14a only
    python3 -c 'import chip_smoke; chip_smoke.realspace_only()'
                                        # phases 1, 2, 7, 15 and rms_cells
    python3 -c 'import chip_smoke; chip_smoke.tools_only()'
                                        # phases 1, 2, 7, 10 and 16
    python3 -c 'import chip_smoke; chip_smoke.mesh_only()'
                                        # phases 1, 2, 7 and 17

Builds the port's CUDA kernels from the checkout, holds each against its
plain torch version at the main paths' shapes, then runs the one-tile cluster
search (nemo_tpu_torch: config -> preprocess -> matched filters -> grid
RMS / S/N -> detection -> photometry -> optimal catalog) on a seeded
two-band 896 x 1536 tile on the card in float32, and again on the CPU in
float64, and checks that both recover the injected clusters alike; then a
16-tile survey chunk through the batched engine, and the same survey
through the ``nemo`` CLI with the DR5 selection-function epilogue (Q fit,
RMS tables, completeness, mass-limit maps), through ``nemoMass``, and
through ``nemo -I`` (the source-injection test); then the simulated skies
on a survey at dec -47: model-noise filtering, the sky-sim contamination
estimate and ``nemoModel``; then the real-space (DR3-style) search on the
survey; then the survey's tools: ``nemoSpec``, ``nemoMock``,
``nemoCatalogCheck``, the extended-source mask and ``nemo --profile``;
then the survey again on a device mesh of every card (two shards on one
card).

Phases (each prints one line; any failure raises, so the script exits
non-zero and prints no result):
  1 card: name and power limit (nvidia-smi), torch and CUDA versions;
  2 build: nvcc builds of nemo_tpu_torch/csrc/rms_cells.cu,
    label_components.cu, boltzmann_rk4.cu and legendre_contract.cu,
    started together, seconds, and ptxas's register and spill report of
    the Boltzmann and Legendre kernels (synthesis and analysis, float32
    and float64);
  3 kernels vs plain versions on the card, timed with CUDA events in the
    order plain, kernel(s), kernel(s), plain, each beside its bound:
    rms_cells' staged and streaming variants (f64 rtol 1e-10, f32 rtol
    1e-4 but for borderline clips, see check_cells) at nT = 1 (the host
    path), at the batched step's nT = 16 x 900 x 1536 and at the
    real-space step's nT = 16 x 896 x 1536 (the true shape, unpadded);
    label_components bitwise at 16 x 900 x 1536 on an S/N
    mask, an empty mask and a serpentine that splits at 128 passes, with
    n_iter 128, 4000 and 37; boltzmann_rk4 on the 160-k splice grid at
    nGrid 4,096 (rtol 1e-9), timed plain, kernel, kernel, and at the
    production nGrid 24,576 against its plain version (on the CPU) and
    the JAX package's table in tests/data (rtol 1e-9), each call's time
    beside the kernel's own, and the kernel's time a step beside the
    length of its dependent chain (latencies from the source's probe);
  4 inputs: seeded CMB + white noise + ~20 Arnaud clusters, written as
    FITS with beam files under _smoke_work/;
  5 the main path on the card (cuda, float32), with the kernel's launch
    count > 0 and the plain version's 0;
  6 the same path on the CPU (float64): clusters, positions, fixed_y_c;
  7 survey inputs: a seeded two-band map cut into 16 DR5-like tiles of
    896 x 1536 by its tileDefinitions, ~20 clusters per tile, as FITS;
  8 the batched engine on the card (float32): the 16-scale Arnaud bank of
    examples/dr5-cluster-search.yml over one 16-tile chunk with device
    detection, run cold and warm; launches of both kernels (one each per
    step, rms_cells in its staged variant, largest tile batch 16), plain
    calls (0), (tile, label) pairs on device detection and overflowed,
    seconds by phase, peak device memory, and one more warm batched run
    under torch.profiler: the card's busy share and its largest device
    operations;
  9 batched against the per-tile host engine on the card, same 16 tiles,
    the photometry filter and one other scale;
 10 the DR5 epilogue: ``nemo -S --device cuda`` on the same survey with the
    16-scale bank, DR5's fitQ, selFnOptions and massOptions (the default
    Boltzmann transfer): seconds by stage, the fitQ route and its chunk
    budgets, kernel launches (Boltzmann: one per distinct cosmology; plain
    calls 0), Q at the reference filter's theta500 per tile (a sanity
    print: 1 by construction), the 90% mass limit for 0.2 < z < 1;
 11 fitQ routes on the card: tile-batched against serial on all 16 tiles,
    and one tile against the CPU float64 serial route;
 12 masses: the nemoMass CLI on the card against a seeded redshift
    catalog at the truth positions, its mass columns against the same CLI
    on the CPU in float64 (rtol 2e-3), and calcMassBatch on 10,000 seeded
    rows, card against CPU float64, rows per second;
 13 source injection: paint_objects (torch ops) at the injection shape (50
    clusters on one tile) and at 10,000 point sources on the survey map,
    card float32 and float64 against CPU float64 and bitwise repeatable;
    then ``nemo -I --device cuda`` on the survey with DR5's 16-scale bank,
    fitQ, 9 iterations of 50 clusters a tile of the photometry filter's
    model, the reruns on the batched engine's given-filter step: seconds
    by stage and per iteration (staging, step, download, catalog), the
    given step once a chunk and iteration, no filter built, both kernels
    launched (rms_cells in every rerun) with no plain call, the
    injection-test checks of tests/test_injection_and_spec.py; then the
    first 2 iterations again on the per-tile engine, same seed: every
    injected object recovered at S/N >= 5 by either run found by both,
    within 0.1', y_c within rtol 5e-3.  The last iteration's rerun runs
    under torch.profiler (card activity only) for its device-busy share;
 14 sims: (a) the Legendre kernel (csrc/legendre_contract.cu) against its
    plain version on the rings of one dec -62 .. -54.5 tile at lmax = mmax
    = 6,000, synthesis and analysis, float32 and float64, timed plain,
    kernel, kernel, plain, each call beside the kernel's own time (CUDA
    events around its launch): synthesis bitwise equal to plain,
    analysis float64 within 1e-10 of max |plain| and float32 within 1e-5
    of max |alm|; two kernel calls bitwise equal; synthesis float32 again
    at nemoModel's lmax 12,000, bitwise equal to one plain call; analysis
    float32 on its multi-block path (3,584 rings, a survey map's height, at
    lmax 2,000) within 1e-5 of max |alm| of plain; (b) the
    nemo CLI on the batched engine over phase 7's survey re-centred at dec
    -47 (12 tiles on the curved path, 4 flat),
    with the quickstart's two scales and noiseParams dataMap, model and
    max(dataMap,CMB): seconds, stages, sims and clusters recovered; the
    model run launches the synthesis 48 times with 16 flat draws and no
    plain call; one curved tile's filters rebuilt on the CPU in float64
    from the card's model stacks, its catalog against the card's by phase
    6's rule; (c) two sky sims and the inverted maps on the dataMap run's
    filter caches, the contamination tables; (d) nemoModel on a dec -55
    tile with 50 clusters, -C --curved-cmb (lmax 12,000), -N 20 --lknee
    2000: seconds by step, one analysis and three syntheses, the CMB's
    variance, the draw's band powers at lmax 6,000 (within 5%) and the
    noise's white level above the band limit;
 15 the real-space search on phase 7's survey: the quickstart's two
    scales as ArnaudModelRealSpaceMatchedFilter with
    tests/test_tiled_e2e.py's settings (kernel from a Fourier filter on a
    4 x 4 deg box, cut at 7': 29 x 29; 30' background subtraction;
    10' edge trim): (a) the step's convolution on one chunk (16 x 2 x 896
    x 1536 float32, through the FFT) beside its bound and the library's
    grouped conv2d, within 1e-5 of the peak of the CPU float64
    convolution of two tiles; (b) the search on the batched
    engine, cold and warm (seconds, stages, the kernel builds' share of
    staging, the steps, launches; the two catalogs bitwise the same), and
    a warm run profiled for its device-busy share; (c) the per-tile host
    engine on the card, and the CPU float64 port on two tiles, against
    (b) by phase 9's rule; (d) fitQ with a real-space reference on two
    tiles: the card's kernels fitted on the card and on the CPU in
    float64 (rtol 1e-4), the card against the CPU's own float64 kernels
    and fit (within 1e-4 of the largest Q), and the card's kernels and
    fit in float64 against the CPU's (rtol 1e-9);
 16 the tools on phase 7's survey: (a) ``nemoSpec -m matchedFilter`` at
    phase 15's catalog on the 16 tiles on the card (rms_cells launched
    twice a (tile, template) filter, no plain call) and on two tiles on
    the CPU in float64, y_c and S/N per band within 1e-4 relative; (b)
    ``nemoSpec -m CAP`` on four tiles, card against CPU float64, within
    1e-4 of each column's largest; (c) ``nemoMock -N 3`` on phase 10's
    selFn/ on the CPU (the transfer from phase 12's cache) and on the
    card with the transfer cache emptied (one boltzmann_rk4 launch): the
    mass-function grids within 1e-8, the mocks row for row (rtol 1e-6;
    the totals within 3 sqrt(N) if a draw moved); (d) ``nemoCatalogCheck``
    of the truth clusters against phase 10's run, card and CPU printing
    and writing the same; (e) ``makeExtendedSourceMask`` on a tile with an
    added blob, card against CPU float64 but within a dilation of pixels
    at the threshold; (f) ``nemo --profile`` on two chunks of 8 tiles,
    the trace written and naming both kernels, the catalog bitwise that
    of the same run without the flag, its five longest device operations;
 17 the mesh: every card, or two virtual shards on cuda:0 with one card
    (printed as mesh=): (a) the sharded benchmark step (float64, 16 tiles
    of 896 x 1536, trim 240) on the mesh against one shard, the survey
    histogram and candidate count exactly equal; (b) phase 7's survey with
    the 16-scale bank and device detection through batchFilterTilesMulti
    on the mesh, cold and warm: seconds by phase and each shard's step
    seconds, rms_cells and label_components launched on each shard's
    device with no plain call, every cluster at fixed_SNR >= 5 in the
    mesh run or phase 8's warm run found by both within 0.1' and rtol
    5e-3 in fixed_y_c, and whether the catalogs are bitwise the same; (c)
    the photometry filters held on their shards' devices and read onto
    cuda:0; (d) with two cards or more, two processes of one card each
    joined over NCCL by multihost.initialize_from_env: the benchmark
    step's survey statistics reduced over the processes equal one
    process's over a two-card mesh.  Phase 10 also reports fitQ's filters read from the device
    cache, the FITS writes deferred, and a second fitQ with a cache of
    budget 0 giving a bitwise-equal QFit.fits.
The last lines are the convolution's JSON record (a library call), the
kernels' JSON record, the card's name and power limit, and {"ok": true,
"device": {...}}.

Needs a CUDA device and nvcc; imports no JAX.
"""

import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

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

# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): HBM3 bytes/s,
# and operations/s outside the tensor cores by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12, "int32": 67e12}
# operations per window pixel and stage of the clipped RMS: |v|, compare,
# add (sweep 1; the count is one more integer add), subtract, multiply, add
# (sweep 2)
RMS_OPS_PER_PIXEL_STAGE = 7
# operations per mask pixel and Jacobi pass: four minima and a compare
LABEL_OPS_PER_PIXEL_PASS = 5
# float64 operations of csrc/boltzmann_rk4.cu, counted from the source (each
# +, -, *, /, negation, compare, min and max one operation), once for each
# k however many lanes repeat them: per derivative evaluation the shared
# terms (potentials 23, matter 17) and the /Hc of the 31 multipole rates,
# the 31 rates by regime (photons: streaming, tight coupling with its slip,
# full hierarchies; neutrinos: streaming, full) and phi's streaming pin;
# per step the regime tests at three abscissae (27), the rate cap, the RK4
# stages and combine over 36 components (468) and the relaxation's test,
# and, outside tight coupling, its update.  "table" is the host's per-step
# table (_step_tables), counted once a step, not once a k: exp and 18
# derived values at the knot, the same after ~40 operations of lookup and
# lerps at each of the two other abscissae, and the step's own 23.
BOLTZ_OPS = {"derivs": 23 + 17 + 31, "photons_rsa": 38,
             "photons_tca": 56, "photons_full": 70, "neutrinos_rsa": 28,
             "neutrinos_full": 53, "phi_rsa": 15, "step": 27 + 1 + 468 + 3,
             "relax": 38, "table": 19 + 2 * 59 + 23}
# The dependent chain of one step outside tight coupling, from the source.
# A quotient's reciprocal depends on its divisor alone (k^2, Hc, a table
# value), known before the state, so a division adds three operations to
# the chain (q = a r, the residual, the correction).  Each of the four
# evaluations is a round of shuffles and 18 float64 operations deep
# (th_g to mom, c15H2 mom / k^2, phi', the rate, its / Hc, the stage
# input), the RK4 combine one more, the relaxation a round of shuffles and
# 10 operations.  Tight coupling skips the relaxation.
BOLTZ_CHAIN = {"shuffles": 5, "operations": 4 * 18 + 1 + 10}
BOLTZ_REF = os.path.join(ROOT, "tests", "data",
                         "boltzmann_transfer_reference.json")


def bound(nbytes, ops, optype):
    """(least ms for the work, "bytes" or "operations")."""
    tb = nbytes / HBM_BYTES_PER_S
    to = ops / PEAK_OPS_PER_S[optype]
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def ptxas_report(log, entry):
    """ptxas's register and spill lines for the entry function whose
    mangled name holds ``entry``."""
    out, mine = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            mine = entry in line
        elif mine and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return " | ".join(out)


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


def time_turns(fns, reps):
    """Mean ms of each named function, timed in turns: the names in order
    and then in reverse (plain, kernel, kernel, plain)."""
    names = list(fns)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(time_ms(fns[k], reps[k]))
    return {k: sum(v) / len(v) for k, v in times.items()}


def check_cells(got, ref, rtol, nGood, name):
    """Every cell within ``rtol`` of the plain version, except, in float32,
    cells whose difference one borderline pixel explains: a pixel at the
    clip threshold (~3 sigma) kept by one version and clipped by the other
    moves a cell of n good pixels by ~4/n of its RMS (the two versions sum
    in different orders, so their thresholds differ in the last bits).
    Those cells are allowed up to 5/n, at most one in a thousand; returns
    their count."""
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        raise RuntimeError("rms_cells %s output malformed" % name)
    off = ~np.isclose(got, ref, rtol=rtol, atol=0)
    if got.dtype == np.float32:
        flip = np.abs(got - ref) <= 5.0 * np.abs(ref) / np.maximum(nGood, 1)
        if np.any(off & ~flip) or off.sum() > max(1, got.size // 1000):
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=0,
                                       err_msg=name)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0, err_msg=name)
    return int(off.sum())


def clip_stages(noise, windows, valid, n_iter=10):
    """Stages each cell's clip needs (the seed, then iterations up to the
    first whose threshold repeats the last one's: the staged variant stops
    there, its result final), by the plain version's arithmetic."""
    import torch
    mean, rms, n0 = noise._masked_mean_std(windows, valid)
    stages = torch.ones_like(n0)
    done = n0 == 0                      # an empty cell stops at its seed
    last = None
    for _ in range(n_iter):
        thr = torch.abs(mean + 3.0 * rms)
        if last is not None:
            done |= thr == last
        stages += (~done).to(stages.dtype)
        last = thr
        m = valid & (torch.abs(windows) < thr[:, None])
        newMean, newRms, nm = noise._masked_mean_std(windows, m)
        mean = torch.where(nm > 0, newMean, mean)
        rms = torch.where(nm > 0, newRms, rms)
    return stages


def rms_case(noise, padded, tabs, window, rtol, reps, plainReps):
    """Both variants of the kernel against the plain version on the card:
    (max_abs_err by variant, borderline cells by variant and the cell
    count, ms by name, bound ms, bound_by)."""
    import torch
    ref = noise._rms_cells_plain(padded, *tabs, window)
    refNp = ref.cpu().numpy()
    windows, valid = noise._gather_windows(padded, *tabs, window)
    nGood = valid.sum(dim=1).reshape(refNp.shape).cpu().numpy()
    stages = clip_stages(noise, windows, valid).cpu().numpy()
    del windows, valid
    errs, flips = {}, {"cells": int(refNp.size)}
    fns = {"plain": lambda: noise._rms_cells_plain(padded, *tabs, window)}
    for variant in ("staged", "streaming"):
        got = noise._rms_cells_cuda(padded, *tabs, window, variant=variant)
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        flips[variant] = check_cells(got, refNp, rtol, nGood, variant)
        errs[variant] = float(np.max(np.abs(got - refNp)))
        fns[variant] = (lambda v=variant: noise._rms_cells_cuda(
            padded, *tabs, window, variant=v))
    ms = time_turns(fns, {"plain": plainReps, "staged": reps,
                          "streaming": reps})
    # work of this run's tables: each cell's clipped extent, every stage
    nT, PY, PX = padded.shape
    sy, sx, ly, lx = (t.cpu().numpy().astype(np.int64) for t in tabs)
    h = np.minimum(np.minimum(ly, window[0]), PY - sy) - np.maximum(0, -sy)
    w = np.minimum(np.minimum(lx, window[1]), PX - sx) - np.maximum(0, -sx)
    pixelStages = int(np.sum(np.maximum(h, 0) * np.maximum(w, 0)
                             * stages.reshape(h.shape)))
    item = padded.element_size()
    nbytes = padded.numel() * item + 4 * sy.size * 4 + sy.size * item
    bms, by = bound(nbytes, RMS_OPS_PER_PIXEL_STAGE * pixelStages,
                    str(padded.dtype).split(".")[-1])
    flips["mean_stages"] = float(stages.mean())
    return errs, flips, ms, bms, by


def filtered_like_maps(nT, shape=SHAPE):
    """Seeded maps shaped like filtered tiles: noise with a masked (zero)
    border and a zeroed corner block, zero-padded to ``shape``."""
    rng = np.random.default_rng(SEED)
    m = np.zeros((nT,) + tuple(shape))
    t = rng.normal(0, 1e-5, (nT,) + SHAPE)
    t[:, :20] = 0
    t[:, :, -20:] = 0
    t[:, 300:420, 500:700] = 0
    m[:, :SHAPE[0], :SHAPE[1]] = t
    return m


def step_pad():
    from nemo_tpu_torch.ops import fourier
    return (fourier.good_fft_size(SHAPE[0]), fourier.good_fft_size(SHAPE[1]))


def check_rms(noise, card):
    """The kernel's two variants against the plain version: the host
    path's layout (nT = 1, 896 x 1536), the Fourier step's (nT = 16,
    per-tile cells on the padded 900 x 1536) and the real-space step's
    (nT = 16, the cells on the true 896 x 1536, no FFT padding), float64
    (rtol 1e-10) and float32 (rtol 1e-4: float32 may flip one borderline
    clip)."""
    import torch
    dev = torch.device("cuda")
    results = {}
    ny, nx = SHAPE
    ov, ye, xe, window, tables = noise._grid_geometry(ny, nx, GRID_PIX, None)
    pad = step_pad()
    meta = noise.cell_meta_batch([SHAPE] * N_TILES_META, pad, GRID_PIX)
    mtabs, mwindow, mpad = noise.meta_cell_tables(meta, GRID_PIX, pad,
                                                  N_TILES_META, dev)
    rmeta = noise.cell_meta_batch([SHAPE] * N_TILES_META, SHAPE, GRID_PIX)
    rtabs, rwindow, rpad = noise.meta_cell_tables(rmeta, GRID_PIX, SHAPE,
                                                  N_TILES_META, dev)
    for dtype, rtol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        dname = str(dtype).split(".")[-1]
        padded = torch.nn.functional.pad(
            torch.as_tensor(filtered_like_maps(1), dtype=dtype, device=dev),
            (ov, window[1], ov, window[0])).contiguous()
        tabs = [noise._int32_table(a, 1, dev) for a in tables]
        results[("nT1", dname)] = rms_case(noise, padded, tabs, window,
                                           rtol, reps=20, plainReps=5)
        padded = torch.nn.functional.pad(
            torch.as_tensor(filtered_like_maps(N_TILES_META, pad),
                            dtype=dtype, device=dev), mpad).contiguous()
        results[("step", dname)] = rms_case(noise, padded, mtabs, mwindow,
                                            rtol, reps=10, plainReps=2)
        padded = torch.nn.functional.pad(
            torch.as_tensor(filtered_like_maps(N_TILES_META),
                            dtype=dtype, device=dev), rpad).contiguous()
        results[("realspace", dname)] = rms_case(
            noise, padded, rtabs, rwindow, rtol, reps=10, plainReps=2)
        del padded
    torch.cuda.empty_cache()
    for (layout, dname), (errs, flips, ms, bms, by) in sorted(
            results.items()):
        phase(3, "rms_cells %s %s (window %s): max_abs_err staged %.3e "
              "streaming %.3e, borderline-clip cells %d and %d of %d; "
              "%.2f of 11 stages a cell; staged %.4f ms, streaming %.4f ms, "
              "plain %.4f ms; bound %.4f ms (%s), staged at %.1f%% of it (%s)"
              % (layout, dname, {"step": mwindow, "realspace": rwindow}.get(
                  layout, window),
                 errs["staged"], errs["streaming"], flips["staged"],
                 flips["streaming"], flips["cells"], flips["mean_stages"],
                 ms["staged"],
                 ms["streaming"], ms["plain"], bms, by,
                 100 * bms / ms["staged"], card))
    return results


def label_masks(T, shape, seed=SEED + 3):
    """(T, ny, nx) bool masks on the card: an S/N-like map (beam-smoothed
    white noise at unit rms plus 20 compact sources a tile of S/N 5-15)
    above 4, an empty mask, and a one-pixel serpentine through every tile,
    far longer than 128 passes, over the S/N mask."""
    import torch
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    white = torch.as_tensor(rng.standard_normal((T,) + tuple(shape),
                                                dtype=np.float32), device=dev)
    ky = torch.fft.fftfreq(shape[0], device=dev)[:, None]
    kx = torch.fft.rfftfreq(shape[1], device=dev)[None, :]
    beam = torch.exp(-2 * (np.pi * 1.5) ** 2 * (ky ** 2 + kx ** 2))
    sn = torch.fft.irfft2(torch.fft.rfft2(white) * beam, s=tuple(shape))
    sn = sn / sn.std()
    yy = torch.arange(shape[0], device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(shape[1], device=dev, dtype=torch.float32)[None, :]
    for t in range(T):
        for y, x, a in zip(rng.uniform(20, shape[0] - 20, 20),
                           rng.uniform(20, shape[1] - 20, 20),
                           rng.uniform(5, 15, 20)):
            sn[t] += float(a) * torch.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                          / (2 * 3.0 ** 2))
    snake = torch.zeros((T,) + tuple(shape), dtype=torch.bool, device=dev)
    for k, r in enumerate(range(1, shape[0] - 1, 4)):
        snake[:, r, 1:shape[1] - 1] = True
        col = shape[1] - 2 if k % 2 == 0 else 1
        snake[:, r:min(r + 5, shape[0] - 1), col] = True
    sig = sn > 4.0
    return {"sn": sig, "empty": torch.zeros_like(sig), "snake": snake | sig}


def check_labels(detect, card):
    """The labelling kernel against its plain version, bitwise, at the
    batched step's 16 x 900 x 1536 on three masks and n_iter 128, 4000 and
    37; timed on the S/N mask at 128 passes.  Returns (max abs error, ms
    by name, bound ms, bound_by)."""
    import torch
    masks = label_masks(N_TILES_META, step_pad())
    err = 0
    for name, mask in masks.items():
        for nIter in (128, 4000, 37):
            got = detect.label_components_batch(mask, n_iter=nIter)
            ref = detect._label_components_plain(mask, nIter)
            if got.dtype == torch.int32 and got.shape == ref.shape:
                err = max(err, int((got - ref).abs().max()))
            if got.dtype != torch.int32 or not torch.equal(got, ref):
                raise RuntimeError("label kernel differs from the plain "
                                   "version: %s mask, n_iter %d"
                                   % (name, nIter))
            if name == "snake" and nIter == 128:
                path = mask[0] & ~masks["sn"][0]
                if len(torch.unique(got[0][path])) < 2:
                    raise RuntimeError("the serpentine did not split at "
                                       "128 passes")
    mask = masks["sn"]
    ms = time_turns({
        "plain": lambda: detect._label_components_plain(mask, 128),
        "kernel": lambda: detect.label_components_batch(mask, n_iter=128)},
        {"plain": 3, "kernel": 20})
    nSig = int(mask.sum())
    bms, by = bound(mask.numel() * (1 + 4),
                    LABEL_OPS_PER_PIXEL_PASS * 128 * nSig, "int32")
    share = nSig / mask.numel()
    phase(3, "label_components 16 x %d x %d: bitwise equal to the plain "
          "version on the S/N, empty and serpentine masks at n_iter 128, "
          "4000, 37; S/N mask (%.3f%% significant) at 128 passes: kernel "
          "%.4f ms, plain %.4f ms; bound %.4f ms (%s), kernel at %.1f%% of "
          "it (%s)" % (mask.shape[1], mask.shape[2], 100 * share,
                       ms["kernel"], ms["plain"], bms, by,
                       100 * bms / ms["kernel"], card))
    del masks, mask
    torch.cuda.empty_cache()
    return err, ms, bms, by


def boltzmann_ops(boltzmann, bg, k):
    """float64 operations of one Boltzmann solve on these inputs: the
    per-step table once a step, and BOLTZ_OPS by the regime each k is in
    at each RK4 abscissa (the kernel's own regime tests on the table)."""
    tab = boltzmann._step_tables(bg)
    nAb = len(boltzmann._AB)
    kk = np.asarray(k, dtype=np.float64)[:, None]
    o = BOLTZ_OPS
    total = tab.shape[0] * (o["table"] + kk.size * o["step"])
    for j, evals in ((0, 1), (1, 2), (2, 1)):
        b = dict(zip(boltzmann._AB, tab[:, j * nAb:(j + 1) * nAb].T))
        ktau = kk * b["tau"]
        rsa = ((ktau > boltzmann.RSA_KTAU)
               & (b["kap"] < boltzmann.RSA_KAPPA * kk)) \
            | ((ktau > 100.0) & (kk > 3.0 * b["kD"]))
        tight = b["kap"] > boltzmann.TCA_FAC * np.maximum(kk, b["Hc"])
        tca = tight & ~rsa
        per = (o["derivs"]
               + np.where(rsa, o["photons_rsa"] + o["phi_rsa"],
                          np.where(tca, o["photons_tca"], o["photons_full"]))
               + np.where(ktau > boltzmann.RSA_KTAU, o["neutrinos_rsa"],
                          o["neutrinos_full"]))
        total += evals * int(per.sum())
        if j == 2:                      # the step's end: relaxation
            total += o["relax"] * int((~tight).sum())
    return total


def chain_latencies(boltzmann):
    """ns per link of a dependent chain on the card, from the kernel
    source's probe (one warp, 2^18 links, CUDA events): float64 add,
    multiply and divide, and a shuffle of a double."""
    import torch
    lib = boltzmann.load_kernel()
    out = torch.empty(32, dtype=torch.float64, device="cuda")
    n = 1 << 18
    res = {}
    for op, name in enumerate(("add", "mul", "div", "shfl")):
        def run(op=op):
            err = lib.nemo_boltzmann_chain_probe(
                op, n, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError("chain probe launch failed: %d" % err)
        res[name] = 1e6 * time_ms(run, 3) / n
    return res


def check_boltzmann(boltzmann, cosmology, card):
    """The Boltzmann kernel against its plain version on the 160-k splice
    grid at nGrid 4,096, timed plain, kernel, kernel (the plain version
    once: it takes ~40 s), then at the main path's nGrid 24,576 against
    the plain version (one run, on the CPU) and the JAX package's
    committed table.
    All compared at rtol 1e-9: both versions read the same per-step table
    and do the same float64 arithmetic in the same order, the kernel with
    its lanes' operations in another grouping of the batch (~1e-12 over
    the integration).  A call's time includes building and uploading the
    per-step table; the kernel's own time is taken on a table already on
    the card.  Returns a dict of the measurements."""
    import torch
    dev = torch.device("cuda")
    k = torch.as_tensor(cosmology._BOLTZ_KGRID, device=dev)
    bg = boltzmann._solver_tables(70.0, 0.3, 0.05, 4096)
    boltzmann._transfer_cuda(k, bg)             # module load
    torch.cuda.synchronize()

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return [t.cpu().numpy() for t in out], start.elapsed_time(stop)

    ieee = boltzmann.load_kernel(boltzmann.IEEE_DIV_BUILD)

    def kernel_only(kk, g):
        """The kernel alone on a table already on the card, and the build
        with nvcc's `/` (which must give the same bits), in turns."""
        tab = boltzmann._device_step_tables(g, dev)
        fast, _ = boltzmann._launch(kk, tab, g)
        slow, _ = boltzmann._launch(kk, tab, g, lib=ieee)
        if not torch.equal(fast, slow):
            raise RuntimeError("the branch-free division changed T")
        ms = time_turns({
            "kernel": lambda: boltzmann._launch(kk, tab, g),
            "ieee": lambda: boltzmann._launch(kk, tab, g, lib=ieee)},
            {"kernel": 1, "ieee": 1})
        return ms["kernel"], ms["ieee"]

    (Tp, Rp), plainMs = timed(lambda: boltzmann._transfer_plain(k, bg))
    (T, R), t1 = timed(lambda: boltzmann._transfer_cuda(k, bg))
    _, t2 = timed(lambda: boltzmann._transfer_cuda(k, bg))
    np.testing.assert_allclose(T, Tp, rtol=1e-9, atol=0, err_msg="nGrid 4096")
    np.testing.assert_allclose(R, Rp, rtol=1e-9, atol=0, err_msg="nGrid 4096")
    kms, ims = kernel_only(k, bg)
    res = {"ms4096": (t1 + t2) / 2, "plain_ms4096": plainMs,
           "kernel_ms4096": kms, "ieee_div_ms4096": ims,
           "max_abs_err": float(np.max(np.abs(T - Tp))),
           "max_rel_err": float(np.max(np.abs(T / Tp - 1)))}

    with open(BOLTZ_REF) as f:
        ref = json.load(f)
    if not np.array_equal(np.array(ref["kMpc"]), cosmology._BOLTZ_KGRID):
        raise RuntimeError("the reference table's k grid is not the port's")
    bg24 = boltzmann._solver_tables(ref["H0"], ref["Om0"], ref["Ob0"],
                                    ref["nGrid"])
    k24 = torch.as_tensor(np.array(ref["kMpc"]), device=dev)
    (T24, R24), t1 = timed(lambda: boltzmann._transfer_cuda(k24, bg24))
    _, t2 = timed(lambda: boltzmann._transfer_cuda(k24, bg24))
    res["kernel_ms24576"], res["ieee_div_ms24576"] = kernel_only(k24, bg24)
    # one k, one warp: the same time as 160 when one warp's instruction
    # stream sets it
    tab24 = boltzmann._device_step_tables(bg24, dev)
    k1 = k24[-1:].contiguous()
    res["kernel_ms24576_one_k"] = time_ms(
        lambda: boltzmann._launch(k1, tab24, bg24), 1)
    del tab24
    # the plain version once at the main path's nGrid, on the CPU in
    # float64: on the card its time is the ~1,000 small launches of each
    # of the 24,575 steps (~4 minutes), on the CPU about half that
    t0 = time.perf_counter()
    Tp24, Rp24 = (x.numpy() for x in boltzmann._transfer_plain(k24.cpu(),
                                                                bg24))
    tp = 1e3 * (time.perf_counter() - t0)
    Tref, Rref = np.array(ref["T"]), np.array(ref["R0"])
    np.testing.assert_allclose(T24, Tref, rtol=1e-9, atol=0,
                               err_msg="nGrid 24576 vs the JAX table")
    np.testing.assert_allclose(T24, Tp24, rtol=1e-9, atol=0,
                               err_msg="nGrid 24576 vs plain")
    np.testing.assert_allclose(R24, Rref, rtol=1e-9, atol=0)
    np.testing.assert_allclose(R24, Rp24, rtol=1e-9, atol=0)
    res.update(ms24576=(t1 + t2) / 2, plain_ms24576=tp,
               max_rel_err_24576=float(np.max(np.abs(T24 / Tref - 1))),
               max_abs_err_24576=float(np.max(np.abs(T24 - Tref))),
               max_abs_err_24576_plain=float(np.max(np.abs(T24 - Tp24))),
               max_rel_err_24576_plain=float(np.max(np.abs(T24 / Tp24 - 1))))
    for tag, g, kk in (("4096", bg, k), ("24576", bg24, k24)):
        # the per-step table read once, the wavenumbers read and T, R0
        # written once
        nbytes = (g.lna.size - 1) * boltzmann.STEP_REC * 8 \
            + 3 * kk.numel() * 8
        ops = boltzmann_ops(boltzmann, g, kk.cpu().numpy())
        res["ops" + tag] = ops
        res["bound_ms" + tag], res["bound_by" + tag] = bound(nbytes, ops,
                                                             "float64")
    lat = chain_latencies(boltzmann)
    c = BOLTZ_CHAIN
    chainNs = (c["shuffles"] * lat["shfl"]
               + c["operations"] * (lat["add"] + lat["mul"]) / 2)
    stepNs = 1e6 * res["kernel_ms24576"] / (bg24.lna.size - 1)
    res.update(chain_ns_per_step=chainNs, kernel_ns_per_step=stepNs,
               chain_latency_ns=lat)
    phase(3, "boltzmann_rk4 160 k: nGrid 4096 call %.3f ms (kernel %.3f "
          "ms; with nvcc's division %.3f ms), plain %.1f ms, max rel err vs "
          "plain %.2e; nGrid 24576 call %.3f ms (kernel %.3f ms; with "
          "nvcc's division %.3f ms, T bitwise equal), plain (CPU) %.1f "
          "ms, max "
          "rel err vs plain %.2e, vs the JAX table %.2e; bound %.4f / %.4f "
          "ms (%s: %.3g / %.3g float64 operations), call at %.3f%% of it "
          "at 24576 (%s)"
          % (res["ms4096"], res["kernel_ms4096"], res["ieee_div_ms4096"],
             res["plain_ms4096"], res["max_rel_err"], res["ms24576"],
             res["kernel_ms24576"], res["ieee_div_ms24576"],
             res["plain_ms24576"], res["max_rel_err_24576_plain"],
             res["max_rel_err_24576"], res["bound_ms4096"],
             res["bound_ms24576"], res["bound_by24576"], res["ops4096"],
             res["ops24576"], 100 * res["bound_ms24576"] / res["ms24576"],
             card))
    phase(3, "boltzmann_rk4 dependent chain: links measured on one warp "
          "(ns) add %.3f, mul %.3f, div %.3f (nvcc's, with its branch), "
          "shuffle %.3f; a step outside tight coupling is %d shuffle rounds "
          "+ %d float64 operations deep = %.1f ns; the kernel takes %.1f ns "
          "a step at nGrid 24576 (%.2f x the chain; one k alone %.3f ms "
          "against 160 k %.3f ms), against %.4f ns a step of bound (%s)"
          % (lat["add"], lat["mul"], lat["div"], lat["shfl"],
             c["shuffles"], c["operations"], chainNs, stepNs,
             stepNs / chainNs, res["kernel_ms24576_one_k"],
             res["kernel_ms24576"],
             1e6 * res["bound_ms24576"] / (bg24.lna.size - 1), card))
    return res


# -- phase 4 -------------------------------------------------------------------

def cmb_field(rng, pixRad, fwhmArcmin, shape=SHAPE):
    """Gaussian CMB-like field (uK) from the lensed D_l table, synthesised
    with numpy FFTs and beam-smoothed."""
    tab = np.loadtxt(os.path.join(ROOT, "nemo_tpu_torch", "data",
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

def run_search(configDict, device, outName, mesh=None):
    """NemoConfig -> filterMapsAndMakeCatalogs -> catalog files, as the
    CLI runs it (``mesh``: the batched engine's, default every card);
    returns (catalog, seconds, stage seconds)."""
    import copy
    from nemo_tpu_torch import pipelines, startup
    from nemo_tpu_torch.cli import nemo_main
    from nemo_tpu_torch.utils.timing import RECORDER

    parDict = startup.parseConfigDict(copy.deepcopy(configDict))
    parDict["outputDir"] = os.path.join(WORK, outName)
    RECORDER.reset()
    t0 = time.perf_counter()
    config = startup.NemoConfig(parDict, device=device, writeTileInfo=True,
                                mesh=mesh)
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
    return catalog, secs, dict(RECORDER.totals)


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

    def snr(cat):
        return np.asarray(cat["fixed_SNR"]) if "fixed_SNR" in cat.keys() \
            else fixed_snr(cat)
    snrG = np.where(ig >= 0, snr(gpuCat)[ig], 0)
    snrC = np.where(ic >= 0, snr(cpuCat)[ic], 0)
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

def survey_inputs(work, device="cuda", decDeg=0.0, ivar=False):
    """Seeded two-band survey map of SURVEY_GRID tiles of SHAPE centred at
    ``decDeg``, with SURVEY_CLUSTERS clusters inside each tile's trimmed
    interior, written as float32 FITS (with ``ivar``, each band's inverse
    variance map too); returns (config dict, truth)."""
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
                     centreDecDeg=decDeg)
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
        if ivar:
            entries[-1]["weightsFileName"] = os.path.join(
                work, "ivar_%s.fits" % band)
            nfits.write_image(entries[-1]["weightsFileName"], np.full(
                shape, noiseUK ** -2.0, dtype=np.float32), w.header)
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
    out["shards"] = [r.get("shards") for r in recs]
    out["shardStep"] = [r.get("shardStep") for r in recs]
    return out


def reset_counts(noise, detect):
    """Set every kernel launch count and plain-version call count to 0."""
    from nemo_tpu_torch.models import boltzmann
    noise.rms_cells.launches = 0
    noise.rms_cells.largest_nT = 0
    noise.rms_cells.variant_launches.update(staged=0, streaming=0)
    noise._rms_cells_plain.calls = 0
    noise.rms_cells.device_launches.clear()
    detect.label_components_batch.launches = 0
    detect.label_components_batch.device_launches.clear()
    detect._label_components_plain.calls = 0
    boltzmann.transfer_function.launches = 0
    boltzmann._transfer_plain.calls = 0


def read_counts(noise, detect):
    from nemo_tpu_torch.models import boltzmann
    return {"rms_cells": noise.rms_cells.launches,
            "largest_nT": noise.rms_cells.largest_nT,
            "staged": noise.rms_cells.variant_launches["staged"],
            "streaming": noise.rms_cells.variant_launches["streaming"],
            "rms_plain": noise._rms_cells_plain.calls,
            "labels": detect.label_components_batch.launches,
            "labels_plain": detect._label_components_plain.calls,
            "boltzmann": boltzmann.transfer_function.launches,
            "boltzmann_plain": boltzmann._transfer_plain.calls}


def batched_run(configDict, outName, noise, detect, device="cuda"):
    """One batched search with the kernel counters set to 0 just before it
    and read just after; returns (catalog, seconds, budget, counts)."""
    reset_counts(noise, detect)
    cat, secs, _ = run_search(configDict, device, outName)
    return cat, secs, chunk_budget(outName), read_counts(noise, detect)


def fixed_snr(cat):
    """fixed_SNR of every row (the device-detection catalog carries it
    as fixed_y_c / fixed_err_y_c, the host one also as a column)."""
    y = np.asarray(cat["fixed_y_c"], dtype=float)
    err = np.asarray(cat["fixed_err_y_c"], dtype=float)
    return np.divide(y, err, out=np.zeros_like(y), where=err != 0)


def profile_warm_run(configDict, outName="run_profile"):
    """One more warm batched run under torch.profiler: (wall s, device
    busy s, top device operations, the port's own kernels). Busy time sums
    the device-side events only (kernels and copies, on one stream, do not
    overlap); the CPU ops that launched them carry the same time and are
    left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_search(configDict, "cuda", outName)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, top, ours = device_busy(prof)
    return wall, busy, top, ours


def device_busy(prof):
    """(device busy s, top device operations, the port's own kernels) of a
    finished torch.profiler run: the sum of the device-side events' own
    times."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    onDevice = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in onDevice) / 1e6
    top = sorted(onDevice, key=dev_us, reverse=True)[:10]
    ours = [e for e in onDevice
            if "label_kernel" in e.key or "rms_cells" in e.key]

    def row(e):
        return (e.key[:70], round(dev_us(e) / 1e3, 3), e.count)
    return busy, [row(e) for e in top], [row(e) for e in ours]


def batched_phases(noise, detect, card, device="cuda"):
    """Phases 7 to 9; returns (the batched runs by tag, the survey's
    config dict, its truth table)."""
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
                                detect, device)
        cat, secs, bud, counts = runs[tag]
        nLabels = len(surveyDict["mapFilters"])
        # on the card every step launches each kernel once over all 16
        # tiles, rms_cells in its staged variant; a CPU rehearsal runs the
        # plain versions instead
        if onCard:
            want = {"rms_cells": nLabels, "largest_nT": nTiles,
                    "staged": nLabels, "streaming": 0, "rms_plain": 0,
                    "labels": nLabels, "labels_plain": 0, "boltzmann": 0,
                    "boltzmann_plain": 0}
        else:
            want = {"rms_cells": 0, "largest_nT": 0, "staged": 0,
                    "streaming": 0, "rms_plain": nLabels, "labels": 0,
                    "labels_plain": nLabels, "boltzmann": 0,
                    "boltzmann_plain": 0}
        if counts != want:
            raise RuntimeError("batched %s run: counts %s (want %s)"
                               % (tag, counts, want))
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
    cat, secs, bud, counts = runs["warm"]
    phase(8, "launches and plain calls of the warm run %s; step tensors on "
          "%s" % (json.dumps(counts), bud["devices"]))
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
        wall, busy, top, ours = profile_warm_run(surveyDict)
        phase(8, "profiled warm batched run: %.3f s wall, device busy %.3f "
              "s (%.1f%%); top device ops (name, ms, calls): %s; the "
              "port's kernels: %s (%s)" % (wall, busy, 100 * busy / wall,
                                          json.dumps(top), json.dumps(ours),
                                          card))

    return runs, surveyDict, surveyTruth


# -- phases 10 to 12 -----------------------------------------------------------

# examples/dr5-cluster-search.yml's selection-function options (the
# redshift catalog is the smoke's own; no transferFunction: the default
# Boltzmann transfer)
DR5_MASS_OPTIONS = {"tenToA0": 4.95e-5, "B0": 0.08, "Mpivot": 3.0e+14,
                    "sigma_int": 0.2, "relativisticCorrection": True,
                    "rescaleFactor": 0.71, "rescaleFactorErr": 0.07}
DR5_SELFN_OPTIONS = {"fixedSNRCut": 5.0, "method": "fast",
                     "massLimitMaps": [{"z": 0.5}]}
MASS_ROWS = 10000


def redshift_catalog(truth, path, seed=SEED + 11):
    """Seeded redshifts at the truth positions, half spectroscopic (zErr
    0) and half photometric (zErr 0.03), written as FITS."""
    from nemo_tpu_torch import catalogs
    from nemo_tpu_torch.utils.tables import Table
    rng = np.random.default_rng(seed)
    n = len(truth["RADeg"])
    catalogs.writeCatalog(Table({
        "name": np.array(["SMOKE-Z%04d" % i for i in range(n)]),
        "RADeg": np.asarray(truth["RADeg"]),
        "decDeg": np.asarray(truth["decDeg"]),
        "redshift": rng.uniform(0.1, 1.0, n),
        "redshiftErr": np.where(np.arange(n) % 2 == 0, 0.0, 0.03)}), path)


def epilogue_config(surveyDict, truth):
    """The survey's config with DR5's fitQ, calcSelFn, selFnOptions and
    massOptions, written as JSON (which YAML parsers read too); returns
    (config path, dict, output directory)."""
    work = os.path.join(WORK, "dr5")
    os.makedirs(work, exist_ok=True)
    zPath = os.path.join(work, "redshifts.fits")
    redshift_catalog(truth, zPath)
    outDir = os.path.join(work, "epilogue")
    d = dict(copy.deepcopy(surveyDict), fitQ=True, calcSelFn=True,
             outputDir=outDir, selFnOptions=copy.deepcopy(DR5_SELFN_OPTIONS),
             massOptions=dict(DR5_MASS_OPTIONS, redshiftCatalog=zPath))
    cfgPath = os.path.join(work, "dr5_epilogue.yml")
    with open(cfgPath, "w") as f:
        json.dump(d, f, indent=1)
    return cfgPath, d, outDir


def qfit_tables(path):
    """{tile: Q array} of a QFit.fits."""
    from nemo_tpu_torch.utils import fits as nfits
    out = {}
    for h in nfits.read(path):
        if h.is_table:
            cols, _ = nfits.read_table(path, ext=h.name)
            out[h.name] = np.asarray(cols["Q"], dtype=float)
    return out


def epilogue_phase(noise, detect, card, surveyDict, truth, device="cuda"):
    """Phase 10: ``nemo -S`` with the DR5 epilogue on the survey; returns
    (config path, config dict, output directory, launch counts)."""
    import torch
    from nemo_tpu_torch.cli import nemo_main
    from nemo_tpu_torch.models import cosmology, qfit
    from nemo_tpu_torch.utils.tables import Table
    from nemo_tpu_torch.utils.timing import RECORDER

    from nemo_tpu_torch.parallel import filtercache

    cfgPath, d, outDir = epilogue_config(surveyDict, truth)
    nTiles = len(d["tileDefinitions"])
    RECORDER.reset()
    deferred = []

    def count_deferred(orig):
        def run(fileName, *a):
            deferred.append(fileName)
            return orig(fileName, *a)
        return run

    reset_counts(noise, detect)
    t0 = time.perf_counter()
    with patched((filtercache, "register_deferred", count_deferred)):
        nemo_main.main([cfgPath, "-S", "--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts(noise, detect)
    stages = dict(RECORDER.totals)
    if device == "cuda" and (counts["boltzmann"] != 1
                             or counts["boltzmann_plain"] != 0
                             or counts["rms_cells"] <= 0
                             or counts["rms_plain"] != 0
                             or counts["labels"] <= 0
                             or counts["labels_plain"] != 0):
        raise RuntimeError("DR5 epilogue run: counts %s" % counts)

    selFn = os.path.join(outDir, "selFn")
    diag = os.path.join(outDir, "diagnostics")
    for name in ("QFit.fits", "RMSTab.fits", "fRelWeights.fits",
                 "tileAreas.fits"):
        if not os.path.exists(os.path.join(selFn, name)):
            raise RuntimeError("the epilogue wrote no selFn/%s" % name)
    qtabs = qfit_tables(os.path.join(selFn, "QFit.fits"))
    if len(qtabs) != nTiles:
        raise RuntimeError("QFit.fits holds %d tiles" % len(qtabs))
    # a sanity print, not a check: fitQ divides each tile's Q by the
    # reference model's own peak (and raises itself when that peak is more
    # than 1% off the filter's y0), so Q there is 1 by construction
    Q = qfit.QFit(selFnDir=selFn)
    thetaRef = cosmology.calcTheta500Arcmin(0.4, 2e14,
                                            cosmology.fiducialCosmoModel())
    qRef = {t: float(Q.getQ(np.array([thetaRef]), z=0.4, tileName=t)[0])
            for t in sorted(qtabs)}
    comp = Table.read(os.path.join(diag, "completeness90pc_full.fits"))
    z = np.asarray(comp["z"])
    mlim = np.asarray(comp["MLim_90pc_1e14MSun"])
    sel = (z > 0.2) & (z < 1.0) & np.isfinite(mlim)
    if not sel.any():
        raise RuntimeError("no 90% mass limit for 0.2 < z < 1")
    limMaps = [t for t in sorted(qtabs) if os.path.exists(os.path.join(
        diag, t, "massLimitMap_z0p5#%s.fits" % t))]
    if len(limMaps) != nTiles:
        raise RuntimeError("mass-limit maps for %d tiles" % len(limMaps))
    with open(os.path.join(diag, "chunk_budgets.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    qrecs = [r for r in recs if r.get("stage") == "fitQ"]
    route = "tile-batched" if qrecs else "per-tile"
    cacheLoads = qrecs[-1]["cum"]["cacheLoads"] if qrecs else None
    if device == "cuda" and (cacheLoads != nTiles
                             or len(deferred) != nTiles):
        raise RuntimeError("DR5 epilogue run: fitQ read %s filters from "
                           "the device cache, %d FITS writes deferred (%d "
                           "tiles)" % (cacheLoads, len(deferred), nTiles))
    # the same fit with a cache of budget 0: every filter from its FITS
    from nemo_tpu_torch import startup
    saved = filtercache.DEVICE_CACHE
    filtercache.DEVICE_CACHE = filtercache.DeviceFilterCache(maxBytes=0)
    try:
        config = startup.NemoConfig(startup.parseConfigDict(
            copy.deepcopy(d)), device=device)
        config.selFnDir = os.path.join(WORK, "dr5", "qfit_nocache")
        os.makedirs(config.selFnDir, exist_ok=True)
        t1 = time.perf_counter()
        qfit.fitQ(config)
        secsNoCache = time.perf_counter() - t1
    finally:
        filtercache.DEVICE_CACHE = saved
    with open(os.path.join(config.diagnosticsDir,
                           "chunk_budgets.jsonl")) as f:
        cumNoCache = [json.loads(line) for line in f][-1].get("cum", {})
    noCache = qfit_tables(os.path.join(config.selFnDir, "QFit.fits"))
    if device == "cuda" and cumNoCache.get("cacheLoads") != 0:
        raise RuntimeError("fitQ with a cache of budget 0 read %s filters "
                           "from it" % cumNoCache.get("cacheLoads"))
    if sorted(noCache) != sorted(qtabs) or any(
            not np.array_equal(noCache[t], qtabs[t]) for t in qtabs):
        raise RuntimeError("fitQ from the FITS differs from fitQ from the "
                           "device cache")
    phase(10, "fitQ's filters: %s of %d from the device cache (%d FITS "
          "writes deferred until fitQ released them), loadFilter %.3f s; "
          "with a cache of budget 0: loadFilter %.3f s, fitQ %.2f s, "
          "QFit.fits bitwise the same (%s)"
          % (cacheLoads, nTiles, len(deferred),
             qrecs[-1]["cum"]["loadFilter"] if qrecs else float("nan"),
             cumNoCache.get("loadFilter", float("nan")), secsNoCache, card))
    phase(10, "nemo -S on %s, %d tiles x %d scales with the DR5 epilogue: "
          "%.2f s; stages (s) %s; fitQ route %s, chunks of %s tiles, "
          "budget %s; launches and plain calls %s (%s)"
          % (device, nTiles, len(d["mapFilters"]), secs,
             json.dumps({k: round(v, 3) for k, v in sorted(stages.items())}),
             route, [r["nTiles"] for r in qrecs],
             json.dumps(qrecs[-1]["cum"] if qrecs else {}),
             json.dumps(counts), card))
    phase(10, "Q at the reference filter's theta500 (%.3f') per tile: %s; "
          "90%% mass limit for 0.2 < z < 1: mean %.3f, range %.3f-%.3f "
          "x 1e14 MSun (M500c); mass-limit maps for %d tiles (%s)"
          % (thetaRef, json.dumps({t: round(q, 4) for t, q in qRef.items()}),
             float(np.mean(mlim[sel])), float(np.min(mlim[sel])),
             float(np.max(mlim[sel])), len(limMaps), card))
    return cfgPath, d, outDir, counts


def qfit_routes_phase(card, d, outDir, device="cuda"):
    """Phase 11: the per-tile route (model chunks of 16) on the card on
    every tile, and the CPU float64 serial route on one tile, against the
    epilogue's tile-batched Q tables.  Tolerance rtol 1e-4: the float32
    FFTs of a 900 x 1536 tile carry ~1e-6 relative round-off into each
    filtered peak, and the routes sum in other orders."""
    from nemo_tpu_torch import startup
    from nemo_tpu_torch.models import qfit

    batched = qfit_tables(os.path.join(outDir, "selFn", "QFit.fits"))

    def run(device, tiles, tag):
        parDict = startup.parseConfigDict(copy.deepcopy(d))
        parDict["qfitTileBatch"] = False
        config = startup.NemoConfig(parDict, device=device)
        config.selFnDir = os.path.join(WORK, "dr5", "qfit_" + tag)
        os.makedirs(config.selFnDir, exist_ok=True)
        config.tileNames = tiles
        t0 = time.perf_counter()
        qfit.fitQ(config)
        secs = time.perf_counter() - t0
        got = qfit_tables(os.path.join(config.selFnDir, "QFit.fits"))
        rel = max(float(np.max(np.abs(got[t] / batched[t] - 1)))
                  for t in tiles)
        if rel > 1e-4:
            raise RuntimeError("fitQ %s route differs from tile-batched by "
                               "%.3e" % (tag, rel))
        return rel, secs

    tiles = sorted(batched)
    relCard, secsCard = run(device, tiles, device + "_serial")
    relCpu, secsCpu = run("cpu", tiles[:1], "cpu_serial_one")
    phase(11, "fitQ on the card: per-tile route (model chunks of 16) on %d "
          "tiles in %.2f s, max rel diff from the tile-batched route %.2e; "
          "CPU float64 serial route on tile %s in %.2f s, max rel diff "
          "%.2e (tolerance 1e-4, float32) (%s)"
          % (len(tiles), secsCard, relCard, tiles[0], secsCpu, relCpu, card))


def masses_phase(card, cfgPath, d, outDir, truth, device="cuda"):
    """Phase 12: nemoMass on the card against nemoMass on the CPU (float64,
    the plain Boltzmann solve), then calcMassBatch on MASS_ROWS seeded rows
    (half photometric) on the card (float32) against the CPU (float64),
    with the Eisenstein & Hu transfer for this comparison."""
    import torch
    from nemo_tpu_torch.cli import nemoMass_main
    from nemo_tpu_torch.mock import MockSurvey
    from nemo_tpu_torch.models import qfit, scaling
    from nemo_tpu_torch.utils.tables import Table

    t0 = time.perf_counter()
    nemoMass_main.main([cfgPath, "--device", device])
    secs = time.perf_counter() - t0
    tab = Table.read(os.path.join(outDir, "%s_mass.fits"
                                  % os.path.basename(outDir)))
    m = np.asarray(tab["M500c"], dtype=float)
    ok = np.asarray(tab["fixed_y_c"], dtype=float) > 0
    if len(tab) < 0.8 * len(truth["RADeg"]) or not np.all(m[ok] > 0):
        raise RuntimeError("nemoMass: %d rows, %d with M500c > 0"
                           % (len(tab), int(np.sum(m > 0))))
    cols = {c: np.asarray(tab[c], dtype=float)[ok]
            for c in ("M500c", "M500cUncorr", "M500cCal", "M200m",
                      "M500c_errPlus", "M500c_errMinus", "Q")}
    if not all(np.all(np.isfinite(v)) for v in cols.values()):
        raise RuntimeError("nemoMass wrote non-finite masses")
    np.testing.assert_allclose(cols["M500cCal"], cols["M500c"] / 0.71,
                               rtol=1e-6)
    if not (np.all(cols["M200m"] > cols["M500c"])
            and np.all(cols["M500cUncorr"] > 0)):
        raise RuntimeError("nemoMass: M200m or Uncorr columns wrong")
    zErr = np.asarray(tab["redshiftErr"], dtype=float)
    phase(12, "nemoMass on the card: %d clusters matched to the redshift "
          "catalog (%d photometric) in %.2f s; median M500c %.3f, "
          "M500cUncorr %.3f, M500cCal %.3f, M200m %.3f x 1e14 MSun, "
          "median Q %.3f (%s)"
          % (len(tab), int(np.sum(zErr > 0)), secs,
             *(float(np.median(cols[c])) for c in
               ("M500c", "M500cUncorr", "M500cCal", "M200m", "Q")), card))

    # the same catalog on the CPU in float64, its Boltzmann solve the
    # plain version: the card's float32 ML point may move one fine-grid
    # step (3e-4 dex, 7e-4 relative), and M200m and Cal follow M500c
    cpuPath = os.path.join(WORK, "dr5", "mass_cpu.fits")
    t0 = time.perf_counter()
    nemoMass_main.main([cfgPath, "--device", "cpu", "-o", cpuPath])
    cpuSecs = time.perf_counter() - t0
    cpuTab = Table.read(cpuPath)
    if list(np.asarray(cpuTab["name"])) != list(np.asarray(tab["name"])):
        raise RuntimeError("nemoMass: the CPU run matched other rows")
    massCols = ("M500c", "M500cUncorr", "M500cCal", "M200m")
    rels = {c: float(np.max(np.abs(
        cols[c] / np.asarray(cpuTab[c], dtype=float)[ok] - 1)))
        for c in massCols}
    if max(rels.values()) > 2e-3:
        raise RuntimeError("nemoMass card vs CPU: max |ratio - 1| %s" % rels)
    phase(12, "nemoMass on the CPU (float64, plain Boltzmann solve) in "
          "%.2f s; card vs CPU max |ratio - 1|: %s (tolerance 2e-3: "
          "float32) (%s)"
          % (cpuSecs, ", ".join("%s %.2e" % (c, rels[c]) for c in massCols),
             card))

    rng = np.random.default_rng(SEED + 12)
    y0 = rng.uniform(2e-5, 3e-4, MASS_ROWS)
    rows = (y0, y0 / rng.uniform(4.0, 15.0, MASS_ROWS),
            rng.uniform(0.1, 1.4, MASS_ROWS),
            np.where(np.arange(MASS_ROWS) % 2 == 0, 0.0,
                     rng.uniform(0.01, 0.05, MASS_ROWS)))
    tiles = list(rng.choice(sorted(qfit_tables(os.path.join(
        outDir, "selFn", "QFit.fits"))), MASS_ROWS))
    Q = qfit.QFit(selFnDir=os.path.join(outDir, "selFn"))
    kw = {k: DR5_MASS_OPTIONS[k] for k in ("tenToA0", "B0", "Mpivot",
                                           "sigma_int")}
    res, secs = {}, {}
    for dev in (device, "cpu"):
        ms = MockSurvey(1e13, 700.0, 0.0, 3.0, 70.0, 0.3, 0.05, 0.8, 0.95,
                        transferFunction="eisenstein_hu", device=dev)
        if dev == "cuda":       # warm the card's path
            scaling.calcMassBatch(*(r[:64] for r in rows), Q, ms,
                                  tileNames=tiles[:64], **kw)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[dev] = scaling.calcMassBatch(*rows, Q, ms, tileNames=tiles,
                                         **kw)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    c, p = res[device], res["cpu"]
    # float32 on the card: the ML point may move one fine-grid step (3e-4
    # dex) and the 68.3% crossing one or two, Q one mass-grid point
    relM = float(np.max(np.abs(c["M500c"] / p["M500c"] - 1)))
    errDiff = max(float(np.max(np.abs(c[k] - p[k]) / p["M500c"]))
                  for k in ("M500c_errPlus", "M500c_errMinus",
                            "M500cUncorr_errPlus"))
    qDiff = float(np.max(np.abs(c["Q"] - p["Q"])))
    if relM > 2e-3 or errDiff > 3e-3 or qDiff > 1e-2 \
            or not np.all(np.isfinite(c["M500c"])):
        raise RuntimeError("calcMassBatch card vs CPU: M %.2e, errors %.2e,"
                           " Q %.2e" % (relM, errDiff, qDiff))
    phase(12, "calcMassBatch, %d rows (half photometric): card %.3f s "
          "(%.0f rows/s), CPU float64 %.3f s (%.0f rows/s); card vs CPU: "
          "max |M500c ratio - 1| %.2e, max |error diff| / M500c %.2e, max "
          "|Q diff| %.2e (tolerances 2e-3, 3e-3, 1e-2: float32) (%s)"
          % (MASS_ROWS, secs[device], MASS_ROWS / secs[device],
             secs["cpu"], MASS_ROWS / secs["cpu"], relM, errDiff, qDiff,
             card))
    return MASS_ROWS / secs[device]


# -- phase 13 ------------------------------------------------------------------

# examples/dr5-cluster-search.yml's injection settings; the model is the
# photometry filter's own (the DR5 example sets none, and a cluster run
# without models recovers nothing)
INJ_MODELS = [{"redshift": 0.4, "M500": 2.0e14}]
INJ_ITERATIONS = 9
INJ_PER_TILE = 50
INJ_SEED = SEED + 13
INJ_COMPARED = 2            # iterations rerun on the per-tile engine
PAINT_SOURCES = 10000
# operations per window pixel of paint_objects: the distance (6), the
# interpolation (a ~12-step binary search and 6), the amplitude and the add
PAINT_OPS_PER_WINDOW_PIXEL = 6 + 12 + 6 + 2


@contextlib.contextmanager
def patched(*targets):
    """Wrap module or class attributes for the length of a ``with``; each
    wrapper gets the original and returns the replacement."""
    with contextlib.ExitStack() as stack:
        for owner, name, wrap in targets:
            stack.enter_context(mock.patch.object(owner, name,
                                                  wrap(getattr(owner, name))))
        yield


def injection_recorder(log, profiled=None):
    """Wrappers that record each injection iteration: the mock catalog and
    its seconds, each rerun's catalog, seconds and chunk records.  The
    rerun of iteration ``profiled`` (1-based) runs under torch.profiler,
    tracing the card only, and records its device-busy seconds and top
    device operations (``device_busy``)."""
    from nemo_tpu_torch import catalogs, pipelines

    def mock(orig):
        def run(*a, **kw):
            t0 = time.perf_counter()
            cat = orig(*a, **kw)
            log.append({"mock": cat, "mock_s": time.perf_counter() - t0})
            return cat
        return run

    def rerun(orig):
        def run(config, *a, **kw):
            if not kw.get("useCachedFilters"):
                return orig(config, *a, **kw)       # not an injection rerun
            budgets = os.path.join(config.diagnosticsDir,
                                   "chunk_budgets.jsonl")
            n0 = 0
            if os.path.exists(budgets):
                with open(budgets) as f:
                    n0 = len(f.readlines())
            prof = None
            if len(log) == profiled:
                import torch
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CUDA])
            with prof or contextlib.nullcontext():
                t0 = time.perf_counter()
                cat = orig(config, *a, **kw)
                if prof is not None:
                    torch.cuda.synchronize()
                log[-1]["rerun_s"] = time.perf_counter() - t0
            if prof is not None:
                (log[-1]["device_busy_s"], log[-1]["device_top"],
                 _) = device_busy(prof)
            log[-1]["catalog"] = cat
            with open(budgets) as f:
                log[-1]["chunks"] = [json.loads(x)
                                     for x in f.readlines()[n0:]]
            return cat
        return run
    return ((catalogs, "generateTestCatalog", mock),
            (pipelines, "filterMapsAndMakeCatalogs", rerun))


def counting(counts):
    """Wrappers that count the per-tile engine's filter builds and read the
    kernel counters and step calls at the start and end of the injection
    test (the reruns)."""
    from nemo_tpu_torch import filters, maps
    from nemo_tpu_torch.ops import detect, noise
    from nemo_tpu_torch.parallel import distribute

    def snapshot():
        c = read_counts(noise, detect)
        c.update({"step_" + k: v for k, v in
                  distribute.make_matched_filter_step.calls.items()},
                 host_builds=counts["host_builds"])
        return c

    def build(orig):
        def run(*a, **kw):
            counts["host_builds"] += 1
            return orig(*a, **kw)
        return run

    def injection(orig):
        def run(config, *a, **kw):
            before = snapshot()
            out = orig(config, *a, **kw)
            after = snapshot()
            counts["reruns"] = {k: after[k] - before[k] for k in after
                                if k != "largest_nT"}
            return out
        return run
    counts["host_builds"] = 0
    return ((filters.MatchedFilter, "_buildFilter", build),
            (maps, "sourceInjectionTest", injection))


def injection_config(surveyDict, outName, **over):
    """The survey's DR5 config with fitQ and the injection settings,
    written as JSON; returns (path, dict)."""
    work = os.path.join(WORK, "inj")
    os.makedirs(work, exist_ok=True)
    d = dict(copy.deepcopy(surveyDict), fitQ=True,
             outputDir=os.path.join(work, outName),
             sourceInjectionModels=copy.deepcopy(INJ_MODELS),
             sourceInjectionIterations=INJ_ITERATIONS,
             sourcesPerTile=INJ_PER_TILE, seed=INJ_SEED, **over)
    path = os.path.join(work, outName + ".yml")
    with open(path, "w") as f:
        json.dump(d, f, indent=1)
    return path, d


def compare_injection(mocksB, recsB, mocksH, recsH):
    """Per iteration: the same mock catalog; every injected object that
    either run recovers at S/N >= 5 (nearest detection within 1') is
    recovered by both, within 0.1', y_c within rtol 5e-3.  Returns
    (objects compared, max offset ', max |y_c ratio - 1|)."""
    from nemo_tpu_torch.utils.wcs import calcAngSepDeg
    n, maxSep, maxDy = 0, 0.0, 0.0
    for it, (mb, mh, b, h) in enumerate(zip(mocksB, mocksH, recsB, recsH)):
        if not (np.array_equal(np.asarray(mb["RADeg"]), np.asarray(mh["RADeg"]))
                and np.array_equal(np.asarray(mb["y_c"]),
                                   np.asarray(mh["y_c"]))):
            raise RuntimeError("iteration %d drew other mock catalogs" % it)
        truth = {"RADeg": np.asarray(mb["RADeg"], dtype=float),
                 "decDeg": np.asarray(mb["decDeg"], dtype=float)}
        ib, ih = match(truth, b, 1.0), match(truth, h, 1.0)
        snrB = np.where(ib >= 0, np.asarray(b["SNR"])[ib], 0)
        snrH = np.where(ih >= 0, np.asarray(h["SNR"])[ih], 0)
        sel = (snrB >= 5) | (snrH >= 5)
        missing = np.nonzero(sel & ((ib < 0) | (ih < 0)))[0]
        if len(missing):
            raise RuntimeError("iteration %d: injected objects %s recovered "
                               "by one engine only" % (it, missing.tolist()))
        gb, gh = ib[sel], ih[sel]
        sep = 60 * calcAngSepDeg(
            np.asarray(b["RADeg"], dtype=float)[gb],
            np.asarray(b["decDeg"], dtype=float)[gb],
            np.asarray(h["RADeg"], dtype=float)[gh],
            np.asarray(h["decDeg"], dtype=float)[gh])
        if np.any(sep > 0.1):
            raise RuntimeError("iteration %d: batched/per-tile offsets up "
                               "to %.3f'" % (it, sep.max()))
        yB = np.asarray(b["y_c"], dtype=float)[gb]
        yH = np.asarray(h["y_c"], dtype=float)[gh]
        np.testing.assert_allclose(yB, yH, rtol=5e-3)
        n += int(sel.sum())
        maxSep = max(maxSep, float(sep.max(initial=0.0)))
        maxDy = max(maxDy, float(np.max(np.abs(yB / yH - 1), initial=0.0)))
    return n, maxSep, maxDy


def paint_timings(card, surveyDict, device="cuda"):
    """paint_objects at the injection shape (the model's 50 clusters on one
    tile) and at 10,000 point sources on the whole survey map: card float32
    and float64 (CUDA events) and CPU float64 times, each against the CPU
    float64 canvas, two float32 calls bitwise equal; the bound from the
    bytes (inputs read once, the canvas written once) and the operations
    of the windows."""
    import torch
    from nemo_tpu_torch import maps
    from nemo_tpu_torch.models import cosmology, profiles
    from nemo_tpu_torch.models.beams import BeamProfile
    from nemo_tpu_torch.ops import paint
    from nemo_tpu_torch.utils import wcs as nwcs

    onCard = device == "cuda"
    rng = np.random.default_rng(SEED + 14)
    beamFile = surveyDict["unfilteredMaps"][0]["beamFileName"]
    out = {}
    m = INJ_MODELS[0]
    theta = cosmology.calcTheta500Arcmin(m["redshift"], m["M500"],
                                         cosmology.fiducialCosmoModel())
    prof = profiles.makeArnaudModelProfile(m["redshift"], m["M500"])
    grid = SURVEY_GRID
    cases = {
        "injection": (SHAPE, INJ_PER_TILE, profiles.signalTemplateTable(
            prof["rDeg"], prof["prof"], beam=beamFile,
            amplitude=rng.uniform(1e-4, 1e-3, INJ_PER_TILE)),
            maps._quantizeSizeDeg(5 * theta / 60)),
        "sources": ((grid[0] * SHAPE[0], grid[1] * SHAPE[1]), PAINT_SOURCES,
                    profiles.beamTemplateTable(
                        beamFile, 10 ** rng.uniform(1, 3, PAINT_SOURCES)),
                    maps._quantizeSizeDeg(
                        5 * BeamProfile(beamFileName=beamFile).FWHMArcmin
                        / 60))}
    for tag, (shape, n, (r, v, amps), rmaxDeg) in cases.items():
        w = nwcs.makeWCS(shape, PIX_ARCMIN / 60.0, centreRADeg=60.0,
                         centreDecDeg=-30.0)
        dxr = maps.pixScaleXRadPerRow(w, shape)
        pix = maps.pixScalesRad(w, shape)
        ys = rng.uniform(0, shape[0], n)
        xs = rng.uniform(0, shape[1], n)
        rmax = np.radians(rmaxDeg)

        def run(dev, dt, ys=ys, xs=xs, amps=amps, r=r, v=v, rmax=rmax,
                dxr=dxr, pix=pix, shape=shape):
            return paint.paint_objects(shape, pix, ys, xs, amps, r, v, rmax,
                                       dx_rows=dxr, device=dev, dtype=dt)
        t0 = time.perf_counter()
        ref = run("cpu", torch.float64).numpy()
        cpuMs = 1e3 * (time.perf_counter() - t0)
        peak = float(np.abs(ref).max())
        res = {"objects": n, "shape": list(shape), "cpu_f64_ms": cpuMs}
        wy = min(int(np.ceil(rmax / pix[0])), shape[0])
        wx = min(int(np.ceil(rmax / float(dxr.min()))), shape[1])
        winPix = n * (2 * wy + 1) * (2 * wx + 1)
        res["window"] = [2 * wy + 1, 2 * wx + 1]
        for dt, name, size, tol in ((torch.float32, "float32", 4, 1e-5),
                                    (torch.float64, "float64", 8, 1e-12)):
            if not onCard:
                continue
            a = run(device, dt)
            b = run(device, dt)
            if not torch.equal(a, b):
                raise RuntimeError("paint_objects %s %s: two calls differ"
                                   % (tag, name))
            err = float(np.max(np.abs(a.cpu().numpy().astype(np.float64)
                                      - ref)))
            if err > tol * peak:
                raise RuntimeError("paint_objects %s %s: max abs err %.3e "
                                   "of peak %.3e" % (tag, name, err, peak))
            nbytes = size * (3 * n + 2 * len(r) + shape[0]
                             + shape[0] * shape[1])
            bms, by = bound(nbytes, PAINT_OPS_PER_WINDOW_PIXEL * winPix,
                            name)
            res[name] = {"ms": time_ms(lambda: run(device, dt), 5),
                         "max_abs_err": err, "bound_ms": bms, "bound_by": by,
                         "bitwise_repeat": True}
            del a, b
        out[tag] = res
    phase(13, "paint_objects (torch ops, no kernel): %s (%s)"
          % (json.dumps(out), card))
    return out


def injection_phase(noise, detect, card, surveyDict, device="cuda"):
    """Phase 13: ``nemo -I`` on the survey through the batched engine, then
    its first INJ_COMPARED iterations again on the per-tile engine."""
    import torch
    from nemo_tpu_torch import maps, startup
    from nemo_tpu_torch.cli import nemo_main
    from nemo_tpu_torch.utils.tables import Table
    from nemo_tpu_torch.utils.timing import RECORDER

    paint_timings(card, surveyDict, device)
    cfgPath, d = injection_config(surveyDict, "batched")
    nTiles = len(d["tileDefinitions"])
    logB, counts = [], {}
    RECORDER.reset()
    reset_counts(noise, detect)
    t0 = time.perf_counter()
    onCard = device == "cuda"
    with patched(*injection_recorder(logB, INJ_ITERATIONS if onCard
                                     else None), *counting(counts)):
        nemo_main.main([cfgPath, "-I", "--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    whole = read_counts(noise, detect)
    reruns = counts["reruns"]
    stages = dict(RECORDER.totals)
    if len(logB) != INJ_ITERATIONS or any(
            len(it["chunks"]) != 1 or it["chunks"][0]["givenLabels"] != 1
            for it in logB):
        raise RuntimeError("injection reruns: %d iterations, chunks %s"
                           % (len(logB), [[c.get("givenLabels") for c in
                                           it.get("chunks", [])]
                                          for it in logB]))
    kernelsOk = (whole["rms_cells"] > 0 and whole["labels"] > 0
                 and whole["rms_plain"] == 0 and whole["labels_plain"] == 0
                 and reruns["rms_cells"] == INJ_ITERATIONS
                 and reruns["rms_plain"] == 0) if onCard else \
        (whole["rms_cells"] == 0 and whole["labels"] == 0)
    if reruns["step_given"] != INJ_ITERATIONS or reruns["step_build"] != 0 \
            or reruns["host_builds"] != 0 or not kernelsOk:
        raise RuntimeError("nemo -I: counts %s, reruns %s" % (whole, reruns))

    selFn = os.path.join(d["outputDir"], "selFn")
    tab = Table.read(os.path.join(selFn, "sourceInjectionData.fits"))
    inF = np.asarray(tab["inFlux"], dtype=float)
    outF = np.asarray(tab["outFlux"], dtype=float)
    snr = np.asarray(tab["SNR"], dtype=float)
    rArc = np.asarray(tab["rArcmin"], dtype=float)
    corr = float(np.corrcoef(inF, outF)[0, 1])
    bright = snr > 8
    ratio = float(np.median(outF[bright] / inF[bright]))
    offset = float(np.median(rArc[bright]) * 60)
    if len(tab) < 0.3 * nTiles * INJ_PER_TILE * INJ_ITERATIONS \
            or corr <= 0.7 or bright.sum() < 20 \
            or not 0.95 < ratio < 1.08 or offset >= 12.0 \
            or not np.all(np.isfinite(outF)):
        raise RuntimeError("injection results: %d rows, corr %.3f, %d "
                           "bright, median ratio %.4f, median offset "
                           "%.2f\"" % (len(tab), corr, int(bright.sum()),
                                        ratio, offset))
    phase(13, "nemo -I on %s, %d tiles: first pass (%d scales) and "
          "epilogue, then %d iterations x %d sources a tile of M500 %.1e "
          "z %.1f on the batched engine: %.2f s; stages (s) %s; %d rows, "
          "corr(inFlux, outFlux) %.3f, bright (S/N > 8: %d) median "
          "outFlux/inFlux %.4f, median offset %.2f\" (%s)"
          % (device, nTiles, len(d["mapFilters"]), INJ_ITERATIONS,
             INJ_PER_TILE, INJ_MODELS[0]["M500"], INJ_MODELS[0]["redshift"],
             secs, json.dumps({k: round(v, 3) for k, v in
                               sorted(stages.items())}), len(tab), corr,
             int(bright.sum()), ratio, offset, card))
    rows = []
    for it in logB:
        c = it["chunks"][0]
        rows.append({"wall": round(it["mock_s"] + it["rerun_s"], 3),
                     "mock": round(it["mock_s"], 3),
                     "rerun": round(it["rerun_s"], 3),
                     "staging": round(c["stageWait"] + c["upload"], 3),
                     "step": round(c["step"], 3),
                     "download": round(c["download"], 3),
                     "catalog": round(c["consume"], 3),
                     "other": round(it["rerun_s"] - c["stageWait"]
                                    - c["upload"] - c["step"]
                                    - c["download"] - c["consume"], 3)})
    phase(13, "per iteration (s; staging = staging-worker wait + upload, "
          "catalog = host detection and photometry, other = the rest of "
          "the rerun: optimal catalog, emission): %s (%s)"
          % (json.dumps(rows), card))
    if onCard:
        last = logB[-1]
        phase(13, "iteration %d's rerun under torch.profiler (card only): "
              "%.3f s wall, device busy %.3f s (%.1f%%); top device ops "
              "(name, ms, calls): %s (%s)"
              % (INJ_ITERATIONS, last["rerun_s"], last["device_busy_s"],
                 100 * last["device_busy_s"] / last["rerun_s"],
                 json.dumps(last["device_top"]), card))
    phase(13, "launches and plain calls: the whole run %s; the reruns %s "
          "(given steps %d, build steps %d, per-tile filter builds %d; the "
          "reruns detect on the host against the cached RMS maps, as "
          "nemo_tpu does, so the labelling kernel runs in the first pass)"
          % (json.dumps(whole), json.dumps(reruns), reruns["step_given"],
             reruns["step_build"], reruns["host_builds"]))

    # the first iterations again on the per-tile engine, same seed
    logH, countsH = [], {}
    parDict = startup.parseConfigDict(copy.deepcopy(d))
    parDict.update(useDeviceBatching=False,
                   sourceInjectionIterations=INJ_COMPARED)
    config = startup.NemoConfig(parDict, device=device)
    t0 = time.perf_counter()
    with patched(*injection_recorder(logH), *counting(countsH)):
        maps.sourceInjectionTest(config)
    hostSecs = time.perf_counter() - t0
    if countsH["reruns"]["host_builds"] != 0 \
            or countsH["reruns"]["step_build"] != 0:
        raise RuntimeError("per-tile reruns built filters: %s"
                           % countsH["reruns"])
    n, maxSep, maxDy = compare_injection(
        [it["mock"] for it in logB[:INJ_COMPARED]],
        [it["catalog"] for it in logB[:INJ_COMPARED]],
        [it["mock"] for it in logH], [it["catalog"] for it in logH])
    if n < 0.2 * nTiles * INJ_PER_TILE * INJ_COMPARED:
        raise RuntimeError("only %d injected objects compared" % n)
    phase(13, "iterations 1-%d again on the per-tile engine on %s: %.2f s "
          "(%s s an iteration), no filter built; %d injected objects at "
          "S/N >= 5 in either run, found by both, max offset %.4f', max "
          "|y_c ratio - 1| %.2e (%s)"
          % (INJ_COMPARED, device, hostSecs,
             [round(it["mock_s"] + it["rerun_s"], 2) for it in logH], n,
             maxSep, maxDy, card))
    return whole, reruns


# -- phase 14 ------------------------------------------------------------------

SIM_LMAX = 6000              # maps.CURVED_AUTO_LMAX: the auto curved path
MODEL_LMAX = 12000           # nemoModel's default CMB band limit (lensedClTT)
SIM_DEC = -47.0              # phase 14's survey centre: dec ~ -62 .. -32
# float operations of csrc/legendre_contract.cu per (m, ring) lane and l,
# counted from the source: the recurrence c P, b Pp, their difference, a
# times it; the |P| > 2^48 test; lam = P 2^S; then in synthesis two
# products and two sums into F, in analysis the two products lam G and the
# two sums of the ring reduction (R - 1 of them a row, one a lane)
LEGENDRE_OPS_PER_LANE_STEP = {"synthesis": 10, "analysis": 10}


def legendre_rings_of_tile(shape=SHAPE, decDeg=-58.25):
    """Colatitudes, FFT length and ring weights of one 896 x 1536 tile at
    0.5' centred at ``decDeg`` (dec -62 .. -54.5 by default)."""
    from nemo_tpu_torch.ops import sht
    from nemo_tpu_torch.utils import wcs as nwcs
    w = nwcs.makeWCS(shape, PIX_ARCMIN / 60.0, centreRADeg=30.0,
                     centreDecDeg=decDeg)
    thetas, nphi, _, _ = sht.car_ring_geometry(shape, w)
    return thetas, nphi, sht.ring_weights(thetas, 1.0), w


def legendre_lane_steps(lmax, mmax, R):
    """Active (l, m) pairs times rings: the kernel's lane-steps."""
    nm = min(lmax, mmax) + 1
    return (nm * (lmax + 1) - nm * (nm - 1) // 2) * R


def legendre_bound(direction, lmax, R, dtype):
    """(bound ms, "bytes"/"operations") of one contraction: the alm
    triangle and the (m, ring) array, one read and one written, and
    LEGENDRE_OPS_PER_LANE_STEP a lane-step."""
    import torch
    size = 4 if dtype == torch.float32 else 8
    ntri = legendre_lane_steps(lmax, lmax, 1)
    nbytes = size * (2 * ntri + 2 * (lmax + 1) * R + 2 * R)
    ops = LEGENDRE_OPS_PER_LANE_STEP[direction] \
        * legendre_lane_steps(lmax, lmax, R)
    return bound(nbytes, ops, "float32" if dtype == torch.float32
                 else "float64")


def time_once(fn):
    """(result, ms) of one call, timed with CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def kernel_only_ms(sht, fn, reps):
    """Mean ms a call of ``fn`` spends in the Legendre kernel itself: CUDA
    events recorded around each launch (``sht._launch``) of ``reps``
    calls, after one warm call."""
    import torch
    events = []
    launch = sht._launch

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(*args)
        stop.record()
        events.append((start, stop))

    fn()
    with mock.patch.object(sht, "_launch", timed):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def check_legendre(sht, card, lmax=SIM_LMAX, reps=3):
    """Phase 14a: the Legendre kernel against its plain version on the
    rings of one dec -62 .. -54.5 tile at lmax = mmax = ``lmax``, both
    directions, float32 and float64, timed plain, kernel, kernel, plain
    (the call), then the kernel's launches alone; synthesis bitwise equal
    to plain, analysis within its tolerance, two kernel calls bitwise
    equal.  Synthesis takes a lensed-CMB alm from rand_alm, analysis the ring coefficients
    of a white map."""
    import torch
    from nemo_tpu_torch.ops import grf
    thetas, nphi, wts, _ = legendre_rings_of_tile()
    R = len(thetas)
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    alm = sht.rand_alm(grf.lensedClTT()[:lmax + 1], lmax=lmax, generator=g)
    G = torch.randn((2, lmax + 1, R), generator=g, dtype=torch.float64,
                    device="cuda") * (2 * np.pi / nphi)
    inputs = {"synthesis": (alm.real, alm.imag), "analysis": (G[0], G[1])}
    res = {}
    for direction in ("synthesis", "analysis"):
        adj = direction == "analysis"
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[-1]
            th = torch.as_tensor(thetas, dtype=dtype, device="cuda")
            re, im = (x.to(dtype) for x in inputs[direction])
            w = torch.as_tensor(wts, dtype=dtype, device="cuda")

            def plain():
                return sht._legendre_contract_plain(th, re, im, lmax, lmax,
                                                    adj, w)

            def kernel():
                return sht.legendre_contract(thetas, re, im, lmax, lmax,
                                             adjoint=adj, weights=wts,
                                             dtype=dtype, device="cuda")

            ref, p0 = time_once(plain)
            a = kernel()
            k0 = time_ms(kernel, reps)
            k1 = time_ms(kernel, reps)
            b = kernel()
            _, p1 = time_once(plain)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(a, b))
            if not bitwise:
                raise RuntimeError("legendre %s %s: two kernel calls differ"
                                   % (direction, name))
            r = ref.double()
            err = float(torch.max(torch.abs(a.double() - r)))
            if dtype == torch.float64:
                tol = 1e-10 * float(torch.max(torch.abs(r)))
            elif adj:
                tol = 1e-5 * float(torch.max(torch.abs(r)))
            else:
                tol = 1e-5 * float(torch.std(r))
            if not (err <= tol and bool(torch.isfinite(a).all())):
                raise RuntimeError("legendre %s %s: max error %.3e over the "
                                   "tolerance %.3e" % (direction, name, err,
                                                       tol))
            equal = bool(torch.equal(a, ref))
            if not adj and not equal:
                raise RuntimeError("legendre synthesis %s: not bitwise "
                                   "equal to plain" % name)
            kms = kernel_only_ms(sht, kernel, reps)
            bms, by = legendre_bound(direction, lmax, R, dtype)
            ms = (k0 + k1) / 2
            res[(direction, name)] = {
                "ms": ms, "kernel_ms": kms, "plain_ms": (p0 + p1) / 2,
                "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                "tol": tol, "equal_to_plain": equal}
            phase(14, "legendre %s %s, lmax %d, %d rings: call %.3f / "
                  "%.3f ms, kernel %.3f ms, plain %.1f / %.1f ms "
                  "(%.0fx), bound %.3f ms (%s, %.1f%% of the call, %.1f%% "
                  "of the kernel), max |err| %.3e (tolerance %.3e), equal "
                  "to plain %s, two kernel calls bitwise equal (%s)"
                  % (direction, name, lmax, R, k0, k1, kms, p0, p1, (p0 + p1) / (k0 + k1), bms, by,
                     100 * bms / ms, 100 * bms / kms, err, tol, equal,
                     card))
            del ref, a, b, re, im
            torch.cuda.empty_cache()
    res[("synthesis", "float32 lmax %d" % MODEL_LMAX)] = check_legendre_at(
        sht, card, thetas, g, MODEL_LMAX, reps)
    res[("analysis", "float32 %d rings" % MULTI_RINGS)] = \
        check_analysis_blocks(sht, card, g, reps)
    return res


def check_legendre_at(sht, card, thetas, g, lmax, reps):
    """Synthesis float32 on the same rings at nemoModel's CMB band limit
    (lmax = mmax = ``lmax``): bitwise equal to one plain call, two kernel
    calls bitwise equal, the call and the kernel alone timed."""
    import torch
    from nemo_tpu_torch.ops import grf
    alm = sht.rand_alm(grf.lensedClTT()[:lmax + 1], lmax=lmax, generator=g)
    re, im = alm.real.float(), alm.imag.float()
    del alm
    th = torch.as_tensor(thetas, dtype=torch.float32, device="cuda")

    def kernel():
        return sht.legendre_contract(thetas, re, im, lmax, lmax,
                                     dtype=torch.float32, device="cuda")

    ref, pms = time_once(lambda: sht._legendre_contract_plain(
        th, re, im, lmax, lmax))
    a = kernel()
    ms = time_ms(kernel, reps)
    kms = kernel_only_ms(sht, kernel, reps)
    if not (torch.equal(a, ref) and torch.equal(a, kernel())):
        raise RuntimeError("legendre synthesis float32 at lmax %d: not "
                           "bitwise equal to plain, or two calls differ"
                           % lmax)
    bms, by = legendre_bound("synthesis", lmax, len(thetas), torch.float32)
    phase(14, "legendre synthesis float32, lmax %d, %d rings: call %.3f "
          "ms, kernel %.3f ms, plain %.1f ms, bound %.3f ms (%s, %.1f%% of "
          "the kernel), bitwise equal to plain and two kernel calls "
          "bitwise equal (%s)" % (lmax, len(thetas), ms, kms, pms, bms, by,
                                  100 * bms / kms, card))
    del ref, a, re, im
    torch.cuda.empty_cache()
    return {"ms": ms, "kernel_ms": kms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "equal_to_plain": True}


MULTI_RINGS = 4 * SHAPE[0]   # phase 13's survey map height
MULTI_LMAX = 2000


def check_analysis_blocks(sht, card, g, reps, R=MULTI_RINGS,
                          lmax=MULTI_LMAX):
    """Analysis float32 on the multi-block path: the ``R`` rows of a survey
    map at dec -47 (more rings than one block takes) at lmax = mmax =
    ``lmax``, the ring coefficients of a white map; within 1e-5 of max
    |alm| of one plain call, two kernel calls bitwise equal, the call and
    the kernel alone timed."""
    import torch
    thetas, nphi, wts, _ = legendre_rings_of_tile(
        shape=(R, SHAPE[1]), decDeg=SIM_DEC)
    blocks = sht.legendre_geometry(R, lmax + 1, torch.float32)[2][0]
    if blocks < 2:
        raise RuntimeError("analysis at %d rings: %d block an m, not the "
                           "multi-block path" % (R, blocks))
    G = (torch.randn((2, lmax + 1, R), generator=g, dtype=torch.float64,
                     device="cuda") * (2 * np.pi / nphi)).float()
    th = torch.as_tensor(thetas, dtype=torch.float32, device="cuda")
    w = torch.as_tensor(wts, dtype=torch.float32, device="cuda")

    def kernel():
        return sht.legendre_contract(thetas, G[0], G[1], lmax, lmax,
                                     adjoint=True, weights=wts,
                                     dtype=torch.float32, device="cuda")

    ref, pms = time_once(lambda: sht._legendre_contract_plain(
        th, G[0], G[1], lmax, lmax, True, w))
    a = kernel()
    ms = time_ms(kernel, reps)
    kms = kernel_only_ms(sht, kernel, reps)
    if not torch.equal(a, kernel()):
        raise RuntimeError("legendre analysis at %d rings: two kernel calls "
                           "differ" % R)
    r = ref.double()
    err = float(torch.max(torch.abs(a.double() - r)))
    tol = 1e-5 * float(torch.max(torch.abs(r)))
    if not (err <= tol and bool(torch.isfinite(a).all())):
        raise RuntimeError("legendre analysis at %d rings: max error %.3e "
                           "over the tolerance %.3e" % (R, err, tol))
    bms, by = legendre_bound("analysis", lmax, R, torch.float32)
    phase(14, "legendre analysis float32, lmax %d, %d rings (%d blocks an "
          "m): call %.3f ms, kernel %.3f ms, plain %.1f ms, bound %.3f ms "
          "(%s, %.1f%% of the kernel), max |err| %.3e (tolerance %.3e), two "
          "kernel calls bitwise equal (%s)" % (lmax, R, blocks, ms, kms, pms,
                                              bms, by, 100 * bms / kms, err,
                                              tol, card))
    del ref, a, G
    torch.cuda.empty_cache()
    return {"ms": ms, "kernel_ms": kms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "max_abs_err": err, "tol": tol}


SIM_LABELS = (PHOT, "Arnaud_M4e14_z0p2")   # the quickstart's two scales
SIM_METHODS = ("dataMap", "model", "max(dataMap,CMB)")
SIM_CHECK_TILE = "T00"       # dec -62 .. -54.5: a curved tile
NUM_SKY_SIMS = 2
MODEL_CLUSTERS = 50


def reset_sim_counts():
    from nemo_tpu_torch.ops import sht
    sht.legendre_contract.launches = 0
    sht.legendre_contract.direction_launches.update(synthesis=0, analysis=0)
    sht._legendre_contract_plain.calls = 0


def read_sim_counts():
    from nemo_tpu_torch.ops import sht
    d = sht.legendre_contract.direction_launches
    return {"synthesis": d["synthesis"], "analysis": d["analysis"],
            "plain": sht._legendre_contract_plain.calls}


def sim_recorder(log):
    """Wrappers that time each sim (card synchronised before and after):
    the flat CMB draws, the curved CMB draws and the curved 1/f noise."""
    import torch
    from nemo_tpu_torch.ops import grf, sht

    def timed(kind):
        def wrap(orig):
            def run(*a, **kw):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(*a, **kw)
                if out.is_cuda:
                    torch.cuda.synchronize()
                log.append((kind, time.perf_counter() - t0))
                return out
            return run
        return wrap
    return ((grf, "sim_cmb_map", timed("flat")),
            (sht, "sim_cmb_map_curved", timed("curved")),
            (sht, "sim_noise_map_curved", timed("curved_noise")))


def sim_summary(log):
    out = {}
    for kind, secs in log:
        n, t = out.get(kind, (0, 0.0))
        out[kind] = (n + 1, t + secs)
    return {k: {"n": n, "s": round(t, 3)} for k, (n, t) in out.items()}


def stack_recorder(stacks, tile):
    """Wrapper keeping a host copy of every noise stack built for
    ``tile``, by filter label."""
    from nemo_tpu_torch import filters

    def wrap(orig):
        def run(self, dataStack):
            out = orig(self, dataStack)
            if self.tileName == tile:
                stacks[self.label] = out.detach().cpu().numpy()
            return out
        return run
    return (filters.MatchedFilter, "_noiseStack", wrap)


def given_stacks(stacks):
    """Wrapper that builds every filter from its label's given stack."""
    from nemo_tpu_torch import filters

    def wrap(orig):
        def run(self, dataStack):
            self.givenNoiseStack = stacks[self.label]
            return orig(self, dataStack)
        return run
    return (filters.MatchedFilter, "_noiseStack", wrap)


def south_config(surveyDict, method, outName, **over):
    """The dec -47 survey with the two-scale bank and ``method``, written
    as JSON; returns (path, dict)."""
    d = with_filters(surveyDict, SIM_LABELS, **over)
    d = copy.deepcopy(d)
    d["allFilters"]["params"]["noiseParams"]["method"] = method
    d["allFilters"]["params"]["saveFilter"] = True
    d["outputDir"] = os.path.join(WORK, outName)
    path = os.path.join(WORK, outName + ".yml")
    with open(path, "w") as f:
        json.dump(d, f, indent=1)
    return path, d


def read_optimal(outDir):
    from nemo_tpu_torch.utils.tables import Table
    return Table.read(os.path.join(outDir, "%s_optimalCatalog.fits"
                                   % os.path.basename(outDir)))


def in_tile(truth, d, tile):
    """The truth rows inside ``tile``'s RADecSection."""
    sec = next(t["RADecSection"] for t in d["tileDefinitions"]
               if t["tileName"] == tile)
    ra, dec = np.asarray(truth["RADeg"]), np.asarray(truth["decDeg"])
    sel = (ra >= min(sec[:2])) & (ra < max(sec[:2])) \
        & (dec >= min(sec[2:])) & (dec < max(sec[2:]))
    return {k: np.asarray(v)[sel] for k, v in truth.items()}


def sims_search_phase(noise, detect, card, device="cuda"):
    """Phase 14b: the nemo CLI on the batched engine over the dec -47
    survey with each noise method; the model run's Legendre launches and
    draws; one curved tile's card catalog against the CPU float64 filter
    built from the card's downloaded model stacks.  Returns (survey dict,
    truth, the dataMap run's config path, the model run's counts)."""
    import torch
    from nemo_tpu_torch import maps
    from nemo_tpu_torch.cli import nemo_main
    from nemo_tpu_torch.utils.timing import RECORDER

    onCard = device == "cuda"
    t0 = time.perf_counter()
    surveyDict, truth = survey_inputs(os.path.join(WORK, "survey_south"),
                                      device=device, decDeg=SIM_DEC,
                                      ivar=True)
    nTiles = len(surveyDict["tileDefinitions"])
    phase(14, "dec %.0f survey: %d tiles of %d x %d, %d clusters, in %.1f s"
          % (SIM_DEC, nTiles, SHAPE[0], SHAPE[1], len(truth["y_c"]),
             time.perf_counter() - t0))
    runs = {}
    for method in SIM_METHODS:
        tag = method.split("(")[0]
        cfgPath, d = south_config(surveyDict, method, "south_" + tag)
        log, stacks = [], {}
        targets = sim_recorder(log)
        if method == "model":
            targets += (stack_recorder(stacks, SIM_CHECK_TILE),)
        RECORDER.reset()
        reset_counts(noise, detect)
        reset_sim_counts()
        t0 = time.perf_counter()
        with patched(*targets):
            nemo_main.main([cfgPath, "--device", device])
        if onCard:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(read_counts(noise, detect), **read_sim_counts())
        sims = sim_summary(log)
        cat = read_optimal(d["outputDir"])
        found = int(np.sum(match(truth, cat, 1.0) >= 0))
        phase(14, "nemo --device %s, %s noise, %d tiles x %d scales: %.2f s"
              "; stages (s) %s; sims %s; launches and plain calls %s; %d "
              "objects, %d/%d clusters within 1' (%s)"
              % (device, method, nTiles, len(SIM_LABELS), secs,
                 json.dumps({k: round(v, 3) for k, v in
                             sorted(RECORDER.totals.items())}),
                 json.dumps(sims), json.dumps(counts), len(cat), found,
                 len(truth["y_c"]), card))
        if found < len(truth["y_c"]) // 2:
            raise RuntimeError("%s run: %d clusters recovered"
                               % (method, found))
        nSims = sum(v["n"] for v in sims.values())
        if method == "model":
            nCurved = sims.get("curved", {}).get("n", 0)
            nFlat = sims.get("flat", {}).get("n", 0)
            want = 2 * len(SIM_LABELS)
            if nCurved != 12 * want or nFlat != 4 * want:
                raise RuntimeError("model run: %d curved and %d flat draws"
                                   % (nCurved, nFlat))
            if counts["synthesis" if onCard else "plain"] != nCurved \
                    or counts["analysis"] != 0 \
                    or counts["plain" if onCard else "synthesis"] != 0:
                raise RuntimeError("model run: Legendre counts %s" % counts)
        elif nSims or counts["synthesis"] or counts["plain"]:
            raise RuntimeError("%s run drew %d sims" % (method, nSims))
        if onCard and (counts["rms_cells"] <= 0 or counts["rms_plain"]
                       or counts["labels"] <= 0 or counts["labels_plain"]):
            raise RuntimeError("%s run: counts %s" % (method, counts))
        runs[method] = {"secs": secs, "counts": counts, "sims": sims,
                        "catalog": cat, "config": cfgPath, "stacks": stacks}

    # the curved tile's filters rebuilt on the CPU in float64 from the
    # card's model stacks; its catalog against the card's by phase 6's rule
    model = runs["model"]
    if sorted(model["stacks"]) != sorted(SIM_LABELS):
        raise RuntimeError("no model stacks kept for %s" % SIM_CHECK_TILE)
    d = with_filters(surveyDict, SIM_LABELS, useDeviceBatching=False)
    d["tileDefinitions"] = [t for t in d["tileDefinitions"]
                            if t["tileName"] == SIM_CHECK_TILE]
    cfgPath, d = south_config(d, "model", "south_model_cpu_" + SIM_CHECK_TILE)
    t0 = time.perf_counter()
    with patched(given_stacks(model["stacks"])):
        nemo_main.main([cfgPath, "--device", "cpu"])
    cpuSecs = time.perf_counter() - t0
    cpuCat = read_optimal(d["outputDir"])
    gpuCat = model["catalog"]
    gpuCat = gpuCat[np.asarray(gpuCat["tileName"]) == SIM_CHECK_TILE]
    tileTruth = in_tile(truth, d, SIM_CHECK_TILE)
    nCompared, maxSep, maxDy = compare_runs(tileTruth, gpuCat, cpuCat)
    if nCompared < 5:
        raise RuntimeError("curved tile: %d clusters compared" % nCompared)
    phase(14, "tile %s (curved), the card's model stacks given to the CPU "
          "float64 per-tile filter: %.2f s, %d objects against %d on the "
          "card; %d clusters at fixed_SNR >= 5 in both, max offset %.4f', "
          "max |fixed_y_c ratio - 1| %.2e (%s)"
          % (SIM_CHECK_TILE, cpuSecs, len(cpuCat), len(gpuCat), nCompared,
             maxSep, maxDy, card))
    return surveyDict, truth, runs


def contamination_phase(noise, detect, card, runs, device="cuda"):
    """Phase 14c: the sky-sim and inverted-map contamination estimates on
    the dataMap run's filter caches."""
    import torch
    from nemo_tpu_torch import maps, startup
    from nemo_tpu_torch.utils.timing import RECORDER

    onCard = device == "cuda"
    realCat = runs["dataMap"]["catalog"]
    config = startup.NemoConfig(runs["dataMap"]["config"], device=device,
                                writeTileInfo=True)
    log, perSim = [], []

    def each_sim(orig):
        def run(cfg, *a, **kw):
            n0 = len(log)
            if onCard:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            cat = orig(cfg, *a, **kw)
            if onCard:
                torch.cuda.synchronize()
            perSim.append((time.perf_counter() - t0, sim_summary(log[n0:]),
                           int(np.sum(np.asarray(cat["SNR"]) >= 5))
                           if len(cat) else 0, len(cat)))
            return cat
        return run
    from nemo_tpu_torch import pipelines
    RECORDER.reset()
    reset_counts(noise, detect)
    reset_sim_counts()
    t0 = time.perf_counter()
    with patched(*sim_recorder(log),
                 (pipelines, "filterMapsAndMakeCatalogs", each_sim)):
        sims = maps.estimateContaminationFromSkySim(config,
                                                    numSkySims=NUM_SKY_SIMS)
    secs = time.perf_counter() - t0
    counts = dict(read_counts(noise, detect), **read_sim_counts())
    nTiles = len(config.tileNames)
    for i, (s, kinds, n5, n) in enumerate(perSim):
        phase(14, "sky sim %d: %.2f s, sims %s, %d detections, %d at S/N "
              ">= 5 (%s)" % (i + 1, s, json.dumps(kinds), n, n5, card))
        want = {"curved": 12 * 2, "flat": 4 * 2}
        if {k: kinds.get(k, {}).get("n", 0) for k in want} != want \
                or len(kinds) != 2:
            raise RuntimeError("sky sim %d drew %s" % (i + 1, kinds))
    if onCard and (counts["synthesis"] != NUM_SKY_SIMS * 24
                   or counts["plain"] or counts["rms_cells"] <= 0
                   or counts["rms_plain"]):
        raise RuntimeError("sky sims: counts %s" % counts)
    t0 = time.perf_counter()
    inverted = maps.estimateContaminationFromInvertedMaps(config)
    invSecs = time.perf_counter() - t0
    tabs = {}
    for label, cats in (("skySim", sims), ("invertedMap", [inverted])):
        for j, cat in enumerate(cats):
            tabs.update(maps.estimateContamination(
                cat, realCat, ["SNR"], "%s%d" % (label, j),
                diagnosticsDir=config.diagnosticsDir))
    rates = {k: round(float(np.asarray(t["contaminationRate"])[2]), 4)
             for k, t in sorted(tabs.items())}
    phase(14, "contamination: %d sky sims of %d tiles in %.2f s, launches "
          "and plain calls %s; inverted maps %.2f s, %d detections; "
          "contamination rate at S/N > 5 %s (%s)"
          % (NUM_SKY_SIMS, nTiles, secs, json.dumps(counts), invSecs,
             len(inverted), json.dumps(rates), card))
    return counts


def model_catalog(w, shape, path, seed=SEED + 31):
    """MODEL_CLUSTERS Arnaud clusters at seeded positions inside the tile,
    written as FITS."""
    from nemo_tpu_torch.utils.tables import Table
    rng = np.random.default_rng(seed)
    ys = rng.uniform(60, shape[0] - 60, MODEL_CLUSTERS)
    xs = rng.uniform(60, shape[1] - 60, MODEL_CLUSTERS)
    coords = w.pix2wcs(xs, ys)
    Table({"name": np.array(["c%02d" % i for i in range(MODEL_CLUSTERS)]),
           "RADeg": coords[:, 0], "decDeg": coords[:, 1],
           "y_c": rng.uniform(2.0, 6.0, MODEL_CLUSTERS),
           "template": np.array([PHOT] * MODEL_CLUSTERS)}).write(path)


def nemo_model_phase(card, device="cuda"):
    """Phase 14d: nemoModel on one dec -55 tile with a curved CMB at the
    default band limit and curved 1/f noise; seconds by step, Legendre
    launches, and the statistics of the CMB, its draw and the noise."""
    import torch
    from nemo_tpu_torch import maps
    from nemo_tpu_torch.cli import nemoModel_main
    from nemo_tpu_torch.models import beams
    from nemo_tpu_torch.ops import grf, sht
    from nemo_tpu_torch.utils import fits as nfits
    from nemo_tpu_torch.utils import wcs as nwcs

    onCard = device == "cuda"
    work = os.path.join(WORK, "nemoModel")
    os.makedirs(work, exist_ok=True)
    w = nwcs.makeWCS(SHAPE, PIX_ARCMIN / 60.0, centreRADeg=30.0,
                     centreDecDeg=-55.0)
    template = os.path.join(work, "template.fits")
    nfits.write_image(template, np.ones(SHAPE), w.header)
    beamFile = os.path.join(work, "beam_f150.txt")
    beams.makeGaussianBeamFile(beamFile, BANDS[0][2])
    catPath = os.path.join(work, "clusters.fits")
    model_catalog(w, SHAPE, catPath)
    out = os.path.join(work, "mock_f150.fits")
    noiseUK, lKnee = 20.0, 2000.0
    steps = []

    def timed(name):
        def wrap(orig):
            def run(*a, **kw):
                if onCard:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = orig(*a, **kw)
                if onCard:
                    torch.cuda.synchronize()
                steps.append((name, time.perf_counter() - t0))
                return r
            return run
        return wrap
    reset_sim_counts()
    t0 = time.perf_counter()
    with patched((maps, "makeModelImage", timed("model image")),
                 (maps, "simCMBMap", timed("CMB")),
                 (maps, "simNoiseMap", timed("1/f noise"))):
        nemoModel_main.main([catPath, template, beamFile, out, "-f",
                             str(BANDS[0][1]), "-C", "--curved-cmb", "-N",
                             str(noiseUK), "--lknee", str(lKnee), "-S",
                             "42", "--device", device])
    secs = time.perf_counter() - t0
    counts = read_sim_counts()
    want = {"synthesis": 3, "analysis": 1, "plain": 0} if onCard else \
        {"synthesis": 0, "analysis": 0, "plain": 4}
    if counts != want:
        raise RuntimeError("nemoModel: Legendre counts %s" % counts)

    signal, _ = nfits.read_image(out.replace(".fits", "_signalOnly.fits"))
    withCMB, _ = nfits.read_image(out.replace(".fits", "_signalAndCMB.fits"))
    final, _ = nfits.read_image(out)
    cmb = np.asarray(withCMB, float) - np.asarray(signal, float)
    noiseMap = np.asarray(final, float) - np.asarray(withCMB, float)
    if not (np.all(np.isfinite(final)) and final.shape == SHAPE):
        raise RuntimeError("nemoModel output malformed")
    beam = beams.BeamProfile(beamFileName=beamFile)
    Cl = grf.lensedClTT()
    ClB = Cl * np.interp(np.arange(len(Cl), dtype=float), beam.ell,
                         beam.Bell)
    ls = np.arange(len(Cl))
    varRatio = cmb.var() / (np.sum((2 * ls + 1) * ClB) / (4 * np.pi))
    # the draw: rand_alm on the card at the auto band limit, hat C_l in
    # bands of 500 over l 500 .. 6,000
    g = torch.Generator(device=device).manual_seed(SEED + 32)
    alm = sht.rand_alm(ClB[:SIM_LMAX + 1], lmax=SIM_LMAX, generator=g,
                       device=device)
    power = torch.abs(alm) ** 2
    power[:, 1:] *= 2
    hatCl = (power.sum(dim=1) / (2 * torch.arange(
        SIM_LMAX + 1, device=alm.device) + 1)).cpu().numpy()
    del alm, power
    bands = [(l0, l0 + 500) for l0 in range(500, SIM_LMAX, 500)]
    clRatios = [float(hatCl[a:b].mean() / ClB[a:b].mean()) for a, b in bands]
    # the 1/f noise keeps the white level above its band limit: the flat
    # power at l 8,000 .. 18,000 against noiseUK^2 Omega_pix
    pixRad = np.radians(PIX_ARCMIN / 60.0)
    pix = maps.pixScalesRad(w, SHAPE)
    P2 = np.abs(np.fft.rfft2(noiseMap)) ** 2 * pix[0] * pix[1] \
        / noiseMap.size
    from nemo_tpu_torch.ops import fourier
    lmap = fourier.rmodlmap(SHAPE, pix)
    sel = (lmap > 8000) & (lmap < 18000)
    whiteRatio = float(P2[sel].mean() / (noiseUK ** 2 * pix[0] * pix[1]))
    byStep = {}
    for name, s in steps:
        byStep[name] = round(byStep.get(name, 0.0) + s, 3)
    phase(14, "nemoModel --device %s on a dec -55 tile of %d x %d, %d "
          "clusters, -C --curved-cmb (lmax 12000) -N %g --lknee %g: %.2f s; "
          "by step (s) %s; Legendre launches and plain calls %s; CMB "
          "variance / sum (2l+1) C_l B_l / 4pi %.4f; rand_alm hat C_l / "
          "C_l B_l in bands of 500 over l 500-6000: %s; 1/f noise power at "
          "l 8000-18000 / white %.4f (pixel %.1f') (%s)"
          % (device, SHAPE[0], SHAPE[1], MODEL_CLUSTERS, noiseUK, lKnee,
             secs, json.dumps(byStep), json.dumps(counts), varRatio,
             [round(r, 4) for r in clRatios], whiteRatio,
             np.degrees(pixRad) * 60, card))
    if not 0.5 < varRatio < 2.0:
        raise RuntimeError("CMB variance ratio %.3f" % varRatio)
    if max(abs(r - 1) for r in clRatios) > 0.05:
        raise RuntimeError("rand_alm band powers %s" % clRatios)
    if not 0.9 < whiteRatio < 1.1:
        raise RuntimeError("1/f noise white level %.3f" % whiteRatio)
    return counts


# -- phase 15 ------------------------------------------------------------------

# tests/test_tiled_e2e.py's real-space filter settings (the DR3 / E-D56
# style): the kernel from a Fourier matched filter on a 4 x 4 deg box about
# the tile centre, cut at 7' (29 x 29 at 0.5'), 30' background subtraction
RS_PARAMS = {"noiseParams": {"method": "dataMap", "noiseGridArcmin": 40.0,
                             "RADecSection": "auto", "kernelMaxArcmin": 7.0,
                             "symmetrize": False,
                             "matchedFilterClass": "ArnaudModelMatchedFilter"},
             "bckSub": True, "bckSubScaleArcmin": 30.0, "outputUnits": "yc",
             "edgeTrimArcmin": 10.0, "GNFWParams": "default",
             "saveFilteredMaps": False, "saveRMSMap": False,
             "savePlots": False}
RS_KERNEL = 29
RS_CPU_TILES = ("T11", "T12")    # the CPU float64 comparisons' tiles
# The Q fit's reference scale: with a real-space reference the kernel's
# calibration template carries no pixel window and the Q models do, so at
# 0.5' both packages stop on Q[0]/y0 = 0.975 for the quickstart's M2e14
# z0.4 (0.984 for M4e14 z0.2); this scale gives ~0.992 (the 1% check holds).
RS_QREF = ("Arnaud_M1e15_z0p1", 1e15, 0.1)


def realspace_config(surveyDict, outName, labels=SIM_LABELS, tiles=None,
                     **over):
    """Phase 7's survey with ``labels`` as ArnaudModelRealSpaceMatchedFilter
    (RS_PARAMS), the photometry filter M2e14 z0.4, on the batched engine
    unless ``over`` says otherwise; ``tiles`` keeps those tiles only."""
    d = copy.deepcopy(with_filters(surveyDict, labels, **over))
    d["allFilters"] = {"class": "ArnaudModelRealSpaceMatchedFilter",
                       "params": copy.deepcopy(RS_PARAMS)}
    if tiles is not None:
        d["tileDefinitions"] = [t for t in d["tileDefinitions"]
                                if t["tileName"] in tiles]
    d["outputDir"] = os.path.join(WORK, outName)
    return d


def reset_rs_counts():
    from nemo_tpu_torch.ops import imageops
    from nemo_tpu_torch.parallel import distribute
    imageops.convolve2d_reflect_sum_batch.calls = 0
    distribute.make_realspace_step.calls = 0


def read_rs_counts():
    from nemo_tpu_torch.ops import imageops
    from nemo_tpu_torch.parallel import distribute
    return {"conv": imageops.convolve2d_reflect_sum_batch.calls,
            "step": distribute.make_realspace_step.calls}


def conv_bound(T, nf, shape, k, itemsize=4):
    """The least time for T tiles' band-summed convolution, the maps and
    kernels read and the sums written once: (ms, by, operations) of the
    transform route's work (an rfft2 of each map and kernel and an irfft2
    of each tile at the padded transform size, nominally 2.5 N log2 N
    operations a real transform of N points, and the band products and
    sums, 8 operations a half-grid point a band) and (ms, by, operations)
    of the direct sum's, 2 T nf ny nx k^2."""
    from nemo_tpu_torch.ops import fourier
    ny, nx = shape
    nbytes = itemsize * (T * nf * ny * nx + T * nf * k * k + T * ny * nx)
    py = fourier.good_fft_size(ny + k - 1)
    px = fourier.good_fft_size(nx + k - 1)
    n = py * px
    fftOps = (2 * T * nf + T) * 2.5 * n * np.log2(n) \
        + 8.0 * T * nf * py * (px // 2 + 1)
    directOps = 2.0 * T * nf * ny * nx * k * k
    return (bound(nbytes, fftOps, "float32") + (fftOps,),
            bound(nbytes, directOps, "float32") + (directOps,))


def check_conv(card, T=16, nf=2, shape=SHAPE, k=RS_KERNEL, reps=5):
    """Phase 15a: convolve2d_reflect_sum on one chunk (T x nf x ny x nx
    float32, k x k kernels) as the step runs it (through the FFT), timed
    with CUDA events in turns with the library's convolution (one grouped
    cuDNN conv2d, TF32 off, timed only), beside its bound; the largest
    error against the CPU float64 convolution of two tiles, within 1e-5 of
    the peak.  Returns the record."""
    import torch
    from nemo_tpu_torch import device as device_mod
    from nemo_tpu_torch.ops import imageops
    device_mod.policy("cuda")           # TF32 off, as every card run has it
    rng = np.random.default_rng(SEED + 15)
    m = torch.as_tensor(rng.normal(0, 30.0, (T, nf) + shape),
                        dtype=torch.float32, device="cuda")
    yy, xx = np.mgrid[:k, :k] - k // 2
    kern = np.exp(-(yy ** 2 + xx ** 2)[None, None]
                  / (2 * rng.uniform(1.5, 4.0, (T, nf, 1, 1)) ** 2)) \
        - 0.1 * rng.uniform(0, 1, (T, nf, 1, 1))
    kern = torch.as_tensor(kern, dtype=torch.float32, device="cuda")
    calls = imageops.convolve2d_reflect_sum_batch.calls

    def library(mm, kk):
        """One grouped conv2d, a group a tile with the bands as its input
        channels; conv2d is a cross-correlation, so the kernels flip."""
        padded = imageops._reflect_pad(mm, k, k)
        return torch.nn.functional.conv2d(
            padded.reshape((1, -1) + padded.shape[-2:]),
            torch.flip(kk, dims=(-2, -1)), groups=mm.shape[0])[0]

    ms = time_turns({
        "step": lambda: imageops.convolve2d_reflect_sum_batch(m, kern),
        "library": lambda: library(m, kern)}, {"step": reps, "library": 2})
    got = imageops.convolve2d_reflect_sum_batch(m[:2], kern[:2]).cpu()
    lib = library(m[:2], kern[:2]).cpu()
    ref = imageops.convolve2d_reflect_sum_batch(m[:2].double().cpu(),
                                                kern[:2].double().cpu())
    imageops.convolve2d_reflect_sum_batch.calls = calls
    peak = float(ref.abs().max())
    err = float((got.double() - ref).abs().max())
    errLib = float((lib.double() - ref).abs().max())
    if err > 1e-5 * peak:
        raise RuntimeError("convolve2d_reflect_sum on the card: max err "
                           "%.3e against a %.3e peak" % (err, peak))
    (bms, by, ops), (dms, dby, dops) = conv_bound(T, nf, shape, k)
    phase(15, "15a convolve2d_reflect_sum, %d x %d x %d x %d float32, %d x "
          "%d kernels, through the FFT: %.3f ms; bound %.4f ms (%s: %.3g "
          "float32 operations), at %.1f%% of it; the library's grouped "
          "conv2d %.3f ms (the direct sum's bound %.3f ms, %s: %.3g "
          "operations); max abs err vs CPU float64 on 2 tiles %.3e "
          "(conv2d %.3e) of a %.3e peak (%s)"
          % (T, nf, shape[0], shape[1], k, k, ms["step"], bms, by, ops,
             100 * bms / ms["step"], ms["library"], dms, dby, dops, err,
             errLib, peak, card))
    return {"ms": ms["step"], "library_ms": ms["library"], "bound_ms": bms,
            "bound_by": by, "operations": ops, "direct_bound_ms": dms,
            "direct_operations": dops, "max_abs_err": err,
            "library_max_abs_err": errLib, "peak": peak}


def rs_budget(outName):
    """Summed chunk budgets of a real-space batched run, with the staging
    worker's kernel-build and staging seconds."""
    with open(os.path.join(WORK, outName, "diagnostics",
                           "chunk_budgets.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    out = {k: sum(r[k] for r in recs) for k in (
        "stageWait", "upload", "step", "download", "consume", "hostOther",
        "kernelBuild", "staging")}
    out["nTiles"] = [r["nTiles"] for r in recs]
    out["devices"] = sorted({r["device"] for r in recs})
    return out


def same_catalog(a, b):
    """The largest difference of two catalogs' positions, amplitudes and
    S/N, row for row by name (0.0: bitwise the same)."""
    if sorted(a["name"]) != sorted(b["name"]):
        return float("inf")
    ia, ib = np.argsort(np.asarray(a["name"])), np.argsort(np.asarray(
        b["name"]))
    return max(float(np.max(np.abs(np.asarray(a[k], dtype=float)[ia]
                                   - np.asarray(b[k], dtype=float)[ib])))
               for k in ("RADeg", "decDeg", "y_c", "fixed_y_c", "SNR"))


def realspace_phase(noise, detect, card, surveyDict, truth, device="cuda"):
    """Phase 15: the real-space search (the DR3 / E-D56 style) on phase 7's
    survey: (a) the convolution on one chunk; (b) the nemo search on the
    batched engine, cold and warm, and once more profiled; (c) the per-tile
    host engine on the card, and the CPU float64 port on two tiles,
    against (b) by phase 9's rule; (d) fitQ with a real-space reference on
    two tiles, the card (float32, and float64) against the CPU float64
    run.
    Returns (the 15a record, the warm run's counts)."""
    import torch
    from nemo_tpu_torch import filters, startup
    from nemo_tpu_torch.models import qfit
    onCard = device == "cuda"
    conv = check_conv(card) if onCard else None
    nTiles = len(surveyDict["tileDefinitions"])

    runs = {}
    for tag in ("cold", "warm"):
        outName = "rs_%s" % tag
        reset_rs_counts()
        cat, secs, bud, counts = batched_run(
            realspace_config(surveyDict, outName), outName, noise, detect,
            device)
        counts.update(read_rs_counts())
        bud = rs_budget(outName)
        runs[tag] = (cat, secs, bud, counts)
        # one step (one convolution) a label over all 16 tiles; rms_cells
        # launched by each step and each kernel build's sub-region filter
        # on the card, the plain version on the CPU
        launched = counts["rms_plain"] if not onCard else counts["rms_cells"]
        if counts["conv"] != len(SIM_LABELS) or counts["step"] != \
                len(SIM_LABELS) or launched < len(SIM_LABELS) or (
                    counts["rms_plain"] if onCard else counts["rms_cells"]):
            raise RuntimeError("real-space %s run: counts %s" % (tag, counts))
        if bud["nTiles"] != [nTiles] * len(SIM_LABELS) or bud["devices"] \
                != [str(torch.device(device, 0) if onCard
                        else torch.device(device))]:
            raise RuntimeError("real-space %s run: budget %s" % (tag, bud))
        phase(15, "15b nemo --device %s, batched engine, real-space %s, %d "
              "tiles x %d scales: %.2f s (staging wait %.2f + upload %.2f, "
              "steps %.3f, downloads %.2f, host catalog %.2f, other host "
              "%.2f; the staging worker's stagings %.2f s, of it kernel "
              "builds %.2f s = %.1f%%), %d objects; launches %s (%s)"
              % (device, tag, nTiles, len(SIM_LABELS), secs,
                 bud["stageWait"], bud["upload"], bud["step"],
                 bud["download"], bud["consume"], bud["hostOther"],
                 bud["staging"], bud["kernelBuild"],
                 100 * bud["kernelBuild"] / bud["staging"], len(cat),
                 json.dumps(counts), card))
    cat, secs, bud, counts = runs["warm"]
    from nemo_tpu_torch.utils.timing import RECORDER
    stages = dict(RECORDER.totals)
    diff = same_catalog(runs["cold"][0], cat)
    if diff != 0.0:
        raise RuntimeError("two real-space card runs differ by %.3e" % diff)
    recovered = int(np.sum(match(truth, cat, 1.0) >= 0))
    if recovered < 0.9 * len(truth["y_c"]):
        raise RuntimeError("real-space run recovered %d clusters"
                           % recovered)
    phase(15, "15b warm run: stages (s) %s; %d/%d clusters within 1'; the "
          "cold and warm catalogs bitwise the same (%d rows) (%s)"
          % (json.dumps({k: round(v, 3) for k, v in sorted(stages.items())}),
             recovered, len(truth["y_c"]), len(cat), card))
    if onCard:
        wall, busy, top, _ = profile_warm_run(
            realspace_config(surveyDict, "rs_profile"), "rs_profile")
        phase(15, "15b profiled warm run: %.3f s wall, device busy %.3f s "
              "(%.1f%%); top device ops (name, ms, calls): %s (%s)"
              % (wall, busy, 100 * busy / wall, json.dumps(top), card))

    hostCat, hostSecs, _ = run_search(
        realspace_config(surveyDict, "rs_host", useDeviceBatching=False),
        device, "rs_host")
    n, sep, dy = compare_runs(truth, cat, hostCat)
    phase(15, "15c per-tile host engine on %s: %.2f s, %d objects; %d "
          "clusters at fixed_SNR >= 5 in either run found by both, max "
          "offset %.4f', max |fixed_y_c ratio - 1| %.2e against 15b (%s)"
          % (device, hostSecs, len(hostCat), n, sep, dy, card))
    if n < 0.5 * len(truth["y_c"]):
        raise RuntimeError("too few clusters compared (%d)" % n)
    sub = realspace_config(surveyDict, "rs_cpu", tiles=RS_CPU_TILES,
                           useDeviceBatching=False)
    subTruth = {k: np.concatenate([in_tile(truth, sub, t)[k]
                                   for t in RS_CPU_TILES]) for k in truth}
    cpuCat, cpuSecs, _ = run_search(sub, "cpu", "rs_cpu")
    n, sep, dy = compare_runs(subTruth, cat, cpuCat)
    phase(15, "15c CPU float64, per-tile engine, tiles %s: %.2f s; %d "
          "clusters at fixed_SNR >= 5 in either run found by both, max "
          "offset %.4f', max |fixed_y_c ratio - 1| %.2e against 15b (%s)"
          % ("+".join(RS_CPU_TILES), cpuSecs, n, sep, dy, card))
    if n < 0.5 * len(subTruth["y_c"]):
        raise RuntimeError("too few clusters compared (%d)" % n)

    def fit_q(dev, tag, kernelsOf=None, x64=False):
        """Build the reference's kernels on ``dev`` (in float64 on the card
        with ``x64``; or read those of the config ``kernelsOf``, as phase
        11 reads the card's filters) and fit Q there; returns (config,
        {tile: Q}, kernel s, fitQ s)."""
        label, M, z = RS_QREF
        d = realspace_config(surveyDict, "rs_q_" + tag, labels=(),
                             tiles=RS_CPU_TILES, photFilter=label)
        d["mapFilters"] = [{"label": label,
                            "params": {"M500MSun": M, "z": z}}]
        config = startup.NemoConfig(startup.parseConfigDict(d), device=dev,
                                    x64=x64, writeTileInfo=True)
        f = config.parDict["mapFilters"][0]
        t0 = time.perf_counter()
        if kernelsOf is not None:
            config.diagnosticsDir = kernelsOf.diagnosticsDir
        else:
            for tileName in config.tileNames:
                fObj = filters.getFilterClass(f["class"])(
                    f["label"], config.unfilteredMapsDictList, f["params"],
                    tileName=tileName, diagnosticsDir=config.diagnosticsDir,
                    selFnDir=config.selFnDir, policy=config.policy)
                fObj.buildKernel(fObj._resolveRADecSection())
        tKernels = time.perf_counter() - t0
        t0 = time.perf_counter()
        qfit.fitQ(config)
        if dev == "cuda":
            torch.cuda.synchronize()
        return (config,
                qfit_tables(os.path.join(config.selFnDir, "QFit.fits")),
                tKernels, time.perf_counter() - t0)

    def max_diff(a, b):
        """(max |a/b - 1|, max |a - b| / max b, the b where a/b is worst)
        over the tiles."""
        if sorted(a) != sorted(b) or len(a) != len(RS_CPU_TILES):
            raise RuntimeError("fitQ tiles %s / %s" % (sorted(a), sorted(b)))
        rel = {t: np.abs(a[t] / b[t] - 1) for t in b}
        worst = max(b, key=lambda t: rel[t].max())
        return (max(float(r.max()) for r in rel.values()),
                max(float(np.max(np.abs(a[t] - b[t]))) for t in b)
                / max(float(q.max()) for q in b.values()),
                float(b[worst][int(np.argmax(rel[worst]))]))

    # the card's float32 kernels fitted on the card and on the CPU in
    # float64 (phase 11's comparison: one set of kernels, two fits); the
    # CPU's own float64 kernels and fit, each Q's difference taken
    # relative to the table's largest (float32 kernels move every Q by up
    # to ~5e-5 of the largest, the smallest, ~4e-4 of the largest, by
    # ~1.4e-4 of itself); and the card's kernels and fit in float64
    # against the CPU's own, which shows that the last difference is the
    # float32 round-off (~1e-10 in float64)
    cardConfig, qCard, kCard, sCard = fit_q(device, device)
    _, qCpu, _, sCpu = fit_q("cpu", "cpu", kernelsOf=cardConfig)
    _, qOwn, kOwn, sOwn = fit_q("cpu", "cpu_own")
    _, q64, k64, s64 = fit_q(device, device + "_x64", x64=True)
    rel = max_diff(qCard, qCpu)[0]
    relOwn, ofMaxOwn, atOwn = max_diff(qCard, qOwn)
    rel64, ofMax64, at64 = max_diff(q64, qOwn)
    phase(15, "15d fitQ, real-space reference %s, tiles %s, %d Q values a "
          "tile (%.3g to %.3g): %s kernels %.2f s + fitQ %.2f s; the CPU "
          "float64 fit of the same kernels %.2f s, max rel diff %.2e "
          "(tolerance 1e-4); the CPU's own float64 kernels %.2f s + fitQ "
          "%.2f s: max diff %.2e of the largest Q (tolerance 1e-4), %.2e "
          "of its own (at Q %.3g); the %s kernels and fit in float64 %.2f "
          "+ %.2f s: max diff %.2e of the largest Q, %.2e of its own (at Q "
          "%.3g; tolerance 1e-9) (%s)"
          % (RS_QREF[0], "+".join(RS_CPU_TILES), len(qOwn[RS_CPU_TILES[0]]),
             min(q.min() for q in qOwn.values()),
             max(q.max() for q in qOwn.values()), device, kCard, sCard, sCpu,
             rel, kOwn, sOwn, ofMaxOwn, relOwn, atOwn, device, k64, s64,
             ofMax64, rel64, at64, card))
    if rel > 1e-4 or ofMaxOwn > 1e-4 or rel64 > 1e-9:
        raise RuntimeError("real-space fitQ: card and CPU differ by %.3e "
                           "(the same kernels), %.3e of the largest Q (each "
                           "its own), %.3e (float64)"
                           % (rel, ofMaxOwn, rel64))
    return conv, counts


def conv_row(conv, counts):
    """The conv line's record of the real-space step's convolution: torch
    FFT ops (cuFFT), not a hand-written kernel; the plain version is the
    route itself."""
    return {
        "name": "convolve2d_reflect_sum_batch",
        "route": "torch.fft (cuFFT; torch ops, not a hand-written kernel)",
        "source": "nemo_tpu_torch/ops/imageops.py",
        "replaces": "nemo_tpu/ops/imageops.py:201 (XLA "
                    "conv_general_dilated, not a TPU kernel)",
        "launches": counts["conv"], "max_abs_err": conv["max_abs_err"],
        "ms": conv["ms"], "plain_ms": conv["ms"],
        "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
        "library_ms": conv["library_ms"],
        "share_of_bound": conv["bound_ms"] / conv["ms"],
        "operations": conv["operations"],
        "bound_ms_direct_sum": conv["direct_bound_ms"],
        "operations_direct_sum": conv["direct_operations"],
        "library_max_abs_err": conv["library_max_abs_err"],
        "shape": "16 x 2 x %d x %d float32, %d x %d kernels; library_ms is "
                 "one grouped cuDNN conv2d (TF32 off)"
                 % (SHAPE[0], SHAPE[1], RS_KERNEL, RS_KERNEL)}


# -- phase 16 ------------------------------------------------------------------

# 16a's CPU float64 comparison (the card runs all 16 tiles); 16b's tiles,
# all four on the card and on the CPU
SPEC_CPU_TILES = ("T11", "T12")
CAP_TILES = ("T11", "T12", "T21", "T22")
MOCKS = 3
MOCK_SEED = SEED + 16
# tests/test_preprocessing_features.py:123-128's settings and blob
EXT_TILE = "T11"
EXT_SETTINGS = {"thresholdSigma": 5.0, "bigScaleDeg": 1.0,
                "smallScaleDeg": 0.1, "dilationPix": 2}
EXT_BLOB = (3000.0, 450, 760, 30.0)          # uK, y, x, sigma (pixels)
PROFILE_BATCH = 8                            # two chunks of the 16 tiles


def tools_config(surveyDict, outName, tiles=None, **over):
    """Phase 7's survey with the quickstart's two scales, written as JSON
    (which YAML parsers read too) under WORK/tools; ``tiles`` keeps those
    tiles only.  Returns the config path."""
    d = copy.deepcopy(with_filters(surveyDict, SIM_LABELS, **over))
    if tiles is not None:
        d["tileDefinitions"] = [t for t in d["tileDefinitions"]
                                if t["tileName"] in tiles]
    work = os.path.join(WORK, "tools")
    os.makedirs(work, exist_ok=True)
    d["outputDir"] = os.path.join(work, outName)
    path = os.path.join(work, outName + ".yml")
    with open(path, "w") as f:
        json.dump(d, f, indent=1)
    return path


@contextlib.contextmanager
def working_directory(path):
    """Run a CLI from ``path`` (nemoSpec's cache and nemoCatalogCheck's
    tables go to the working directory)."""
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def spec_targets(catPath):
    """nemoSpec's targets: the name, position and template of each row of
    a two-scale run's optimal catalog, written as FITS."""
    from nemo_tpu_torch import catalogs
    from nemo_tpu_torch.utils.tables import Table
    cat = Table.read(catPath)
    if sorted(set(np.asarray(cat["template"]))) != sorted(SIM_LABELS):
        raise RuntimeError("the targets' templates are %s"
                           % sorted(set(np.asarray(cat["template"]))))
    path = os.path.join(WORK, "tools", "targets.fits")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    catalogs.writeCatalog(Table({k: np.asarray(cat[k]) for k in (
        "name", "RADeg", "decDeg", "template")}), path)
    return path, len(cat)


def rows_by_name(got, ref, cols):
    """{column: (got values, ref values)} over ref's rows, each matched by
    name to got's one row of that name."""
    names = list(np.asarray(got["name"]))
    if len(set(names)) != len(names):
        raise RuntimeError("repeated names in a nemoSpec table")
    idx = [names.index(n) for n in np.asarray(ref["name"])]
    return {c: (np.asarray(got[c], dtype=float)[idx],
                np.asarray(ref[c], dtype=float)) for c in cols}


def spec_phase(noise, detect, card, surveyDict, targets, device="cuda"):
    """16a and 16b: ``nemoSpec -m matchedFilter`` on the 16 tiles on the
    card and on SPEC_CPU_TILES on the CPU in float64; ``nemoSpec -m CAP``
    on CAP_TILES on both.  Returns the matched-filter run's rms_cells
    launches."""
    import torch
    from nemo_tpu_torch import filters
    from nemo_tpu_torch.cli import nemoSpec_main
    from nemo_tpu_torch.utils.tables import Table
    work = os.path.join(WORK, "tools")
    runs = {}

    def run(tag, dev, method, tiles=None):
        cfgPath = tools_config(surveyDict, "spec_" + tag, tiles=tiles)
        outPath = os.path.join(work, "spec_%s.fits" % tag)
        calls = {"filterMaps": 0}

        def counted(orig):
            def f(*a, **kw):
                calls["filterMaps"] += 1
                return orig(*a, **kw)
            return f
        reset_counts(noise, detect)
        t0 = time.perf_counter()
        with working_directory(os.path.join(work, "cwd_" + tag)), \
                patched((filters, "filterMaps", counted)):
            nemoSpec_main.main([cfgPath, targets, "-m", method, "-o",
                                outPath, "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs[tag] = (Table.read(outPath), secs, read_counts(noise, detect),
                     calls["filterMaps"])

    run("mf_" + device, device, "matchedFilter")
    run("mf_cpu", "cpu", "matchedFilter", tiles=SPEC_CPU_TILES)
    tab, secs, counts, nFilters = runs["mf_" + device]
    cpuTab, cpuSecs, cpuCounts, _ = runs["mf_cpu"]
    cols = [c for c in cpuTab.keys() if c.startswith(("y_c_", "SNR_"))]
    if len(cols) != 4 or len(cpuTab) == 0:
        raise RuntimeError("nemoSpec -m matchedFilter columns %s, %d CPU "
                           "rows" % (cols, len(cpuTab)))
    rel = {c: float(np.max(np.abs(g / r - 1)))
           for c, (g, r) in rows_by_name(tab, cpuTab, cols).items()}
    # each (tile, template) filter is built and applied to the reference
    # band, then applied to the other: one grid RMS (one launch) a band
    onCard = device == "cuda"
    want = 2 * nFilters if onCard else 0
    if counts["rms_cells"] != want or nFilters < len(SIM_LABELS) \
            or (counts["rms_plain"] if onCard else False):
        raise RuntimeError("nemoSpec -m matchedFilter: %d filters, counts "
                           "%s" % (nFilters, counts))
    phase(16, "16a nemoSpec -m matchedFilter --device %s, %d tiles, %d "
          "targets: %d rows in %.2f s, %d (tile, template) filters, "
          "rms_cells launches %d (2 a filter: the reference band and the "
          "PSF-matched other), plain calls %d; the CPU float64 run on %s: "
          "%d rows in %.2f s; card vs CPU max |ratio - 1| %s (tolerance "
          "1e-4) (%s)"
          % (device, len(surveyDict["tileDefinitions"]),
             len(Table.read(targets)), len(tab), secs, nFilters,
             counts["rms_cells"], counts["rms_plain"],
             "+".join(SPEC_CPU_TILES), len(cpuTab), cpuSecs,
             json.dumps({c: float("%.3e" % v) for c, v in rel.items()}),
             card))
    if max(rel.values()) > 1e-4:
        raise RuntimeError("nemoSpec -m matchedFilter card vs CPU: %s" % rel)

    run("cap_" + device, device, "CAP", tiles=CAP_TILES)
    run("cap_cpu", "cpu", "CAP", tiles=CAP_TILES)
    capTab, capSecs, _, _ = runs["cap_" + device]
    capCpu, capCpuSecs, _, _ = runs["cap_cpu"]
    cols = [c for c in capCpu.keys() if c.startswith("diskT_uKArcmin2_")]
    if len(cols) != 2 or len(capTab) != len(capCpu) or len(capCpu) == 0:
        raise RuntimeError("nemoSpec -m CAP: columns %s, rows %d / %d"
                           % (cols, len(capTab), len(capCpu)))
    ofMax = {c: float(np.max(np.abs(g - r)) / np.max(np.abs(r)))
             for c, (g, r) in rows_by_name(capTab, capCpu, cols).items()}
    phase(16, "16b nemoSpec -m CAP --device %s on %s: %d rows in %.2f s "
          "(host-bound: a distance map per target, band and random); CPU "
          "float64 %.2f s; card vs CPU max |diff| / max |column| %s "
          "(tolerance 1e-4) (%s)"
          % (device, "+".join(CAP_TILES), len(capTab), capSecs, capCpuSecs,
             json.dumps({c: float("%.3e" % v) for c, v in ofMax.items()}),
             card))
    if max(ofMax.values()) > 1e-4:
        raise RuntimeError("nemoSpec -m CAP card vs CPU: %s" % ofMax)
    return counts["rms_cells"]


def mock_phase(noise, detect, card, selFnDir, device="cuda"):
    """16c: ``nemoMock -N MOCKS -s MOCK_SEED`` on a selFn/ with DR5's
    massOptions (the default Boltzmann transfer), on the CPU (float64, the
    plain solve, from this process's cache where an earlier phase solved
    that cosmology) and then on the card with the cache emptied, so that
    this path launches the kernel.  Returns the card run's boltzmann_rk4
    launches."""
    from nemo_tpu_torch import mock as mock_mod
    from nemo_tpu_torch.cli import nemoMock_main
    from nemo_tpu_torch.models import cosmology
    from nemo_tpu_torch.utils.tables import Table
    cache = cosmology._boltzmann_Tk_cached
    out = {}
    for dev in ("cpu", device):
        grids = []

        def recording(orig):
            class Recorded(orig):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    grids.append(np.array(self.clusterCount))
            return Recorded
        if dev == "cuda":
            cache.cache_clear()
        before = cache.cache_info()
        mocksDir = os.path.join(WORK, "tools", "mocks_" + dev)
        reset_counts(noise, detect)
        t0 = time.perf_counter()
        with patched((mock_mod, "MockSurvey", recording)):
            nemoMock_main.main([selFnDir, mocksDir, "-N", str(MOCKS), "-s",
                                str(MOCK_SEED), "--device", dev])
        secs = time.perf_counter() - t0
        after = cache.cache_info()
        tabs = [Table.read(os.path.join(mocksDir, "mockCatalog_%d.fits"
                                        % (i + 1))) for i in range(MOCKS)]
        out[dev] = {"secs": secs, "counts": read_counts(noise, detect),
                    "cached": after.misses == before.misses,
                    "grid": grids[0], "tabs": tabs}
    c, p = out[device], out["cpu"]
    if len(c["grid"]) == 0 or c["grid"].shape != p["grid"].shape:
        raise RuntimeError("nemoMock: mass-function grids %s / %s"
                           % (c["grid"].shape, p["grid"].shape))
    pos = p["grid"] > 0
    gridRel = float(np.max(np.abs(c["grid"][pos] / p["grid"][pos] - 1)))
    nC = [len(t) for t in c["tabs"]]
    nP = [len(t) for t in p["tabs"]]
    if nC == nP:
        colRel = max(float(np.max(np.abs(
            np.asarray(g[k], dtype=float) - np.asarray(r[k], dtype=float))
            / np.maximum(np.abs(np.asarray(r[k], dtype=float)), 1e-300)))
            for g, r in zip(c["tabs"], p["tabs"])
            for k in ("true_M500c", "true_fixed_y_c", "fixed_y_c",
                      "redshift"))
        rows = "the same rows (%s), max rel diff of true_M500c, " \
               "true_fixed_y_c, fixed_y_c, redshift %.2e" % (nC, colRel)
    else:
        # a draw moved by the grid's last digits: hold the totals
        colRel = 0.0
        if abs(sum(nC) - sum(nP)) > 3 * np.sqrt(sum(nP)):
            raise RuntimeError("nemoMock rows %s / %s" % (nC, nP))
        rows = "rows %s / %s (a draw moved; totals within 3 sqrt(N))" % (
            nC, nP)
    launches = c["counts"]["boltzmann"]
    if (device == "cuda" and (launches != 1 or c["counts"]["boltzmann_plain"]
                              or c["cached"])) \
            or gridRel > 1e-8 or colRel > 1e-6 or min(nC) == 0:
        raise RuntimeError("nemoMock: card counts %s (cached %s), grid %.3e, "
                           "columns %.3e, rows %s"
                           % (c["counts"], c["cached"], gridRel, colRel, nC))
    phase(16, "16c nemoMock -N %d -s %d on the DR5 selFn: --device %s %.2f s "
          "(boltzmann_rk4 launches %d, plain calls %d, transfer from the "
          "cache: %s), --device cpu %.2f s (plain solves %d, from the "
          "cache: %s); mass-function grid %s card vs CPU max rel diff %.2e "
          "(tolerance 1e-8: float64 both); %s (tolerance 1e-6) (%s)"
          % (MOCKS, MOCK_SEED, device, c["secs"], launches,
             c["counts"]["boltzmann_plain"], c["cached"], p["secs"],
             p["counts"]["boltzmann_plain"], p["cached"],
             "x".join(map(str, c["grid"].shape)), gridRel, rows, card))
    return launches


def catalog_check_phase(card, cfgPath, truth, device="cuda"):
    """16d: ``nemoCatalogCheck`` of the smoke's truth catalog against the
    DR5 run, on the card and on the CPU: the same printed counts and the
    same in-mask and missed tables."""
    import io
    from nemo_tpu_torch.cli import nemoCatalogCheck_main
    from nemo_tpu_torch.utils.tables import Table
    work = os.path.join(WORK, "tools")
    extPath = os.path.join(work, "truthCatalog.fits")
    Table({"name": np.array(["SMOKE-T%04d" % i
                             for i in range(len(truth["RADeg"]))]),
           "RADeg": np.asarray(truth["RADeg"]),
           "decDeg": np.asarray(truth["decDeg"])}).write(extPath)
    out = {}
    for dev in (device, "cpu"):
        cwd = os.path.join(work, "check_" + dev)
        shutil.rmtree(cwd, ignore_errors=True)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with working_directory(cwd), contextlib.redirect_stdout(buf):
            nemoCatalogCheck_main.main([cfgPath, extPath, "--device", dev])
        out[dev] = {"secs": time.perf_counter() - t0,
                    "lines": [ln for ln in buf.getvalue().splitlines()
                              if ln.startswith("...")],
                    "files": sorted(os.listdir(cwd)), "dir": cwd}
    c, p = out[device], out["cpu"]
    if c["lines"] != p["lines"] or c["files"] != p["files"] \
            or len(c["lines"]) < 4:
        raise RuntimeError("nemoCatalogCheck card vs CPU:\n%s\n%s"
                           % (c["lines"], p["lines"]))
    for f in c["files"]:
        if not f.endswith(".fits"):
            continue
        a = Table.read(os.path.join(c["dir"], f))
        b = Table.read(os.path.join(p["dir"], f))
        if sorted(a.keys()) != sorted(b.keys()) or len(a) != len(b) or any(
                not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                for k in b.keys()):
            raise RuntimeError("nemoCatalogCheck: %s differs" % f)
    counts = [ln.split(" ")[1] for ln in c["lines"][:3]]
    phase(16, "16d nemoCatalogCheck --device %s of %d truth clusters: in "
          "the mask %s, found %s, missed %s; tables %s equal to the CPU "
          "run's; %.2f s (CPU %.2f s) (%s)"
          % (device, len(truth["RADeg"]), counts[0], counts[1], counts[2],
             ", ".join(f for f in c["files"] if f.endswith(".fits")),
             c["secs"], p["secs"], card))


def extended_snr(config, policy):
    """The plain reference of makeExtendedSourceMask's S/N: each band's
    band-pass over its clipped noise, in float64 on the CPU, and the
    S/N's float32 rounding bound (16 float32 ulps of the band's largest
    |map| over its noise)."""
    from nemo_tpu_torch import maps
    s = config.parDict["findAndMaskExtended"]
    out = []
    for mapDict in config.unfilteredMapsDictList:
        data, wcs = mapDict.loadTile("mapFileName", "PRIMARY",
                                     returnWCS=True)
        data = np.asarray(data, dtype=float)
        band = maps.subtractBackground(data, wcs,
                                       smoothScaleDeg=s["bigScaleDeg"],
                                       policy=policy) \
            - maps.subtractBackground(data, wcs,
                                      smoothScaleDeg=s["smallScaleDeg"],
                                      policy=policy)
        mean, sigma = 0.0, 1e6
        vals = band.ravel()
        for _ in range(10):
            sel = np.abs(vals - mean) < 3 * sigma
            mean, sigma = np.mean(vals[sel]), np.std(vals[sel])
        out.append((band / sigma, 16 * np.finfo(np.float32).eps
                    * np.abs(data).max() / sigma))
    return out


def extended_phase(card, surveyDict, device="cuda"):
    """16e: makeExtendedSourceMask on tile EXT_TILE of the survey with an
    extended blob added, on the card (float32) and on the CPU (float64):
    the masks equal but within a dilation of pixels whose S/N lies within
    float32 rounding of the threshold."""
    import torch
    from nemo_tpu_torch import device as device_mod
    from nemo_tpu_torch import maps, startup
    from nemo_tpu_torch.ops import imageops
    from nemo_tpu_torch.utils import fits as nfits
    work = os.path.join(WORK, "tools", "extended")
    os.makedirs(work, exist_ok=True)
    parDict = startup.parseConfigDict(copy.deepcopy(with_filters(
        surveyDict, [PHOT], outputDir=os.path.join(work, "cut"))))
    cut = startup.NemoConfig(parDict, device="cpu", writeTileInfo=True)
    amp, by, bx, sig = EXT_BLOB
    entries = []
    for mapDict in cut.unfilteredMapsDictList:
        data, wcs = mapDict.loadTile("mapFileName", EXT_TILE,
                                     returnWCS=True)
        yy, xx = np.mgrid[:data.shape[0], :data.shape[1]]
        data = np.asarray(data, dtype=float) + amp * np.exp(
            -((yy - by) ** 2 + (xx - bx) ** 2) / (2 * sig ** 2))
        path = os.path.join(work, "ext_%d.fits" % int(mapDict["obsFreqGHz"]))
        nfits.write_image(path, data, wcs.header)
        entries.append({"mapFileName": path, "weightsFileName": None,
                        "obsFreqGHz": mapDict["obsFreqGHz"], "units": "uK",
                        "beamFileName": mapDict["beamFileName"]})
    masks, secs = {}, {}
    for dev in (device, "cpu"):
        d = {"unfilteredMaps": entries, "thresholdSigma": 5.0,
             "minObjPix": 1, "removeRings": False, "photFilter": None,
             "findAndMaskExtended": dict(EXT_SETTINGS),
             "outputDir": os.path.join(work, "ext_" + dev),
             "mapFilters": [{"label": "Beam", "class": "BeamMatchedFilter",
                             "params": {"noiseParams": {
                                 "method": "dataMap",
                                 "noiseGridArcmin": 40.0},
                                 "outputUnits": "uK",
                                 "edgeTrimArcmin": 0.0}}]}
        config = startup.NemoConfig(startup.parseConfigDict(d), device=dev,
                                    writeTileInfo=True)
        t0 = time.perf_counter()
        masks[dev] = maps.makeExtendedSourceMask(config, "PRIMARY")
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
        written = os.path.join(config.diagnosticsDir, "extendedMask",
                               "PRIMARY.fits")
        if not os.path.exists(written) or any(
                m["extendedMask"] != os.path.dirname(written)
                for m in config.unfilteredMapsDictList):
            raise RuntimeError("makeExtendedSourceMask on %s wrote or set "
                               "no mask" % dev)
    c, p = masks[device], masks["cpu"]
    borderline = np.zeros(p.shape, dtype=bool)
    for snr, tol in extended_snr(config, device_mod.CPU):
        borderline |= np.abs(snr - EXT_SETTINGS["thresholdSigma"]) <= tol
    reach = imageops.binary_dilate_cross(
        torch.as_tensor(borderline), EXT_SETTINGS["dilationPix"]).numpy()
    differ = c != p
    if np.any(differ & ~reach) or p[by, bx] != 1 or not 0 < p.mean() < 0.25:
        raise RuntimeError("makeExtendedSourceMask card vs CPU: %d pixels "
                           "differ, %d away from the threshold; blob %d, "
                           "masked share %.3f"
                           % (differ.sum(), (differ & ~reach).sum(),
                              p[by, bx], p.mean()))
    phase(16, "16e makeExtendedSourceMask on %s + a %.0f uK blob (%d x %d): "
          "--device %s %.3f s, CPU float64 %.3f s; %d pixels masked (%.2f%%),"
          " %d differ from the CPU's, all within a dilation of the %d "
          "pixels whose S/N is within float32 rounding of %.1f (%s)"
          % (EXT_TILE, amp, p.shape[0], p.shape[1], device, secs[device],
             secs["cpu"], int(p.sum()), 100 * p.mean(), int(differ.sum()),
             int(borderline.sum()), EXT_SETTINGS["thresholdSigma"], card))


def trace_top(path, n=5):
    """The ``n`` longest device operations of a chrome trace (summed by
    name: name, ms, calls) and the names of all of them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tot = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            t = tot.setdefault(e["name"], [0.0, 0])
            t[0] += e.get("dur", 0.0) / 1e3
            t[1] += 1
    top = sorted(tot.items(), key=lambda kv: -kv[1][0])[:n]
    return [(k[:70], round(v[0], 3), v[1]) for k, v in top], list(tot)


def profile_phase(noise, detect, card, surveyDict, device="cuda"):
    """16f: ``nemo --profile`` on the survey with the two scales in two
    chunks of PROFILE_BATCH tiles, beside the same run without the flag.
    The engine's chunk counter is process-wide (as in the JAX package):
    it is set to 0 before each run, so that the profiled run's chunk 1 is
    its second chunk.  Returns the profiled run's catalog path."""
    import torch
    from nemo_tpu_torch.cli import nemo_main
    from nemo_tpu_torch.parallel import engine
    from nemo_tpu_torch.utils.tables import Table
    from nemo_tpu_torch.utils.timing import RECORDER
    out = {}
    for tag, extra in (("plain", []), ("profiled", ["--profile"])):
        cfgPath = tools_config(surveyDict, "profile_" + tag,
                               deviceBatchSize=PROFILE_BATCH)
        engine.PROFILE_CHUNK_DIR = None
        engine._chunkCounter[0] = 0
        RECORDER.reset()
        reset_counts(noise, detect)
        t0 = time.perf_counter()
        try:
            nemo_main.main([cfgPath, "--device", device] + extra)
        finally:
            engine.PROFILE_CHUNK_DIR = None
        if device == "cuda":
            torch.cuda.synchronize()
        outDir = os.path.join(WORK, "tools", "profile_" + tag)
        out[tag] = {"secs": time.perf_counter() - t0,
                    "counts": read_counts(noise, detect),
                    "chunks": engine._chunkCounter[0],
                    "cat": os.path.join(outDir, "profile_%s_optimalCatalog"
                                        ".fits" % tag),
                    "trace": os.path.join(outDir, "diagnostics", "profile",
                                          "trace.json")}
    p, q = out["profiled"], out["plain"]
    diff = same_catalog(Table.read(p["cat"]), Table.read(q["cat"]))
    if not os.path.exists(p["trace"]) or os.path.exists(q["trace"]) \
            or p["chunks"] != 2 or diff != 0.0:
        raise RuntimeError("nemo --profile: trace %s, %d chunks, catalogs "
                           "differ by %.3e" % (os.path.exists(p["trace"]),
                                               p["chunks"], diff))
    top, names = trace_top(p["trace"])
    ours = {k: any(k in n for n in names) for k in ("rms_cells",
                                                    "label_kernel")}
    if device == "cuda" and not all(ours.values()):
        raise RuntimeError("the profile names no %s" % ours)
    phase(16, "16f nemo --profile --device %s, %d tiles x %d scales in "
          "chunks of %d: %.2f s (without the flag %.2f s), catalogs bitwise "
          "the same; chunk 1's trace %s (%.1f MiB) names %s; its five "
          "longest device operations (name, ms, calls): %s (%s)"
          % (device, len(surveyDict["tileDefinitions"]), len(SIM_LABELS),
             PROFILE_BATCH, p["secs"], q["secs"],
             os.path.relpath(p["trace"], WORK),
             os.path.getsize(p["trace"]) / 2 ** 20,
             ", ".join(k for k, v in ours.items() if v), json.dumps(top),
             card))
    return p["cat"]


def tools_phase(noise, detect, card, surveyDict, truth, catPath, cfgPath,
                selFnDir, device="cuda"):
    """Phase 16, the survey's tools on the card: 16a-b nemoSpec on the
    two-scale catalog ``catPath``, 16c nemoMock on ``selFnDir``, 16d
    nemoCatalogCheck on the run of ``cfgPath``, 16e the extended-source
    mask, 16f nemo --profile.  Returns the kernels' launches on the
    nemoSpec and nemoMock paths."""
    t0 = time.perf_counter()
    targets, nTargets = spec_targets(catPath)
    specLaunches = spec_phase(noise, detect, card, surveyDict, targets,
                              device)
    mockLaunches = mock_phase(noise, detect, card, selFnDir, device)
    catalog_check_phase(card, cfgPath, truth, device)
    extended_phase(card, surveyDict, device)
    profile_phase(noise, detect, card, surveyDict, device)
    phase(16, "phase 16 in %.1f s (%s)" % (time.perf_counter() - t0, card))
    return {"rms_cells": specLaunches, "boltzmann": mockLaunches}


# -- phase 17 ----------------------------------------------------------------

MESH_VIRTUAL = 2     # shards on cuda:0 when the machine has one card
TILE_STEP_TRIM = 240     # bench.py's trimPix


def survey_mesh(device="cuda"):
    """Every card, or MESH_VIRTUAL virtual shards on cuda:0 when there is
    only one (on the CPU, for a rehearsal: MESH_VIRTUAL CPU shards)."""
    import torch
    from nemo_tpu_torch.parallel import mesh
    if device == "cpu":
        return mesh.get_mesh(MESH_VIRTUAL, device="cpu")
    if torch.cuda.device_count() > 1:
        return mesh.get_mesh()
    return mesh.get_mesh(devices=["cuda:0"] * MESH_VIRTUAL)


def sync(devices):
    import torch
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def device_counts(noise, detect):
    return {"rms_cells": dict(noise.rms_cells.device_launches),
            "label_components":
            dict(detect.label_components_batch.device_launches)}


def tile_step_batch(dev, nT=16, seed=SEED + 17):
    """The benchmark step's arguments on ``dev``: nT seeded two-band
    float64 tiles of SHAPE with 12 compact sources each, a centred
    template, weights, apodisation and masks."""
    import torch
    from nemo_tpu_torch.ops import fourier
    g = torch.Generator(device=dev).manual_seed(seed)
    ny, nx = SHAPE
    data = torch.randn((nT, 2, ny, nx), generator=g, device=dev,
                       dtype=torch.float64)
    yy = torch.arange(ny, device=dev, dtype=torch.float64)[:, None]
    xx = torch.arange(nx, device=dev, dtype=torch.float64)[None, :]
    tmpl = torch.exp(-((yy - ny / 2) ** 2 + (xx - nx / 2) ** 2)
                     / (2 * 2.5 ** 2))
    pos = torch.rand((nT, 12, 2), generator=g, device=dev,
                     dtype=torch.float64)
    for t in range(nT):
        for y, x in pos[t].tolist():
            y, x = 300 + y * (ny - 600), 300 + x * (nx - 600)
            data[t] += 8.0 * torch.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                       / (2 * 2.5 ** 2))
    return (data, data, tmpl.expand(nT, 2, ny, nx).contiguous(),
            torch.tensor([1.0, 0.8], dtype=torch.float64, device=dev),
            fourier.apod_mask(SHAPE, 20, device=dev),
            torch.ones((nT, ny, nx), dtype=torch.float64, device=dev),
            torch.ones((nT, ny, nx), dtype=torch.float64, device=dev))


def place(sharding, args, idx=slice(None)):
    """The step's arguments as shards (w and apodM shared), of the tiles
    ``idx``."""
    return [sharding.put(a[idx]) if i not in (3, 4) else a
            for i, a in enumerate(args)]


def mesh_tile_step(noise, card, m):
    """17a: the sharded benchmark step (float64) on the mesh against one
    shard on the mesh's first device (:func:`tile_step_batch`): the
    survey histogram and candidate count equal exactly, the S/N maps
    within 1e-9 of the largest; the step's seconds on each."""
    import torch
    from nemo_tpu_torch.parallel import distribute, mesh
    dev = m.devices[0]
    args = tile_step_batch(dev)
    nT, _, ny, nx = args[0].shape
    out, secs = {}, {}
    for tag, mm in (("one", mesh.get_mesh(devices=[dev])), ("mesh", m)):
        placed = place(mesh.tile_sharding(mm), args)
        step = distribute.make_sharded_tile_step(mm, GRID_PIX,
                                                 TILE_STEP_TRIM, topK=64)
        step(*placed)                           # warm-up: plans, kernels
        sync(mm.devices)
        t0 = time.perf_counter()
        out[tag] = step(*placed)
        sync(mm.devices)
        secs[tag] = time.perf_counter() - t0
    a, b = out["one"], out["mesh"]
    hist = np.array_equal(a["surveyRMSHist"].cpu().numpy(),
                          b["surveyRMSHist"].cpu().numpy())
    count = int(a["surveyCandidateCount"]) == int(b["surveyCandidateCount"])
    snA = torch.cat([x.to(dev) for x in a["SNMap"]])
    snB = torch.cat([x.to(dev) for x in b["SNMap"]])
    snDiff = float((snA - snB).abs().max() / snA.abs().max())
    if not (hist and count) or snDiff > 1e-9:
        raise RuntimeError("tile step on the mesh: histogram equal %s, "
                           "count equal %s, S/N %.3e" % (hist, count, snDiff))
    phase(17, "17a sharded tile step, %d x 2 x %d x %d float64 (gridSize "
          "%d, trim %d): one shard %.3f s, %d shards %.3f s (per shard "
          "%s s); survey histogram and candidate count (%d) the same, "
          "max |S/N diff| %.2e of the largest (%s)"
          % (nT, ny, nx, GRID_PIX, TILE_STEP_TRIM, secs["one"], m.size,
             secs["mesh"], [round(t.seconds(), 4) for t in b["stepTimer"]],
             int(b["surveyCandidateCount"]), snDiff, card))


def _mesh_process(rank, port, out):
    """17d's worker: join the two-process group through
    multihost.initialize_from_env (NCCL), run the sharded benchmark step
    on this process's tiles (multihost.local_tile_slice) on its card, and
    send back the survey statistics."""
    import torch
    import torch.distributed as dist
    os.environ.update(NEMO_TPU_MULTIHOST="1", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank))
    sys.path.insert(0, ROOT)
    from nemo_tpu_torch.parallel import distribute, mesh, multihost
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    multihost.initialize_from_env("cuda")
    try:
        m = mesh.get_mesh(devices=[dev])
        args = tile_step_batch(dev)
        idx = [int(n) for n in multihost.local_tile_slice(
            [str(i) for i in range(args[0].shape[0])], m)]
        o = distribute.make_sharded_tile_step(
            m, GRID_PIX, TILE_STEP_TRIM, topK=64)(
                *place(mesh.tile_sharding(m), args, idx))
        out.put((rank, idx, o["surveyRMSHist"].cpu().numpy(),
                 int(o["surveyCandidateCount"]), dist.get_backend()))
    finally:
        dist.destroy_process_group()


def mesh_processes(card):
    """17d, with two cards or more: two processes of one card each, joined
    over NCCL, reduce the benchmark step's survey statistics over the
    process group; each equals one process's over a two-card mesh."""
    import socket
    import torch
    from nemo_tpu_torch.parallel import distribute, mesh
    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_mesh_process, args=(r, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = sorted(q.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError("17d: process exit codes %s"
                           % [p.exitcode for p in procs])
    m = mesh.get_mesh(devices=["cuda:0", "cuda:1"])
    ref = distribute.make_sharded_tile_step(
        m, GRID_PIX, TILE_STEP_TRIM, topK=64)(
            *place(mesh.tile_sharding(m), tile_step_batch(m.devices[0])))
    refHist = ref["surveyRMSHist"].cpu().numpy()
    refCount = int(ref["surveyCandidateCount"])
    for rank, idx, hist, count, backend in res:
        if not np.array_equal(hist, refHist) or count != refCount:
            raise RuntimeError("17d: rank %d's survey statistics differ"
                               % rank)
    phase(17, "17d two processes (%s), one card each, tiles %s and %s: "
          "the survey histogram and candidate count (%d) equal one "
          "process's over a two-card mesh, in %.1f s (%s)"
          % (res[0][4], res[0][1], res[1][1], refCount,
             time.perf_counter() - t0, card))


def mesh_phase(noise, detect, card, surveyDict, truth, oneCat,
               device="cuda"):
    """Phase 17, the mesh: 17a the sharded tile step; 17b phase 7's survey
    through batchFilterTilesMulti on the mesh (every card, or two shards
    on cuda:0), cold and warm, against ``oneCat`` (phase 8's one-device
    warm catalog) by phase 9's rule and bitwise; launches of both kernels
    on each shard's device and no plain call; each shard's step seconds;
    17c the photometry filters held on their shards' devices and read
    onto the policy's.  Returns the warm run's launches (total, and by
    device)."""
    import torch
    from nemo_tpu_torch import filters as filters_mod
    from nemo_tpu_torch import startup
    from nemo_tpu_torch.parallel import filtercache
    t0 = time.perf_counter()
    m = survey_mesh(device)
    phase(17, "mesh=%s (%d card(s) on the machine)"
          % ([str(d) for d in m.devices], torch.cuda.device_count()))
    mesh_tile_step(noise, card, m)

    nTiles = SURVEY_GRID[0] * SURVEY_GRID[1]
    nLabels = len(surveyDict["mapFilters"])
    runs = {}
    for tag in ("cold", "warm"):
        reset_counts(noise, detect)
        cat, secs, _ = run_search(surveyDict, device, "mesh_" + tag,
                                  mesh=m)
        runs[tag] = (cat, secs, chunk_budget("mesh_" + tag),
                     read_counts(noise, detect), device_counts(noise, detect))
    cat, secs, bud, counts, byDevice = runs["warm"]
    perShard = {str(d): nLabels * list(m.devices).count(d)
                for d in dict.fromkeys(m.devices)}
    # a CPU rehearsal runs the plain versions, one call a shard and label
    plain = 0 if device == "cuda" else nLabels * m.size
    if device != "cuda":
        perShard = {}
    if counts["rms_plain"] != plain or counts["labels_plain"] != plain \
            or byDevice["rms_cells"] != perShard \
            or byDevice["label_components"] != perShard:
        raise RuntimeError("mesh run: counts %s, by device %s (want %s)"
                           % (counts, byDevice, perShard))
    if bud["shards"] != [[nTiles // m.size] * m.size]:
        raise RuntimeError("mesh run: shards %s" % bud["shards"])
    nCompared, maxSep, maxDy = compare_runs(truth, cat, oneCat)
    diff = same_catalog(cat, oneCat)
    phase(17, "17b the survey on the mesh, %d tiles x %d scales: cold "
          "%.2f s, warm %.2f s (staging wait %.2f + upload %.2f, steps "
          "%.2f, downloads %.2f, host catalog %.2f, other host %.2f); "
          "steps by shard %s s over %s tiles; launches by device %s, plain "
          "calls %d + %d (%s)"
          % (nTiles, nLabels, runs["cold"][1], secs, bud["stageWait"],
             bud["upload"], bud["step"], bud["download"], bud["consume"],
             bud["hostOther"], [round(t, 4) for t in bud["shardStep"][0]],
             bud["shards"][0], json.dumps(byDevice), counts["rms_plain"],
             counts["labels_plain"], card))
    phase(17, "17b catalog against the one-device run: %d clusters at "
          "fixed_SNR >= 5 in either, found by both, max offset %.4f', max "
          "|fixed_y_c ratio - 1| %.2e; %s (largest row difference %.3e)"
          % (nCompared, maxSep, maxDy, "bitwise the same" if diff == 0.0
             else "not bitwise the same", diff))

    # 17c: the photometry filters stay on their shards' devices; a reader
    # on the policy's device moves them there
    parDict = startup.parseConfigDict(copy.deepcopy(surveyDict))
    parDict["outputDir"] = os.path.join(WORK, "mesh_warm")
    config = startup.NemoConfig(parDict, device=device)
    f = next(x for x in parDict["mapFilters"] if x["label"] == PHOT)
    entryDevices, moved = set(), 0
    for tile in sorted(t["tileName"] for t in surveyDict["tileDefinitions"]):
        loader = filters_mod.getFilterClass(f["class"])(
            f["label"], config.unfilteredMapsDictList, f["params"],
            tileName=tile, diagnosticsDir=config.diagnosticsDir,
            geometryOnly=True, policy=config.policy)
        ent = filtercache.DEVICE_CACHE.get(loader.filterFileName)
        if ent is None:
            raise RuntimeError("tile %s's photometry filter is not device-"
                               "resident" % tile)
        entryDevices.add(str(ent["filt"].device))
        loader.loadFilter()
        if loader.filt.device != m.devices[0] or not torch.equal(
                loader.filt, ent["filt"].to(loader.filt.device)):
            raise RuntimeError("tile %s's cached filter read onto %s"
                               % (tile, loader.filt.device))
        moved += ent["filt"].device != loader.filt.device
    phase(17, "17c the photometry filters of %d tiles held on %s, read "
          "onto %s (%d moved across cards), equal (%s)"
          % (nTiles, sorted(entryDevices), m.devices[0], moved, card))
    if device == "cuda" and torch.cuda.device_count() >= 2:
        mesh_processes(card)
    phase(17, "phase 17 in %.1f s" % (time.perf_counter() - t0))
    return {"rms_cells": counts["rms_cells"], "labels": counts["labels"],
            "by_device": byDevice}


def mesh_only():
    """Phases 1, 2, 7 and 17 alone, for a change on the mesh path: the
    kernels' build, the survey, its one-device warm batched run (phase 8's
    reference, on cuda:0 alone) and the mesh phase on every card (two
    shards on cuda:0 with one card); prints the card, no ``ok`` line.
    ``python3 -c 'import chip_smoke; chip_smoke.mesh_only()'``"""
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, ROOT)
    from nemo_tpu_torch import cuda_build
    from nemo_tpu_torch.ops import detect, noise
    from nemo_tpu_torch.parallel import mesh
    tStart = time.perf_counter()
    card = nvidia_smi()
    phase(1, "card: %s | torch %s | CUDA %s | %d device(s)"
          % (card, torch.__version__, torch.version.cuda,
             torch.cuda.device_count()))
    sources = ("rms_cells.cu", "label_components.cu")
    cuda_build.build(sources)
    noise.load_kernel()
    detect.load_label_kernel()
    phase(2, "build: %s in %.2f s" % (", ".join(sources),
                                      time.perf_counter() - tStart))
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    surveyDict, truth = survey_inputs(os.path.join(WORK, "survey"))
    phase(7, "survey inputs in %.1f s" % (time.perf_counter() - t0))
    one = mesh.get_mesh(devices=["cuda:0"])
    run_search(surveyDict, "cuda", "batched_cold", mesh=one)
    oneCat, oneSecs, _ = run_search(surveyDict, "cuda", "batched_warm",
                                    mesh=one)
    phase(8, "one-device warm run on cuda:0: %.2f s, %d objects"
          % (oneSecs, len(oneCat)))
    launches = mesh_phase(noise, detect, card, surveyDict, truth, oneCat)
    print("launches on the mesh %s; total %.1f s"
          % (json.dumps(launches), time.perf_counter() - tStart))
    print(card)


def tools_only():
    """Phases 1, 2, 7, 10 and 16 alone on fresh inputs, for a change on
    the tools' paths: the survey, its DR5 epilogue run (phase 10, whose
    selFn/ feeds nemoMock) and a batched two-scale run whose catalog feeds
    nemoSpec; prints the card, no ``ok`` line.  The CPU nemoMock solves
    the Boltzmann transfer with the plain version (minutes).  ``python3 -c
    'import chip_smoke; chip_smoke.tools_only()'``"""
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, ROOT)
    from nemo_tpu_torch import cuda_build
    from nemo_tpu_torch.models import boltzmann
    from nemo_tpu_torch.ops import detect, noise
    tStart = time.perf_counter()
    card = nvidia_smi()
    phase(1, "card: %s | torch %s | CUDA %s" % (card, torch.__version__,
                                                torch.version.cuda))
    sources = ("rms_cells.cu", "label_components.cu", "boltzmann_rk4.cu")
    cuda_build.build(sources)
    noise.load_kernel()
    detect.load_label_kernel()
    boltzmann.load_kernel()
    phase(2, "build: %s in %.2f s" % (", ".join(sources),
                                      time.perf_counter() - tStart))
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    surveyDict, truth = survey_inputs(os.path.join(WORK, "survey"))
    phase(7, "survey inputs in %.1f s" % (time.perf_counter() - t0))
    cfgPath, _, dr5Out, _ = epilogue_phase(noise, detect, card, surveyDict,
                                           truth)
    outName = "two_scales"
    run_search(with_filters(surveyDict, SIM_LABELS), "cuda", outName)
    launches = tools_phase(
        noise, detect, card, surveyDict, truth,
        os.path.join(WORK, outName, "%s_optimalCatalog.fits" % outName),
        cfgPath, os.path.join(dr5Out, "selFn"))
    print("launches on the tools' paths %s; total %.1f s"
          % (json.dumps(launches), time.perf_counter() - tStart))
    print(card)


def realspace_only():
    """Phases 1, 2 (rms_cells and label_components), rms_cells against its
    plain version (phase 3's first check), 7 and 15 alone, for a
    change on the real-space path; prints the conv line and the card, no
    ``ok`` line.  ``python3 -c 'import chip_smoke;
    chip_smoke.realspace_only()'``"""
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, ROOT)
    from nemo_tpu_torch import cuda_build
    from nemo_tpu_torch.ops import detect, noise
    tStart = time.perf_counter()
    card = nvidia_smi()
    phase(1, "card: %s | torch %s | CUDA %s" % (card, torch.__version__,
                                                torch.version.cuda))
    sources = ("rms_cells.cu", "label_components.cu")
    cuda_build.build(sources)
    noise.load_kernel()
    detect.load_label_kernel()
    phase(2, "build: %s in %.2f s" % (", ".join(sources),
                                      time.perf_counter() - tStart))
    check_rms(noise, card)
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    surveyDict, truth = survey_inputs(os.path.join(WORK, "survey"))
    phase(7, "survey inputs in %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    conv, counts = realspace_phase(noise, detect, card, surveyDict, truth)
    print(json.dumps({"conv": [conv_row(conv, counts)]}))
    print("phase 15 %.1f s, total %.1f s" % (time.perf_counter() - t0,
                                            time.perf_counter() - tStart))
    print(card)


def legendre_ptxas(cuda_build, sht):
    """Phase 2: ptxas's registers and spills of each Legendre kernel:
    synthesis and analysis (4 rings a thread in float32, 2 in float64)."""
    import torch
    log = cuda_build.BUILD_LOGS.get(sht.SOURCE, "")
    for name, t, dtype in (("float32", "f", torch.float32),
                           ("float64", "d", torch.float64)):
        k = sht.legendre_geometry(1, 1, dtype)[0]
        for direction in ("synthesis", "analysis"):
            phase(2, "ptxas, legendre_contract %s %s, %d rings a thread: %s"
                  % (direction, name, k, ptxas_report(
                      log, "%s_kernelI%sLi%dE" % (direction, t, k))))


def legendre_only():
    """Phases 1, 2 and 14a alone, for a change to the Legendre kernel:
    build csrc/legendre_contract.cu, print ptxas's report of its kernels,
    run check_legendre, and print the record and the card; no ``ok`` line.
    ``python3 -c 'import chip_smoke; chip_smoke.legendre_only()'``"""
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, ROOT)
    from nemo_tpu_torch import cuda_build
    from nemo_tpu_torch.ops import sht
    tStart = time.perf_counter()
    card = nvidia_smi()
    phase(1, "card: %s | torch %s | CUDA %s" % (card, torch.__version__,
                                                torch.version.cuda))
    cuda_build.build((sht.SOURCE,))
    sht.load_kernel()
    phase(2, "build: %s in %.2f s" % (
        sht.SOURCE, cuda_build.BUILD_SECONDS.get(sht.SOURCE, 0.0)))
    legendre_ptxas(cuda_build, sht)
    leg = check_legendre(sht, card)
    print(json.dumps({"legendre": {
        "%s %s" % key: {k: v for k, v in r.items() if k != "tol"}
        for key, r in leg.items()}}))
    print("total %.1f s" % (time.perf_counter() - tStart))
    print(card)


def legendre_row(leg, direction, launches, extra):
    """The kernels line's record of one Legendre direction: float32 (the
    card's default) with the float64 run beside it, and synthesis at
    nemoModel's band limit."""
    r32, r64 = leg[(direction, "float32")], leg[(direction, "float64")]
    big = leg.get((direction, "float32 lmax %d" % MODEL_LMAX))
    if big:
        extra = dict(extra, **{k + "_lmax%d" % MODEL_LMAX: big[k] for k in (
            "ms", "kernel_ms", "plain_ms", "bound_ms", "equal_to_plain")})
    multi = leg.get((direction, "float32 %d rings" % MULTI_RINGS))
    if multi:
        extra = dict(extra, **{"%s_R%d_lmax%d" % (k, MULTI_RINGS, MULTI_LMAX):
                               multi[k] for k in ("ms", "kernel_ms",
                                                  "plain_ms", "bound_ms",
                                                  "max_abs_err")})
    if launches <= 0:
        raise RuntimeError("legendre %s: no launch on its main path"
                           % direction)
    return dict({
        "name": "legendre_" + direction, "route": "cuda",
        "launches_mesh": 0,          # phase 17 runs no sims
        "source": "nemo_tpu_torch/csrc/legendre_contract.cu",
        "replaces": "nemo_tpu/ops/sht.py:70 (XLA lax.scan, not a TPU "
                    "kernel)",
        "launches": launches, "max_abs_err": r32["max_abs_err"],
        "ms": r32["ms"], "plain_ms": r32["plain_ms"],
        "bound_ms": r32["bound_ms"], "bound_by": r32["bound_by"],
        "library_ms": None, "share_of_bound": r32["bound_ms"] / r32["ms"],
        "shape": "lmax = mmax = %d, 896 rings, float32; ms is the call "
                 "(seed tables, one launch), kernel_ms the launch alone"
                 % SIM_LMAX,
        "kernel_ms": r32["kernel_ms"],
        "kernel_share_of_bound": r32["bound_ms"] / r32["kernel_ms"],
        "equal_to_plain": r32["equal_to_plain"],
        "ms_float64": r64["ms"], "kernel_ms_float64": r64["kernel_ms"],
        "plain_ms_float64": r64["plain_ms"],
        "bound_ms_float64": r64["bound_ms"],
        "max_abs_err_float64": r64["max_abs_err"],
        "equal_to_plain_float64": r64["equal_to_plain"]}, **extra)


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
        from nemo_tpu_torch.models import boltzmann, cosmology
        from nemo_tpu_torch.ops import detect, noise, sht
    except ImportError as exc:
        sys.exit("chip_smoke: the port is not importable from %s (%s)"
                 % (ROOT, exc))
    tStart = time.perf_counter()

    card = nvidia_smi()
    phase(1, "card: %s | torch %s | CUDA %s | %d device(s)"
          % (card, torch.__version__, torch.version.cuda,
             torch.cuda.device_count()))

    t0 = time.perf_counter()
    sources = ("rms_cells.cu", "label_components.cu", "boltzmann_rk4.cu",
               boltzmann.IEEE_DIV_BUILD, sht.SOURCE)
    cuda_build.build(sources)
    noise.load_kernel()
    detect.load_label_kernel()
    boltzmann.load_kernel()
    sht.load_kernel()
    phase(2, "build: %s for sm_90a, in parallel, in %.2f s (nvcc %s)"
          % (", ".join(sources), time.perf_counter() - t0,
             ", ".join("%.2f s" % cuda_build.BUILD_SECONDS.get(k, 0.0)
                       for k in sources)))
    phase(2, "ptxas, boltzmann_rk4: %s" % ptxas_report(
        cuda_build.BUILD_LOGS.get("boltzmann_rk4.cu", ""),
        "boltzmann_rk4_kernel"))
    legendre_ptxas(cuda_build, sht)

    rms = check_rms(noise, card)
    labelErr, labelMs, labelBound, labelBy = check_labels(detect, card)
    boltz = check_boltzmann(boltzmann, cosmology, card)

    t0 = time.perf_counter()
    configDict, truth = make_inputs("cuda")
    phase(4, "inputs: %d x %d two-band tile, %d clusters, in %.1f s"
          % (SHAPE[0], SHAPE[1], N_CLUSTERS, time.perf_counter() - t0))

    torch.cuda.reset_peak_memory_stats()
    reset_counts(noise, detect)
    gpuCat, gpuSecs, gpuStages = run_search(configDict, "cuda", "run_cuda")
    oneTile = read_counts(noise, detect)
    launches = oneTile["rms_cells"]
    plainCalls = oneTile["rms_plain"]
    if launches <= 0 or plainCalls != 0 or oneTile["staged"] != launches:
        raise RuntimeError("one-tile path: counts %s" % oneTile)
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

    runs, surveyDict, surveyTruth = batched_phases(noise, detect, card)
    warm = runs["warm"][3]

    cfgPath, dr5Dict, dr5Out, dr5Counts = epilogue_phase(
        noise, detect, card, surveyDict, surveyTruth)
    qfit_routes_phase(card, dr5Dict, dr5Out)
    masses_phase(card, cfgPath, dr5Dict, dr5Out, surveyTruth)
    injCounts = injection_phase(noise, detect, card, surveyDict)

    leg = check_legendre(sht, card)
    _, _, simRuns = sims_search_phase(noise, detect, card)
    contamCounts = contamination_phase(noise, detect, card, simRuns)
    modelCounts = nemo_model_phase(card)
    t0 = time.perf_counter()
    conv, rsCounts = realspace_phase(noise, detect, card, surveyDict,
                                     surveyTruth)
    phase(15, "phase 15 in %.1f s" % (time.perf_counter() - t0))
    toolLaunches = tools_phase(
        noise, detect, card, surveyDict, surveyTruth,
        os.path.join(WORK, "rs_warm", "rs_warm_optimalCatalog.fits"),
        cfgPath, os.path.join(dr5Out, "selFn"))
    meshLaunches = mesh_phase(noise, detect, card, surveyDict, surveyTruth,
                              runs["warm"][0])
    # the deferred filter-cache FITS of every run, written now rather than
    # by the exit hook
    from nemo_tpu_torch.parallel import filtercache
    t0 = time.perf_counter()
    nDeferred = filtercache.deferred_count()
    filtercache.flush(materialize_deferred=True)
    print("filter cache: %d deferred FITS written in %.2f s"
          % (nDeferred, time.perf_counter() - t0))

    errs, flips, ms, bms, by = rms[("step", "float32")]
    ms1 = rms[("nT1", "float32")][2]
    errsRs, _, msRs, bmsRs, _ = rms[("realspace", "float32")]
    print(json.dumps({"conv": [conv_row(conv, rsCounts)]}))
    print(json.dumps({"kernels": [{
        "name": "rms_cells", "route": "cuda",
        "source": "nemo_tpu_torch/csrc/rms_cells.cu",
        "replaces": "nemo_tpu/ops/noise.py:212",
        "launches": warm["rms_cells"], "max_abs_err": errs["staged"],
        "ms": ms["staged"], "plain_ms": ms["plain"], "bound_ms": bms,
        "bound_by": by, "library_ms": None,
        "share_of_bound": bms / ms["staged"],
        "shape": "nT 16 x 900 x 1536 float32, staged variant",
        "launches_staged": warm["staged"],
        "launches_streaming": warm["streaming"],
        "ms_streaming": ms["streaming"],
        "max_abs_err_streaming": errs["streaming"],
        "borderline_clip_cells": flips,
        "launches_one_tile": launches,
        "launches_nemo_I": injCounts[0]["rms_cells"],
        "launches_injection_reruns": injCounts[1]["rms_cells"],
        "launches_realspace_run": rsCounts["rms_cells"],
        "launches_nemoSpec_matchedFilter": toolLaunches["rms_cells"],
        "launches_mesh": meshLaunches["rms_cells"],
        "launches_mesh_by_device": meshLaunches["by_device"]["rms_cells"],
        "ms_nT1": ms1["staged"],
        "ms_nT1_streaming": ms1["streaming"], "plain_ms_nT1": ms1["plain"],
        "ms_realspace_layout": msRs["staged"],
        "plain_ms_realspace_layout": msRs["plain"],
        "bound_ms_realspace_layout": bmsRs,
        "max_abs_err_realspace_layout": errsRs["staged"],
    }, {
        "name": "label_components", "route": "cuda",
        "source": "nemo_tpu_torch/csrc/label_components.cu",
        "replaces": "nemo_tpu/ops/detect.py:55 (XLA, not a TPU kernel)",
        "launches": warm["labels"], "max_abs_err": float(labelErr),
        "ms": labelMs["kernel"], "plain_ms": labelMs["plain"],
        "bound_ms": labelBound, "bound_by": labelBy, "library_ms": None,
        "share_of_bound": labelBound / labelMs["kernel"],
        "launches_nemo_I": injCounts[0]["labels"],
        "launches_mesh": meshLaunches["labels"],
        "launches_mesh_by_device":
            meshLaunches["by_device"]["label_components"],
        "shape": "16 x 900 x 1536 S/N mask, 128 passes"}, {
        "name": "boltzmann_rk4", "route": "cuda",
        "source": "nemo_tpu_torch/csrc/boltzmann_rk4.cu",
        "replaces": "nemo_tpu/models/boltzmann.py:555 (XLA lax.scan, not a "
                    "TPU kernel)",
        "launches": dr5Counts["boltzmann"],
        "launches_nemoMock": toolLaunches["boltzmann"],
        # phase 17 filters only; the epilogue runs on the policy's device
        "launches_mesh": 0,
        "max_abs_err": boltz["max_abs_err_24576_plain"],
        "ms": boltz["ms24576"], "plain_ms": boltz["plain_ms24576"],
        "bound_ms": boltz["bound_ms24576"],
        "bound_by": boltz["bound_by24576"], "library_ms": None,
        "share_of_bound": boltz["bound_ms24576"] / boltz["ms24576"],
        "shape": "160 k, nGrid 24576, float64, one warp a k, a multipole "
                 "a lane; ms is the call (per-step table built, uploaded, "
                 "one launch)",
        "ms_kernel_only": boltz["kernel_ms24576"],
        "plain_device": "cpu (float64; at nGrid 4096 on the card)",
        "ms_kernel_nvcc_division": boltz["ieee_div_ms24576"],
        "ms_kernel_one_k": boltz["kernel_ms24576_one_k"],
        "chain_ns_per_step": boltz["chain_ns_per_step"],
        "kernel_ns_per_step": boltz["kernel_ns_per_step"],
        "chain_latency_ns": boltz["chain_latency_ns"],
        "max_rel_err": boltz["max_rel_err_24576_plain"],
        "max_rel_err_vs_jax": boltz["max_rel_err_24576"],
        "ms_nGrid4096": boltz["ms4096"],
        "ms_kernel_only_nGrid4096": boltz["kernel_ms4096"],
        "ms_kernel_nvcc_division_nGrid4096": boltz["ieee_div_ms4096"],
        "plain_ms_nGrid4096": boltz["plain_ms4096"],
        "bound_ms_nGrid4096": boltz["bound_ms4096"],
        "max_rel_err_nGrid4096": boltz["max_rel_err"],
        "operations": boltz["ops24576"]}] + [legendre_row(
            leg, direction, launches, extra)
            for direction, launches, extra in (
                ("synthesis", simRuns["model"]["counts"]["synthesis"],
                 {"launches_sky_sims": contamCounts["synthesis"],
                  "launches_nemoModel": modelCounts["synthesis"]}),
                ("analysis", modelCounts["analysis"],
                 {"launches_model_noise_run":
                  simRuns["model"]["counts"]["analysis"]}))]}))
    print("total %.1f s" % (time.perf_counter() - tStart))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
