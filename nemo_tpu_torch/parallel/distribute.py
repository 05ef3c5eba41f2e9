"""The batched matched-filter step on one device.

Port of ``nemo_tpu/parallel/distribute.py`` for one GPU: a batch of
same-shaped tiles ``(n_tiles, n_freq, ny, nx)`` goes through one call that
builds every tile's matched filter (noise covariance -> closed-form
N^-1 w|s| solve), applies it, estimates the local-noise RMS (the
hand-written ``rms_cells`` kernel, in the batched per-tile-geometry
layout), forms the S/N map, trims edges and, in detection mode, segments
the S/N map and reads per-object statistics on the device
(:mod:`..ops.detect`).  The real-space step does the same tail after a
band-summed convolution with each tile's own kernels, at the tiles' true
shape.

The one-device steps (``make_tile_step``, ``make_matched_filter_step``,
``make_realspace_step``) take tensors that all live on one device and
raise if one does not: nothing falls back to the CPU.  The JAX package
shards the tile axis over a device mesh with ``shard_map``; the
``make_sharded_*`` steps here take a :class:`.mesh.Mesh` and a batch as
its shards (:func:`.mesh.tile_sharding`), run the one-device step on
each shard on that shard's device, and launch every shard before they
wait on any (shards on distinct devices run from one thread per device,
so a host sync inside one shard's step does not hold the others back).
The benchmark step's survey statistics are real collectives over the
shards: the maximum RMS over every shard sets the shared histogram
edges, each shard takes its own histogram, and the histograms and
candidate counts are summed; with ``torch.distributed`` initialised over
several processes they are also all-reduced over the process group, as
a JAX mesh that spans processes reduces over all of it.
"""

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import detect as detect_ops
from ..ops import fourier, imageops
from ..ops import noise as noise_ops
from ..ops import solve as solve_ops
from .mesh import get_mesh, replicated, tile_sharding


def _check_one_device(*tensors):
    """Every tensor argument on the first one's device (the step moves
    nothing between devices)."""
    dev = tensors[0].device
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError("step inputs span devices (%s and %s): stage "
                             "every input on the policy's device"
                             % (dev, t.device))


def _sn(filtered, RMSMap):
    zero = torch.zeros((), dtype=filtered.dtype, device=filtered.device)
    return torch.where(RMSMap > 0,
                       filtered / torch.clamp(RMSMap, min=1e-30), zero)


def _edge_check(filtered, psMask, trimPix):
    if trimPix > 0:
        edge = imageops.minimum_filter(torch.abs(filtered + (1 - psMask)),
                                       trimPix)
        return (edge > 0).to(filtered.dtype)
    return torch.ones_like(filtered)


def _covariance_filter(fNoise, fSignalAbs, w, fg, nx):
    """filt = N^-1 (w |s|) per Fourier pixel for a (T, nf, ...) batch: the
    band x band noise covariance, floored by ``fg`` (-inf: no floor) and
    smoothed on the Hermitian-extended full grid."""
    T, nf = fNoise.shape[:2]
    prods = torch.real(fNoise[:, :, None] * torch.conj(fNoise[:, None, :]))
    if fg is not None:
        prods = torch.maximum(prods, fg[:, None, None])
    prods = imageops.gaussian_filter_rfft_fullgrid(
        prods.reshape((-1,) + prods.shape[-2:]), (3, 3), nx)
    N = prods.reshape((T, nf, nf) + prods.shape[-2:])
    A = N.permute(0, 3, 4, 1, 2)                      # (T, ny, nxh, nf, nf)
    b = fSignalAbs.permute(0, 2, 3, 1) * w            # (T, ny, nxh, nf)
    return solve_ops.solve_small(A, b).permute(0, 3, 1, 2)


def _build_and_apply_filter(data, noise, template, w, apodM):
    """Matched-filter build + apply for a (T, nf, ny, nx) batch sharing
    one apodisation; filtered maps normalised so the filtered template
    peaks at 1 (the benchmark step's normalisation)."""
    T, nf, ny, nx = data.shape
    fNoise = fourier.rfft2(noise * apodM)
    fSignalAbs = torch.abs(fourier.rfft2(template))
    filt = _covariance_filter(fNoise, fSignalAbs, w, None, nx)
    filteredTemplate = torch.sum(fourier.irfft2(fSignalAbs * filt, (ny, nx)),
                                 dim=1)
    norm = 1.0 / torch.clamp(filteredTemplate.reshape(T, -1).amax(dim=1),
                             min=1e-30)
    fMaps = fourier.rfft2(data * apodM)
    return torch.sum(fourier.irfft2(fMaps * filt, (ny, nx)), dim=1) \
        * norm[:, None, None]


def _top_peaks(SNMap, threshold, topK):
    """Top-K local S/N maxima above ``threshold`` per tile: (vals, ys, xs),
    each (T, topK).  Entries past a tile's peak count are zeros whose
    indices are unspecified (JAX and torch order ties differently)."""
    localMax = imageops.maximum_filter(SNMap, 3)
    isPeak = (SNMap >= localMax) & (SNMap > threshold)
    peakVals = torch.where(isPeak, SNMap, torch.zeros_like(SNMap))
    vals, flatIdx = torch.topk(peakVals.reshape(SNMap.shape[0], -1), topK,
                               dim=1)
    nx = SNMap.shape[-1]
    return vals, torch.div(flatIdx, nx, rounding_mode="floor"), flatIdx % nx


def _histogram(values, valid, edges):
    """``jnp.histogram`` counts of the ``valid`` entries of ``values`` over
    ``edges`` (right edge of the last bin inclusive), as bucketize and an
    integer scatter-add (no host sync)."""
    nb = edges.shape[0] - 1
    idx = torch.bucketize(values, edges, right=True) - 1
    idx = torch.where(values == edges[-1], torch.full_like(idx, nb - 1), idx)
    inside = (valid & (idx >= 0) & (idx < nb)).reshape(-1)
    counts = torch.zeros(nb, dtype=torch.int64, device=values.device)
    counts.scatter_add_(0, torch.where(inside, idx.reshape(-1), 0),
                        inside.to(torch.int64))
    return counts.to(values.dtype)


def _process_all_reduce(t, op):
    """All-reduce ``t`` in place over the process group when
    ``torch.distributed`` runs more than one process; else nothing."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.all_reduce(t, op=op)
    return t


def _survey_stats(RMSMaps, peakVals, threshold, across_processes):
    """The survey-wide candidate count and RMS histogram of a batch given
    as shards: the maximum RMS over every shard (``pmax``) sets 33 shared
    edges, each shard takes its own histogram on its device, and the
    counts and histograms are summed (``psum``) on the first shard's
    device; ``across_processes`` also all-reduces them over the process
    group (MAX, then SUM)."""
    import torch.distributed as dist
    dev0 = RMSMaps[0].device
    globalMax = torch.stack([torch.max(r).to(dev0) for r in RMSMaps]).max()
    if across_processes:
        globalMax = _process_all_reduce(globalMax, dist.ReduceOp.MAX)
    edges = torch.linspace(0.0, 1.0, 33, dtype=RMSMaps[0].dtype,
                           device=dev0) * (globalMax * 1.0001 + 1e-30)
    hist = torch.stack([
        _histogram(r, r > 0, edges.to(r.device)).to(dev0)
        for r in RMSMaps]).sum(dim=0)
    nCand = torch.stack([torch.sum(v > threshold).to(dev0)
                         for v in peakVals]).sum()
    if across_processes:
        hist = _process_all_reduce(hist, dist.ReduceOp.SUM)
        nCand = _process_all_reduce(nCand, dist.ReduceOp.SUM)
    return nCand, hist


def make_tile_step(gridSize, trimPix, topK=256, threshold=4.0,
                   with_survey_stats=True):
    """The benchmark step (the JAX package's ``make_sharded_tile_step``,
    the step ``bench.py`` times): a function of (data, noise, template, w,
    apodM, psMask, surveyMask) with a leading tile axis on data, noise,
    template and the two masks (w and apodM shared)."""

    def step(data, noise, template, w, apodM, psMask, surveyMask):
        _check_one_device(data, noise, template, w, apodM, psMask,
                          surveyMask)
        psMask = psMask.to(data.dtype)
        filtered = _build_and_apply_filter(data, noise, template, w, apodM)
        filtered = filtered * psMask
        RMSMap = noise_ops.grid_rms_map_batch(filtered, gridSize)
        SNMap = _sn(filtered, RMSMap)
        mask = _edge_check(filtered, psMask, trimPix) * surveyMask \
            * psMask * (apodM == 1)
        SNMap = SNMap * mask
        RMSMap = RMSMap * mask
        filtered = filtered * mask
        vals, ys, xs = _top_peaks(SNMap, threshold, topK)
        out = {"filtered": filtered, "SNMap": SNMap, "RMSMap": RMSMap,
               "peakVals": vals, "peakYs": ys, "peakXs": xs}
        if with_survey_stats:
            # survey-wide reductions over the whole batch, one shard
            out["surveyCandidateCount"], out["surveyRMSHist"] = \
                _survey_stats([RMSMap], [vals], threshold, False)
        return out

    return step


def _single_tile_step(data, noise, template, w, apodM, psMask, surveyMask,
                      gridSize, trimPix, topK, threshold):
    """One-tile forward step (unbatched, host-path RMS layout)."""
    filtered = _build_and_apply_filter(data[None], noise[None],
                                       template[None], w, apodM)[0]
    filtered = filtered * psMask
    RMSMap = noise_ops.grid_rms_map(filtered, gridSize)
    SNMap = _sn(filtered, RMSMap)
    mask = _edge_check(filtered, psMask, trimPix) * surveyMask * psMask \
        * (apodM == 1)
    SNMap = SNMap * mask
    RMSMap = RMSMap * mask
    filtered = filtered * mask
    vals, ys, xs = _top_peaks(SNMap[None], threshold, topK)
    return {"filtered": filtered, "SNMap": SNMap, "RMSMap": RMSMap,
            "peakVals": vals[0], "peakYs": ys[0], "peakXs": xs[0]}


def _undo_pixel_window_masked(filtered, mask):
    """Deconvolve the map pixel window (``apply_pixel_window(pow=-1)``),
    keeping masked pixels at exactly zero; works on any leading axes."""
    out = fourier.apply_pixel_window(filtered, pow=-1.0)
    return torch.where(mask != 0, out, torch.zeros_like(out))


def gather_cutouts_batch(snBatch, fmBatch, ys, xs, window=16):
    """Per-tile spline-window cutouts from a resident (S/N, signal) map
    pair at (T, K) positions."""
    return detect_ops.gather_cutouts_batch(
        torch.stack([snBatch, fmBatch], dim=1), ys, xs, window=window)


def subpixel_read_batch(snBatch, fmBatch, ys, xs, window=16):
    """Per-tile sub-pixel (spline, nearest) S/N + signal reads of a
    resident (S/N, signal) map pair at (T, K) positions - the cross-filter
    (fixed_) photometry read against the reference filter's maps.
    Returns (spline, nearest), each (T, K, 2)."""
    return detect_ops.spline_values_batch(
        torch.stack([snBatch, fmBatch], dim=1), ys, xs, window=window)


def make_matched_filter_step(gridSize, trimPix, undo_pixel_window=False,
                             lean_outputs=False, detect_params=None,
                             return_filter=False, given_filter=False):
    """The production batched matched filter (the JAX package's
    ``make_sharded_matched_filter_step``): the host engine's math for a
    tile batch, returning unnormalised filtered maps plus the calibration
    crops from which the host fixes each tile's signal norm.

    With ``given_filter`` the step applies pre-built filters instead
    (cached-filter reruns: injection and contamination tests reload the
    saved filters, as the host engine does): a function of (data, filt,
    apodM, psMask, surveyMask, meta), with ``filt`` (T, nf, py, px//2+1),
    that applies them and runs the same tail, with ``signalNorm`` all ones
    (the host takes the norms from the cache headers) and no calibration.
    Each call of a step adds one to ``make_matched_filter_step.calls``
    under "build" or "given".

    Args of the returned function (leading tile axis T):
        data, noise: (T, nf, py, px) preprocessed maps, zero-padded (pass
            the same tensor for both with the dataMap noise method: its
            transform is then taken once).
        template: (T, nf, py, px) unit-amplitude signal templates.
        calib: (T, nf, py, px) known-amplitude calibration templates.
        w: (nf,) spectral weights.
        apodM: (T, py, px) apodisation, zero in the padding.
        psMask, surveyMask: (T, py, px) masks (any dtype; binary).
        fgPower: (T, py, px//2+1) covariance floor, -inf for no floor.
        peakYX: (T, 2) int calibration peak pixels (tile centres).
        meta: :func:`..ops.noise.cell_meta_batch` dict (host numpy) laying
            the noise cells out on each tile's true shape.
    Returns a dict: full tail "filtered", "SNMap", "RMSMap",
    "surveyMask" (uint8), "signalNorm"; the lean tail "RMSCells" instead of
    the S/N and RMS maps; the detection tail adds "det", "subSpline",
    "subNearest" (``detect_params`` = (threshold, maxObjects, nIter,
    useCom, cutWindow)).  Always "calibCrop" (T, nf, 33, 33), and "filt"
    with ``return_filter``.
    """

    def one_batch(d, n, t, c, w, apod, fg, peakYX):
        T, nf, ny, nx = d.shape
        fMaps = fourier.rfft2(d * apod[:, None])
        fNoise = fMaps if n is d else fourier.rfft2(n * apod[:, None])
        fSignalAbs = torch.abs(fourier.rfft2(t))
        filt = _covariance_filter(fNoise, fSignalAbs, w, fg, nx)
        # Calibration: a 33 x 33 window of the filtered known-amplitude
        # template around the tile centre, evaluated straight from the
        # half-grid spectra (fourier.windowed_irfft2); the host reads the
        # sub-pixel peak from it and cross-checks the integer read below.
        peakYX = peakYX.to(torch.int64)
        y0c = torch.clamp(peakYX[:, 0] - 16, 0, ny - 33)
        x0c = torch.clamp(peakYX[:, 1] - 16, 0, nx - 33)
        crop = fourier.windowed_irfft2(fourier.rfft2(c) * filt, y0c, x0c,
                                       ny, nx, 33)
        # clamped as jax.lax.dynamic_slice clamps its start
        py = torch.clamp(peakYX[:, 0] - y0c, 0, 32)
        px = torch.clamp(peakYX[:, 1] - x0c, 0, 32)
        peak = crop.sum(dim=1)[torch.arange(T, device=d.device), py, px]
        filtered = torch.sum(fourier.irfft2(fMaps * filt, (ny, nx)), dim=1)
        return filtered, 1.0 / peak, filt, crop

    def tail(filtered, norms, filterOut, apodM, psMask, surveyMask, meta):
        filtered = filtered * psMask
        maskData = _edge_check(filtered, psMask, trimPix) * surveyMask \
            * psMask
        maskSN = maskData * (apodM == 1)
        out = dict({"surveyMask": maskSN.to(torch.uint8),
                    "signalNorm": norms}, **filterOut)

        if detect_params is not None:
            # segmentation, statistics and the sub-pixel S/N + signal
            # reads on the device; only O(K) values go to the host
            threshold, maxObjects, nIter, useCom, cutWindow = detect_params
            cells = noise_ops.grid_rms_map_batch(filtered, gridSize,
                                                 return_cells=True,
                                                 meta=meta)
            RMSMap = torch.stack([
                noise_ops._assemble_rms_meta(cells[i], meta["c0y"][i],
                                             meta["c1y"][i], meta["c0x"][i],
                                             meta["c1x"][i])
                for i in range(cells.shape[0])])
            SNMap = _sn(filtered, RMSMap) * maskSN
            det = detect_ops.detect_objects_batch(SNMap, threshold,
                                                  max_objects=maxObjects,
                                                  n_iter=nIter)
            outMap = _undo_pixel_window_masked(filtered * maskData,
                                               maskData)
            ys = det["comY"] if useCom else det["peakY"].to(SNMap.dtype)
            xs = det["comX"] if useCom else det["peakX"].to(SNMap.dtype)
            subSpline, subNearest = subpixel_read_batch(SNMap, outMap, ys,
                                                        xs, window=cutWindow)
            out.update({"filtered": outMap, "SNMap": SNMap,
                        "RMSCells": cells, "det": det,
                        "subSpline": subSpline, "subNearest": subNearest})
            return out

        if lean_outputs:
            # the per-cell RMS grid instead of the RMS and S/N maps; the
            # host expands it and rebuilds SN = filtered * maskSN / RMS
            out["RMSCells"] = noise_ops.grid_rms_map_batch(
                filtered, gridSize, return_cells=True, meta=meta)
            out["filtered"] = filtered * maskData
            return out

        RMSMap = noise_ops.grid_rms_map_batch(filtered, gridSize, meta=meta)
        SNMap = _sn(filtered, RMSMap)
        outMap = filtered * maskData
        if undo_pixel_window:
            outMap = _undo_pixel_window_masked(outMap, maskData)
        out.update({"filtered": outMap, "SNMap": SNMap * maskSN,
                    "RMSMap": RMSMap * maskSN})
        return out

    def step(data, noise, template, calib, w, apodM, psMask, surveyMask,
             fgPower, peakYX, meta):
        _check_one_device(data, noise, template, calib, w, apodM, psMask,
                          surveyMask, fgPower, peakYX)
        with _COUNT_LOCK:
            make_matched_filter_step.calls["build"] += 1
        dt = data.dtype
        filtered, norms, filt, crops = one_batch(
            data, noise, template, calib, w, apodM, fgPower, peakYX)
        filterOut = {"calibCrop": crops}
        if return_filter:
            filterOut["filt"] = filt
        return tail(filtered, norms, filterOut, apodM, psMask.to(dt),
                    surveyMask.to(dt), meta)

    def step_given(data, filt, apodM, psMask, surveyMask, meta):
        _check_one_device(data, filt, apodM, psMask, surveyMask)
        with _COUNT_LOCK:
            make_matched_filter_step.calls["given"] += 1
        dt = data.dtype
        ny, nx = data.shape[-2:]
        fMaps = fourier.rfft2(data * apodM[:, None])
        filtered = torch.sum(fourier.irfft2(fMaps * filt, (ny, nx)), dim=1)
        norms = torch.ones(filtered.shape[0], dtype=dt, device=data.device)
        return tail(filtered, norms, {}, apodM, psMask.to(dt),
                    surveyMask.to(dt), meta)

    return step_given if given_filter else step


make_matched_filter_step.calls = {"build": 0, "given": 0}
_COUNT_LOCK = threading.Lock()    # shards on several cards run in threads


def make_realspace_step(gridSize, trimPix, undo_pixel_window=False):
    """The production batched real-space matched filter (the JAX package's
    ``make_sharded_realspace_step``): the host engine's apply stage of
    :class:`..filters.RealSpaceMatchedFilter` for a tile batch.  The
    truncated kernels are built per tile on the host (a Fourier matched
    filter on a sub-region, with the signal-norm calibration in
    ``signalNorm``); the step does the full-tile work: the kernel
    convolution (the bands summed inside it), the grid RMS (the
    ``rms_cells`` kernel), S/N, edge trim and masking.  Each call adds one
    to ``make_realspace_step.calls``.

    Args of the returned function (leading tile axis T):
        data: (T, nf, ny, nx) background-subtracted maps at the tiles'
            true shape (no padding: the convolution reflects at the
            genuine tile edge).
        kern: (T, nf, ky, kx) odd kernels, zero-padded to the chunk's
            largest kernel (exact: zero taps add nothing).
        signalNorm: (T,) calibrations from the host kernel build.
        apodM: (T, ny, nx) apodisation (only its == 1 core is used, as a
            border cut).
        psMask, surveyMask: (T, ny, nx) masks (any dtype; binary).
        meta: :func:`..ops.noise.cell_meta_batch` dict of the true shape.
    Returns a dict of "filtered" (signal units; the apodisation border
    kept, as the host engine keeps it), "SNMap", "RMSMap" and "surveyMask"
    (uint8).
    """

    def step(data, kern, signalNorm, apodM, psMask, surveyMask, meta):
        _check_one_device(data, kern, signalNorm, apodM, psMask, surveyMask)
        with _COUNT_LOCK:
            make_realspace_step.calls += 1
        dt = data.dtype
        psMask = psMask.to(dt)
        filtered = imageops.convolve2d_reflect_sum_batch(data, kern)
        filtered = filtered * signalNorm[:, None, None].to(dt)
        filtered = filtered * psMask
        RMSMap = noise_ops.grid_rms_map_batch(filtered, gridSize, meta=meta)
        SNMap = _sn(filtered, RMSMap)
        maskData = _edge_check(filtered, psMask, trimPix) \
            * surveyMask.to(dt) * psMask
        maskSN = maskData * (apodM == 1)
        outMap = filtered * maskData
        if undo_pixel_window:
            outMap = _undo_pixel_window_masked(outMap, maskData)
        return {"filtered": outMap, "SNMap": SNMap * maskSN,
                "RMSMap": RMSMap * maskSN,
                "surveyMask": maskSN.to(torch.uint8)}

    return step


make_realspace_step.calls = 0


# -- the sharded steps ---------------------------------------------------------

def _check_shards(mesh, shards):
    """The shards of a batch lie on the mesh's devices, no more of them
    than it has positions."""
    if len(shards) > mesh.size or not shards:
        raise ValueError("%d shards on a mesh of %d positions"
                         % (len(shards), mesh.size))
    for t, dev in zip(shards, mesh.devices):
        if t.device != dev:
            raise ValueError("a shard on %s at a mesh position of %s: "
                             "place the batch with tile_sharding(mesh)"
                             % (t.device, dev))


class StepTimer:
    """A shard step's time on its device: CUDA events around its launches
    on the device's current stream (read once the device has synced), or
    the call's wall time on the CPU, whose steps run synchronously."""

    def __init__(self, device):
        self._events = None
        self._wall = time.perf_counter()
        if device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()

    def stop(self):
        if self._events is not None:
            self._events[1].record()
        else:
            self._wall = time.perf_counter() - self._wall

    def seconds(self):
        if self._events is None:
            return self._wall
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1]) / 1e3


def _run_shards(fn, shardArgs):
    """``fn(*args)`` for each shard's argument tuple, results in mesh
    order, each with its :class:`StepTimer` under "stepTimer".  Shards on one device run in order from one thread (under
    ``torch.cuda.device`` of theirs), so each is launched before any waits;
    with several devices each device's shards run from a thread of their
    own, and a failure on any device raises here."""

    def runDevice(items):
        dev = items[0][1][0].device
        done = []
        with torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext():
            for k, args in items:
                timer = StepTimer(dev)
                out = fn(*args)
                timer.stop()
                done.append((k, dict(out, stepTimer=timer)))
        return done

    byDevice = {}
    for k, args in enumerate(shardArgs):
        byDevice.setdefault(args[0].device, []).append((k, args))
    groups = list(byDevice.values())
    if len(groups) == 1:
        done = runDevice(groups[0])
    else:
        with ThreadPoolExecutor(max_workers=len(groups)) as pool:
            futures = [pool.submit(runDevice, g) for g in groups]
            done = [r for f in futures for r in f.result()]
    return [out for _, out in sorted(done, key=lambda kv: kv[0])]


def _by_shard(outs):
    """A list of per-shard output dicts -> one dict of per-shard lists
    (nested dicts, as detection's ``det``, likewise)."""
    merged = {}
    for k, v in outs[0].items():
        merged[k] = _by_shard([o[k] for o in outs]) if isinstance(v, dict) \
            else [o[k] for o in outs]
    return merged


def _shard_meta(meta, shards):
    """Cut a whole-batch :func:`..ops.noise.cell_meta_batch` dict into the
    shards' consecutive tile ranges."""
    out, start = [], 0
    for t in shards:
        stop = start + t.shape[0]
        out.append({k: v[start:stop] for k, v in meta.items()})
        start = stop
    return out


def _on_shards(mesh, t, shards):
    """A shared tensor on each shard's device (one copy a device)."""
    copies = replicated(mesh).put(t)
    return [copies[s.device] for s in shards]


def make_sharded_tile_step(mesh, gridSize, trimPix, topK=256, threshold=4.0,
                           with_survey_stats=True):
    """The benchmark step over a mesh (the JAX package's
    ``make_sharded_tile_step``): a function of (data, noise, template, w,
    apodM, psMask, surveyMask) where data, noise, template and the masks
    are shards (:func:`.mesh.tile_sharding`) and w, apodM are shared
    tensors.  Each output is a list of per-shard tensors, but for
    "surveyCandidateCount" and "surveyRMSHist", the collectives' results
    on the first shard's device."""
    step = make_tile_step(gridSize, trimPix, topK=topK, threshold=threshold,
                          with_survey_stats=False)

    def sharded(data, noise, template, w, apodM, psMask, surveyMask):
        _check_shards(mesh, data)
        outs = _run_shards(step, list(zip(
            data, noise, template, _on_shards(mesh, w, data),
            _on_shards(mesh, apodM, data), psMask, surveyMask)))
        out = _by_shard(outs)
        if with_survey_stats:
            out["surveyCandidateCount"], out["surveyRMSHist"] = \
                _survey_stats(out["RMSMap"], out["peakVals"], threshold,
                              True)
        return out

    return sharded


def run_tile_batch(dataBatch, noiseBatch, templateBatch, w, apodM, psMask,
                   surveyMask, gridSize, trimPix, mesh=None, topK=256,
                   threshold=4.0):
    """Host API: place a tile batch (host arrays or tensors) on the mesh
    (default: every card) and run the sharded benchmark step."""
    mesh = mesh or get_mesh()
    step = make_sharded_tile_step(mesh, gridSize, trimPix, topK=topK,
                                  threshold=threshold)
    sh = tile_sharding(mesh)
    return step(sh.put(dataBatch), sh.put(noiseBatch), sh.put(templateBatch),
                torch.as_tensor(w), torch.as_tensor(apodM), sh.put(psMask),
                sh.put(surveyMask))


def make_sharded_matched_filter_step(mesh, gridSize, trimPix,
                                     undo_pixel_window=False,
                                     lean_outputs=False, detect_params=None,
                                     return_filter=False,
                                     given_filter=False):
    """:func:`make_matched_filter_step` over a mesh (the JAX package's
    ``make_sharded_matched_filter_step``): the same arguments, with every
    tile-axis tensor given as shards (:func:`.mesh.tile_sharding`), ``w``
    a shared tensor and ``meta`` the whole batch's host dict; returns the
    same keys, each a list of per-shard tensors (``det`` a dict of such
    lists)."""
    step = make_matched_filter_step(
        gridSize, trimPix, undo_pixel_window=undo_pixel_window,
        lean_outputs=lean_outputs, detect_params=detect_params,
        return_filter=return_filter, given_filter=given_filter)

    def sharded(data, noise, template, calib, w, apodM, psMask, surveyMask,
                fgPower, peakYX, meta):
        # the same list for data and noise keeps the dataMap method's
        # shared transform (the one-device step tests identity)
        _check_shards(mesh, data)
        return _by_shard(_run_shards(step, list(zip(
            data, noise, template, calib, _on_shards(mesh, w, data), apodM,
            psMask, surveyMask, fgPower, peakYX, _shard_meta(meta, data)))))

    def sharded_given(data, filt, apodM, psMask, surveyMask, meta):
        _check_shards(mesh, data)
        return _by_shard(_run_shards(step, list(zip(
            data, filt, apodM, psMask, surveyMask,
            _shard_meta(meta, data)))))

    return sharded_given if given_filter else sharded


def make_sharded_realspace_step(mesh, gridSize, trimPix,
                                undo_pixel_window=False):
    """:func:`make_realspace_step` over a mesh (the JAX package's
    ``make_sharded_realspace_step``): every tensor argument given as
    shards, ``meta`` the whole batch's host dict; returns the same keys,
    each a list of per-shard tensors."""
    step = make_realspace_step(gridSize, trimPix,
                               undo_pixel_window=undo_pixel_window)

    def sharded(data, kern, signalNorm, apodM, psMask, surveyMask, meta):
        _check_shards(mesh, data)
        return _by_shard(_run_shards(step, list(zip(
            data, kern, signalNorm, apodM, psMask, surveyMask,
            _shard_meta(meta, data)))))

    return sharded
