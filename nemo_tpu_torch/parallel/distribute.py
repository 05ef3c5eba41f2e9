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
shape.  The JAX package shards the batch over a device
mesh with ``shard_map``; here the tile axis is a plain leading axis, and
the survey ``psum``/``pmax`` reductions of the benchmark step are plain
reductions over it.

The step functions take tensors that all live on one device (the policy's)
and raise if one does not: nothing falls back to the CPU.
"""

import torch

from ..ops import detect as detect_ops
from ..ops import fourier, imageops
from ..ops import noise as noise_ops
from ..ops import solve as solve_ops


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


def _histogram(values, edges):
    """``jnp.histogram`` counts of ``values`` over ``edges`` (right edge of
    the last bin inclusive), as bucketize + integer bincount."""
    nb = edges.shape[0] - 1
    idx = torch.bucketize(values, edges, right=True) - 1
    idx = torch.where(values == edges[-1], torch.full_like(idx, nb - 1), idx)
    inside = (idx >= 0) & (idx < nb)
    return torch.bincount(idx[inside], minlength=nb).to(values.dtype)


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
            # survey-wide reductions over the whole batch (the JAX
            # package's psum / pmax over its device mesh)
            out["surveyCandidateCount"] = torch.sum(vals > threshold)
            valid = RMSMap > 0
            edges = torch.linspace(0.0, 1.0, 33, dtype=RMSMap.dtype,
                                   device=RMSMap.device) \
                * (torch.max(RMSMap) * 1.0001 + 1e-30)
            out["surveyRMSHist"] = _histogram(RMSMap[valid], edges)
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
