"""Device-batched production filtering: many tiles, one call per chunk.

Port of ``nemo_tpu/parallel/engine.py``.  The per-tile host engine
(:mod:`..filters`) processes one tile at a time; this engine stages the
preprocessed tiles of a survey in chunks of ``deviceBatchSize`` tiles of
one padded-shape bucket, uploads each chunk's maps and masks once, split
over the device mesh (:mod:`.mesh`; default: every card, or one CPU
shard), and runs every filter of the bank against the resident copies
with one call of :func:`.distribute.make_sharded_matched_filter_step` per
(chunk, filter): on each shard's device, filter build, apply, calibration
crop, grid RMS (the ``rms_cells`` kernel), S/N, edge trim, and - with
device detection - segmentation, object statistics and sub-pixel reads,
so that only O(K) values per tile come back.  Host code then feeds each
tile's results, in tile order, to the unchanged photometry and catalog
stage, through the pipeline's streaming ``consume`` sink.

Enabled with ``useDeviceBatching: true``; filters that need host-only
features stay on the per-tile engine (:func:`eligibleForBatch`).  The
noise cells are laid out on each tile's true shape
(:func:`..ops.noise.cell_meta`), so results match the host engine to float
tolerance.

Differences from the JAX package, on purpose: a partial chunk is not
padded up to ``deviceBatchSize`` (eager torch compiles nothing, and every
output is per tile); downloads are plain ``.cpu()`` copies of the small
results, with none of the JAX package's remote-link machinery (coalesced
copy batches, bit-packed masks, pipeline and lag depths); a rerun that
applies cached filters writes no RMS map (the host engine's rule).

The photometry filter's built filters stay on their shards' devices in
:data:`.filtercache.DEVICE_CACHE` with their FITS writes deferred; the
other filters' cache FITS go through the background writer
(:mod:`.filtercache`), off the chunk's critical path.

Real-space filters (:class:`..filters.RealSpaceMatchedFilter`) take their
own route: each (tile, label) builds its kernel on the host at staging
(with the background subtraction), tiles are bucketed per label by their
true shape (no FFT padding: the convolution reflects at the genuine tile
edge), and each chunk goes through
:func:`.distribute.make_realspace_step` (band-summed convolution, grid RMS,
S/N, edge trim); detection stays on the host for them.

The ``nemo`` CLI's ``--profile`` sets :data:`PROFILE_CHUNK_DIR`: the
Fourier route's chunk of index :data:`_PROFILE_CHUNK_INDEX` (the first
warm one) then runs under a torch.profiler trace written there.
"""

import contextlib
import functools
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import filters as filters_mod
from ..models import sz
from ..ops import fourier
from ..ops import noise as noise_ops
from ..ops import paint as paint_ops
from ..utils import timing
from ..utils.timing import profile_trace
from . import filtercache
from .distribute import (make_sharded_matched_filter_step,
                         make_sharded_realspace_step, subpixel_read_batch)
from .mesh import get_mesh, tile_sharding

_BATCHABLE_CLASSES = ("BeamMatchedFilter", "ArnaudModelMatchedFilter",
                      "BattagliaModelMatchedFilter")
_REALSPACE_CLASSES = ("BeamRealSpaceMatchedFilter",
                      "ArnaudModelRealSpaceMatchedFilter",
                      "BattagliaModelRealSpaceMatchedFilter")
# Config keys of the JAX package's remote-link pipelining: accepted and
# ignored (a local card needs no upload/download overlap machinery).
_LINK_KEYS = ("chunkPipelineDepth", "detectLagDepth")


def _rmsGridBatchable(noiseParams):
    """The apply-side RMS grid must be device-expressible."""
    if noiseParams.get("RMSEstimator", "default") != "default":
        return False
    grid = noiseParams.get("noiseGridArcmin")
    return grid is not None and grid != "smart" \
        and noiseParams.get("numNoiseBins", 1) <= 1


def eligibleForBatch(f, parDict):
    """A filter spec can go through the batched device path when it is a
    Fourier matched filter with the dataMap, model or max(dataMap,CMB)
    noise method and none of the host-only extras (plots, weight-binned
    noise cells, noise-model catalogs, background subtraction), or a
    real-space matched filter with a device-expressible RMS grid (its
    kernel builds on the host whatever its noise method; background
    subtraction runs at staging)."""
    params = f["params"]
    noiseParams = params.get("noiseParams", {})
    if f["class"] in _REALSPACE_CLASSES:
        return _rmsGridBatchable(noiseParams) \
            and params.get("outputUnits") in ("yc", "uK")
    if f["class"] not in _BATCHABLE_CLASSES:
        return False
    if params.get("savePlots"):
        return False
    if noiseParams.get("method") not in ("dataMap", "model",
                                         "max(dataMap,CMB)"):
        return False
    if not _rmsGridBatchable(noiseParams):
        return False
    if params.get("noiseModelCatalog") \
            or noiseParams.get("noiseModelCatalog"):
        return False
    if params.get("bckSub"):
        return False
    if params.get("outputUnits") not in ("yc", "uK"):
        return False
    return True


def _preprocessTileOnce(config, tileName, diagnosticsDir=None):
    """Preprocess each frequency's maps for one tile once, returning
    MapDict copies carrying the preprocessed state (filter objects built
    on them skip preprocessing: it is filter-independent)."""
    out = []
    for mapDict in config.unfilteredMapsDictList:
        newDict = mapDict.copy() if hasattr(mapDict, "copy") \
            else dict(mapDict)
        if hasattr(newDict, "preprocess"):
            with timing.span("stage.preprocess",
                             band=newDict.get("obsFreqGHz")):
                newDict.preprocess(tileName=tileName,
                                   diagnosticsDir=diagnosticsDir
                                   or config.diagnosticsDir)
        out.append(newDict)
    return out


@functools.lru_cache(maxsize=64)
def _apod_np(shape, width):
    """Host cosine apodisation window, cached so same-shape tiles share
    one ndarray (uploads are deduplicated by identity)."""
    ny, nx = shape[-2], shape[-1]
    wy = fourier._apod_profile(ny, int(width))
    wx = fourier._apod_profile(nx, int(width))
    return wy[:, None] * wx[None, :]


def _stage_tile_common(filterObj):
    """Label-independent big arrays for one tile from a filter object
    (used for filters that subset the maps with ``mapToUse``).  Ragged
    coverage folds the coverage-edge taper into the apodisation and the
    coverage-edge trim into the survey mask."""
    dataStack = np.stack([np.asarray(m["data"], dtype=np.float64)
                          for m in filterObj.unfilteredMapsDictList])
    apodM = _apod_np(filterObj.shape, filterObj.apodPix)
    surveyMask = np.asarray(
        filterObj.unfilteredMapsDictList[0]["surveyMask"], dtype=np.float64)
    psMask = np.asarray(
        filterObj.unfilteredMapsDictList[0]["pointSourceMask"],
        dtype=np.float64)
    validHost = (dataStack != 0).all(axis=0)
    if not validHost.all():
        taper, keep = filters_mod.raggedEdgeArrays(
            validHost, filterObj.apodPix, filterObj._trimSizePix(),
            gridPix=filterObj._noiseGridPix())
        apodM = apodM * taper
        surveyMask = surveyMask * keep
    return {"data": dataStack, "apodM": apodM, "surveyMask": surveyMask,
            "psMask": psMask, "shape": filterObj.shape,
            "padShape": filterObj.padShape}


def _stage_tile_common_from_maps(mapsList):
    """Label-independent big arrays for one tile, straight from the
    preprocessed map dicts (apodisation width MapFilter.apodPix = 20).
    Ragged-coverage tiles get the coverage-edge taper folded into their
    apodisation and carry the coverage distance transform (``coverEdt``)
    so :func:`_prepare_tile` can fold the coverage-edge trim into the
    survey mask.  It also holds the tile's state every filter of the bank
    shares (``MapFilter``'s ``tileState``): the combined ``flagMask``,
    made read only, and the ``beamSolidAngles``."""
    dataStack = np.stack([np.asarray(m["data"], dtype=np.float64)
                          for m in mapsList])
    shape = dataStack.shape[-2:]
    padShape = (fourier.good_fft_size(shape[0]),
                fourier.good_fft_size(shape[1]))
    apodM = _apod_np(shape, 20)
    surveyMask = np.asarray(mapsList[0]["surveyMask"], dtype=np.float64)
    psMask = np.asarray(mapsList[0]["pointSourceMask"], dtype=np.float64)
    coverEdt = None
    validHost = (dataStack != 0).all(axis=0)
    if not validHost.all():
        from scipy.ndimage import distance_transform_edt
        coverEdt = distance_transform_edt(validHost).astype(np.float32)
        apodM = apodM * (0.5 - 0.5 * np.cos(
            np.pi * np.minimum(coverEdt / 20.0, 1.0)))
    flagMask = filters_mod.combinedFlagMask(mapsList, shape)
    flagMask.setflags(write=False)
    return {"data": dataStack, "apodM": apodM, "surveyMask": surveyMask,
            "psMask": psMask, "shape": shape, "padShape": padShape,
            "coverEdt": coverEdt, "flagMask": flagMask,
            "beamSolidAngles": filters_mod.beamSolidAngles(mapsList)}


def _templateTable(f, beamFileName, amplitude, cache):
    """Radial (r, vAbs, scale) painting table for one (filter model, beam,
    amplitude): geometry-independent, cached without eviction."""
    params = f["params"]
    key = ("table", f["class"], params.get("M500MSun"), params.get("z"),
           repr(params.get("GNFWParams", "default")), beamFileName,
           None if amplitude is None else float(amplitude))
    if cache is not None and key in cache:
        return cache[key]
    from ..models import profiles
    if f["class"].startswith("Beam"):
        tab = profiles.beamTemplateTable(beamFileName, amplitude)
    else:
        mk = profiles.makeBattagliaModelProfile \
            if f["class"].startswith("Battaglia") \
            else profiles.makeArnaudModelProfile
        d = mk(params["z"], params["M500MSun"],
               GNFWParams=params.get("GNFWParams", "default"))
        tab = profiles.signalTemplateTable(d["rDeg"], d["prof"],
                                           beam=beamFileName,
                                           amplitude=amplitude)
    if cache is not None:
        cache[key] = tab
    return tab


def _trimBankCache(cache, keep=3):
    """Evict painted bank stacks beyond ``keep`` geometries (oldest first;
    survey tiles alternate between a few shape variants per band)."""
    bankKeys = [k for k in cache
                if isinstance(k, tuple) and k and k[0] == "bank"]
    while len(bankKeys) > keep:
        cache.pop(bankKeys.pop(0))


_BANK_CHUNK = 16    # planes painted per call (bounds the painter's memory)


def _bankTemplateStacks(cache, filterObj, bank, label):
    """Device (templates, calibStack) for every Fourier-MF filter of the
    bank at this tile's geometry, painted together from cached radial
    tables: on the padded-shape canvas with the true-shape centre, then
    cropped (each pixel is interp(r(y - cy, x - cx)), so the crop equals a
    paint at the true shape)."""
    P = filterObj.policy
    mapsList = filterObj.unfilteredMapsDictList
    geomKey = (tuple(filterObj.shape),
               tuple(np.round(filterObj.pixScalesRad, 12)),
               tuple(m["beamFileName"] for m in mapsList),
               tuple((m.get("units"), m.get("obsFreqGHz"))
                     for m in mapsList))
    bankKey = ("bank", geomKey, tuple(f["label"] for f in bank))
    if bankKey in cache:
        timing.count("stage.template_cache_hits")
        ent = cache.pop(bankKey)
        cache[bankKey] = ent            # LRU touch
        return ent[label]
    timing.count("stage.template_cache_misses")
    y0 = 2e-4
    tables, scales = [], []
    for f in bank:
        for m in mapsList:
            r, v, s = _templateTable(f, m["beamFileName"], None, cache)
            tables.append((r, v))
            scales.append(s)
        if f["params"]["outputUnits"] == "yc":
            for m in mapsList:
                amplitude = y0 if m.get("units") == "yc" \
                    else sz.convertToDeltaT(y0, m["obsFreqGHz"])
                r, v, s = _templateTable(f, m["beamFileName"], amplitude,
                                         cache)
                tables.append((r, v))
                scales.append(s)
    ny, nx = filterObj.shape
    canvas = (int(filterObj.padShape[0]), int(filterObj.padShape[1]))
    planes = torch.cat([
        paint_ops.paint_templates_centered_batch(
            canvas, filterObj.pixScalesRad, tables[c0:c0 + _BANK_CHUNK],
            center=(ny / 2.0, nx / 2.0), device=P.device,
            dtype=P.dtype)[:, :ny, :nx]
        for c0 in range(0, len(tables), _BANK_CHUNK)])
    planes = planes * P.tensor(np.asarray(scales, dtype=np.float64))[
        :, None, None]
    nf = len(mapsList)
    ent, i = {}, 0
    calibPlanes, calibLabels = [], []
    for f in bank:
        tmpl = planes[i:i + nf]
        i += nf
        if f["params"]["outputUnits"] == "yc":
            calibLabels.append(f["label"])
            calibPlanes.append(planes[i:i + nf])
            i += nf
            ent[f["label"]] = [tmpl, None]
        else:
            # non-yc output calibrates against the unnormalised template
            ent[f["label"]] = [tmpl, tmpl]
    if calibPlanes:
        calibAll = fourier.apply_pixel_window(torch.stack(calibPlanes),
                                              pow=1.0)
        for j, lab in enumerate(calibLabels):
            ent[lab][1] = calibAll[j]
    ent = {k: tuple(v) for k, v in ent.items()}
    cache[bankKey] = ent
    _trimBankCache(cache)
    return ent[label]


_TEMPLATE_CACHE_MAX = 96    # tile-shape template stacks kept on the device


def _trimCache(cache):
    """Evict the oldest template-cache entries (survey tiles march through
    declination bands in order, so old bands never recur)."""
    while len(cache) > _TEMPLATE_CACHE_MAX:
        cache.pop(next(iter(cache)))


def _bankPaintOn(config):
    """``bankPaintBatch``: true/false, or "auto" = on when the policy
    device is a GPU (the JAX package: on the TPU)."""
    mode = config.parDict.get("bankPaintBatch", "auto")
    return (mode is True) or (mode == "auto"
                              and config.policy.device.type == "cuda")


def _cachedFilter(filterObj):
    """(filt, SIGNORM) of the tile's saved filter, or (None, None) when
    there is none of this filter's half-grid shape: the device-resident
    cache's tensor first (on the device of the shard that built it), else
    the cache FITS (once any pending write of it has landed)."""
    if filterObj.filterFileName is None:
        return None, None
    nf = len(filterObj.unfilteredMapsDictList)
    halfShape = (nf, filterObj.padShape[0], filterObj.padShape[1] // 2 + 1)
    ent = filtercache.DEVICE_CACHE.get(filterObj.filterFileName)
    if ent is not None and tuple(ent["filt"].shape) == halfShape:
        return ent["filt"], ent["signalNorm"]
    filtercache.ensure_written(filterObj.filterFileName)
    if not os.path.exists(filterObj.filterFileName):
        return None, None
    from ..utils import fits as nfits
    fdata, fheader = nfits.read_image(filterObj.filterFileName)
    fdata = np.asarray(fdata, dtype=np.float64)
    if tuple(fdata.shape) != halfShape:
        return None, None
    return fdata, float(fheader["SIGNORM"])


def _prepare_tile(config, f, tileName, templateCache=None, mapsList=None,
                  diagnosticsDir=None, common=None, bank=None,
                  useCachedFilter=False):
    """Host-side staging for one (tile, filter): the filter object, its
    signal and calibration templates (on the policy's device) and the
    masks.  Returns (filterObj, stacks dict) at tile shape.

    ``templateCache`` shares templates between tiles of identical
    geometry; ``common`` is a :func:`_stage_tile_common_from_maps` dict
    shared by the bank's filters, whose filter objects take its tile
    state.  With ``useCachedFilter`` the tile's saved filter and its
    SIGNORM are staged too (``cachedFilt``, ``cachedNorm``; None where no
    cache of the right shape exists)."""
    filterClass = filters_mod.getFilterClass(f["class"])
    with timing.span("stage.filter_object"):
        filterObj = filterClass(f["label"],
                                mapsList or config.unfilteredMapsDictList,
                                f["params"], tileName=tileName,
                                diagnosticsDir=diagnosticsDir
                                or config.diagnosticsDir,
                                selFnDir=config.selFnDir,
                                policy=config.policy, tileState=common)
    timing.count("stage.filter_objects")
    params = filterObj.params
    if common is None or params.get("mapToUse"):
        common = _stage_tile_common(filterObj)

    # the template depends on the filter class and its model parameters
    # as well as the geometry: a key without them would alias scales
    modelKey = (type(filterObj).__name__,
                params.get("M500MSun"), params.get("z"),
                repr(params.get("GNFWParams", "default")))

    def _template(beamFileName, amplitude=None):
        return filterObj.makeSignalTemplateMap(
            beamFileName, amplitude=amplitude, returnDevice=True)

    dataStack = common["data"]
    method = params["noiseParams"]["method"]
    # the data is the noise stack but for 'model', whose realisations are
    # drawn once per (tile, filter) and uploaded per filter
    noiseStack = filterObj._noiseStack(dataStack) if method == "model" \
        else dataStack
    # max(dataMap,CMB): the lensed CMB power floors the covariance
    fgPower = None
    if method == "max(dataMap,CMB)":
        with timing.span("stage.fg_power"):
            fgPower = filterObj._foregroundsPower()

    # stacked templates are cached so same-geometry tiles share one
    # tensor (the chunk upload deduplicates by identity)
    beamFiles = tuple(m["beamFileName"]
                      for m in filterObj.unfilteredMapsDictList)
    geomKey = (filterObj.shape,
               tuple(np.round(filterObj.pixScalesRad, 12)), beamFiles,
               modelKey)

    def _cachedStack(key, build):
        if templateCache is None:
            return build()
        if key not in templateCache:
            timing.count("stage.template_cache_misses")
            templateCache[key] = build()
            _trimCache(templateCache)
        else:
            timing.count("stage.template_cache_hits")
        return templateCache[key]

    y0 = 2e-4
    useBank = bank is not None and templateCache is not None \
        and not params.get("mapToUse") and _bankPaintOn(config)

    with timing.span("stage.templates"):
        if useBank:
            templates, calibStack = _bankTemplateStacks(
                templateCache, filterObj, bank, f["label"])
        else:
            templates = _cachedStack(
                ("stack",) + geomKey,
                lambda: torch.stack([
                    _template(m["beamFileName"])
                    for m in filterObj.unfilteredMapsDictList]))
            if params["outputUnits"] == "yc":
                def _buildCalib():
                    calib = []
                    for m in filterObj.unfilteredMapsDictList:
                        amplitude = y0 if m.get("units") == "yc" \
                            else sz.convertToDeltaT(y0, m["obsFreqGHz"])
                        calib.append(fourier.apply_pixel_window(
                            _template(m["beamFileName"],
                                      amplitude=amplitude), pow=1.0))
                    return torch.stack(calib)

                unitsKey = tuple((m.get("units"), m.get("obsFreqGHz"))
                                 for m in filterObj.unfilteredMapsDictList)
                calibStack = _cachedStack(("calib", unitsKey) + geomKey,
                                          _buildCalib)
            else:
                calibStack = templates
    unitsScale = y0 if params["outputUnits"] == "yc" else 1.0
    w = filters_mod._freq_weights(filterObj.unfilteredMapsDictList, params)
    cachedFilt, cachedNorm = None, None
    if useCachedFilter:
        with timing.span("stage.cached_filter"):
            cachedFilt, cachedNorm = _cachedFilter(filterObj)

    gridSize = int(round(
        (params["noiseParams"]["noiseGridArcmin"] / 60.0)
        / filterObj.wcs.getPixelSizeDeg()))
    trimPix = filterObj._trimSizePix()
    if common.get("coverEdt") is not None and \
            not common.get("_keepApplied"):
        # ragged coverage: fold the coverage-edge trim into the common
        # survey mask once per tile (the first label's trim decides; a
        # bank shares one trim in practice)
        erodePix = filters_mod.coverageErodePix(filterObj.apodPix,
                                                trimPix, gridSize)
        common["surveyMask"] = common["surveyMask"] * (
            common["coverEdt"] > erodePix)
        common["_keepApplied"] = True
    return filterObj, {"common": common, "data": dataStack,
                       "noise": noiseStack, "fgPower": fgPower,
                       "cachedFilt": cachedFilt, "cachedNorm": cachedNorm,
                       "template": templates, "calib": calibStack, "w": w,
                       "apodM": common["apodM"],
                       "surveyMask": common["surveyMask"],
                       "psMask": common["psMask"], "gridSize": gridSize,
                       "trimPix": trimPix, "unitsScale": unitsScale,
                       "padShape": filterObj.padShape,
                       "shape": filterObj.shape}


def _prepare_tile_realspace(config, f, tileName, mapsList=None,
                            diagnosticsDir=None):
    """Host-side staging for one (tile, real-space filter): the kernel
    build (sub-region Fourier matched filter, truncation, signal-norm
    calibration: ``RealSpaceMatchedFilter.buildKernel``), the background
    subtraction and the masks, at the tile's true shape.  Returns
    (filterObj, stacks dict); the stacks carry the seconds of the kernel
    build (``kernelSeconds``) and of the whole staging (``stageSeconds``)
    for the chunk budget."""
    t0 = time.time()
    filterClass = filters_mod.getFilterClass(f["class"])
    filterObj = filterClass(f["label"],
                            mapsList or config.unfilteredMapsDictList,
                            f["params"], tileName=tileName,
                            diagnosticsDir=diagnosticsDir
                            or config.diagnosticsDir,
                            selFnDir=config.selFnDir, policy=config.policy)
    params = filterObj.params
    tKernel = time.time()
    with timing.span("buildKernel"):
        filterObj.buildKernel(filterObj._resolveRADecSection())
    tKernel = time.time() - tKernel

    dataStack = np.stack([np.asarray(m["data"], dtype=np.float64)
                          for m in filterObj.unfilteredMapsDictList])
    if params.get("bckSub") and filterObj.bckSubScaleArcmin > 0:
        from .. import maps as maps_mod
        dataStack = np.stack([
            maps_mod.subtractBackground(
                dataStack[i], filterObj.wcs,
                smoothScaleDeg=filterObj.bckSubScaleArcmin / 60.0,
                policy=config.policy)
            for i in range(dataStack.shape[0])])

    surveyMask = np.asarray(
        filterObj.unfilteredMapsDictList[0]["surveyMask"], dtype=np.float64)
    psMask = np.asarray(
        filterObj.unfilteredMapsDictList[0]["pointSourceMask"],
        dtype=np.float64)
    validHost = (dataStack != 0).all(axis=0)
    if not validHost.all():
        # ragged coverage: the coverage-edge trim (erosion only: the
        # compact kernel needs no taper), as the host engine does
        _, keep = filters_mod.raggedEdgeArrays(
            validHost, filterObj.apodPix, filterObj._trimSizePix(),
            gridPix=filterObj._noiseGridPix())
        surveyMask = surveyMask * keep
    return filterObj, {"data": dataStack,
                       "kern": np.asarray(filterObj.kern2d,
                                          dtype=np.float64),
                       "signalNorm": float(filterObj.signalNorm),
                       "apodM": _apod_np(filterObj.shape,
                                         filterObj.apodPix),
                       "surveyMask": surveyMask, "psMask": psMask,
                       "gridSize": filterObj._noiseGridPix(),
                       "trimPix": filterObj._trimSizePix(),
                       "shape": tuple(filterObj.shape),
                       "kernelSeconds": tKernel,
                       "stageSeconds": time.time() - t0}


def _padKernels(kern, kShape):
    """Zero-pad (nf, ky, kx) kernels symmetrically to a chunk's common odd
    kernel shape: exact for the reflect convolution (zero taps add
    nothing, and the centre tap stays centred)."""
    ky, kx = kern.shape[-2:]
    dy, dx = kShape[0] - ky, kShape[1] - kx
    assert dy % 2 == 0 and dx % 2 == 0
    return np.pad(kern, ((0, 0), (dy // 2, dy // 2), (dx // 2, dx // 2)))


def _asBinaryMask(m):
    """uint8 copy of a strictly-binary mask; others pass through."""
    m = np.asarray(m)
    if m.dtype == np.uint8:
        return m
    if np.all((m == 0) | (m == 1)):
        return m.astype(np.uint8)
    return m


def _pad2(a, padShape):
    """Zero-pad the last two axes to padShape on the host."""
    a = np.asarray(a)
    ny, nx = a.shape[-2], a.shape[-1]
    py, px = padShape
    if (py, px) == (ny, nx):
        return a
    pad = [(0, 0)] * (a.ndim - 2) + [(0, py - ny), (0, px - nx)]
    return np.pad(a, pad)


def batchFilterTiles(config, f, tileNames=None, mesh=None,
                     undoPixelWindow=True, verbose=True,
                     deviceBatchSize=None):
    """Filter every tile with one sharded device call per chunk; returns
    {tileName: filteredMapDict} with the contract of
    ``filters.filterMaps``."""
    return batchFilterTilesMulti(
        config, [f], tileNames=tileNames, mesh=mesh,
        undoPixelWindow=undoPixelWindow, verbose=verbose,
        deviceBatchSize=deviceBatchSize)[f["label"]]


def batchFilterTilesMulti(config, fList, tileNames=None, mesh=None,
                          undoPixelWindow=True, verbose=True,
                          deviceBatchSize=None, consume=None,
                          detectParams=None, diagnosticsDir=None,
                          useCachedFilters=False):
    """Batched filtering of every (tile, filter) combination.

    ``consume(label, tileName, filteredMapDict) -> bool``: optional
    streaming sink called as each result lands on the host; returning True
    transfers ownership (the engine drops its reference, so peak host
    memory is one chunk of results, not the survey's).

    Staging runs tile-outer on one worker thread (each tile is loaded and
    preprocessed once for the whole bank, a bounded look-ahead ahead of
    the device work); a chunk is flushed to the device as soon as
    ``deviceBatchSize`` tiles of one padded-shape bucket are staged
    (default 2 per mesh position; config key ``deviceBatchSize``, rounded
    down to a multiple of the mesh size, at least one tile a position).
    ``mesh`` (:func:`.mesh.get_mesh`; default every card, or one CPU shard
    on a CPU policy) splits each chunk over its positions; the photometry
    and Q-fit stages stay on the policy's device.
    A real-space label's tiles are bucketed apart, per label and true
    tile shape, and each chunk of them runs one real-space step.

    ``useCachedFilters``: a label whose every tile of a chunk has a saved
    filter applies the saved filters with the given-filter step (no
    filter build, no calibration: the norms come from the cache headers),
    as the host engine reloads them; otherwise it builds.

    Returns {filterLabel: {tileName: filteredMapDict}} of the results not
    consumed.
    """
    tileNames = list(tileNames if tileNames is not None
                     else config.tileNames)
    mesh = mesh or get_mesh(device=config.policy.device)
    if any(d.type != config.policy.device.type for d in mesh.devices):
        raise ValueError("a mesh on %s for a %s policy"
                         % (mesh.devices, config.policy.device.type))
    nDev = mesh.size
    if deviceBatchSize is None:
        deviceBatchSize = int(config.parDict.get("deviceBatchSize",
                                                 2 * nDev))
    deviceBatchSize = max(nDev, (int(deviceBatchSize) // nDev) * nDev)
    ignored = [k for k in _LINK_KEYS if k in config.parDict]
    if ignored and verbose:
        print("... %s: ignored (remote-link pipelining; a local device "
              "needs none)" % ", ".join(ignored), flush=True)

    templateCache = {}
    mfList = [f for f in fList if f["class"] not in _REALSPACE_CLASSES]
    mfBank = [f for f in mfList if not f["params"].get("mapToUse")] or None
    results = {f["label"]: {} for f in fList}
    staged = {f["label"]: {} for f in fList}
    buckets = {}        # key -> {"names": [...], "labels": set()}
    rsBuckets = {}      # (label, key) -> [names]  (real-space: per label)
    run = {"chunk": 0, "stageWait": 0.0, "waitFiled": 0.0,
           "t0": time.time()}

    def _filedWait():
        wait = run["stageWait"] - run["waitFiled"]
        run["waitFiled"] = run["stageWait"]
        run["chunk"] += 1
        return wait

    def _flush(key, bucket):
        padShape, nf, gridSize, trimPix = key
        names = bucket["names"]
        # group labels by the subset of these names they staged under
        # this key (labels can hop buckets across declination bands)
        groups = {}
        for label in sorted(bucket["labels"]):
            sub = tuple(n for n in names if n in staged[label])
            if sub:
                groups.setdefault(sub, []).append(label)
        photLabel = config.parDict.get("photFilter")
        for sub, labels in sorted(groups.items(),
                                  key=lambda kv: photLabel not in kv[1]):
            if photLabel in labels:   # phot first: its maps stay resident
                labels = [photLabel] + [lb for lb in labels
                                        if lb != photLabel]
            ctx = _stage_bucket_uploads(staged, labels, list(sub),
                                        padShape, config.policy, gridSize,
                                        mesh, run["chunk"])
            for label in labels:
                for n in sub:
                    staged[label].pop(n, None)
            _process_bucket_shared(config, ctx, gridSize, trimPix, mesh,
                                   undoPixelWindow, verbose, results,
                                   consume=consume,
                                   detectParams=detectParams,
                                   chunkIdx=run["chunk"],
                                   diagnosticsDir=diagnosticsDir,
                                   stageWait=_filedWait())

    def _flush_rs(label, key, names):
        _, _, gridSize, trimPix = key
        entries = {n: staged[label].pop(n) for n in names}
        _run_bucket_realspace(config, entries, names, gridSize, trimPix,
                              mesh, undoPixelWindow, verbose, results,
                              label,
                              consume=consume, chunkIdx=run["chunk"],
                              diagnosticsDir=diagnosticsDir,
                              stageWait=_filedWait())

    def _stageFilter(f, tileName, mapsList, common):
        with timing.span("stage.filter", tile=tileName, label=f["label"]):
            if f["class"] in _REALSPACE_CLASSES:
                return _prepare_tile_realspace(
                    config, f, tileName, mapsList=mapsList,
                    diagnosticsDir=diagnosticsDir)
            return _prepare_tile(
                config, f, tileName, templateCache=templateCache,
                mapsList=mapsList, common=common,
                diagnosticsDir=diagnosticsDir, bank=mfBank,
                useCachedFilter=useCachedFilters)

    def _stageTileWorker(tileName):
        with timing.span("stage.tile", tile=tileName):
            timing.count("stage.tiles")
            mapsList = _preprocessTileOnce(config, tileName, diagnosticsDir)
            common = None
            if mfList:
                with timing.span("stage.common"):
                    common = _stage_tile_common_from_maps(mapsList)
            return [(f,) + _stageFilter(f, tileName, mapsList, common)
                    for f in fList]

    # One staging worker with a bounded look-ahead: tiles are staged in
    # survey order (template-cache order preserved) while the main thread
    # runs the device chunks.
    lookahead = max(2, min(deviceBatchSize, 16))
    prefetched = {}
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="stage") as prefetcher:

        def _submitPrefetch(i):
            if 0 <= i < len(tileNames) and i not in prefetched:
                prefetched[i] = prefetcher.submit(_stageTileWorker,
                                                  tileNames[i])

        try:
            for i in range(min(lookahead, len(tileNames))):
                _submitPrefetch(i)
            for tileIdx, tileName in enumerate(tileNames):
                # filed into the budget of the next chunk to run
                with timing.span("loop.stage_wait", into=(run, "stageWait"),
                                 tile=tileName, chunk=run["chunk"]):
                    entries = prefetched.pop(tileIdx).result()
                    _submitPrefetch(tileIdx + lookahead)
                for f, filterObj, stacks in entries:
                    staged[f["label"]][tileName] = (filterObj, stacks)
                    if f["class"] in _REALSPACE_CLASSES:
                        # the true tile shape: no padding of the maps
                        key = (stacks["shape"], stacks["data"].shape[0],
                               stacks["gridSize"], stacks["trimPix"])
                        rsBuckets.setdefault((f["label"], key),
                                             []).append(tileName)
                        continue
                    key = (stacks["padShape"], stacks["data"].shape[0],
                           stacks["gridSize"], stacks["trimPix"])
                    bucket = buckets.setdefault(key, {"names": [],
                                                      "labels": set()})
                    bucket["labels"].add(f["label"])
                    if tileName not in bucket["names"]:
                        bucket["names"].append(tileName)
                # flush only at tile boundaries, so every filter of the
                # bank is staged for every tile of the chunk
                for (label, key), names in list(rsBuckets.items()):
                    if len(names) >= deviceBatchSize:
                        _flush_rs(label, key, names)
                        rsBuckets[(label, key)] = []
                for key, bucket in list(buckets.items()):
                    if len(bucket["names"]) >= deviceBatchSize:
                        _flush(key, bucket)
                        buckets[key] = {"names": [], "labels": set()}
        finally:
            for fut in prefetched.values():
                fut.cancel()
    for (label, key), names in rsBuckets.items():
        if names:
            _flush_rs(label, key, names)
    for key, bucket in buckets.items():
        if bucket["names"]:
            _flush(key, bucket)
    # the cache FITS queued on the background writer are on disk when the
    # run returns (the photometry filter's deferred ones: on demand)
    with timing.span("loop.writer_flush"):
        filtercache.WRITER.flush()
    if verbose:
        print("    [batch total %.1fs; staging-worker wait %.1fs]"
              % (time.time() - run["t0"], run["stageWait"]), flush=True)
    return results


def _emit_result(filterObj, tileName, dataMap, SNMap, RMSMap, tileMask,
                 undoPixelWindow, results):
    """Per-tile result assembly (the tail of the host engine's
    buildAndApply): pixel-window undo on the host at tile shape, RMS-map
    save, output-units metadata."""
    if undoPixelWindow:
        zeroMask = dataMap == 0
        ny, nx = dataMap.shape
        wy, wx = fourier._window_half_1d(ny, nx, -1.0)
        fm = np.fft.rfft2(dataMap)
        dataMap = np.fft.irfft2(fm * (wy[:, None] * wx[None, :]),
                                s=(ny, nx))
        dataMap[zeroMask] = 0
    params = filterObj.params
    if params.get("saveRMSMap") and RMSMap is not None:
        filterObj.saveRMSMap(RMSMap)
    results[tileName] = dict({
        "data": dataMap, "wcs": filterObj.wcs, "SNMap": SNMap,
        "RMSMap": RMSMap, "surveyMask": tileMask,
        "flagMask": filterObj.flagMask, "label": filterObj.label,
        "tileName": tileName}, **_unitsMeta(filterObj))


def _unitsMeta(filterObj):
    if filterObj.params["outputUnits"] == "yc":
        return {"mapUnits": "yc", "obsFreqGHz": "yc",
                "beamSolidAngle_nsr": 0.0}
    obsFreqGHz = float(list(filterObj.beamSolidAnglesDict)[0])
    return {"mapUnits": "uK", "obsFreqGHz": obsFreqGHz,
            "beamSolidAngle_nsr": filterObj.beamSolidAnglesDict[obsFreqGHz]}


def _download(t, tPhase):
    """Device -> host copy of a small result, timed as download; a batch
    given as per-shard tensors comes back as one array in tile order."""
    with timing.span("emit.download", into=(tPhase, "download")):
        if isinstance(t, list):
            a = np.concatenate([x.cpu().numpy() for x in t])
        else:
            a = t.cpu().numpy()
    tPhase["downBytes"] += a.nbytes
    timing.count("emit.download_bytes", a.nbytes)
    return a


def _step_norms(out, tPhase):
    """The step's signal norms, downloaded together with its tiles' counts
    of singular band x band systems, which add to the counter
    ``solve.singular_systems`` (no download of their own)."""
    both = _download([torch.stack([n, c.to(n.dtype)], dim=-1)
                      for n, c in zip(out["signalNorm"],
                                      out["singularSystems"])], tPhase)
    timing.count("solve.singular_systems", int(both[:, 1].sum()))
    return both[:, 0]


def _tile(parts, i):
    """Tile ``i`` of a batch given as per-shard tensors (a view on its
    shard's device)."""
    for p in parts:
        if i < p.shape[0]:
            return p[i]
        i -= p.shape[0]
    raise IndexError("tile index out of range")


def _calibNormsFromCrops(crops, stepNorms, st, names, padShape):
    """Per-tile signal normalisation (1 / sub-pixel calibration peak) and
    fRel weights from the step's per-band 33 x 33 filtered-calibration
    crops: the host engine's windowed-spline read.

    Tripwire: the crop's integer peak pixel must reproduce the step's own
    in-graph peak read (1 / stepNorms), rtol 1e-3; a corrupted crop is a
    hard error, never a silently wrong calibration.

    Returns (norms (nT,), fRelW (nT, nf))."""
    from scipy import interpolate as sinterp

    crops = np.asarray(crops, dtype=np.float64)
    stepPeaks = 1.0 / np.asarray(stepNorms, dtype=np.float64)
    py, px = padShape
    nT, nf = crops.shape[:2]
    norms = np.empty(nT)
    fRelW = np.empty((nT, nf))
    for i, tileName in enumerate(names):
        shape = st[tileName][1]["shape"]
        y0c = int(np.clip(shape[0] // 2 - 16, 0, py - 33))
        x0c = int(np.clip(shape[1] // 2 - 16, 0, px - 33))
        summed = crops[i].sum(axis=0)
        cropPeak = summed[shape[0] // 2 - y0c, shape[1] // 2 - x0c]
        if not np.isclose(cropPeak, stepPeaks[i], rtol=1e-3):
            raise RuntimeError(
                "calibration crop is inconsistent with the step's "
                "in-graph peak read for tile %s (%.6e vs %.6e): the step "
                "returned a corrupted intermediate"
                % (tileName, cropPeak, stepPeaks[i]))
        ys = np.arange(y0c, y0c + 33)
        xs = np.arange(x0c, x0c + 33)
        cy, cx = shape[0] / 2.0, shape[1] / 2.0
        spl = sinterp.RectBivariateSpline(ys, xs, summed, kx=3, ky=3)
        peak = float(spl(cy, cx)[0][0])
        norms[i] = 1.0 / peak
        for f in range(nf):
            fspl = sinterp.RectBivariateSpline(ys, xs, crops[i][f],
                                               kx=3, ky=3)
            fRelW[i, f] = float(fspl(cy, cx)[0][0]) / peak
    return norms, fRelW


def _saveFilterCaches(st, names, filt, hostNorms, fRelW,
                      deviceCache=False):
    """Save each tile's built filter in the host engine's ``saveFilter``
    format ((nf, PY, PX//2+1) float64, SIGNORM + RW* headers) from the
    step's ``return_filter`` output (per-shard tensors); fitQ and
    getFRelWeights read these, in this package or the JAX one.

    With ``deviceCache`` (the photometry filter) each tile's filter is
    held in :data:`.filtercache.DEVICE_CACHE` on its shard's device and
    its FITS write deferred (fitQ and getFRelWeights read the cache);
    otherwise, or past the cache's budget, the FITS write is queued on the
    background writer."""
    from ..utils import fits as nfits

    for i, tileName in enumerate(names):
        filterObj, stacks = st[tileName]
        header = nfits.Header()
        # host convention: signalNorm includes the output-units scale
        signalNorm = float(hostNorms[i] * stacks["unitsScale"])
        header["SIGNORM"] = signalNorm
        fRelWeights = {}
        for count, m in enumerate(filterObj.unfilteredMapsDictList,
                                  start=1):
            header["RW%d_GHZ" % count] = m["obsFreqGHz"]
            header["RW%d" % count] = float(fRelW[i, count - 1])
            fRelWeights[m["obsFreqGHz"]] = float(fRelW[i, count - 1])
        # its own buffer, so the chunk's stacked output can be freed
        filtDev = _tile(filt, i).clone()
        if deviceCache and filtercache.DEVICE_CACHE.put(
                filterObj.filterFileName, filtDev, signalNorm, fRelWeights):
            filtercache.register_deferred(filterObj.filterFileName, filtDev,
                                          header)
        else:
            filtercache.WRITER.enqueue(filterObj.filterFileName, filtDev,
                                       header)


def _emit_overflow_fallback(out, i, filterObj, tileName, shape,
                            scale, tileMask, cellsI, gridSize, saveRMS,
                            photRes, label, photLabel, tPhase):
    """Host-style result for a tile whose segment count exceeded the
    device detection budget: its signal and S/N maps (pixel window undone
    in the step) come off the device, and the pipeline's host
    ``findObjects`` - which has no object cap - takes over for it.  The
    reference filter's maps ride along for the fixed_ columns."""
    fullF = _download(_tile(out["filtered"], i)[:shape[0], :shape[1]],
                      tPhase)
    fullSN = _download(_tile(out["SNMap"], i)[:shape[0], :shape[1]], tPhase)
    nCyT = noise_ops.n_cells(shape[0], gridSize)
    nCxT = noise_ops.n_cells(shape[1], gridSize)
    rms = noise_ops.assemble_rms_host(cellsI[:nCyT, :nCxT], shape[0],
                                      shape[1], gridSize) * tileMask * scale
    res = dict({"data": fullF * scale, "SNMap": fullSN,
                "RMSMap": rms if saveRMS else None,
                "surveyMask": tileMask, "flagMask": filterObj.flagMask,
                "wcs": filterObj.wcs, "label": filterObj.label,
                "tileName": tileName}, **_unitsMeta(filterObj))
    if photRes is not None and label != photLabel:
        pSN = _download(_tile(photRes["SNMap"], i)[:shape[0], :shape[1]],
                        tPhase)
        pD = _download(_tile(photRes["filtered"], i)[:shape[0], :shape[1]],
                       tPhase) * photRes["scale"][i]
        res["photMapsDict"] = {"SNMap": pSN, "data": pD}
    elif photRes is None and photLabel is not None and label != photLabel:
        print("... WARNING: overflow tile %s#%s has no reference-filter "
              "maps in its device chunk (photFilter uses different "
              "noise-grid/trim parameters); fixed_ columns for its "
              "objects will be missing" % (label, tileName))
    if saveRMS:
        filterObj.saveRMSMap(rms)
    return res


_DET_KEYS = ("valid", "numPix", "comY", "comX", "peak", "peakY", "peakX")


def _consume_detect_results(st, names, out, gridSize, trimPix,
                            detectParams, label, photLabel, photRes,
                            seenTiles, tPhase, results, consume, hostNorms,
                            saveRMS):
    """Host side of detection mode: download the O(K) statistics, the
    sub-pixel reads and the RMS cell grid, and assemble per-tile results
    for ``photometry.catalogFromDeviceDetections``.  A tile over the
    object budget falls back to host detection (counted and printed)."""
    maxObjects = detectParams[1]
    cutWindow = detectParams[4]
    useCom = detectParams[3]
    det = out["det"]
    hasPhotSub = photRes is not None and label != photLabel
    packed, valParts = [], []
    for k in range(len(out["SNMap"])):       # each shard on its device
        dt = out["SNMap"][k].dtype
        parts = [out["subSpline"][k], out["subNearest"][k]]
        if hasPhotSub:
            ys = det["comY"][k] if useCom else det["peakY"][k].to(dt)
            xs = det["comX"][k] if useCom else det["peakX"][k].to(dt)
            parts += list(subpixel_read_batch(
                photRes["SNMap"][k], photRes["filtered"][k], ys, xs,
                window=cutWindow))
        valParts.append(torch.cat(parts, dim=-1))
        packed.append(torch.stack([det[key][k].to(torch.float32)
                                   for key in _DET_KEYS], dim=-1))
    packed = _download(packed, tPhase)
    detNp = {k: packed[..., j] for j, k in enumerate(_DET_KEYS)}
    nObjects = _download(det["nObjects"], tPhase)
    vals = _download(valParts, tPhase)
    cells = _download(out["RMSCells"], tPhase)

    for i, tileName in enumerate(names):
        filterObj, stacks = st[tileName]
        shape = stacks["shape"]
        scale = stacks["unitsScale"] * hostNorms[i]
        nObj = int(nObjects[i])
        overflow = nObj > maxObjects
        tileMask = None
        if overflow or tileName not in seenTiles or saveRMS:
            # one output mask per tile (the first label's); without edge
            # trim it is surveyMask * psMask * (apodM == 1) of arrays the
            # host staged, so it is rebuilt instead of downloaded
            if trimPix == 0:
                common = stacks["common"]
                tileMask = (np.asarray(common["surveyMask"])
                            * np.asarray(common["psMask"])
                            * (np.asarray(common["apodM"]) == 1)
                            ).astype(float)
            else:
                tileMask = _download(
                    _tile(out["surveyMask"], i)[:shape[0], :shape[1]],
                    tPhase).astype(float)
            seenTiles.add(tileName)
        if overflow:
            tPhase["overflowTiles"] += 1
            print("... %d objects in %s#%s exceed the device detection "
                  "budget (%d): falling back to host detection for this "
                  "tile" % (nObj, label, tileName, maxObjects))
            res = _emit_overflow_fallback(
                out, i, filterObj, tileName, shape, scale, tileMask,
                cells[i], gridSize, saveRMS, photRes, label, photLabel,
                tPhase)
        else:
            tPhase["detectTiles"] += 1
            # the sub-pixel reads are linear in the map, so the units
            # scale applies after them; columns (S/N, value)
            subVals = {"spline": np.array(vals[i, :, 0:2], dtype=np.float64),
                       "nearest": np.array(vals[i, :, 2:4],
                                           dtype=np.float64)}
            subVals["spline"][:, 1] *= scale
            subVals["nearest"][:, 1] *= scale
            res = dict({
                "deviceDetections": {k: detNp[k][i] for k in _DET_KEYS},
                "subVals": subVals, "wcs": filterObj.wcs,
                "label": filterObj.label, "tileName": tileName,
                "flagMask": filterObj.flagMask, "surveyMask": tileMask,
                "signalNorm": float(hostNorms[i])}, **_unitsMeta(filterObj))
            if hasPhotSub:
                pv = {"spline": np.array(vals[i, :, 4:6], dtype=np.float64),
                      "nearest": np.array(vals[i, :, 6:8],
                                          dtype=np.float64)}
                pv["spline"][:, 1] *= photRes["scale"][i]
                pv["nearest"][:, 1] *= photRes["scale"][i]
                res["photSubVals"] = pv
            elif label == photLabel:
                # the phot filter reads fixed_ values from its own maps
                res["photSubVals"] = subVals
            if saveRMS:
                with timing.span("emit.rms_map", tile=tileName):
                    nCyT = noise_ops.n_cells(shape[0], gridSize)
                    nCxT = noise_ops.n_cells(shape[1], gridSize)
                    rms = noise_ops.assemble_rms_host(
                        cells[i][:nCyT, :nCxT], shape[0], shape[1],
                        gridSize) * tileMask * scale
                    filterObj.saveRMSMap(rms)
        _deliver(label, tileName, res, results, consume, tPhase)


def _deliver(label, tileName, res, results, consume, tPhase):
    results[label][tileName] = res
    if consume is not None:
        with timing.span("emit.catalog", into=(tPhase, "consume"),
                         tile=tileName, label=label):
            if consume(label, tileName, res):
                results[label].pop(tileName, None)


def _upload(a, dev, dtype=None):
    """``torch.as_tensor(a, dtype=dtype, device=dev)``, counting the bytes
    a host array sends to a card (``chunk.upload_bytes.pageable``, or
    ``.pinned`` from pinned memory)."""
    t = torch.as_tensor(a, dtype=dtype, device=dev)
    onHost = not isinstance(a, torch.Tensor) or a.device.type == "cpu"
    if t.device.type != "cpu" and onHost:
        pinned = isinstance(a, torch.Tensor) and a.is_pinned()
        timing.count("chunk.upload_bytes.pinned" if pinned
                     else "chunk.upload_bytes.pageable", t.nbytes)
    return t


def _stage_bucket_uploads(staged, labels, names, padShape, policy,
                          gridSize, mesh, chunkIdx):
    """Snapshot one tile chunk's staged state and upload its big
    label-independent arrays (data, apodisation, masks), each shard's
    tiles to that shard's device (:func:`.mesh.tile_sharding`), cast once
    to the policy dtype (staging stays float64).  Every uploaded input is
    a list of per-shard tensors; ``putDedup`` uploads a label's stacks
    the same way.  Timed as the ``chunk.upload`` span of chunk
    ``chunkIdx`` (``stageUpload``)."""
    P = policy
    shards = tile_sharding(mesh).slices(len(names))

    def _sharded(fn, arrs, *extra):
        return [fn(dev, arrs[sl], *[e[sl] for e in extra])
                for dev, sl in shards]

    def _put1(dev, arrs):
        return _upload(np.stack([_pad2(a, padShape) for a in arrs]), dev,
                       P.dtype)

    def _putDedup1(dev, arrs):
        """Upload only the distinct arrays of a shard's stacked input (by
        identity: same-geometry tiles share staged arrays) and gather the
        shard's stack on its device; device-resident inputs (the template
        caches, on the policy's device) are moved to the shard's device,
        padded and stacked there."""
        seen, idx = {}, []
        for a in arrs:
            idx.append(seen.setdefault(id(a), len(seen)))
        uniq = [None] * len(seen)
        for a in arrs:
            uniq[seen[id(a)]] = a
        if not any(isinstance(a, torch.Tensor) for a in uniq):
            if len(uniq) == len(arrs):
                return _put1(dev, arrs)
            uniqDev = _put1(dev, uniq)
        else:
            uniqDev = torch.stack([fourier.pad_to(
                _upload(a, dev, P.dtype), padShape) for a in uniq])
        return uniqDev[torch.as_tensor(idx, device=dev)]

    def _putMask1(dev, arrs, shapes):
        """Binary masks go up as uint8; an all-ones mask is synthesised on
        the device (ones over the true tile shape, zeros in the
        padding)."""
        arrs = [_asBinaryMask(a) for a in arrs]
        if not all(a.dtype == np.uint8 and a.min() == 1 for a in arrs):
            if all(a.dtype == np.uint8 for a in arrs):
                return _upload(np.stack([_pad2(a, padShape) for a in arrs]),
                               dev)
            return _put1(dev, arrs)
        sy = torch.as_tensor([s[0] for s in shapes], device=dev)
        sx = torch.as_tensor([s[1] for s in shapes], device=dev)
        yy = torch.arange(padShape[0], device=dev)
        xx = torch.arange(padShape[1], device=dev)
        return ((yy[None, :, None] < sy[:, None, None])
                & (xx[None, None, :] < sx[:, None, None])).to(torch.uint8)

    snapshot = {label: {n: staged[label][n] for n in names
                        if n in staged[label]} for label in labels}
    common = [snapshot[labels[0]][n][1]["common"] for n in names]
    shapes = [c["shape"] for c in common]
    ctx = {"labels": labels, "names": names, "padShape": padShape,
           "snapshot": snapshot, "nT": len(names), "shards": shards,
           "putDedup": lambda arrs: _sharded(_putDedup1, arrs)}
    with timing.span("chunk.upload", into=(ctx, "stageUpload"),
                     chunk=chunkIdx):
        ctx.update(
            dataDev=_sharded(_put1, [c["data"] for c in common]),
            apodDev=_sharded(_putDedup1, [c["apodM"] for c in common]),
            psDev=_sharded(_putMask1, [c["psMask"] for c in common],
                           shapes),
            surveyDev=_sharded(_putMask1, [c["surveyMask"] for c in common],
                               shapes),
            peakDev=_sharded(lambda dev, sh: torch.as_tensor(
                [[s[0] // 2, s[1] // 2] for s in sh], device=dev), shapes),
            # per-tile true-shape noise-cell geometry (host int tables)
            meta=noise_ops.cell_meta_batch(shapes, padShape, gridSize))
    return ctx


def _finish_label_lean(st, names, out, gridSize, label, tPhase, results,
                       consume, hostNorms, saveRMS, undoPixelWindow):
    """Host-detection emission: download the filtered maps, cell grids and
    output masks, rebuild S/N on the host at each tile's true shape."""
    filtered = _download(out["filtered"], tPhase)
    cells = _download(out["RMSCells"], tPhase)
    outMask = _download(out["surveyMask"], tPhase)
    for i, tileName in enumerate(names):
        filterObj, stacks = st[tileName]
        shape = stacks["shape"]
        scale = stacks["unitsScale"] * hostNorms[i]
        nCyT = noise_ops.n_cells(shape[0], gridSize)
        nCxT = noise_ops.n_cells(shape[1], gridSize)
        rms = noise_ops.assemble_rms_host(
            cells[i][:nCyT, :nCxT], shape[0], shape[1], gridSize)
        tileMask = outMask[i][:shape[0], :shape[1]].astype(float)
        filt = filtered[i][:shape[0], :shape[1]]
        with np.errstate(divide="ignore", invalid="ignore"):
            SNMap = np.where(rms > 0, filt / np.maximum(rms, 1e-30),
                             0.0) * tileMask
        RMSMap = rms * tileMask * scale if saveRMS else None
        _emit_result(filterObj, tileName, filt * scale, SNMap,
                     RMSMap, tileMask, undoPixelWindow, results[label])
        _deliver(label, tileName, results[label][tileName], results,
                 consume, tPhase)


def _sync(devices):
    """Wait for the work queued on each cuda device of ``devices``."""
    for device in dict.fromkeys(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


# One warm chunk's trace (the CLI's --profile): chunk 0 pays the first
# calls' costs (kernel loads, cuFFT plans), so chunk 1 is traced.  The
# counter counts Fourier-route chunks over the whole process, as in the JAX
# package: a caller that runs the engine again in one process and wants a
# trace resets it.
PROFILE_CHUNK_DIR = None
_PROFILE_CHUNK_INDEX = 1
_chunkCounter = [0]


def _process_bucket_shared(*args, **kwargs):
    """:func:`_process_bucket` in the ``chunk`` span of its ``chunkIdx``,
    traced into :data:`PROFILE_CHUNK_DIR` when it is set and this is the
    process's chunk of index :data:`_PROFILE_CHUNK_INDEX`."""
    idx = _chunkCounter[0]
    _chunkCounter[0] += 1
    traced = PROFILE_CHUNK_DIR and idx == _PROFILE_CHUNK_INDEX
    with profile_trace(PROFILE_CHUNK_DIR) if traced \
            else contextlib.nullcontext():
        with timing.span("chunk", chunk=kwargs["chunkIdx"]):
            return _process_bucket(*args, **kwargs)


def _process_bucket(config, ctx, gridSize, trimPix, mesh,
                    undoPixelWindow, verbose, results, consume=None,
                    detectParams=None, chunkIdx=0, diagnosticsDir=None,
                    stageWait=0.0):
    """Run one uploaded tile chunk through every filter of the bank, the
    photometry filter first (its maps stay resident for the other labels'
    fixed_ reads), and emit each label's results before the next runs.

    Appends the chunk's budget to ``diagnostics/chunk_budgets.jsonl``:
    seconds waiting on the staging worker (``stageWait``), uploading,
    in the steps (device work included: each step ends in a device
    sync), downloading, in the host catalog stage (``consume``) and in
    the rest of the host emission (``hostOther``: calibration reads, map
    FITS writes); (tile, label) pairs that took device detection and that
    overflowed to host detection; each shard's tile count (``shards``)
    and its steps' device seconds (``shardStep``)."""
    tChunk0 = time.time()
    t0Ns = time.perf_counter_ns()
    cpu0 = time.process_time()
    labels = ctx["labels"]
    names = ctx["names"]
    padShape = ctx["padShape"]
    snapshot = ctx["snapshot"]
    dataDev = ctx["dataDev"]
    shards = ctx["shards"]
    devs = [d.device for d in dataDev]
    P = config.policy
    if verbose:
        print("... device batch: %d tile(s) x %d filter(s) at %s"
              % (len(names), len(labels), str(padShape)), flush=True)
    tPhase = _new_budget(stageWait, ctx["stageUpload"])
    tPhase["shards"] = [sl.stop - sl.start for _, sl in shards]
    tPhase["shardStep"] = [0.0] * len(shards)
    halfShape = (padShape[0], padShape[1] // 2 + 1)

    photLabel = config.parDict.get("photFilter")
    photRes = None          # resident phot maps for the fixed_ reads
    seenTiles = set()       # output mask emitted once per tile
    for label in labels:
        st = snapshot[label]
        stacksList = [st[n][1] for n in names]
        params0 = st[names[0]][0].params
        useDetect = detectParams is not None \
            and not params0.get("saveFilteredMaps")
        # cached-filter rerun: apply the saved filters, build none
        given = all(sk.get("cachedFilt") is not None for sk in stacksList)
        wantFilter = bool(params0.get("saveFilter")) and not given
        # a rerun on cached filters writes no RMS map, as the host engine
        # (MatchedFilter.buildAndApply) does when it loads a cache
        saveRMS = params0.get("saveRMSMap") and not given
        step = make_sharded_matched_filter_step(
            mesh, gridSize, trimPix, lean_outputs=not useDetect,
            detect_params=detectParams if useDetect else None,
            return_filter=wantFilter, given_filter=given)
        with timing.span("chunk.step", into=(tPhase, "step"), label=label,
                         bands=int(dataDev[0].shape[1])):
            if given:
                # a device-cached filter moves to its shard's device
                out = step(dataDev, [torch.stack([
                    _upload(sk["cachedFilt"], dev, P.dtype)
                    for sk in stacksList[sl]]) for dev, sl in shards],
                    ctx["apodDev"], ctx["psDev"], ctx["surveyDev"],
                    ctx["meta"])
            else:
                noiseDev = dataDev if all(sk["noise"] is sk["data"]
                                          for sk in stacksList) \
                    else ctx["putDedup"]([sk["noise"] for sk in stacksList])
                # -inf, not 0: the step's max(prods, fg) must be a no-op
                # but for max(dataMap,CMB) (about half the cross-band
                # covariance is negative)
                fgDev = []
                for dev, sl in shards:
                    fg = torch.full((sl.stop - sl.start,) + halfShape,
                                    float("-inf"), dtype=P.dtype, device=dev)
                    for j, sk in enumerate(stacksList[sl]):
                        if sk["fgPower"] is not None:
                            fg[j] = _upload(sk["fgPower"], dev, P.dtype)
                    fgDev.append(fg)
                out = step(dataDev, noiseDev,
                           ctx["putDedup"]([sk["template"]
                                            for sk in stacksList]),
                           ctx["putDedup"]([sk["calib"]
                                            for sk in stacksList]),
                           P.tensor(stacksList[0]["w"]), ctx["apodDev"],
                           ctx["psDev"], ctx["surveyDev"], fgDev,
                           ctx["peakDev"], ctx["meta"])
            _sync(devs)
        for k, timer in enumerate(out.pop("stepTimer")):
            tPhase["shardStep"][k] += timer.seconds()

        # the emission's calibration reads and FITS writes are host time
        # that is neither a download nor the catalog stage: hostOther
        down0, cons0 = tPhase["download"], tPhase["consume"]
        with timing.span("chunk.emit", into=(tPhase, "hostOther"),
                         label=label):
            if given:
                # host convention: the cached SIGNORM includes the units
                # scale
                hostNorms = np.array([sk["cachedNorm"] / sk["unitsScale"]
                                      for sk in stacksList])
                tPhase["givenLabels"] += 1
            else:
                crops = _download(out["calibCrop"], tPhase)
                stepNorms = _step_norms(out, tPhase)
                with timing.span("emit.calib"):
                    hostNorms, fRelW = _calibNormsFromCrops(
                        crops, stepNorms, st, names, padShape)
            if wantFilter:
                with timing.span("emit.filter_cache"):
                    _saveFilterCaches(st, names, out["filt"], hostNorms,
                                      fRelW,
                                      deviceCache=(label == photLabel))
            if useDetect:
                tPhase["detectLabels"] += 1
                _consume_detect_results(
                    st, names, out, gridSize, trimPix, detectParams,
                    label, photLabel, photRes, seenTiles, tPhase, results,
                    consume, hostNorms, saveRMS)
                if label == photLabel:
                    photRes = {"SNMap": out["SNMap"],
                               "filtered": out["filtered"],
                               "scale": stacksList[0]["unitsScale"]
                               * hostNorms}
            else:
                _finish_label_lean(st, names, out, gridSize, label, tPhase,
                                   results, consume, hostNorms, saveRMS,
                                   undoPixelWindow)
        tPhase["hostOther"] -= (tPhase["download"] - down0) \
            + (tPhase["consume"] - cons0)
        del out
    if verbose:
        print("    [chunk: upload %.2fs, steps %.2fs, download %.2fs "
              "(%.1f MB), host catalog %.2fs, other host %.2fs, device "
              "detection %d/%d labels, %d (tile, label) overflowed]"
              % (tPhase["upload"], tPhase["step"], tPhase["download"],
                 tPhase["downBytes"] / 1e6, tPhase["consume"],
                 tPhase["hostOther"], tPhase["detectLabels"], len(labels),
                 tPhase["overflowTiles"]), flush=True)
    _record_chunk(config, diagnosticsDir, tPhase, chunkIdx, len(names),
                  len(labels), padShape, devs, tChunk0, cpu0, t0Ns)


def _new_budget(stageWait, upload):
    return {"stageWait": stageWait, "upload": upload, "step": 0.0,
            "download": 0.0, "hostOther": 0.0, "downBytes": 0,
            "consume": 0.0, "detectLabels": 0, "detectTiles": 0,
            "overflowTiles": 0, "givenLabels": 0}


def _record_chunk(config, diagnosticsDir, tPhase, chunkIdx, nTiles,
                  nLabels, padShape, devs, tChunk0, cpu0, t0Ns):
    """Append one chunk's budget to ``diagnostics/chunk_budgets.jsonl``;
    ``device`` names the shards' distinct devices, ``pass`` the
    recorder's pass number; ``t_wall`` and ``wall_s`` are on
    ``time.time()``, ``t0_ns`` and ``t1_ns`` on ``perf_counter_ns()``."""
    diagnosticsDir = diagnosticsDir or config.diagnosticsDir
    if not diagnosticsDir:
        return
    rec = dict(tPhase, chunk=chunkIdx, nTiles=nTiles, nLabels=nLabels,
               padShape=list(padShape),
               device=",".join(dict.fromkeys(str(d) for d in devs)),
               t_wall=time.time(), wall_s=time.time() - tChunk0,
               cpu_s=time.process_time() - cpu0,
               t0_ns=t0Ns, t1_ns=time.perf_counter_ns(),
               **{"pass": timing.RECORDER.passes})
    os.makedirs(diagnosticsDir, exist_ok=True)
    with open(os.path.join(diagnosticsDir, "chunk_budgets.jsonl"),
              "a") as f:
        f.write(json.dumps(rec) + "\n")


def _run_bucket_realspace(config, entries, names, gridSize, trimPix,
                          mesh, undoPixelWindow, verbose, results, label,
                          consume=None, chunkIdx=0, diagnosticsDir=None,
                          stageWait=0.0):
    """One real-space step for a chunk of one label's same-shaped tiles
    (``entries``: tileName -> (filterObj, stacks) from
    :func:`_prepare_tile_realspace`), then each tile's result emitted.

    The chunk's budget line adds ``kernelBuild`` and ``staging``: the
    seconds its tiles' kernel builds and whole stagings took on the
    staging worker."""
    tChunk0 = time.time()
    t0Ns = time.perf_counter_ns()
    cpu0 = time.process_time()
    P = config.policy
    stacks = [entries[n][1] for n in names]
    shape = stacks[0]["shape"]
    if verbose:
        print("... device batch (real-space): %d tile(s) of %s at %s"
              % (len(names), label, str(shape)), flush=True)
    kShape = (max(st["kern"].shape[-2] for st in stacks),
              max(st["kern"].shape[-1] for st in stacks))
    t0 = time.time()
    shards = tile_sharding(mesh).slices(len(names))
    inputs = [[torch.as_tensor(np.stack(arrs[sl]), dtype=P.dtype,
                               device=dev) for dev, sl in shards]
              for arrs in (
                  [st["data"] for st in stacks],
                  [_padKernels(st["kern"], kShape) for st in stacks],
                  [st["signalNorm"] for st in stacks],
                  [st["apodM"] for st in stacks],
                  [st["psMask"] for st in stacks],
                  [st["surveyMask"] for st in stacks])]
    devs = [dev for dev, _ in shards]
    _sync(devs)
    tPhase = dict(_new_budget(stageWait, time.time() - t0),
                  kernelBuild=sum(st["kernelSeconds"] for st in stacks),
                  staging=sum(st["stageSeconds"] for st in stacks),
                  shards=[sl.stop - sl.start for _, sl in shards])
    # the true shape is the batch shape: the noise cells of every tile
    # are laid out on it
    meta = noise_ops.cell_meta_batch([shape] * len(names), shape, gridSize)
    step = make_sharded_realspace_step(mesh, gridSize, trimPix,
                                       undo_pixel_window=undoPixelWindow)
    t0 = time.time()
    out = step(*inputs, meta)
    _sync(devs)
    tPhase["step"] = time.time() - t0
    tPhase["shardStep"] = [t.seconds() for t in out.pop("stepTimer")]

    tEmit = time.time()
    filtered = _download(out["filtered"], tPhase)
    SNMaps = _download(out["SNMap"], tPhase)
    RMSMaps = _download(out["RMSMap"], tPhase) \
        if entries[names[0]][0].params.get("saveRMSMap") else None
    outMask = _download(out["surveyMask"], tPhase).astype(float)
    del out, inputs
    for i, tileName in enumerate(names):
        _emit_result(entries[tileName][0], tileName, filtered[i],
                     SNMaps[i], None if RMSMaps is None else RMSMaps[i],
                     outMask[i], False, results[label])  # undo ran in-step
        _deliver(label, tileName, results[label][tileName], results,
                 consume, tPhase)
    tPhase["hostOther"] = time.time() - tEmit - tPhase["download"] \
        - tPhase["consume"]
    if verbose:
        print("    [chunk: upload %.2fs, step %.2fs, download %.2fs "
              "(%.1f MB), host catalog %.2fs, other host %.2fs; staging "
              "%.2fs, of it kernel builds %.2fs]"
              % (tPhase["upload"], tPhase["step"], tPhase["download"],
                 tPhase["downBytes"] / 1e6, tPhase["consume"],
                 tPhase["hostOther"], tPhase["staging"],
                 tPhase["kernelBuild"]), flush=True)
    _record_chunk(config, diagnosticsDir, tPhase, chunkIdx, len(names), 1,
                  shape, devs, tChunk0, cpu0, t0Ns)
