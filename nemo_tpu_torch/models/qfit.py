"""The filter mismatch function Q (Hasselfield et al. 2013).

Port of ``nemo_tpu/models/qfit.py`` (a rebuild of the reference's ``QFit``
class and ``fitQ`` routine, ``nemo/signals.py:140-347, 864-1129``):
Q(theta500[, z]) is measured per tile by pushing a grid of model clusters
through the tile's reference filter and recording the peak response ratio;
it is then interpolated when converting between y0~ and mass.  :class:`QFit`
is host code, as in the JAX package; :func:`fitQ` paints, filters and reads
the model peaks with torch ops on the config's device, and reads the
cached filters from their FITS files.
"""

import json
import os
import time

import numpy as np
import torch
from scipy import interpolate

from ..utils import fits as nfits
from ..utils.tables import Table
from . import cosmology as cosmo_mod
from . import sz


class QFit:
    """Interpolated Q(theta500 [, z]) per tile (``signals.py:140-347``)."""

    def __init__(self, QSource="fit", selFnDir=None, QFitFileName=None,
                 tileNames=None):
        self._zGrid = np.array([0.05, 0.1, 0.2, 0.3, 0.4, 0.6, 0.8, 1.0,
                                1.2, 1.6, 2.0])
        self._theta500ArcminGrid = np.logspace(np.log10(0.1), np.log10(55),
                                               10)
        self.zMin = self._zGrid.min()
        self.zMax = self._zGrid.max()
        self.zDependent = None
        self.zDepThetaMax = None
        self.selFnDir = selFnDir
        self.fitDict = {}
        self.QSource = QSource
        if QSource not in ("fit", "injection", "hybrid"):
            raise ValueError("QSource must be 'fit', 'injection' or "
                             "'hybrid'")
        if QSource in ("fit", "hybrid"):
            if QFitFileName is None and selFnDir is not None:
                QFitFileName = os.path.join(selFnDir, "QFit.fits")
            if QFitFileName is not None:
                self.loadQ(QFitFileName, tileNames=tileNames)
        elif QSource == "injection":
            theta500s, thetaQ = self._loadInjectionData()
            self.fitDict[None] = interpolate.InterpolatedUnivariateSpline(
                theta500s, thetaQ, ext=1)
            self.zDependent = False

    def _loadInjectionData(self):
        from .. import completeness
        if self.selFnDir is None:
            raise ValueError("selFnDir required for injection QSource")
        injTab = Table.read(os.path.join(self.selFnDir,
                                         "sourceInjectionData.fits"))
        inputTab = Table.read(os.path.join(
            self.selFnDir, "sourceInjectionInputCatalog.fits"))
        theta500s, binCentres, compThetaGrid, thetaQ = \
            completeness._parseSourceInjectionData(injTab, inputTab, 5.0)
        return theta500s, thetaQ

    def loadQ(self, QFitFileName, tileNames=None):
        """Load per-tile Q tables from a MEF (``signals.py:204-267``)."""
        hdus = nfits.read(QFitFileName)
        available = [h.name for h in hdus if h.is_table]
        if tileNames is None:
            tileNames = available

        if self.QSource == "hybrid":
            injThetas, injQs = self._loadInjectionData()
            refTheta = None

        QStack, thetaStack = [], []
        lastTab = None
        for tileName in tileNames:
            if tileName not in available:
                continue
            cols, header = nfits.read_table(QFitFileName, ext=tileName)
            QTab = Table(cols)
            QTab.meta["ZDEPQ"] = header.get("ZDEPQ", 0)
            self.zMin = min(self.zMin, np.min(QTab["z"])) \
                if "z" in QTab.keys() else self.zMin
            self.zMax = max(self.zMax, np.max(QTab["z"])) \
                if "z" in QTab.keys() else self.zMax
            if self.QSource == "hybrid":
                if refTheta is None:
                    refTheta = np.min(np.asarray(QTab["theta500Arcmin"])[
                        np.asarray(QTab["Q"]) > 1])
                sel = np.asarray(QTab["theta500Arcmin"]) <= refTheta
                hyb = Table({
                    "theta500Arcmin": np.concatenate(
                        [np.asarray(QTab["theta500Arcmin"])[sel],
                         injThetas[injThetas > refTheta]]),
                    "Q": np.concatenate([np.asarray(QTab["Q"])[sel],
                                         injQs[injThetas > refTheta]])})
                hyb.meta = QTab.meta
                QTab = hyb
            QStack.append(np.asarray(QTab["Q"]))
            thetaStack.append(np.asarray(QTab["theta500Arcmin"]))
            self.fitDict[tileName] = self._makeInterpolator(QTab)
            lastTab = QTab
        if lastTab is not None:
            medQTab = Table({"Q": np.median(np.array(QStack), axis=0),
                             "theta500Arcmin":
                                 np.asarray(lastTab["theta500Arcmin"])})
            if "z" in lastTab.keys():
                medQTab["z"] = np.asarray(lastTab["z"])
            medQTab.meta = lastTab.meta
            self.fitDict[None] = self._makeInterpolator(medQTab)

    def _makeInterpolator(self, QTab):
        """1-d or 2-d spline per ZDEPQ (``signals.py:270-298``)."""
        if QTab.meta.get("ZDEPQ", 0) == 0:
            QTab.sort("theta500Arcmin")
            spline = interpolate.InterpolatedUnivariateSpline(
                QTab["theta500Arcmin"], QTab["Q"], ext=1)
            if self.zDependent:
                raise ValueError("Mixed z-dependent and z-independent Q")
            self.zDependent = False
            self.zDepThetaMax = None
        else:
            import warnings
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                spline = interpolate.LSQBivariateSpline(
                    np.asarray(QTab["z"]),
                    np.asarray(QTab["theta500Arcmin"]),
                    np.asarray(QTab["Q"]), self._zGrid,
                    self._theta500ArcminGrid)
            zs = np.unique(np.asarray(QTab["z"]))
            thetaMaxs = [np.max(np.asarray(QTab["theta500Arcmin"])[
                np.asarray(QTab["z"]) == z]) for z in zs]
            self.zDepThetaMax = interpolate.InterpolatedUnivariateSpline(
                zs, thetaMaxs)
            if self.zDependent is False:
                raise ValueError("Mixed z-dependent and z-independent Q")
            self.zDependent = True
        return spline

    def getQ(self, theta500Arcmin, z=None, tileName=None):
        """Interpolated Q values (``signals.py:301-347``)."""
        if tileName not in self.fitDict:
            tileName = None
        if self.zDependent:
            Qs = self.fitDict[tileName](z, theta500Arcmin)[0]
            Qs = np.asarray(Qs)
            Qs[np.asarray(theta500Arcmin) > self.zDepThetaMax(z)] = 0.0
            if z < self.zMin or z > self.zMax:
                Qs = np.zeros_like(Qs)
        else:
            Qs = self.fitDict[tileName](theta500Arcmin)
        Qs = np.asarray(Qs)
        Qs[Qs < 0] = 0
        if Qs.ndim == 0 or (np.isscalar(theta500Arcmin)):
            return float(Qs) if Qs.ndim == 0 else float(np.ravel(Qs)[0])
        return Qs


def fitQ(config):
    """Measure Q(theta500[, z]) per tile using the cached reference filter
    (``signals.py:864-1129``); writes selFn/QFit.fits as a MEF of tables.

    Runs on ``config.policy``'s device.  Two routes, as in the JAX package:
    the tile-batched route (:func:`_fitQTileBatched`) and the per-tile
    serial route, whose model paints batch over a model axis in chunks of
    ``qfitBatchSize``.  ``qfitTileBatch`` and ``qfitBatchSize`` default to
    "auto": the tile-batched route and chunks of 16 on CUDA, the serial
    route with one model at a time on the CPU.  A real-space reference
    filter always takes the serial route, one model at a time, painted and
    filtered at the tile's true shape."""
    from .. import filters as filters_mod
    from ..ops import detect as detect_ops
    from ..ops import fourier
    from ..ops import paint as paint_ops
    from ..ops.interp import subpixel_value

    P = config.policy
    onCuda = P.device.type == "cuda"
    cosmoModel = cosmo_mod.fiducialCosmoModel()
    photFilterLabel = config.parDict["photFilter"]
    ref = next(f for f in config.parDict["mapFilters"]
               if f["label"] == photFilterLabel)

    if "Arnaud" in ref["class"]:
        from .profiles import makeArnaudModelSignalMap as makeSignalModelMap
        from .profiles import makeArnaudModelProfile as makeModelProfile
        zDepQ = 0
    elif "Battaglia" in ref["class"]:
        from .profiles import makeBattagliaModelSignalMap \
            as makeSignalModelMap
        from .profiles import makeBattagliaModelProfile as makeModelProfile
        zDepQ = 1
    else:
        raise ValueError("Q calculation requires Arnaud or Battaglia model")

    # (M, z) grids spanning theta500 ~ 0.1 .. 50+ arcmin (signals.py:902-963)
    if zDepQ == 0:
        MRange = [ref["params"]["M500MSun"]]
        zRange = [ref["params"]["z"]]
        theta500Arcmin_wanted = 10 ** np.arange(np.log10(0.1), np.log10(50),
                                                0.05055349)
        zRange_wanted = np.array([2.0] * 10 + [1.0] * 10 + [0.6] * 10
                                 + [0.3] * 10 + [0.1] * 10 + [0.07] * 4)
        zRange_wanted = zRange_wanted[:len(theta500Arcmin_wanted)]
        for theta, z in zip(theta500Arcmin_wanted, zRange_wanted):
            MRange.append(cosmo_mod.M500cFromTheta500(theta, z, cosmoModel))
            zRange.append(z)
    else:
        MRange = [ref["params"]["M500MSun"]]
        zRange = [ref["params"]["z"]]
        zGrid = [0.05, 0.1, 0.2, 0.3, 0.4, 0.6, 0.8, 1.0, 1.2, 1.6, 2.0]
        theta500Arcmin_wanted = np.logspace(np.log10(0.1), np.log10(100), 24)
        for z in zGrid:
            for theta in theta500Arcmin_wanted:
                MRange.append(cosmo_mod.M500cFromTheta500(theta, z,
                                                          cosmoModel))
                zRange.append(z)

    models = list(zip(zRange, MRange))

    QTabDict = {}
    # Painted (and pixel-windowed) model stacks depend on the geometry,
    # not on the filter: tiles of one geometry reuse them (an LRU of two).
    paintCache = {}
    # Beam-convolved model profile tables are geometry-independent: one
    # per (model, freq) for the whole run, painted per geometry.
    modelTables = None

    from .beams import BeamProfile
    beamsDict = {m["obsFreqGHz"]: BeamProfile(
                     beamFileName=m["beamFileName"])
                 for m in config.parDict["unfilteredMaps"]}
    y0 = 2e-4

    def _buildModelTables():
        return _qfitModelTables(models, beamsDict, config,
                                makeModelProfile, y0)

    firstFilterClass = filters_mod.getFilterClass(ref["class"])
    refIsRealSpace = issubclass(firstFilterClass,
                                filters_mod.RealSpaceMatchedFilter)
    useTileBatch = config.parDict.get("qfitTileBatch", None)
    if useTileBatch is None or useTileBatch == "auto":
        useTileBatch = not refIsRealSpace and onCuda
    if useTileBatch and not refIsRealSpace:
        return _fitQTileBatched(config, ref, models, _buildModelTables,
                                cosmoModel, zDepQ, y0)

    for tileName in config.tileNames:
        print("... fitting Q in tile %s" % tileName)
        tTile0 = time.time()
        tPhase = {}  # per-phase wall-clock, printed for slow tiles
        filt = next(f for f in config.parDict["mapFilters"]
                    if f["label"] == photFilterLabel)
        filterClass = filters_mod.getFilterClass(filt["class"])
        filterObj = filterClass(filt["label"], config.unfilteredMapsDictList,
                                filt["params"], tileName=tileName,
                                diagnosticsDir=config.diagnosticsDir,
                                geometryOnly=True, policy=P)
        tPhase["construct"] = time.time() - tTile0
        t0 = time.time()
        filterObj.loadFilter()
        tPhase["loadFilter"] = time.time() - t0
        realSpace = isinstance(filterObj, filters_mod.RealSpaceMatchedFilter)

        # Paint and apply at the filter's padded (FFT) shape, as the JAX
        # package does: the cached filter lives on that grid.  A real-space
        # filter convolves at the tile's true shape.
        shape = filterObj.shape if realSpace else filterObj.padShape
        pix = filterObj.pixScalesRad
        cy, cx = shape[0] / 2.0, shape[1] / 2.0
        # only the central window is needed for the peak read
        half = 48
        y0i = max(int(cy) - half, 0)
        x0i = max(int(cx) - half, 0)

        def _paint(z, M500MSun):
            maps_f = []
            for obsFreqGHz in beamsDict:
                amplitude = sz.convertToDeltaT(y0, obsFreqGHz) \
                    if obsFreqGHz is not None else y0
                maps_f.append(makeSignalModelMap(
                    z, M500MSun, shape, pix, beam=beamsDict[obsFreqGHz],
                    amplitude=amplitude, convolveWithBeam=True,
                    GNFWParams=config.parDict["GNFWParams"],
                    returnDevice=True, device=P.device, dtype=P.dtype))
            return torch.stack(maps_f)

        # The model paints + filter applications batch over a model axis
        # in chunks of qfitBatchSize (the last chunk padded by repeats);
        # the peak is read on the device with the detection path's
        # not-a-knot bicubic spline, window 24, which reproduces the host
        # read's anchor formula (interp._WINDOW).  A real-space filter
        # applies one model at a time (its bands convolve one by one).
        batchSize = config.parDict.get("qfitBatchSize")
        if batchSize is None or batchSize == "auto":
            batchSize = 16 if onCuda else 1
        batchSize = 1 if realSpace else max(1, int(batchSize))

        peaks = []
        tPaint = None
        if batchSize > 1:
            geomKey = (tuple(shape), tuple(np.round(pix, 12)), batchSize)
            if geomKey not in paintCache:
                t0 = time.time()
                if modelTables is None:
                    modelTables = _buildModelTables()
                nF = len(beamsDict)
                chunks = []
                for c0 in range(0, len(models), batchSize):
                    chunk = modelTables[c0:c0 + batchSize]
                    nChunk = len(chunk)
                    chunk = chunk + [chunk[-1]] * (batchSize - nChunk)
                    dev = paint_ops.paint_templates_centered_batch(
                        shape, pix, [t for per in chunk for t in per],
                        device=P.device, dtype=P.dtype)
                    dev = fourier.apply_pixel_window(
                        dev.reshape((batchSize, nF) + tuple(shape)),
                        pow=1.0)
                    chunks.append((dev, nChunk))
                paintCache[geomKey] = chunks
                while len(paintCache) > 2:
                    paintCache.pop(next(iter(paintCache)))
                tPaint = time.time() - t0
            else:
                paintCache[geomKey] = paintCache.pop(geomKey)
            t0 = time.time()
            ysC = torch.full((1,), cy, dtype=P.dtype, device=P.device)
            xsC = torch.full((1,), cx, dtype=P.dtype, device=P.device)
            for dev, nChunk in paintCache[geomKey]:
                filteredDev = filterObj.applyFilter(dev, returnDevice=True)
                sp, _ = detect_ops.spline_values(filteredDev, ysC, xsC,
                                                 window=24)
                peaks.extend(float(v) for v in sp[0, :nChunk].cpu())
                del filteredDev
            tPhase["applyAndRead"] = time.time() - t0
        else:
            t0 = time.time()
            for z, M500MSun in models:
                signalMaps = fourier.apply_pixel_window(_paint(z, M500MSun),
                                                        pow=1.0)
                if realSpace:
                    # host map out (background subtraction included)
                    crop = filterObj.applyFilter(signalMaps)[
                        y0i:int(cy) + half, x0i:int(cx) + half]
                else:
                    filteredDev = filterObj.applyFilter(signalMaps,
                                                        returnDevice=True)
                    crop = filteredDev[y0i:int(cy) + half,
                                       x0i:int(cx) + half].cpu().numpy()
                peaks.append(subpixel_value(crop, cy - y0i, cx - x0i))
            tPhase["serialLoop"] = time.time() - t0

        QTabDict[tileName] = _assembleQTab(peaks, models, cosmoModel,
                                           zDepQ, tileName, y0)
        # fitQ is the filter's last reader in the process: retire it from
        # the device cache (its FITS write queued)
        if filterObj.filterFileName is not None:
            from ..parallel import filtercache
            filtercache.release(filterObj.filterFileName)
        tTile = time.time() - tTile0
        extra = "" if tPaint is None \
            else ", incl. %.1f s painting the model stack" % tPaint
        if tTile > 5:
            extra += "; " + ", ".join("%s %.1fs" % kv
                                      for kv in sorted(tPhase.items()))
        print("    [%.1f s%s]" % (tTile, extra))

    _writeQTabs(config, QTabDict, zDepQ)
    return QTabDict


def _qfitModelTables(models, beamsDict, config, makeModelProfile, y0):
    """Per (model, freq): radial table of the FINAL painted values -
    ``paintSignalMap``'s amplitude semantics folded in (painted map =
    (rconv[0] * amplitude) * |rconv / rconv[0]|, profiles.py:120-133),
    so the batched painter needs no extra scaling pass."""
    from .profiles import convolveProfileWithBeam

    tabs = []
    for z, M500MSun in models:
        d = makeModelProfile(z, M500MSun,
                             GNFWParams=config.parDict["GNFWParams"])
        per = []
        for obsFreqGHz in beamsDict:
            amplitude = sz.convertToDeltaT(y0, obsFreqGHz) \
                if obsFreqGHz is not None else y0
            r, rconv = convolveProfileWithBeam(d["rDeg"], d["prof"],
                                               beamsDict[obsFreqGHz])
            per.append((r, (rconv[0] * amplitude)
                        * np.abs(rconv / rconv[0])))
        tabs.append(per)
    return tabs


def _assembleQTab(peaks, models, cosmoModel, zDepQ, tileName, y0):
    """Shared tail of both fitQ routes: peak list -> normalised QTab."""
    Q, QTheta500Arcmin, Qz = [], [], []
    for peak, (z, M500MSun) in zip(peaks, models):
        if peak not in Q:
            Q.append(peak)
            QTheta500Arcmin.append(
                cosmo_mod.calcTheta500Arcmin(z, M500MSun, cosmoModel))
            Qz.append(z)
    Q = np.array(Q)
    if abs(1 - Q[0] / y0) > 1e-2:
        raise ValueError("Q[0]/y0 = %.4f outside tolerance - filter "
                         "normalisation is off (tile %s)"
                         % (Q[0] / y0, tileName))
    Q = Q / Q[0]
    QTab = Table({"Q": Q, "theta500Arcmin": np.array(QTheta500Arcmin),
                  "z": np.array(Qz)})
    QTab.sort("theta500Arcmin")
    QTab.meta["ZDEPQ"] = zDepQ
    QTab.meta["TILENAME"] = tileName
    return QTab


def _writeQTabs(config, QTabDict, zDepQ):
    outFileName = os.path.join(config.selFnDir, "QFit.fits")
    hdus = [nfits.HDU(data=None, header=None)]
    for tileName in config.allTileNames:
        if tileName in QTabDict:
            hdr = nfits.Header()
            hdr["ZDEPQ"] = zDepQ
            hdu = nfits.HDU(data=QTabDict[tileName].as_dict(), header=hdr,
                            name=tileName)
            hdu.is_table = True
            hdus.append(hdu)
    nfits.write(outFileName, hdus)


def _fitQTileBatched(config, ref, models, buildModelTables, cosmoModel,
                     zDepQ, y0):
    """Tile-batched Q fit.

    Tiles are grouped by geometry (padShape, pixel scales): each
    geometry's model stack is painted and FFT'd once, every tile's cached
    reference filter is applied to the resident spectra in multi-tile
    chunks (``sum_f irfft2(filt_t x fModel_b)``), and the centre peak is
    read on the device with the same windowed not-a-knot spline as the
    serial route: one (T, B) download per tile chunk.  Chunk sizes:
    ``qfitTileBatchSize`` tiles (default 4) by ``qfitBatchSize`` models
    (default 16).  Reference: ``nemo/signals.py:864-1129``.
    """
    from .. import filters as filters_mod
    from ..ops import detect as detect_ops
    from ..ops import fourier, paint as paint_ops

    P = config.policy
    filterClass = filters_mod.getFilterClass(ref["class"])
    tileChunk = int(config.parDict.get("qfitTileBatchSize", 4))
    modelChunk = config.parDict.get("qfitBatchSize")
    modelChunk = 16 if modelChunk in (None, "auto") else int(modelChunk)
    modelChunk = max(1, modelChunk)
    if "qfitReadDepth" in config.parDict:
        print("... qfitReadDepth: accepted and ignored (each tile chunk is "
              "read as it completes)", flush=True)

    from ..parallel import filtercache

    # seconds by phase; cacheLoads counts the filters read from the
    # device-resident cache
    tBudget = {"construct": 0.0, "loadFilter": 0.0, "paint": 0.0,
               "dispatch": 0.0, "download": 0.0, "cacheLoads": 0}
    t0 = time.time()
    groups = {}          # (padShape, pix) -> list of (tileName, filterObj)
    for tileName in config.tileNames:
        filterObj = filterClass(ref["label"],
                                config.unfilteredMapsDictList,
                                ref["params"], tileName=tileName,
                                diagnosticsDir=config.diagnosticsDir,
                                geometryOnly=True, policy=P)
        key = (tuple(filterObj.padShape),
               tuple(np.round(filterObj.pixScalesRad, 12)))
        groups.setdefault(key, []).append((tileName, filterObj))
    tBudget["construct"] = time.time() - t0
    print("... fitting Q: %d tiles in %d geometry group(s), "
          "%d models, tile chunks of %d"
          % (sum(len(v) for v in groups.values()), len(groups),
             len(models), tileChunk), flush=True)

    modelTables = buildModelTables()
    nF = len(config.parDict["unfilteredMaps"])

    def _applyPeaks(filts, fModels, padShape):
        # filts (T, nf, h, wh) real; fModels (B, nf, h, wh) complex
        prod = filts[:, None] * fModels[None]
        filtered = torch.sum(fourier.irfft2(prod, s=padShape), dim=2)
        flat = filtered.reshape((-1,) + tuple(filtered.shape[-2:]))
        cy, cx = padShape[0] / 2.0, padShape[1] / 2.0
        sp, _ = detect_ops.spline_values(
            flat, torch.full((1,), cy, dtype=P.dtype, device=P.device),
            torch.full((1,), cx, dtype=P.dtype, device=P.device), window=24)
        return sp[0].reshape(filts.shape[0], fModels.shape[0])

    QTabDict = {}
    for (padShape, pix), tiles in groups.items():
        # paint + FFT this geometry's model stacks once (same painter,
        # pixel window and apodisation as the serial route / applyFilter)
        t0 = time.time()
        fModelChunks = []
        apodDev = fourier.apod_mask(padShape, tiles[0][1].apodPix,
                                    device=P.device, dtype=P.dtype)
        for c0 in range(0, len(models), modelChunk):
            chunk = modelTables[c0:c0 + modelChunk]
            nChunk = len(chunk)
            chunk = chunk + [chunk[-1]] * (modelChunk - nChunk)
            dev = paint_ops.paint_templates_centered_batch(
                padShape, pix, [t for per in chunk for t in per],
                device=P.device, dtype=P.dtype)
            dev = fourier.apply_pixel_window(
                dev.reshape((modelChunk, nF) + tuple(padShape)), pow=1.0)
            fModelChunks.append((fourier.rfft2(dev * apodDev[None, None]),
                                 nChunk))
            del dev
        tBudget["paint"] += time.time() - t0

        for t0idx in range(0, len(tiles), tileChunk):
            tChunkWall = time.time()
            cpuChunkIn = time.process_time()
            chunkTiles = tiles[t0idx:t0idx + tileChunk]
            t0 = time.time()
            filts, norms = [], []
            hits0 = filtercache.DEVICE_CACHE.hits
            for tileName, filterObj in chunkTiles:
                filterObj.loadFilter()
                filts.append(filterObj.filt)
                norms.append(float(filterObj.signalNorm))
            filts = torch.stack(filts)
            tBudget["loadFilter"] += time.time() - t0
            tBudget["cacheLoads"] += filtercache.DEVICE_CACHE.hits - hits0

            t0 = time.time()
            sps = torch.cat([_applyPeaks(filts, fdev, tuple(padShape))
                             for fdev, _ in fModelChunks], dim=1)
            tBudget["dispatch"] += time.time() - t0
            t0 = time.time()
            vals = sps.cpu().numpy()
            tBudget["download"] += time.time() - t0
            cols = []
            c0 = 0
            for _, nChunk in fModelChunks:
                cols.append(slice(c0, c0 + nChunk))
                c0 += modelChunk
            for ti, (tileName, filterObj) in enumerate(chunkTiles):
                peaks = [float(v) * norms[ti]
                         for sl in cols for v in vals[ti, sl]]
                QTabDict[tileName] = _assembleQTab(
                    peaks, models, cosmoModel, zDepQ, tileName, y0)
                # fitQ is the filter's last reader in the process: retire
                # it from the device cache (its FITS write queued)
                if filterObj.filterFileName is not None:
                    filtercache.release(filterObj.filterFileName)
            _qfitBudgetRecord(config, chunkTiles, tChunkWall, tBudget,
                              cpuChunkIn)
            del filts, sps
    print("... fitQ budgets: " + ", ".join(
        ("%s %d" if isinstance(v, int) else "%s %.1fs") % (k, v)
        for k, v in sorted(tBudget.items())), flush=True)

    _writeQTabs(config, QTabDict, zDepQ)
    return QTabDict


def _qfitBudgetRecord(config, chunkTiles, tChunkWall, tBudget,
                      cpuChunkIn):
    """Append a fitQ chunk record (``"stage": "fitQ"``) to
    diagnostics/chunk_budgets.jsonl: the chunk's wall and process-CPU
    seconds, its tile count and the stage's cumulative seconds by phase."""
    if not config.diagnosticsDir:
        return
    rec = {"stage": "fitQ",
           "t_wall": round(time.time(), 2),
           "wall_s": round(time.time() - tChunkWall, 3),
           "cpu_s": round(time.process_time() - cpuChunkIn, 3),
           "nTiles": len(chunkTiles),
           "cum": {k: round(v, 2) for k, v in tBudget.items()}}
    try:
        os.makedirs(config.diagnosticsDir, exist_ok=True)
        with open(os.path.join(config.diagnosticsDir,
                               "chunk_budgets.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError as exc:      # a diagnostics record never stops the fit
        print("... WARNING: fitQ budget record not written: %s" % exc)
