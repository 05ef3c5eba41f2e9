"""Matched-filter engine (Fourier-space MMF) on torch tensors.

Port of ``nemo_tpu/filters.py``; the class structure mirrors it (and the
reference ``nemo/filters.py``) so configs and call sites translate
directly:

* :class:`MapFilter` - base class (geometry, beams, noise-map estimation);
* :class:`MatchedFilter` - Fourier-space multi-frequency matched filter;
* :class:`RealSpaceMatchedFilter` - its truncated real-space kernel
  variant (the DR3 / E-D56 style): the kernel comes from a Fourier matched
  filter built on a sub-region, cut at ``kernelMaxArcmin`` and applied to
  the whole tile at its true shape by a reflect-boundary convolution
  (through the FFT);
* the Beam/ArnaudModel/BattagliaModel template mixins and the concrete
  classes, resolved through :data:`FILTER_REGISTRY`.

Every array step runs on the :class:`~nemo_tpu_torch.device.Policy`'s
device and dtype: the FFTs (cuFFT on the card), the noise covariance and
its smoothing, the closed-form per-pixel solve, the signal calibration, and
the post-filter chain whose grid RMS runs through the CUDA kernel
``csrc/rms_cells.cu``.  The built filter persists in the same
``filter_*.fits`` cache as the JAX package, so a filter built by either
package is applied by the other.

The noise covariance comes from the data (``dataMap``), from a simulated
CMB plus white noise drawn per band (``model``, through ``ops/grf.py`` or,
above ``maps.CURVED_SKY_DEC_DEG``, ``ops/sht.py`` and its Legendre kernel),
or from the data floored by the lensed CMB power (``max(dataMap,CMB)``).

"""

import os

import numpy as np
import torch

from . import device as device_mod
from .models import profiles, sz
from .models.beams import BeamProfile, _parse_solid_angle
from .ops import fourier, grf, imageops, interp, sht
from .ops import noise as noise_ops
from .ops import solve as solve_ops
from .utils import fits as nfits
from .utils import timing


# ----------------------------------------------------------------------------
def filterMaps(unfilteredMapsDictList, filterParams, tileName,
               diagnosticsDir=".", selFnDir=".", verbose=True,
               undoPixelWindow=True, useCachedFilter=False,
               returnFilter=False, policy=None):
    """Build and apply a filter to the unfiltered map(s) for one tile,
    including the pixel-window deconvolution of the output signal map.
    ``policy`` defaults to the card (:func:`device.policy`, which raises
    when there is none)."""
    policy = policy or device_mod.policy("cuda")
    f = filterParams
    label = f["label"] + "#" + tileName
    if verbose:
        print("... making filtered map %s" % label)
    filterClass = getFilterClass(f["class"])
    filterObj = filterClass(f["label"], unfilteredMapsDictList, f["params"],
                            tileName=tileName, diagnosticsDir=diagnosticsDir,
                            selFnDir=selFnDir, policy=policy)
    filteredMapDict = filterObj.buildAndApply(
        useCachedFilter=useCachedFilter, undoPixelWindow=undoPixelWindow)

    if undoPixelWindow and not getattr(filterObj, "_undoneWindow", False):
        data = filteredMapDict["data"]
        mask = np.equal(data, 0)
        data = fourier.apply_pixel_window(policy.tensor(data),
                                          pow=-1.0).cpu().numpy()
        data[mask] = 0
        filteredMapDict["data"] = data

    if returnFilter:
        return filteredMapDict, filterObj
    return filteredMapDict


def combinedFlagMask(mapDicts, shape):
    """The flag mask of a filter over these preprocessed maps: each map's
    ``flagMask`` times its 1-based index, summed (int)."""
    flagMask = np.zeros(shape, dtype=int)
    for i, mapDict in enumerate(mapDicts):
        flagMask = flagMask + np.asarray(mapDict["flagMask"]) * (i + 1)
    return flagMask


def beamSolidAngles(mapDicts):
    """{obsFreqGHz: beam solid angle in nsr} for Jy conversions: a map's
    own ``solidAngle_nsr`` where set, else what its beam file's header
    declares (0 without), as ``BeamProfile`` reads it.  A beam file that
    cannot be opened raises (OSError)."""
    solidAngles = {}
    for mapDict in mapDicts:
        if "solidAngle_nsr" in mapDict and mapDict["solidAngle_nsr"]:
            sa = mapDict["solidAngle_nsr"]
        else:
            # _parse_solid_angle reads 0 from a file it cannot open
            with open(mapDict["beamFileName"]):
                pass
            sa = _parse_solid_angle(mapDict["beamFileName"])
        solidAngles[mapDict["obsFreqGHz"]] = sa
    return solidAngles


# ----------------------------------------------------------------------------
class MapFilter:
    """Base class: holds the preprocessed per-frequency tile maps plus the
    geometry and beam metadata needed to build filters.

    ``givenNoiseStack``: an (nf, ny, nx) array or tensor that, when set,
    is the noise stack the filter is built from, in place of the one its
    noise method makes (to rebuild a filter from another run's stack)."""

    givenNoiseStack = None

    def __init__(self, label, unfilteredMapsDictList, paramsDict,
                 tileName="PRIMARY", diagnosticsDir=None, selFnDir=None,
                 geometryOnly=False, policy=None, tileState=None):
        """``geometryOnly=True`` skips the per-tile map preprocessing and
        derives (shape, wcs) from the tile coords alone, for consumers that
        only load + apply a cached filter.  ``policy`` defaults to the
        card.  ``tileState``: the tile's ``flagMask`` and
        ``beamSolidAngles`` (:func:`combinedFlagMask`,
        :func:`beamSolidAngles`) already made from these preprocessed
        maps, so the filters of a bank share them (the flag mask is not
        copied: it is read only); ignored with ``mapToUse``."""
        self.label = label
        self.params = dict(paramsDict)
        self.tileName = tileName
        self.diagnosticsDir = diagnosticsDir
        self.selFnDir = selFnDir
        self.policy = policy or device_mod.policy("cuda")
        if diagnosticsDir is not None:
            self.filterFileName = os.path.join(
                diagnosticsDir, tileName,
                "filter_%s#%s.fits" % (label, tileName))
        else:
            self.filterFileName = None

        self.unfilteredMapsDictList = []
        geometry = None
        for mapDict in unfilteredMapsDictList:
            if "mapToUse" in self.params and self.params["mapToUse"] is not None:
                if mapDict.get("label") != self.params["mapToUse"]:
                    continue
            newDict = mapDict.copy() if hasattr(mapDict, "copy") else dict(mapDict)
            if geometryOnly and geometry is None and \
                    hasattr(newDict, "loadGeometry"):
                geometry = newDict.loadGeometry(tileName)
                if geometry is None:
                    geometryOnly = False
            if hasattr(newDict, "preprocess") and not geometryOnly:
                with timing.span("preprocess"):
                    newDict.preprocess(tileName=tileName,
                                       diagnosticsDir=diagnosticsDir)
            self.unfilteredMapsDictList.append(newDict)
        self.geometryOnly = geometryOnly and geometry is not None
        if self.geometryOnly:
            self.shape, self.wcs = geometry
        else:
            self.wcs = self.unfilteredMapsDictList[0]["wcs"]
            self.shape = self.unfilteredMapsDictList[0]["data"].shape

        # a tile state describes every map given: a filter that picks its
        # bands with mapToUse builds its own
        if tileState is not None and not self.params.get("mapToUse"):
            timing.count("stage.tile_state_shared")
            self.flagMask = tileState["flagMask"]
            self.beamSolidAnglesDict = dict(tileState["beamSolidAngles"])
        else:
            self.flagMask = np.zeros(self.shape, dtype=int) \
                if self.geometryOnly \
                else combinedFlagMask(self.unfilteredMapsDictList, self.shape)
            self.beamSolidAnglesDict = beamSolidAngles(
                self.unfilteredMapsDictList)

        self.apodPix = 20

        if not self.geometryOnly:
            for mapDict in self.unfilteredMapsDictList:
                if mapDict["data"].shape != self.shape:
                    raise ValueError(
                        "Maps at different frequencies have different "
                        "dimensions")

        # pixel scales at the tile centre (radians)
        cy, cx = self.shape[0] // 2, self.shape[1] // 2
        ra0, dec0 = self.wcs.pix2wcs(cx, cy)
        ra1, dec1 = self.wcs.pix2wcs(cx + 1, cy + 1)
        from .utils.wcs import calcAngSepDeg
        self.degPerPixX = float(calcAngSepDeg(ra0, dec0, ra1, dec0))
        self.degPerPixY = float(calcAngSepDeg(ra0, dec0, ra0, dec1))
        self.pixScalesRad = (np.radians(self.degPerPixY),
                             np.radians(self.degPerPixX))

        # FFT-friendly padded working shape (5-smooth, or the survey-wide
        # bucket the config injects); results are cropped back.
        padH = fourier.good_fft_size(self.shape[0])
        padW = fourier.good_fft_size(self.shape[1])
        bucket = self.params.get("_fftPadBucket")
        if bucket:
            bH, bW = int(bucket[0]), int(bucket[1])
            if (bH >= self.shape[0] and bW >= self.shape[1]
                    and self.shape[0] * self.shape[1] >= 0.5 * bH * bW):
                padH, padW = bH, bW
        self.padShape = (padH, padW)

        self.signalNorm = 1.0
        self.fRelWeights = {}

    def _trimSizePix(self):
        """Edge-trim width: edgeTrimArcmin, or 3 x the noise grid cell."""
        params = self.params
        if params.get("edgeTrimArcmin", 0) and params["edgeTrimArcmin"] > 0:
            return int(round((params["edgeTrimArcmin"] / 60.0)
                             / self.wcs.getPixelSizeDeg()))
        grid = params["noiseParams"].get("noiseGridArcmin", None)
        if grid is not None and grid != "smart":
            gridSize = int(round((grid / 60.0)
                                 / self.wcs.getPixelSizeDeg()))
            return int(round(gridSize * 3.0))
        return 0

    def _noiseGridPix(self):
        """RMS noise-grid cell size in pixels (0 for whole-map/'smart')."""
        grid = self.params["noiseParams"].get("noiseGridArcmin", None)
        if grid is None or grid == "smart":
            return 0
        return int(round((grid / 60.0) / self.wcs.getPixelSizeDeg()))

    # -- noise map ------------------------------------------------------------
    def makeNoiseMap(self, mapData):
        """Grid-cell RMS estimation on the policy's device (host numpy for
        the weight-binned / biweight variants)."""
        noiseParams = self.params["noiseParams"]
        estimator = noiseParams.get("RMSEstimator", "default")
        grid = noiseParams.get("noiseGridArcmin", None)
        if estimator == "biweight" or grid == "smart" or \
                noiseParams.get("numNoiseBins", 1) > 1:
            return self._makeNoiseMapHost(mapData, estimator)
        data = self.policy.tensor(np.asarray(mapData))
        if grid is None:
            return noise_ops.whole_map_rms(
                data, estimator=estimator).cpu().numpy()
        gridSize = int(round((grid / 60.0) / self.wcs.getPixelSizeDeg()))
        return noise_ops.grid_rms_map(data, gridSize,
                                      estimator=estimator).cpu().numpy()

    def _makeNoiseMapHost(self, mapData, estimator):
        """Host numpy implementation of the less-common noise options:
        'smart' weight-binned mode, biweight scale, and per-cell weight
        binning with numNoiseBins > 1."""
        noiseParams = self.params["noiseParams"]
        mapData = np.asarray(mapData)
        medWeights = np.median(np.stack(
            [np.asarray(m["weights"]) for m in self.unfilteredMapsDictList]),
            axis=0)
        apodMask = mapData != 0

        def measure(values):
            if len(values) == 0:
                return 0.0
            if estimator == "biweight":
                return _biweight_scale(values) if len(values) >= 10 else 0.0
            if estimator == "percentile":
                return float(np.percentile(np.abs(values), 68.3))
            if (values != 0).sum() == 0:
                return 0.0
            mean, rms = np.mean(values), np.std(values)
            for _ in range(10):
                sel = np.abs(values) < abs(mean + 3.0 * rms)
                if sel.sum() > 0:
                    mean, rms = np.mean(values[sel]), np.std(values[sel])
            return float(rms)

        RMSMap = np.zeros(mapData.shape)
        if noiseParams.get("noiseGridArcmin") == "smart":
            numBins = noiseParams.get("numNoiseBins")
            if numBins is None:
                raise ValueError("numNoiseBins required with "
                                 "noiseGridArcmin = 'smart'")
            binEdges = np.linspace(medWeights.min(), medWeights.max(),
                                   numBins)
            for i in range(len(binEdges) - 1):
                weightSel = (medWeights > binEdges[i]) & \
                            (medWeights < binEdges[i + 1])
                good = weightSel & apodMask
                rms = measure(mapData[good])
                if rms > 0:
                    RMSMap[weightSel] = rms
            return RMSMap

        gridSize = int(round((noiseParams["noiseGridArcmin"] / 60.0)
                             / self.wcs.getPixelSizeDeg()))
        overlapPix = gridSize // 2
        numBins = noiseParams.get("numNoiseBins", 1)
        yC = noise_ops.cell_edges(mapData.shape[0], gridSize)
        xC = noise_ops.cell_edges(mapData.shape[1], gridSize)
        for i in range(len(yC) - 1):
            for k in range(len(xC) - 1):
                y0 = max(yC[i] - overlapPix, 0)
                y1 = min(yC[i + 1] + overlapPix, mapData.shape[0])
                x0 = max(xC[k] - overlapPix, 0)
                x1 = min(xC[k + 1] + overlapPix, mapData.shape[1])
                vals = mapData[y0:y1, x0:x1]
                good = apodMask[y0:y1, x0:x1]
                if good.sum() == 0:
                    continue
                wvals = medWeights[y0:y1, x0:x1]
                percentiles = np.arange(0, 100, 100 / numBins)
                binEdges = [np.percentile(wvals[good], p)
                            for p in percentiles]
                binEdges.append(wvals[good].max() + 1e-6)
                for b in range(len(binEdges) - 1):
                    binSel = (wvals >= binEdges[b]) & \
                             (wvals < binEdges[b + 1])
                    rms = measure(vals[binSel & good])
                    if rms > 0:
                        RMSMap[y0:y1, x0:x1][binSel] = rms
        return RMSMap

    # -- template hooks ---------------------------------------------------------
    def makeSignalTemplateMap(self, beam, amplitude=None, returnDevice=False):
        raise NotImplementedError

    def makeRealSpaceFilterProfile(self):
        """1-d real-space profile of the filter."""
        realSpace = np.fft.fftshift(
            np.fft.irfft2(self._filtHost(), s=self.padShape), axes=(-2, -1))
        y0 = realSpace.shape[1] // 2
        x0 = realSpace.shape[2] // 2
        prof = realSpace[:, y0, x0:]
        prof = prof / np.abs(prof).max()
        arcminRange = np.arange(prof.shape[1]) * self.degPerPixX * 60.0
        return prof, arcminRange

    def saveRealSpaceFilterProfile(self):
        """PNG plot of the filter's 1-d real-space profile per band into
        ``diagnosticsDir`` (``savePlots: true``)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        prof, arcminRange = self.makeRealSpaceFilterProfile()
        fig = plt.figure(figsize=(8, 8))
        plt.axes([0.14, 0.11, 0.835, 0.86])
        plt.ylabel("Amplitude")
        plt.xlabel("$\\theta$ (arcmin)")
        for row, mapDict in zip(prof, self.unfilteredMapsDictList):
            if mapDict.get("obsFreqGHz") is not None:
                lineLabel = "%d GHz" % mapDict["obsFreqGHz"]
            else:
                lineLabel = "yc"
            plt.plot(arcminRange, row, label=lineLabel)
        plt.xlim(0, 10.0)
        plt.ylim(prof.min(), prof.max() * 1.1)
        plt.legend()
        os.makedirs(self.diagnosticsDir, exist_ok=True)
        plt.savefig(os.path.join(
            self.diagnosticsDir,
            "realSpaceProfile1d_%s#%s.png" % (self.label, self.tileName)))
        plt.close(fig)

    def saveRMSMap(self, RMSMap):
        """Write the tile's RMS map, RICE_1, to
        ``selFnDir/<tile>/RMSMap_<label>#<tile>.fits``."""
        RMSFileName = os.path.join(
            self.selFnDir, self.tileName,
            "RMSMap_%s#%s.fits" % (self.label, self.tileName))
        os.makedirs(os.path.dirname(RMSFileName), exist_ok=True)
        nfits.write_image(RMSFileName, RMSMap, self.wcs.header,
                          compressionType="RICE_1")

    # -- filter state ------------------------------------------------------------
    def saveFilter(self):
        """Write the filter state to the ``filter_*.fits`` cache: the
        (nf, PY, PX//2+1) filter as float64, SIGNORM and the RW* weights."""
        header = nfits.Header()
        header["SIGNORM"] = float(self.signalNorm)
        for count, key in enumerate(self.fRelWeights, start=1):
            header["RW%d_GHZ" % count] = key
            header["RW%d" % count] = float(self.fRelWeights[key])
        os.makedirs(os.path.dirname(self.filterFileName), exist_ok=True)
        nfits.write_image(self.filterFileName, self._filtHost(), header)

    def loadFilter(self):
        """Read the filter state: from the batched engine's device-resident
        cache when it holds this filter (:mod:`.parallel.filtercache`; the
        tensor moves to the policy's device), else from the
        ``filter_*.fits`` cache once any pending write of it has
        landed."""
        from .parallel import filtercache
        ent = filtercache.DEVICE_CACHE.get(self.filterFileName)
        if ent is not None:
            self.filt = ent["filt"].to(device=self.policy.device,
                                       dtype=self.policy.dtype)
            self.signalNorm = float(ent["signalNorm"])
            self.fRelWeights = dict(ent["fRelWeights"])
            return
        filtercache.ensure_written(self.filterFileName)
        data, header = nfits.read_image(self.filterFileName)
        fRelWeights = {}
        for i in range(1, 10):
            if "RW%d_GHZ" % i in header:
                fRelWeights[header["RW%d_GHZ" % i]] = header["RW%d" % i]
        self.loadFilterState(data, header["SIGNORM"], fRelWeights)

    def loadFilterState(self, filt, signalNorm, fRelWeights):
        """Take a built filter's state as host arrays (e.g. the JAX
        package's ``filt``, ``signalNorm`` and ``fRelWeights``): the filter
        moves to the policy's device and dtype."""
        self.filt = self.policy.tensor(np.array(filt, dtype=np.float64))
        self.signalNorm = float(signalNorm)
        self.fRelWeights = dict(fRelWeights)

    def _filtShape(self):
        return tuple(self.filt.shape)

    def _filtHost(self):
        """Host float64 copy of the filter."""
        return self.filt.cpu().numpy().astype(np.float64)


def _biweight_scale(values, c=9.0):
    """Biweight scale estimator (astropy.stats.biweight_scale parity with
    modify_sample_size=True)."""
    values = np.asarray(values, dtype=float)
    M = np.median(values)
    mad = np.median(np.abs(values - M))
    if mad == 0:
        return 0.0
    u = (values - M) / (c * mad)
    sel = u ** 2 < 1
    n = sel.sum()
    if n < 2:
        return 0.0
    d = values[sel] - M
    u2 = u[sel] ** 2
    num = np.sum(d ** 2 * (1 - u2) ** 4)
    den = np.sum((1 - u2) * (1 - 5 * u2))
    return float(np.sqrt(n * num) / np.abs(den))


# ----------------------------------------------------------------------------
# Numeric cores (tensors in, tensors out)

def _freq_weights(unfilteredMapsDictList, params):
    """Signal frequency weighting w."""
    w = []
    for mapDict in unfilteredMapsDictList:
        if mapDict.get("units") == "yc":
            w.append(1.0)
        elif "specWeight" in mapDict and mapDict["specWeight"] is not None:
            w.append(mapDict["specWeight"])
        elif params["outputUnits"] == "yc":
            w.append(sz.fSZ(mapDict["obsFreqGHz"]))
        elif params["outputUnits"] == "uK":
            alpha = params.get("alpha", None)
            if alpha is not None:
                ref = unfilteredMapsDictList[0]["obsFreqGHz"]
                w.append((mapDict["obsFreqGHz"] / ref) ** alpha)
            else:
                w.append(1.0)
        else:
            raise ValueError("outputUnits must be 'yc' or 'uK'")
    return np.array(w, dtype=float)


def _build_filter_core(noiseStack, fSignalsAbs, w, apodM, padShape=None,
                       fg=None):
    """noiseStack: (nf, ny, nx) real maps used for the noise model.
    fSignalsAbs: (nf, pny, pnx//2+1) |FFT| of unit-normalised signal
    templates on the padded grid; w: (nf,) weights; ``fg``: a floor on
    every band pair's covariance on the half grid (max(dataMap,CMB)), or
    None.  Returns filt (nf, pny, pnx//2+1)."""
    nf = noiseStack.shape[0]
    m = noiseStack * apodM[None]
    if padShape is not None:
        m = fourier.pad_to(m, padShape)
    fNoise = fourier.rfft2(m)
    # N_ij = smooth3(Re(F_i conj F_j)), smoothed as the reference smooths
    # the FULL grid (Hermitian extension of the half grid)
    prods = torch.real(fNoise[:, None] * torch.conj(fNoise[None, :]))
    if fg is not None:
        prods = torch.maximum(prods, fg[None, None])
    prods = imageops.gaussian_filter_rfft_fullgrid(
        prods.reshape((-1,) + prods.shape[-2:]), (3, 3), m.shape[-1])
    N = prods.reshape((nf, nf) + prods.shape[-2:])
    # filt = N^-1 (w |s|) at every (ly, lx)
    A = N.permute(2, 3, 0, 1)                           # (ny, nx, nf, nf)
    b = fSignalsAbs.permute(1, 2, 0) * w                # (ny, nx, nf)
    return solve_ops.solve_small(A, b).permute(2, 0, 1)


def _apply_filter_fourier(fMaps, filt, s):
    """sum_freq irfft(F * filt) (the frequency axis is axis -3)."""
    return torch.sum(fourier.irfft2(fMaps * filt, s), dim=-3)


def _postprocess_filtered(filteredMap, psMask, surveyMask, gridSize,
                          trimSizePix, apodPix, estimator,
                          undoPixelWindow=False):
    """The post-filter chain: mask, grid RMS, S/N, edge trim, apod trim.
    Returns (filteredMap, SNMap, RMSMap, surveyMask) tensors."""
    filtered = filteredMap * psMask
    if gridSize is None:
        RMSMap = noise_ops.whole_map_rms(filtered, estimator=estimator)
    else:
        RMSMap = noise_ops.grid_rms_map(filtered, gridSize,
                                        estimator=estimator)
    zero = torch.zeros((), dtype=filtered.dtype, device=filtered.device)
    SNMap = torch.where(RMSMap > 0,
                        filtered / torch.clamp(RMSMap, min=1e-30), zero)
    if trimSizePix > 0:
        edge = imageops.minimum_filter(torch.abs(filtered + (1 - psMask)),
                                       trimSizePix)
        edgeCheck = (edge > 0).to(filtered.dtype)
    else:
        edgeCheck = torch.ones_like(filtered)
    maskData = edgeCheck * surveyMask * psMask
    apodOne = (fourier.apod_mask(filtered.shape, apodPix,
                                 device=filtered.device,
                                 dtype=filtered.dtype) == 1
               ).to(filtered.dtype)
    maskSN = maskData * apodOne
    filtered = filtered * maskData
    SNMap = torch.nan_to_num(SNMap * maskSN)
    RMSMap = RMSMap * maskSN
    if undoPixelWindow:
        filtered = fourier.apply_pixel_window(filtered, pow=-1.0) \
            * (maskData > 0)
    return filtered, SNMap, RMSMap, maskSN.to(torch.uint8)


def _fft_apod_stack(dataStack, apodM, padShape=None):
    m = dataStack * apodM[None]
    if padShape is not None:
        m = fourier.pad_to(m, padShape)
    return fourier.rfft2(m)


def raggedEdgeArrays(validMask, apodPix, trimPix, gridPix=0):
    """Coverage-edge handling for tiles whose observed (nonzero-data)
    region does not fill the tile rectangle (host numpy, as in the JAX
    package):

    * ``taper``: a cosine ramp over ``apodPix`` pixels inward from the
      coverage edge, multiplied into the apodisation window;
    * ``keep``: coverage eroded by :func:`coverageErodePix`, folded into
      the survey mask so the edge-trim semantics engage.

    Returns ``(taper, keep)`` as float64 arrays of ``validMask.shape``.
    """
    from scipy.ndimage import distance_transform_edt

    d = distance_transform_edt(np.asarray(validMask, dtype=bool))
    w = float(max(int(apodPix), 1))
    taper = 0.5 - 0.5 * np.cos(np.pi * np.minimum(d / w, 1.0))
    keep = (d > coverageErodePix(apodPix, trimPix, gridPix)).astype(
        np.float64)
    return taper, keep


def coverageErodePix(apodPix, trimPix, gridPix=0):
    """Coverage-edge erosion width (see :func:`raggedEdgeArrays`)."""
    return max(int(trimPix), int(apodPix) + int(1.5 * int(gridPix)))


# ----------------------------------------------------------------------------
class MatchedFilter(MapFilter):
    """Fourier-space multi-frequency matched filter."""

    def buildAndApply(self, useCachedFilter=False, undoPixelWindow=False):
        if getattr(self, "geometryOnly", False):
            raise RuntimeError("filter was constructed geometryOnly - it "
                               "can load/apply cached filters but not "
                               "build from map data")
        P = self.policy
        params = self.params
        self._undoneWindow = False

        dataHost = np.stack(
            [np.asarray(m["data"], dtype=np.float64)
             for m in self.unfilteredMapsDictList])
        surveyMask = np.asarray(self.unfilteredMapsDictList[0]["surveyMask"])
        psMask = np.asarray(self.unfilteredMapsDictList[0]["pointSourceMask"])

        apodM = fourier.apod_mask(self.shape, self.apodPix, device=P.device,
                                  dtype=P.dtype)
        validHost = (dataHost != 0).all(axis=0)
        if not validHost.all():
            # ragged data coverage: taper the coverage edge before the
            # FFT and engage the coverage-edge trim
            taper, keep = raggedEdgeArrays(validHost, self.apodPix,
                                           self._trimSizePix(),
                                           gridPix=self._noiseGridPix())
            apodM = apodM * P.tensor(taper)
            surveyMask = surveyMask * keep

        dataStack = P.tensor(dataHost)
        fMapsToFilter = _fft_apod_stack(dataStack, apodM,
                                        padShape=self.padShape)

        # file-based idempotency, as the reference: an existing cached
        # filter is always reused (the device-resident cache counts: its
        # FITS write may still be deferred; loadFilter prefers it)
        from .parallel import filtercache
        haveCache = self.filterFileName is not None
        if haveCache and \
                filtercache.DEVICE_CACHE.get(self.filterFileName) is None:
            filtercache.ensure_written(self.filterFileName)
            haveCache = os.path.exists(self.filterFileName)
        if haveCache:
            self.loadFilter()
            self.params["saveRMSMap"] = False
            self.params["saveFilter"] = False
            self.params["savePlots"] = False
        else:
            with timing.span("buildFilter"):
                self._buildFilter(dataStack, apodM)

        if params["outputUnits"] == "yc":
            mapUnits = "yc"
            combinedObsFreqGHz = "yc"
            beamSolidAngle_nsr = 0.0
        elif params["outputUnits"] == "uK":
            combinedObsFreqGHz = float(list(self.beamSolidAnglesDict)[0])
            mapUnits = "uK"
            beamSolidAngle_nsr = self.beamSolidAnglesDict[combinedObsFreqGHz]
        else:
            raise ValueError("outputUnits must be 'yc' or 'uK'")

        noiseParams = params["noiseParams"]
        estimator = noiseParams.get("RMSEstimator", "default")
        grid = noiseParams.get("noiseGridArcmin", None)
        onDevice = (estimator in ("default", "percentile")
                    and grid != "smart"
                    and noiseParams.get("numNoiseBins", 1) <= 1
                    and not params.get("bckSub"))
        if onDevice:
            with timing.span("applyFilter+noise"):
                filteredDev = self.applyFilter(fMapsToFilter,
                                               returnDevice=True)
                gridSize = None if grid is None else int(round(
                    (grid / 60.0) / self.wcs.getPixelSizeDeg()))
                f, sn, rms, mask = _postprocess_filtered(
                    filteredDev, P.tensor(np.asarray(psMask, dtype=float)),
                    P.tensor(np.asarray(surveyMask, dtype=float)),
                    gridSize, self._trimSizePix(), self.apodPix, estimator,
                    undoPixelWindow=undoPixelWindow)
                self._undoneWindow = undoPixelWindow
                filteredMap = f.cpu().numpy()
                SNMap = sn.cpu().numpy()
                RMSMap = rms.cpu().numpy() if params.get("saveRMSMap") \
                    else None
                surveyMask = mask.cpu().numpy().astype(float)
        else:
            filteredMap = self.applyFilter(fMapsToFilter)
            filteredMap = filteredMap * psMask

            RMSMap = self.makeNoiseMap(filteredMap)
            validMask = RMSMap > 0
            SNMap = np.array(filteredMap)
            SNMap[validMask] = SNMap[validMask] / RMSMap[validMask]

            trimSizePix = self._trimSizePix()
            if trimSizePix > 0:
                edgeCheck = imageops.minimum_filter(
                    torch.abs(P.tensor(filteredMap) + P.tensor(1 - psMask)),
                    trimSizePix).cpu().numpy()
                edgeCheck = (edgeCheck > 0).astype(float)
            else:
                edgeCheck = np.ones(filteredMap.shape)
            filteredMap = filteredMap * edgeCheck
            surveyMask = edgeCheck * surveyMask * psMask
            filteredMap = filteredMap * surveyMask

            apodMask = fourier.apod_mask(filteredMap.shape,
                                         self.apodPix).numpy() == 1
            surveyMask = surveyMask * apodMask

            SNMap = SNMap * surveyMask
            SNMap[np.isnan(SNMap)] = 0.0
            RMSMap = RMSMap * surveyMask

        if params.get("saveRMSMap") and RMSMap is not None:
            self.saveRMSMap(RMSMap)
        if params.get("saveFilter") and self.filterFileName is not None:
            self.saveFilter()
        if params.get("savePlots") and self.diagnosticsDir is not None:
            self.saveRealSpaceFilterProfile()

        return {"data": np.asarray(filteredMap), "wcs": self.wcs,
                "obsFreqGHz": combinedObsFreqGHz,
                "SNMap": np.asarray(SNMap), "surveyMask": surveyMask,
                "flagMask": self.flagMask, "mapUnits": mapUnits,
                "beamSolidAngle_nsr": beamSolidAngle_nsr, "label": self.label,
                "tileName": self.tileName}

    # ------------------------------------------------------------------
    def _noiseStack(self, dataStack):
        """Maps whose power defines the noise covariance: the data, less the
        model images of any ``noiseModelCatalog`` ('dataMap',
        'max(dataMap,CMB)'), or a CMB + white-noise realisation per band
        ('model'); ``givenNoiseStack`` when set."""
        if self.givenNoiseStack is not None:
            given = self.givenNoiseStack
            if isinstance(given, np.ndarray):
                given = np.array(given)         # a writable copy for torch
            return torch.as_tensor(given).to(device=self.policy.device,
                                             dtype=self.policy.dtype)
        method = self.params["noiseParams"]["method"]
        from . import maps as maps_mod
        if method in ("dataMap", "max(dataMap,CMB)"):
            cats = self.params.get("noiseModelCatalog")
            if not cats:
                return dataStack
            if not isinstance(cats, list):
                cats = [cats]
            maps_ = []
            for i, mapDict in enumerate(self.unfilteredMapsDictList):
                d = dataStack[i]
                for cat in cats:
                    model = maps_mod.makeModelImage(
                        tuple(d.shape), self.wcs, cat,
                        mapDict["beamFileName"],
                        obsFreqGHz=mapDict["obsFreqGHz"], asDevice=True,
                        policy=self.policy)
                    if model is not None:
                        d = d - model
                maps_.append(d)
            return torch.stack(maps_)
        if method == "model":
            # CMB + white noise from the weights, one seeded draw per band;
            # the declination policy (maps.resolveSimMethod) sends tiles
            # above CURVED_SKY_DEC_DEG through the curved-sky SHT
            P = self.policy
            curved = maps_mod.resolveSimMethod(
                self.wcs, self.shape, "auto",
                context="model-noise covariance") == "curved"
            maps_ = []
            for i, mapDict in enumerate(self.unfilteredMapsDictList):
                weights = np.asarray(mapDict["weights"])
                valid = weights > 0
                RMS = np.mean(1 / np.sqrt(weights[valid])) if valid.any() \
                    else 10.0
                RMS = max(RMS, 10.0)
                beam = BeamProfile(beamFileName=mapDict["beamFileName"])
                gen = maps_mod.simGenerator(P, 3141592654 + i)
                if curved:
                    cmb = sht.sim_cmb_map_curved(
                        self.shape, self.wcs, beamBell=beam.Bell,
                        beamEll=beam.ell, noiseLevel=RMS,
                        lmax=maps_mod.CURVED_AUTO_LMAX, dtype=P.dtype,
                        device=P.device, generator=gen)
                else:
                    cmb = grf.sim_cmb_map(
                        self.shape, self.pixScalesRad, beamBell=beam.Bell,
                        beamEll=beam.ell, noiseLevel=RMS,
                        dx_rows=maps_mod.pixScaleXRadPerRow(self.wcs,
                                                            self.shape),
                        device=P.device, generator=gen)
                maps_.append(cmb.to(P.dtype))
            return torch.stack(maps_)
        raise ValueError("Unknown noiseParams method '%s'" % method)

    def _signalTemplates(self, amplitudes=None):
        """(nf, ny, nx) templates on the device, one per band."""
        maps_ = []
        for i, mapDict in enumerate(self.unfilteredMapsDictList):
            amp = None if amplitudes is None else amplitudes[i]
            maps_.append(self.makeSignalTemplateMap(
                mapDict["beamFileName"], amplitude=amp, returnDevice=True))
        return torch.stack(maps_)

    def _buildFilter(self, dataStack, apodM):
        noiseStack = self._noiseStack(dataStack)
        w = self.policy.tensor(_freq_weights(self.unfilteredMapsDictList,
                                             self.params))
        # unit-normalised signal templates per band
        fSignalsAbs = torch.abs(fourier.rfft2(fourier.pad_to(
            self._signalTemplates(), self.padShape)))
        fg = None
        if self.params["noiseParams"]["method"] == "max(dataMap,CMB)":
            fg = self.policy.tensor(self._foregroundsPower())
        self.filt = _build_filter_core(noiseStack, fSignalsAbs, w, apodM,
                                       self.padShape, fg=fg)
        self._calibrateSignalNorm()

    def _foregroundsPower(self):
        """CMB-like 2-d power in the same units as |rfft|^2 of a map, on
        the padded half grid (host float64)."""
        Cl = grf.lensedClTT()
        lmap = fourier.rmodlmap(self.padShape, self.pixScalesRad)
        Cl2d = np.interp(lmap, np.arange(len(Cl)), Cl, right=0.0)
        ny, nx = self.padShape
        omega_pix = self.pixScalesRad[0] * self.pixScalesRad[1]
        return Cl2d * (ny * nx) / omega_pix

    def _calibrateSignalNorm(self):
        """Normalise with a known-amplitude template: the filtered peak of
        a y0 = 2e-4 cluster, read off with a cubic spline."""
        params = self.params
        y0 = 2e-4
        if params["outputUnits"] == "yc":
            amps = [y0 if mapDict.get("units") == "yc"
                    else sz.convertToDeltaT(y0, mapDict["obsFreqGHz"])
                    for mapDict in self.unfilteredMapsDictList]
            signalMaps = fourier.apply_pixel_window(
                self._signalTemplates(amps), pow=1.0)
            fSignalMaps = fourier.rfft2(fourier.pad_to(signalMaps,
                                                       self.padShape))
            filteredSignal = fourier.crop_to(
                _apply_filter_fourier(fSignalMaps, self.filt, self.padShape),
                self.shape)
            cy, cx = self.shape[0] / 2.0, self.shape[1] / 2.0
            # only the central window goes to the host for the spline
            # peak read (the template peak is at the centre)
            half = 48
            y0i = max(int(cy) - half, 0)
            x0i = max(int(cx) - half, 0)
            crop = filteredSignal[y0i:int(cy) + half,
                                  x0i:int(cx) + half].cpu().numpy()
            peak = interp.subpixel_value(crop, cy - y0i, cx - x0i)
            self.signalNorm = y0 / peak
            # fRel weights from the per-frequency filtered-signal cube at
            # the peak pixel
            cube = fourier.crop_to(fourier.irfft2(
                fSignalMaps * self.filt, self.padShape), self.shape)
            my, mx = np.unravel_index(np.argmax(crop), crop.shape)
            my += y0i
            mx += x0i
            total = float(filteredSignal[my, mx])
            values = cube[:, my, mx].cpu().numpy()
            self.fRelWeights = {}
            for i, mapDict in enumerate(self.unfilteredMapsDictList):
                self.fRelWeights[mapDict["obsFreqGHz"]] = \
                    float(values[i]) / total
        elif params["outputUnits"] == "uK":
            fSignalMaps = fourier.rfft2(fourier.pad_to(
                self._signalTemplates(), self.padShape))
            filteredSignal = fourier.crop_to(
                _apply_filter_fourier(fSignalMaps, self.filt, self.padShape),
                self.shape)
            self.signalNorm = 1.0 / float(torch.max(filteredSignal))
        else:
            raise ValueError("outputUnits must be 'yc' or 'uK'")

    def reshapeFilter(self, shape):
        """The filter interpolated onto another map's rfft half grid in
        l-space (host float64): a regular-grid linear interpolation on the
        fftshifted (ascending) l axes, zero outside the filter's grid."""
        from scipy.interpolate import RegularGridInterpolator
        filtShape = self._filtShape()
        if len(shape) == 2:
            shape = (filtShape[0], shape[0], shape[1])
        # the filter lives on the padded tile's half grid: ly in fftfreq
        # order (shifted for the interpolation), lx already ascending
        lyIn, lxIn = fourier.rlaxes(
            (filtShape[-2], 2 * (filtShape[-1] - 1)), self.pixScalesRad)
        lyOut, lxOut = fourier.rlaxes(
            (shape[-2], 2 * (shape[-1] - 1)), self.pixScalesRad)
        grid_y, grid_x = np.meshgrid(np.fft.fftshift(lyOut), lxOut,
                                     indexing="ij")
        pts = np.stack([grid_y.ravel(), grid_x.ravel()], axis=-1)
        filtHost = self._filtHost()
        out = np.zeros(shape)
        for i in range(filtHost.shape[0]):
            interp_i = RegularGridInterpolator(
                (np.fft.fftshift(lyIn), lxIn),
                np.fft.fftshift(filtHost[i], axes=0),
                bounds_error=False, fill_value=0.0)
            out[i] = np.fft.ifftshift(
                interp_i(pts).reshape(shape[-2:]), axes=0)
        return out

    def applyFilter(self, mapDataToFilter, returnDevice=False):
        """Apply the filter; accepts real map cubes (apodised and FFT'd
        here) or already-FFT'd complex cubes."""
        P = self.policy
        if isinstance(mapDataToFilter, torch.Tensor) and \
                torch.is_complex(mapDataToFilter):
            fMaps = mapDataToFilter
            outShape = self.shape
        else:
            data = P.tensor(np.asarray(mapDataToFilter)) \
                if not isinstance(mapDataToFilter, torch.Tensor) \
                else mapDataToFilter
            outShape = tuple(data.shape[-2:])
            apodM = fourier.apod_mask(outShape, self.apodPix,
                                      device=P.device, dtype=P.dtype)
            padShape = (fourier.good_fft_size(outShape[0]),
                        fourier.good_fft_size(outShape[1]))
            fMaps = _fft_apod_stack(data, apodM, padShape=padShape)
        if tuple(fMaps.shape[-3:]) == self._filtShape():
            filt, padShape = self.filt, self.padShape
        else:
            # another map's grid: the filter interpolated onto it
            filt = P.tensor(self.reshapeFilter(tuple(fMaps.shape[-3:])))
            padShape = (fMaps.shape[-2], 2 * (fMaps.shape[-1] - 1))
        filteredDev = fourier.crop_to(_apply_filter_fourier(
            fMaps, filt, padShape), outShape)
        if returnDevice:
            return filteredDev * self.signalNorm
        filteredMap = filteredDev.cpu().numpy()
        if self.params.get("bckSub") and self.params.get("bckSubScaleArcmin"):
            from . import maps as maps_mod
            filteredMap = maps_mod.subtractBackground(
                filteredMap, self.wcs,
                smoothScaleDeg=self.params["bckSubScaleArcmin"] / 60.0,
                policy=P)
        return filteredMap * self.signalNorm


# ----------------------------------------------------------------------------
class RealSpaceMatchedFilter(MapFilter):
    """Truncated real-space kernel matched filter.

    The kernel is built from a Fourier matched filter constructed in a
    sub-region, transformed to real space and cut at ``kernelMaxArcmin``
    (host float64); the whole tile is filtered at its true shape by a
    reflect-boundary convolution on the policy's device, one band at a
    time, and the bands summed.
    """

    def loadFilter(self):
        """Read the kernel, SIGNORM, BCKSCALE and the RW* weights from the
        kernel FITS."""
        data, header = nfits.read_image(self.filterFileName)
        self.kern2d = np.asarray(data, dtype=np.float64)
        self.signalNorm = header["SIGNORM"]
        self.bckSubScaleArcmin = header.get("BCKSCALE", 0)
        self.fRelWeights = {}
        for i in range(1, 10):
            if "RW%d_GHZ" % i in header:
                self.fRelWeights[header["RW%d_GHZ" % i]] = header["RW%d" % i]

    def buildKernel(self, RADecSection):
        """Build (or load, when its FITS exists) the kernel, the background
        scale and the signal norm and fRel weights."""
        if self.filterFileName is not None and \
                os.path.exists(self.filterFileName):
            return self.loadFilter()

        # the Fourier MF on the kernel sub-region, from the preprocessed
        # tile maps clipped to RADecSection
        from .utils.wcs import clipUsingRADecCoords
        RAMin, RAMax, decMin, decMax = RADecSection
        kernelDictList = []
        for mapDict in self.unfilteredMapsDictList:
            kd = {k: mapDict[k] for k in mapDict.keys()
                  if k not in ("data", "weights", "wcs", "surveyMask",
                               "pointSourceMask", "flagMask")}
            clip = clipUsingRADecCoords(np.asarray(mapDict["data"]),
                                        mapDict["wcs"], RAMin, RAMax,
                                        decMin, decMax)
            kd["data"] = clip["data"]
            kd["wcs"] = clip["wcs"]
            for key in ("weights", "surveyMask", "pointSourceMask",
                        "flagMask"):
                kd[key] = clipUsingRADecCoords(
                    np.asarray(mapDict[key]), mapDict["wcs"], RAMin, RAMax,
                    decMin, decMax)["data"]
            if kd["data"].size == 0:
                raise ValueError("Kernel RADecSection clip is empty - check "
                                 "noiseParams RADecSection")
            kernelDictList.append(kd)
        mfClassName = self.params["noiseParams"].get(
            "matchedFilterClass",
            self.__class__.__name__.replace("RealSpaceMatchedFilter",
                                            "MatchedFilter"))
        mfClass = getFilterClass(mfClassName)
        kernelLabel = "realSpaceKernel_%s" % self.label
        subDir = os.path.join(self.diagnosticsDir,
                              kernelLabel + "#" + self.tileName)
        os.makedirs(os.path.join(subDir, "diagnostics", self.tileName),
                    exist_ok=True)
        os.makedirs(os.path.join(subDir, "selFn", self.tileName),
                    exist_ok=True)
        matchedFilter = mfClass(kernelLabel, kernelDictList, self.params,
                                tileName=self.tileName,
                                diagnosticsDir=os.path.join(subDir,
                                                            "diagnostics"),
                                selFnDir=os.path.join(subDir, "selFn"),
                                policy=self.policy)
        matchedFilter.buildAndApply()

        kernelMaxArcmin = self.params["noiseParams"]["kernelMaxArcmin"]
        prof, arcminRange = matchedFilter.makeRealSpaceFilterProfile()
        rIndex = np.where(arcminRange > kernelMaxArcmin)[0][0]
        mask = arcminRange < kernelMaxArcmin

        # profile2d in float64 on the host, so that the device's float32
        # filter cannot move the window below by a pixel
        if self.params["noiseParams"].get("symmetrize", False):
            rRadians = np.radians(arcminRange / 60.0)
            radMap = fourier.radial_distance_map(
                matchedFilter.padShape, matchedFilter.pixScalesRad)
            profile2d = np.stack([
                np.interp(radMap, rRadians[mask], prof[i, mask], right=0.0)
                for i in range(prof.shape[0])])
        else:
            profile2d = np.fft.fftshift(
                np.fft.irfft2(matchedFilter._filtHost(),
                              s=matchedFilter.padShape), axes=(-2, -1))

        # an odd window around the |profile| maximum
        z, yy, xx = np.where(np.abs(profile2d) == np.abs(profile2d).max())
        y, x = yy[0], xx[0]
        yMin, yMax = y - rIndex, y + rIndex
        xMin, xMax = x - rIndex, x + rIndex
        if (yMax - yMin) % 2 == 0:
            yMin += 1
        if (xMax - xMin) % 2 == 0:
            xMin += 1
        self.kern2d = profile2d[:, yMin:yMax, xMin:xMax]

        if "bckSubScaleArcmin" in self.params:
            self.bckSubScaleArcmin = self.params["bckSubScaleArcmin"]
        else:
            func = np.min if prof[0, 0] > 0 else np.max
            self.bckSubScaleArcmin = float(
                arcminRange[prof[0] == func(prof[0])][0])

        # signal-norm calibration on the full-tile geometry
        signalMaps = []
        y0 = 2e-4
        for mapDict in self.unfilteredMapsDictList:
            if self.params["outputUnits"] == "yc":
                if mapDict["obsFreqGHz"] is not None:
                    amp = sz.convertToDeltaT(y0, mapDict["obsFreqGHz"])
                else:
                    amp = y0
                signalMaps.append(np.asarray(self.makeSignalTemplateMap(
                    mapDict["beamFileName"], amplitude=amp)))
            else:
                signalMaps.append(np.asarray(self.makeSignalTemplateMap(
                    mapDict["beamFileName"])))
        signalMaps = np.stack(signalMaps)
        filteredSignal = self.applyFilter(signalMaps, calcFRelWeights=True)
        if self.params["outputUnits"] == "yc":
            self.signalNorm = y0 / filteredSignal.max()
        else:
            self.signalNorm = 1.0 / filteredSignal.max()

        if self.filterFileName is not None:
            header = nfits.Header()
            header["SIGNORM"] = float(self.signalNorm)
            if self.params.get("bckSub"):
                header["BCKSCALE"] = float(self.bckSubScaleArcmin)
            for count, key in enumerate(self.fRelWeights, start=1):
                header["RW%d_GHZ" % count] = key
                header["RW%d" % count] = float(self.fRelWeights[key])
            os.makedirs(os.path.dirname(self.filterFileName), exist_ok=True)
            nfits.write_image(self.filterFileName,
                              np.asarray(self.kern2d, dtype=np.float32),
                              header)

        if self.diagnosticsDir is not None:
            self._saveKernelProfilePlot(prof, arcminRange, mask)

    def _saveKernelProfilePlot(self, prof, arcminRange, mask):
        """Kernel-profile diagnostics, written with every kernel build:
        the plotted data as ``filterProf1D_<label>#<tile>.npz`` and, where
        matplotlib is installed, the smoothed per-band 1-d profile plot
        ``filterPlot1D_<label>#<tile>.pdf`` (without it the plot is skipped
        with a warning; the kernel and its FITS never depend on it)."""
        from scipy import interpolate as sinterp
        os.makedirs(self.diagnosticsDir, exist_ok=True)
        np.savez(os.path.join(
            self.diagnosticsDir,
            "filterProf1D_%s#%s.npz" % (self.label, self.tileName)),
            arcminRange=arcminRange, prof=prof, mask=mask,
            bckSubScaleArcmin=self.bckSubScaleArcmin)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from . import plotSettings
            plotSettings.update_rcParams()
        except Exception as exc:  # plotting must never kill a survey run
            print("... WARNING: kernel-profile plot of %s#%s skipped: %s"
                  % (self.label, self.tileName, exc))
            return
        fig = plt.figure(figsize=(9, 6.5))
        plt.axes([0.13, 0.12, 0.86, 0.86])
        for row, mapDict in zip(prof, self.unfilteredMapsDictList):
            tck = sinterp.splrep(arcminRange[mask], row[mask])
            plotRange = np.linspace(0, arcminRange[mask].max(), 1000)
            if mapDict.get("obsFreqGHz") is not None:
                lineLabel = "%d GHz" % mapDict["obsFreqGHz"]
            else:
                lineLabel = "yc"
            plt.plot(plotRange, sinterp.splev(plotRange, tck), "-",
                     label=lineLabel)
        plt.xlabel("$\\theta$ (arcmin)")
        plt.ylabel("Amplitude")
        plt.legend()
        plt.xlim(0, arcminRange[mask].max())
        if self.params.get("bckSub"):
            plt.plot([self.bckSubScaleArcmin] * 3,
                     np.linspace(-1.2, 1.2, 3), "k--")
        plt.ylim(-1.2, 0.2)
        plt.savefig(os.path.join(
            self.diagnosticsDir,
            "filterPlot1D_%s#%s.pdf" % (self.label, self.tileName)))
        plt.close(fig)

    def _resolveRADecSection(self):
        """Kernel sub-region: the configured RADecSection, a per-tile box
        from the config's ``tileNoiseRegions`` (read back from the
        NRAMIN/NRAMAX/NDEMIN/NDEMAX tile headers), or an auto 4 x 4 deg box
        about the tile centre."""
        noiseParams = self.params["noiseParams"]
        if noiseParams["RADecSection"] == "tileNoiseRegions":
            h = self.wcs.header
            try:
                return [h["NRAMIN"], h["NRAMAX"], h["NDEMIN"], h["NDEMAX"]]
            except KeyError:
                raise ValueError(
                    "noiseParams RADecSection is 'tileNoiseRegions' but "
                    "tile %s carries no NRAMIN/NRAMAX/NDEMIN/NDEMAX "
                    "headers - add a top-level tileNoiseRegions section "
                    "to the config (see the reference's "
                    "examples/sources/PS_f220_nightOnly.yml)"
                    % self.tileName)
        if noiseParams["RADecSection"] == "auto":
            cRA, cDec = self.wcs.getCentreWCSCoords()
            half = 2.0
            return [cRA - half / np.cos(np.radians(cDec)),
                    cRA + half / np.cos(np.radians(cDec)),
                    cDec - half, cDec + half]
        return noiseParams["RADecSection"]

    def buildAndApply(self, useCachedFilter=False, undoPixelWindow=False):
        P = self.policy
        params = self.params
        self._undoneWindow = False
        surveyMask = np.asarray(self.unfilteredMapsDictList[0]["surveyMask"])
        psMask = np.asarray(self.unfilteredMapsDictList[0]["pointSourceMask"])

        with timing.span("buildKernel"):
            self.buildKernel(self._resolveRADecSection())

        dataStack = np.stack([np.asarray(m["data"], dtype=np.float64)
                              for m in self.unfilteredMapsDictList])
        validHost = (dataStack != 0).all(axis=0)
        if not validHost.all():
            # ragged data coverage: the coverage-edge trim (no FFT here,
            # so the kernel's compact support needs no taper)
            _, keep = raggedEdgeArrays(validHost, self.apodPix,
                                       self._trimSizePix(),
                                       gridPix=self._noiseGridPix())
            surveyMask = surveyMask * keep
        filteredMap = self.applyFilter(dataStack)

        filteredMap = filteredMap * psMask
        RMSMap = self.makeNoiseMap(filteredMap)
        validMask = RMSMap > 0
        SNMap = np.array(filteredMap)
        SNMap[validMask] = SNMap[validMask] / RMSMap[validMask]

        if params["outputUnits"] == "yc":
            mapUnits = "yc"
            combinedObsFreqGHz = "yc"
            beamSolidAngle_nsr = 0.0
        else:
            combinedObsFreqGHz = float(list(self.beamSolidAnglesDict)[0])
            mapUnits = "uK"
            beamSolidAngle_nsr = self.beamSolidAnglesDict[combinedObsFreqGHz]

        trimSizePix = self._trimSizePix()
        if trimSizePix > 0:
            edgeCheck = imageops.minimum_filter(
                torch.abs(P.tensor(filteredMap) + P.tensor(1 - psMask)),
                trimSizePix).cpu().numpy()
            edgeCheck = (edgeCheck > 0).astype(float)
        else:
            edgeCheck = np.ones(filteredMap.shape)
        filteredMap = filteredMap * edgeCheck
        surveyMask = edgeCheck * surveyMask * psMask

        apodMask = fourier.apod_mask(filteredMap.shape,
                                     self.apodPix).numpy() == 1
        surveyMask = surveyMask * apodMask
        SNMap = SNMap * surveyMask
        SNMap[np.isnan(SNMap)] = 0.0
        RMSMap = RMSMap * surveyMask

        if params.get("saveRMSMap"):
            self.saveRMSMap(RMSMap)

        return {"data": np.asarray(filteredMap), "wcs": self.wcs,
                "obsFreqGHz": combinedObsFreqGHz,
                "SNMap": np.asarray(SNMap), "surveyMask": surveyMask,
                "flagMask": self.flagMask, "mapUnits": mapUnits,
                "beamSolidAngle_nsr": beamSolidAngle_nsr, "label": self.label,
                "tileName": self.tileName}

    def applyFilter(self, mapDataToFilter, calcFRelWeights=False):
        """Background subtraction per band (``bckSub``), then each band
        convolved with its kernel on the policy's device and the bands
        summed; host numpy in (or a tensor) and out.  With
        ``calcFRelWeights`` every band's weight is read at the pixel where
        the band sum peaks."""
        P = self.policy
        if isinstance(mapDataToFilter, torch.Tensor):
            mapDataToFilter = mapDataToFilter.cpu().numpy()
        filtered = np.asarray(mapDataToFilter)
        if self.params.get("bckSub") and self.bckSubScaleArcmin > 0:
            from . import maps as maps_mod
            filtered = np.stack([maps_mod.subtractBackground(
                band, self.wcs, smoothScaleDeg=self.bckSubScaleArcmin / 60.0,
                policy=P) for band in filtered])

        out = torch.stack([
            imageops.convolve2d_reflect(P.tensor(band), P.tensor(kern))
            for band, kern in zip(filtered, self.kern2d)]).cpu().numpy()

        if calcFRelWeights:
            total2d = out.sum(axis=0)
            maxIndex = np.argmax(total2d)
            totalSignal = total2d.flatten()[maxIndex]
            self.fRelWeights = {}
            for plane, mapDict in zip(out, self.unfilteredMapsDictList):
                self.fRelWeights[mapDict["obsFreqGHz"]] = float(
                    plane.flatten()[maxIndex] / totalSignal)

        return out.sum(axis=0) * self.signalNorm


# Template mixins

class BeamFilter(MapFilter):
    def makeSignalTemplateMap(self, beamFileName, amplitude=None,
                              returnDevice=False):
        return profiles.makeBeamModelSignalMap(
            self.shape, self.pixScalesRad, beamFileName, amplitude=amplitude,
            returnDevice=returnDevice, device=self.policy.device,
            dtype=self.policy.dtype)


class ArnaudModelFilter(MapFilter):
    def makeSignalTemplateMap(self, beamFileName, amplitude=None,
                              returnDevice=False):
        return profiles.makeArnaudModelSignalMap(
            self.params["z"], self.params["M500MSun"], self.shape,
            self.pixScalesRad, beam=beamFileName,
            GNFWParams=self.params.get("GNFWParams", "default"),
            amplitude=amplitude, convolveWithBeam=True,
            returnDevice=returnDevice, device=self.policy.device,
            dtype=self.policy.dtype)


class BattagliaModelFilter(MapFilter):
    def makeSignalTemplateMap(self, beamFileName, amplitude=None,
                              returnDevice=False):
        return profiles.makeBattagliaModelSignalMap(
            self.params["z"], self.params["M500MSun"], self.shape,
            self.pixScalesRad, beam=beamFileName,
            GNFWParams=self.params.get("GNFWParams", "default"),
            amplitude=amplitude, convolveWithBeam=True,
            returnDevice=returnDevice, device=self.policy.device,
            dtype=self.policy.dtype)


class ArnaudModelMatchedFilter(MatchedFilter, ArnaudModelFilter):
    pass


class BattagliaModelMatchedFilter(MatchedFilter, BattagliaModelFilter):
    pass


class BeamMatchedFilter(MatchedFilter, BeamFilter):
    pass


class ArnaudModelRealSpaceMatchedFilter(RealSpaceMatchedFilter,
                                        ArnaudModelFilter):
    pass


class BattagliaModelRealSpaceMatchedFilter(RealSpaceMatchedFilter,
                                           BattagliaModelFilter):
    pass


class BeamRealSpaceMatchedFilter(RealSpaceMatchedFilter, BeamFilter):
    pass


FILTER_REGISTRY = {
    "ArnaudModelMatchedFilter": ArnaudModelMatchedFilter,
    "BattagliaModelMatchedFilter": BattagliaModelMatchedFilter,
    "BeamMatchedFilter": BeamMatchedFilter,
    "ArnaudModelRealSpaceMatchedFilter": ArnaudModelRealSpaceMatchedFilter,
    "BattagliaModelRealSpaceMatchedFilter":
        BattagliaModelRealSpaceMatchedFilter,
    "BeamRealSpaceMatchedFilter": BeamRealSpaceMatchedFilter,
}


def getFilterClass(name):
    """Registry-based dispatch replacing the reference's ``eval``."""
    if name not in FILTER_REGISTRY:
        raise KeyError("Unknown filter class '%s' (available: %s)"
                       % (name, sorted(FILTER_REGISTRY)))
    return FILTER_REGISTRY[name]
