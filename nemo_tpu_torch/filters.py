"""Matched-filter engine (Fourier-space MMF) on torch tensors.

Port of ``nemo_tpu/filters.py``; the class structure mirrors it (and the
reference ``nemo/filters.py``) so configs and call sites translate
directly:

* :class:`MapFilter` - base class (geometry, beams, noise-map estimation);
* :class:`MatchedFilter` - Fourier-space multi-frequency matched filter;
* the Beam/ArnaudModel/BattagliaModel template mixins and the concrete
  classes, resolved through :data:`FILTER_REGISTRY`.

Every array step runs on the :class:`~nemo_tpu_torch.device.Policy`'s
device and dtype: the FFTs (cuFFT on the card), the noise covariance and
its smoothing, the closed-form per-pixel solve, the signal calibration, and
the post-filter chain whose grid RMS runs through the CUDA kernel
``csrc/rms_cells.cu``.  The built filter persists in the same
``filter_*.fits`` cache as the JAX package, so a filter built by either
package is applied by the other.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
the real-space matched filter, the 'model' and 'max(dataMap,CMB)' noise
methods, noise-model catalogs, and filters applied to a map of another
shape (``reshapeFilter``).
"""

import os

import numpy as np
import torch

from . import device as device_mod
from .models import profiles, sz
from .models.beams import BeamProfile
from .ops import fourier, imageops, interp
from .ops import noise as noise_ops
from .ops import solve as solve_ops
from .utils import fits as nfits
from .utils.timing import GLOBAL_TIMER

_SIMS_TODO = "not ported yet (ROADMAP.md queue 1, item 10: sims and injection)"
_REST_TODO = "not ported yet (ROADMAP.md queue 1, item 11: the rest)"


# ----------------------------------------------------------------------------
def filterMaps(unfilteredMapsDictList, filterParams, tileName,
               diagnosticsDir=".", selFnDir=".", verbose=True,
               undoPixelWindow=True, useCachedFilter=False,
               returnFilter=False, policy=device_mod.CPU):
    """Build and apply a filter to the unfiltered map(s) for one tile,
    including the pixel-window deconvolution of the output signal map."""
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


# ----------------------------------------------------------------------------
class MapFilter:
    """Base class: holds the preprocessed per-frequency tile maps plus the
    geometry and beam metadata needed to build filters."""

    def __init__(self, label, unfilteredMapsDictList, paramsDict,
                 tileName="PRIMARY", diagnosticsDir=None, selFnDir=None,
                 geometryOnly=False, policy=device_mod.CPU):
        """``geometryOnly=True`` skips the per-tile map preprocessing and
        derives (shape, wcs) from the tile coords alone, for consumers that
        only load + apply a cached filter."""
        self.label = label
        self.params = dict(paramsDict)
        self.tileName = tileName
        self.diagnosticsDir = diagnosticsDir
        self.selFnDir = selFnDir
        self.policy = policy
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
                with GLOBAL_TIMER.stage("preprocess"):
                    newDict.preprocess(tileName=tileName,
                                       diagnosticsDir=diagnosticsDir)
            self.unfilteredMapsDictList.append(newDict)
        self.geometryOnly = geometryOnly and geometry is not None
        if self.geometryOnly:
            self.shape, self.wcs = geometry
        else:
            self.wcs = self.unfilteredMapsDictList[0]["wcs"]
            self.shape = self.unfilteredMapsDictList[0]["data"].shape

        self.flagMask = np.zeros(self.shape, dtype=int)
        if not self.geometryOnly:
            for i, mapDict in enumerate(self.unfilteredMapsDictList):
                self.flagMask = self.flagMask + (
                    np.asarray(mapDict["flagMask"]) * (i + 1))

        # beam solid angles for Jy conversions
        self.beamSolidAnglesDict = {}
        for mapDict in self.unfilteredMapsDictList:
            if "solidAngle_nsr" in mapDict and mapDict["solidAngle_nsr"]:
                sa = mapDict["solidAngle_nsr"]
            else:
                sa = BeamProfile(
                    beamFileName=mapDict["beamFileName"]).solidAngle_nsr
            self.beamSolidAnglesDict[mapDict["obsFreqGHz"]] = sa

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
        """Read the filter state from the ``filter_*.fits`` cache."""
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


def _build_filter_core(noiseStack, fSignalsAbs, w, apodM, padShape=None):
    """noiseStack: (nf, ny, nx) real maps used for the noise model.
    fSignalsAbs: (nf, pny, pnx//2+1) |FFT| of unit-normalised signal
    templates on the padded grid; w: (nf,) weights.  Returns filt
    (nf, pny, pnx//2+1)."""
    nf = noiseStack.shape[0]
    m = noiseStack * apodM[None]
    if padShape is not None:
        m = fourier.pad_to(m, padShape)
    fNoise = fourier.rfft2(m)
    # N_ij = smooth3(Re(F_i conj F_j)), smoothed as the reference smooths
    # the FULL grid (Hermitian extension of the half grid)
    prods = torch.real(fNoise[:, None] * torch.conj(fNoise[None, :]))
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
        # filter is always reused
        if self.filterFileName is not None and \
                os.path.exists(self.filterFileName):
            self.loadFilter()
            self.params["saveRMSMap"] = False
            self.params["saveFilter"] = False
            self.params["savePlots"] = False
        else:
            with GLOBAL_TIMER.stage("buildFilter"):
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
            with GLOBAL_TIMER.stage("applyFilter+noise"):
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
            RMSFileName = os.path.join(
                self.selFnDir, self.tileName,
                "RMSMap_%s#%s.fits" % (self.label, self.tileName))
            os.makedirs(os.path.dirname(RMSFileName), exist_ok=True)
            nfits.write_image(RMSFileName, RMSMap, self.wcs.header,
                              compressionType="RICE_1")
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
        """Maps whose power defines the noise covariance ('dataMap')."""
        method = self.params["noiseParams"]["method"]
        if method == "dataMap":
            if self.params.get("noiseModelCatalog"):
                raise NotImplementedError(
                    "noiseModelCatalog (model images subtracted from the "
                    "noise maps) is " + _SIMS_TODO)
            return dataStack
        if method in ("model", "max(dataMap,CMB)"):
            raise NotImplementedError(
                "noiseParams method '%s' needs the CMB sims, %s"
                % (method, _SIMS_TODO))
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
        self.filt = _build_filter_core(noiseStack, fSignalsAbs, w, apodM,
                                       self.padShape)
        self._calibrateSignalNorm()

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
        raise NotImplementedError(
            "applying a filter to a map of another shape (reshapeFilter) "
            "is " + _REST_TODO)

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
        if tuple(fMaps.shape[-3:]) != self._filtShape():
            self.reshapeFilter(fMaps.shape[-3:])
        filteredDev = fourier.crop_to(_apply_filter_fourier(
            fMaps, self.filt, self.padShape), outShape)
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
    """Truncated real-space kernel matched filter: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the real-space matched filter is "
                                  + _REST_TODO)


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
