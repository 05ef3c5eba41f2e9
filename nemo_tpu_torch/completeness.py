"""Survey selection function and completeness.

Port of ``nemo_tpu/completeness.py`` (a rebuild of ``nemo/completeness.py``):
the SelFn object loads the noise (RMS) tables, area masks, Q and fRel
weights produced by the main pipeline and recomputes the completeness on a
(log10M, z) grid for any cosmology + scaling-relation parameters - the hot
path for cosmological inference (called per MCMC step).  Host numpy, as in
the JAX package, apart from the device it is given: :class:`SelFn`, the
mass-limit maps and the mock surveys they build solve the Boltzmann
transfer function on ``device`` (the config's device in the pipeline).
"""

import os

import numpy as np
from scipy import interpolate, stats

from . import catalogs, maps, startup
from .mock import MockSurvey
from .models.qfit import QFit
from .utils import fits as nfits
from .utils.tables import Table, vstack
from .utils.wcs import WCS


class FootprintError(Exception):
    pass


# -----------------------------------------------------------------------------
def _loadTile(tileName, baseDir, baseFileName, extension="fits"):
    """Load a tile image from MEF-or-per-tile-file layouts
    (``completeness.py:797-828``)."""
    cand1 = os.path.join(baseDir, "%s#%s.%s" % (baseFileName, tileName,
                                                extension))
    cand2 = os.path.join(baseDir, tileName,
                         "%s#%s.%s" % (baseFileName, tileName, extension))
    cand3 = os.path.join(baseDir, "%s.%s" % (baseFileName, extension))
    for fileName in (cand1, cand2, cand3):
        if os.path.exists(fileName):
            break
    else:
        raise FileNotFoundError("No %s found for tile %s under %s"
                                % (baseFileName, tileName, baseDir))
    # Prefer the extension named after the tile; else first with data.
    # read_image seeks to (and decodes) only the wanted extension - a
    # fused survey MEF holds one extension per tile, and loading them
    # all per call made the per-tile loaders O(N^2) across a run.
    try:
        data, header = nfits.read_image(fileName, ext=tileName)
    except nfits.ExtensionNotFound:
        # per-tile files carry no EXTNAME: take the first image HDU.
        # (Only this exact miss falls through - a KeyError raised while
        # DECODING a malformed tile-named extension must propagate, not
        # silently return the wrong tile's data.)
        data, header = nfits.read_image(fileName)
    return np.asarray(data), WCS(header)


def loadAreaMask(tileName, selFnDir):
    return _loadTile(tileName, selFnDir, "areaMask")


def loadFlagMask(tileName, selFnDir):
    return _loadTile(tileName, selFnDir, "flagMask")


def loadRMSMap(tileName, selFnDir, photFilter):
    return _loadTile(tileName, selFnDir, "RMSMap_%s" % photFilter)


def loadIntersectionMask(tileName, selFnDir, footprint):
    return _loadTile(tileName, selFnDir, "intersect_%s" % footprint)


def loadMassLimitMap(tileName, diagnosticsDir, z):
    """Mass-limit map for a tile at redshift z, as written by
    :func:`makeMassLimitMap` (``completeness.py:756-775``).

    Returns (map array, WCS)."""
    return _loadTile(tileName, diagnosticsDir,
                     "massLimitMap_z%s" % str(z).replace(".", "p"))


def getTileTotalAreaDeg2(tileName, selFnDir, masksList=[],
                         footprintLabel=None):
    """Tile area in deg^2 after masking (``completeness.py:831-859``)."""
    areaMap, wcs = loadAreaMask(tileName, selFnDir)
    areaMapSqDeg = (maps.getPixelAreaArcmin2Map(areaMap.shape, wcs)
                    * areaMap) / 3600.0
    total = areaMapSqDeg.sum()
    if footprintLabel is not None:
        intersectMask = makeIntersectionMask(tileName, selFnDir,
                                             footprintLabel,
                                             masksList=masksList)
        total = (areaMapSqDeg * intersectMask).sum()
    return float(total)


def makeIntersectionMask(tileName, selFnDir, label, masksList=[]):
    """Intersection of the survey mask with external footprint masks
    (``completeness.py:862-946``); cached on disk."""
    mef = os.path.join(selFnDir, "intersect_%s.fits" % label)
    perTile = os.path.join(selFnDir, tileName,
                           "intersect_%s#%s.fits" % (label, tileName))
    if os.path.exists(mef) or os.path.exists(perTile):
        mask, _ = loadIntersectionMask(tileName, selFnDir, label)
        return mask
    if not masksList:
        raise ValueError("No cached intersection mask and empty masksList")
    areaMap, wcs = loadAreaMask(tileName, selFnDir)
    intersectMask = np.zeros(areaMap.shape)
    ny, nx = areaMap.shape
    coordsX = wcs.pix2wcs(np.arange(nx, dtype=float), np.zeros(nx))
    coordsY = wcs.pix2wcs(np.zeros(ny), np.arange(ny, dtype=float))
    outRA = coordsX[:, 0]
    outDec = coordsY[:, 1]
    for fileName in masksList:
        maskData, header = nfits.read_image(fileName)
        maskWCS = WCS(header)
        pix = maskWCS.wcs2pix(outRA, np.zeros(nx))
        xIn = np.round(pix[:, 0]).astype(int)
        pixY = maskWCS.wcs2pix(np.full(ny, outRA[nx // 2]), outDec)
        yIn = np.round(pixY[:, 1]).astype(int)
        xOK = (xIn >= 0) & (xIn < maskData.shape[1])
        yOK = (yIn >= 0) & (yIn < maskData.shape[0])
        sub = np.zeros(areaMap.shape)
        sub[np.ix_(yOK, xOK)] = maskData[np.ix_(yIn[yOK], xIn[xOK])]
        intersectMask = np.maximum(intersectMask, sub)
    intersectMask = (intersectMask > 0.5).astype(int)
    os.makedirs(os.path.dirname(perTile), exist_ok=True)
    nfits.write_image(perTile, (intersectMask * areaMap).astype(np.uint8),
                      wcs.header, compressionType="PLIO_1")
    return intersectMask


def getRMSTab(tileName, photFilterLabel, selFnDir, footprintLabel=None):
    """Noise level vs survey area table (``completeness.py:949-1005``)."""
    RMSTabFileName = os.path.join(selFnDir, "RMSTab.fits")
    if footprintLabel is not None:
        RMSTabFileName = RMSTabFileName.replace(
            ".fits", "_%s.fits" % footprintLabel)
    if os.path.exists(RMSTabFileName):
        tab = Table.read(RMSTabFileName)
        return tab[np.asarray(tab["tileName"]) == tileName]

    RMSMap, wcs = loadRMSMap(tileName, selFnDir, photFilterLabel)
    areaMap, wcs = loadAreaMask(tileName, selFnDir)
    areaMapSqDeg = (maps.getPixelAreaArcmin2Map(areaMap.shape, wcs)
                    * areaMap) / 3600.0
    if footprintLabel is not None:
        intersectMask = makeIntersectionMask(tileName, selFnDir,
                                             footprintLabel)
        areaMapSqDeg = areaMapSqDeg * intersectMask
        RMSMap = RMSMap * intersectMask

    RMSValues, inverse = np.unique(RMSMap[RMSMap != 0], return_inverse=True)
    tileArea = np.bincount(inverse, weights=areaMapSqDeg[RMSMap != 0],
                           minlength=len(RMSValues))
    RMSTab = Table({"areaDeg2": tileArea, "y0RMS": RMSValues})
    tol = 0.003
    if abs(tileArea.sum() - areaMapSqDeg.sum()) > tol:
        raise ValueError("Area mismatch between areaMask and RMSTab for "
                         "tile '%s'" % tileName)
    if np.any(tileArea < 0):
        raise ValueError("Negative area in tile '%s'" % tileName)
    return RMSTab


def downsampleRMSTab(RMSTab, stepSize=0.001 * 1e-4):
    """Rebin an RMS table in noise (``completeness.py:1008-1037``)."""
    y0 = np.asarray(RMSTab["y0RMS"])
    area = np.asarray(RMSTab["areaDeg2"])
    binEdges = np.arange(y0.min(), y0.max() + stepSize, stepSize)
    y0Binned, areaBinned = [], []
    for i in range(max(len(binEdges) - 1, 1)):
        if len(binEdges) > 1:
            sel = (y0 >= binEdges[i]) & (y0 < binEdges[i + 1])
        else:
            sel = np.ones(len(y0), dtype=bool)
        if sel.sum() > 0:
            y0Binned.append(np.average(y0[sel], weights=area[sel]))
            areaBinned.append(area[sel].sum())
    return Table({"y0RMS": np.array(y0Binned),
                  "areaDeg2": np.array(areaBinned)})


def calcTileWeightedAverageNoise(tileName, photFilterLabel, selFnDir,
                                 footprintLabel=None):
    """Area-weighted average y0~ noise in a tile
    (``completeness.py:1040-1064``)."""
    RMSTab = getRMSTab(tileName, photFilterLabel, selFnDir,
                       footprintLabel=footprintLabel)
    return float(np.average(np.asarray(RMSTab["y0RMS"]),
                            weights=np.asarray(RMSTab["areaDeg2"])))


# -----------------------------------------------------------------------------
def _parseSourceInjectionData(injTab, inputTab, SNRCut):
    """Injection-sim completeness(theta, y0) grid + injection-derived Q
    (``completeness.py:653-693``)."""
    theta500s = np.unique(np.asarray(inputTab["theta500Arcmin"]))
    inFlux = np.asarray(inputTab["inFlux"])
    binEdges = np.linspace(inFlux.min(), inFlux.max(), 101)
    binCentres = (binEdges[1:] + binEdges[:-1]) / 2
    compThetaGrid = np.zeros((len(theta500s), len(binCentres)))
    thetaQ = np.zeros(len(theta500s))
    for i, t in enumerate(theta500s):
        injSel = (np.asarray(injTab["theta500Arcmin"]) == t) & \
            (np.asarray(injTab["SNR"]) > SNRCut)
        inputSel = np.asarray(inputTab["theta500Arcmin"]) == t
        injFlux = np.asarray(injTab["inFlux"])[injSel]
        outFlux = np.asarray(injTab["outFlux"])[injSel]
        recN, _ = np.histogram(injFlux, bins=binEdges)
        inpN, _ = np.histogram(inFlux[inputSel], bins=binEdges)
        valid = inpN > 0
        compThetaGrid[i][valid] = recN[valid] / inpN[valid]
        if len(outFlux) > 0:
            thetaQ[i] = np.median(outFlux / injFlux)
    return theta500s, binCentres, compThetaGrid, thetaQ


# -----------------------------------------------------------------------------
class SelFn:
    """Survey selection function (``completeness.py:46-649``)."""

    def __init__(self, selFnDir, SNRCut, configFileName=None, footprint=None,
                 zStep=0.01, zMax=3.0, tileNames=None,
                 enableDrawSample=False, mockOversampleFactor=1.0,
                 downsampleRMS=True, applyMFDebiasCorrection=True,
                 applyRelativisticCorrection=True, setUpAreaMask=False,
                 enableCompletenessCalc=True, delta=500, rhoType="critical",
                 massFunction="Tinker08", maxTheta500Arcmin=None,
                 method="fast", QSource="fit", noiseCut=None,
                 biasModel=None, device="cuda"):
        self.SNRCut = SNRCut
        self.device = str(device)
        self.biasModel = biasModel
        self.footprint = None if footprint == "full" else footprint
        self.downsampleRMS = downsampleRMS
        self.applyMFDebiasCorrection = applyMFDebiasCorrection
        self.applyRelativisticCorrection = applyRelativisticCorrection
        self.selFnDir = selFnDir
        self.zStep = zStep
        self.maxTheta500Arcmin = maxTheta500Arcmin
        self.method = method

        if configFileName is None:
            configFileName = os.path.join(selFnDir, "config.yml")
            if not os.path.exists(configFileName):
                raise FileNotFoundError("No config.yml in selFnDir")
        self._config = startup.NemoConfig(configFileName,
                                          makeOutputDirs=False,
                                          setUpMaps=False, verbose=False,
                                          selFnDir=selFnDir,
                                          device=self.device)
        parDict = self._config.parDict
        self.tileNames = tileNames if tileNames is not None \
            else self._config.tileNames
        self.photFilterLabel = parDict["photFilter"]

        if self.footprint is not None:
            labels = [f["label"]
                      for f in parDict.get("selFnFootprints", [])]
            if self.footprint not in labels:
                raise ValueError("Footprint '%s' not defined in config"
                                 % self.footprint)

        self.tileTab = None
        self.WCSDict = None
        self.areaMaskDict = None
        if setUpAreaMask:
            self._setUpAreaMask()

        if enableCompletenessCalc:
            self.scalingRelationDict = parDict["massOptions"]
            defaults = {"H0": 70.0, "Om0": 0.30, "Ob0": 0.05,
                        "sigma8": 0.8, "ns": 0.95}
            for key, val in defaults.items():
                self.scalingRelationDict.setdefault(key, val)

            RMSTabFileName = os.path.join(self.selFnDir, "RMSTab.fits")
            if self.footprint is not None:
                RMSTabFileName = RMSTabFileName.replace(
                    ".fits", "_%s.fits" % self.footprint)
            if not os.path.exists(RMSTabFileName):
                raise FootprintError(RMSTabFileName)
            self.RMSTab = Table.read(RMSTabFileName)
            self.RMSTab = self.RMSTab[
                np.asarray(self.RMSTab["areaDeg2"]) > 0]
            if noiseCut is not None:
                self.RMSTab = self.RMSTab[
                    np.asarray(self.RMSTab["y0RMS"]) < noiseCut]
            self.RMSDict = {}
            keptTiles = []
            totalAreaDeg2 = 0.0
            for tileName in self.tileNames:
                tileTab = self.RMSTab[
                    np.asarray(self.RMSTab["tileName"]) == tileName]
                if downsampleRMS and len(tileTab) > 0:
                    tileTab = downsampleRMSTab(tileTab)
                if len(tileTab) > 0:
                    self.RMSDict[tileName] = tileTab
                    keptTiles.append(tileName)
                    totalAreaDeg2 += float(np.sum(tileTab["areaDeg2"]))
            self.tileNames = keptTiles
            self.totalAreaDeg2 = totalAreaDeg2
            self.tileAreas = np.array(
                [float(np.sum(np.asarray(self.RMSTab["areaDeg2"])[
                    np.asarray(self.RMSTab["tileName"]) == t]))
                 for t in self.tileNames])
            self.fracArea = self.tileAreas / self.totalAreaDeg2

            self.mockOversampleFactor = mockOversampleFactor
            self.y0NoiseAverageDict = {}
            for tileName in self.tileNames:
                t = self.RMSDict[tileName]
                w = np.asarray(t["areaDeg2"])
                self.y0NoiseAverageDict[tileName] = float(
                    np.average(np.asarray(t["y0RMS"]), weights=w))

            fRelPath = os.path.join(self.selFnDir, "fRelWeights.fits")
            if os.path.exists(fRelPath):
                self.fRelDict = loadFRelWeights(fRelPath)
            else:
                self.fRelDict = {t: {148.0: 1.0} for t in self.tileNames}

            if self.method == "injection":
                injTab = Table.read(os.path.join(
                    self.selFnDir, "sourceInjectionData.fits"))
                inputTab = Table.read(os.path.join(
                    self.selFnDir, "sourceInjectionInputCatalog.fits"))
                theta500s, binCentres, compThetaGrid, thetaQ = \
                    _parseSourceInjectionData(injTab, inputTab, self.SNRCut)
                self.compThetaInterpolator = \
                    interpolate.RectBivariateSpline(theta500s, binCentres,
                                                    compThetaGrid, kx=3,
                                                    ky=3)

            self.Q = QFit(QSource=QSource, selFnDir=self.selFnDir,
                          tileNames=keptTiles)

            H0 = self.scalingRelationDict["H0"]
            Om0 = self.scalingRelationDict["Om0"]
            Ob0 = self.scalingRelationDict["Ob0"]
            sigma8 = self.scalingRelationDict["sigma8"]
            ns = self.scalingRelationDict["ns"]
            self.mockSurvey = MockSurvey(5e13, self.totalAreaDeg2, 0.0, zMax,
                                         H0, Om0, Ob0, sigma8, ns,
                                         zStep=self.zStep,
                                         enableDrawSample=enableDrawSample,
                                         delta=delta, rhoType=rhoType,
                                         massFunction=massFunction,
                                         transferFunction=self
                                         .scalingRelationDict.get(
                                             "transferFunction",
                                             "boltzmann_camb"),
                                         device=self.device)
            self.update(H0, Om0, Ob0, sigma8, ns)

    # ------------------------------------------------------------------
    def _setUpAreaMask(self):
        self.WCSDict = {}
        self.areaMaskDict = {}
        self.tileTab = Table({"tileName": np.array(list(self.tileNames))})
        for tileName in self.tileNames:
            if self.footprint is None:
                areaMap, wcs = loadAreaMask(tileName, self.selFnDir)
            else:
                areaMap, wcs = loadIntersectionMask(tileName, self.selFnDir,
                                                    self.footprint)
            self.WCSDict[tileName] = wcs
            self.areaMaskDict[tileName] = areaMap
        self.tileTab = self.tileTab  # placeholder for RA/dec ranges

    def checkCoordsInAreaMask(self, RADeg, decDeg):
        """True where coords land on valid survey area
        (``completeness.py:341-375``)."""
        if self.WCSDict is None:
            self._setUpAreaMask()
        RADeg = np.atleast_1d(np.asarray(RADeg, dtype=float))
        decDeg = np.atleast_1d(np.asarray(decDeg, dtype=float))
        inMask = np.zeros(len(RADeg), dtype=bool)
        for tileName in self.tileNames:
            wcs = self.WCSDict[tileName]
            areaMask = self.areaMaskDict[tileName]
            if areaMask.sum() == 0:
                continue
            coords = wcs.wcs2pix(RADeg, decDeg)
            x = np.round(coords[:, 0]).astype(int)
            y = np.round(coords[:, 1]).astype(int)
            ok = (x >= 0) & (y >= 0) & (x < areaMask.shape[1]) & \
                 (y < areaMask.shape[0])
            sel = np.where(ok)[0]
            inMask[sel] |= areaMask[y[sel], x[sel]] > 0
        return inMask

    def cutCatalogToSurveyArea(self, catalog):
        raKey, decKey = catalogs.getTableRADecKeys(catalog)
        return catalog[self.checkCoordsInAreaMask(catalog[raKey],
                                                  catalog[decKey])]

    # ------------------------------------------------------------------
    def update(self, H0, Om0, Ob0, sigma8, ns, scalingRelationDict=None):
        """Recompute compMz for new parameters (``completeness.py:378-460``)."""
        if scalingRelationDict is not None:
            self.scalingRelationDict = scalingRelationDict
        self.mockSurvey.update(H0, Om0, Ob0, sigma8, ns)

        if self.method == "injection":
            y0Grid, theta500Grid = self._makeSignalGrids(applyQ=False)
            compMz = np.zeros(y0Grid.shape)
            for i in range(y0Grid.shape[0]):
                compMz[i] = np.array(
                    [self.compThetaInterpolator(theta500Grid[i][j],
                                                y0Grid[i][j] / 1e-4)[0][0]
                     for j in range(y0Grid.shape[1])])
            self.compMz = np.clip(compMz, 0, 1)
            self.y0TildeGrid = self.Q.getQ(theta500Grid) * y0Grid
            # Intrinsic scatter: smear the HMF counts along the mass axis
            # in log-y0 units (reference completeness.py:412-424)
            sigma_int = self.scalingRelationDict["sigma_int"]
            if sigma_int > 0:
                from scipy.ndimage import gaussian_filter1d
                logy0Grid = np.log(y0Grid)
                for i in range(logy0Grid.shape[0]):
                    dy = np.mean(np.gradient(logy0Grid[i]))
                    if dy > 0:
                        npix = 0.8 * sigma_int / dy
                        self.mockSurvey.clusterCount[i] = gaussian_filter1d(
                            self.mockSurvey.clusterCount[i], npix,
                            mode="nearest", truncate=4.0)
        else:
            compMzCube = []
            y0GridCube = []
            for tileName in self.RMSDict:
                y0Grid, theta500Grid = self._makeSignalGrids(
                    tileName=tileName)
                RMSTab = self.RMSDict[tileName]
                area = np.asarray(RMSTab["areaDeg2"])
                areaWeights = area / area.sum()
                y0RMS = np.asarray(RMSTab["y0RMS"])
                y0Lim = self.SNRCut * y0RMS
                # Vectorised area-weighted survival-function sum
                # (completeness.py:439-451) over noise bins
                compMz = np.zeros(y0Grid.shape)
                for i in range(len(y0RMS)):
                    if self.biasModel is not None:
                        trueSNR = y0Grid / y0RMS[i]
                        corr = self.biasModel["func"](
                            trueSNR, *self.biasModel["params"])
                    else:
                        corr = 1.0
                    totalErr = np.sqrt((y0RMS[i] / y0Grid) ** 2
                                       + self.scalingRelationDict[
                                           "sigma_int"] ** 2)
                    sfi = stats.norm.sf(y0Lim[i], loc=y0Grid * corr,
                                        scale=totalErr * (y0Grid * corr))
                    compMz = compMz + sfi * areaWeights[i]
                if self.maxTheta500Arcmin is not None:
                    compMz = compMz * (theta500Grid
                                       < self.maxTheta500Arcmin)
                compMzCube.append(compMz)
                y0GridCube.append(y0Grid)
            self.compMz = np.average(np.array(compMzCube), axis=0,
                                     weights=self.fracArea)
            self.y0TildeGrid = np.average(np.array(y0GridCube), axis=0,
                                          weights=self.fracArea)

    def _makeSignalGrids(self, applyQ=True, tileName=None):
        """y0~(M, z) and theta500(M, z) grids (``completeness.py:463-497``)."""
        ms = self.mockSurvey
        tenToA0 = self.scalingRelationDict["tenToA0"]
        B0 = self.scalingRelationDict["B0"]
        Mpivot = self.scalingRelationDict["Mpivot"]
        y0Grid = np.zeros((len(ms.z), len(ms.log10M)))
        theta500Grid = np.zeros_like(y0Grid)
        for k in range(len(ms.z)):
            zk = ms.z[k]
            if ms.delta != 500 or ms.rhoType != "critical":
                log10M500s = np.log10(ms._toM500c(ms.M, zk))
            else:
                log10M500s = ms.log10M
            theta500s = interpolate.splev(log10M500s,
                                          ms.theta500Splines[k])
            Qs = self.Q.getQ(theta500s, zk, tileName=tileName)
            y0 = tenToA0 * ms.Ez[k] ** 2 * (ms.M / Mpivot) ** (1 + B0)
            if applyQ:
                y0 = y0 * Qs
            if self.applyRelativisticCorrection:
                fRels = interpolate.splev(log10M500s, ms.fRelSplines[k])
                y0 = y0 * fRels
            y0Grid[k] = y0
            theta500Grid[k] = theta500s
        y0Grid[y0Grid <= 0] = 1e-9
        return y0Grid, theta500Grid

    # ------------------------------------------------------------------
    def projectCatalogToMz(self, tab):
        """Project a catalog onto the (z, log10M) grid with uncertainties
        (``completeness.py:500-532``)."""
        from .models import scaling
        proj = np.zeros(self.mockSurvey.clusterCount.shape)
        sr = self.scalingRelationDict
        for row in tab:
            P = scaling.calcPMass(
                row["fixed_y_c"] * 1e-4, row["fixed_err_y_c"] * 1e-4,
                row["redshift"], row["redshiftErr"], self.Q,
                self.mockSurvey, tenToA0=sr["tenToA0"], B0=sr["B0"],
                Mpivot=sr["Mpivot"], sigma_int=sr["sigma_int"],
                applyMFDebiasCorrection=self.applyMFDebiasCorrection,
                fRelWeightsDict=self.fRelDict.get(row["tileName"],
                                                  {148.0: 1.0}),
                return2D=True, tileName=row["tileName"])
            proj += P
        return proj

    def projectCatalogToMz_simple(self, tab):
        """Project a catalog onto the (z, log10M) grid ignoring
        uncertainties (``completeness.py:535-569``): one point-mass per
        cluster at its ML mass, histogrammed on the grid's bin edges.
        Masses for all rows come from one batched device computation
        (:func:`models.scaling.calcMassBatch`) instead of the
        reference's per-row loop."""
        from .models import scaling
        sr = self.scalingRelationDict
        out = scaling.calcMassBatch(
            np.asarray(tab["fixed_y_c"], dtype=float) * 1e-4,
            np.asarray(tab["fixed_err_y_c"], dtype=float) * 1e-4,
            np.asarray(tab["redshift"], dtype=float),
            np.asarray(tab["redshiftErr"], dtype=float),
            self.Q, self.mockSurvey, tenToA0=sr["tenToA0"], B0=sr["B0"],
            Mpivot=sr["Mpivot"], sigma_int=sr["sigma_int"],
            applyRelativisticCorrection=self.applyRelativisticCorrection,
            calcErrors=False,
            tileNames=list(np.asarray(tab["tileName"])))
        label = self.mockSurvey.mdefLabel
        if not self.applyMFDebiasCorrection:
            label = label + "Uncorr"
        obs_log10M = 14 + np.log10(np.asarray(out[label]))
        obsGrid, _, _ = np.histogram2d(
            obs_log10M, np.asarray(tab["redshift"], dtype=float),
            bins=[self.mockSurvey.log10MBinEdges,
                  self.mockSurvey.zBinEdges])
        return obsGrid.transpose()

    def addPDetToCatalog(self, tab):
        """Detection probability column (``completeness.py:572-593``)."""
        log_y0Lim = np.log(self.SNRCut * np.asarray(tab["fixed_err_y_c"])
                           * 1e-4)
        log_y0 = np.log(np.asarray(tab["fixed_y_c"]) * 1e-4)
        log_y0Err = 1 / np.asarray(tab["fixed_SNR"])
        sigma_int = self.scalingRelationDict["sigma_int"]
        log_totalErr = np.sqrt(log_y0Err ** 2 + sigma_int ** 2)
        tab["Pdet"] = stats.norm.sf(log_y0Lim, loc=log_y0,
                                    scale=log_totalErr)
        return tab

    def generateMockSample(self, mockOversampleFactor=None,
                           applyPoissonScatter=True, rng=None):
        """Mock catalog matching the survey noise (``completeness.py:596-628``)."""
        if mockOversampleFactor is None:
            mockOversampleFactor = self.mockOversampleFactor
        mockTabsList = []
        for tileName, areaDeg2 in zip(self.tileNames, self.tileAreas):
            mockTab = self.mockSurvey.drawSample(
                self.RMSDict[tileName], self.scalingRelationDict, QFit=self.Q,
                wcs=None, photFilterLabel=self.photFilterLabel,
                tileName=tileName, makeNames=False, SNRLimit=self.SNRCut,
                applySNRCut=True, areaDeg2=areaDeg2 * mockOversampleFactor,
                applyPoissonScatter=applyPoissonScatter,
                applyIntrinsicScatter=True, applyNoiseScatter=True,
                applyRelativisticCorrection=self.applyRelativisticCorrection,
                biasModel=self.biasModel, rng=rng)
            if mockTab is not None and len(mockTab) > 0:
                mockTabsList.append(mockTab)
        return vstack(mockTabsList)

    def getMassLimit(self, completenessFraction, zBinEdges=None):
        """Mass limit vs z at the given completeness
        (``completeness.py:631-649``)."""
        return calcMassLimit(completenessFraction, self.compMz,
                             self.mockSurvey)


# -----------------------------------------------------------------------------
def calcMassLimit(completenessFraction, compMz, mockSurvey, zBinEdges=[]):
    """Mass limit (1e14 MSun) vs z from a completeness grid
    (``completeness.py:1238-1264``)."""
    massLimit_zGrid = np.zeros(compMz.shape[0])
    for i in range(compMz.shape[0]):
        comp = compMz[i]
        above = np.where(comp >= completenessFraction)[0]
        if len(above) > 0:
            massLimit_zGrid[i] = 10 ** mockSurvey.log10M[above[0]] / 1e14
        else:
            massLimit_zGrid[i] = np.nan
    if len(zBinEdges) > 0:
        out = []
        for i in range(len(zBinEdges) - 1):
            sel = (mockSurvey.z >= zBinEdges[i]) & \
                  (mockSurvey.z < zBinEdges[i + 1])
            out.append(np.nanmean(massLimit_zGrid[sel]))
        return np.array(out)
    return massLimit_zGrid


def completenessByFootprint(config):
    """Survey-averaged completeness stats per footprint
    (``completeness.py:1067-1128``); writes diagnostics tables."""
    footprints = ["full"] + [f["label"] for f in
                             config.parDict.get("selFnFootprints", [])]
    SNRCut = config.parDict.get("selFnOptions", {}).get("fixedSNRCut", 5.0)
    method = config.parDict.get("selFnOptions", {}).get("method", "fast")
    QSource = config.parDict.get("selFnOptions", {}).get("QSource", "fit")
    results = {}
    for footprint in footprints:
        try:
            selFn = SelFn(config.selFnDir, SNRCut,
                          configFileName=config.configFileName or None,
                          footprint=None if footprint == "full"
                          else footprint, method=method, QSource=QSource,
                          device=config.policy.device)
        except (FootprintError, FileNotFoundError):
            continue
        massLim = selFn.getMassLimit(0.9)
        tab = Table({"z": selFn.mockSurvey.z,
                     "MLim_90pc_1e14MSun": massLim})
        outPath = os.path.join(config.diagnosticsDir,
                               "completeness90pc_%s.fits" % footprint)
        tab.write(outPath)
        results[footprint] = tab
        # Diagnostic plots (completeness.py:1113-1127 in the reference)
        massLabel = selFn.mockSurvey.mdefLabel
        makeMzCompletenessPlot(
            selFn.compMz, selFn.mockSurvey.log10M, selFn.mockSurvey.z,
            footprint, massLabel,
            os.path.join(config.diagnosticsDir,
                         "MzCompleteness_%s.pdf" % footprint))
        zs = selFn.mockSurvey.z
        valid = np.isfinite(massLim) & (massLim > 0)
        if valid.sum() > 1:
            makeMassLimitVRedshiftPlot(
                massLim[valid], zs[valid],
                os.path.join(config.diagnosticsDir,
                             "massLimit90pc_%s.pdf" % footprint),
                title=footprint if footprint != "full" else None)
            zMask = valid & (zs >= 0.2) & (zs <= 1.0)
            if zMask.sum() > 0:
                print("... survey-averaged 90%% completeness limit (%s, "
                      "0.2 < z < 1.0) = %.1f x 10^14 MSun [%s]"
                      % (massLabel, np.average(massLim[zMask]), footprint))
    return results


def loadFRelWeights(fRelWeightsFileName):
    """fRel weights per tile from FITS table (``signals.py:847-861``)."""
    tab = Table.read(fRelWeightsFileName)
    out = {}
    for i in range(len(tab)):
        row = tab[i]
        out[row["tileName"]] = {}
        for key in tab.keys():
            if key != "tileName":
                out[row["tileName"]][float(key)] = row[key]
    return out


def getFRelWeights(config):
    """Collect fRel weights from the cached filter headers into a table
    (``signals.py:815-844``): from the batched engine's device-resident
    cache entry where it holds the filter, else from the FITS header
    alone (the filter data itself is not needed for the RW weight
    columns)."""
    if config.parDict.get("photFilter") is None:
        return {}
    from .parallel import filtercache
    fRelWeightsFileName = os.path.join(config.selFnDir, "fRelWeights.fits")
    if not os.path.exists(fRelWeightsFileName):
        rows = {"tileName": []}
        for tileName in config.allTileNames:
            filterFileName = os.path.join(
                config.diagnosticsDir, tileName,
                "filter_%s#%s.fits" % (config.parDict["photFilter"],
                                       tileName))
            ent = filtercache.DEVICE_CACHE.get(filterFileName)
            if ent is not None:
                # the weights live in the entry: no file needed
                rows["tileName"].append(tileName)
                for freq, w in ent["fRelWeights"].items():
                    rows.setdefault(str(freq), [])
                    rows[str(freq)].append(w)
                continue
            # settle an in-flight write of this file (not a flush, which
            # would write every deferred filter for a header read)
            filtercache.ensure_written(filterFileName)
            if not os.path.exists(filterFileName):
                continue
            header = nfits.read_image_header(filterFileName)
            rows["tileName"].append(tileName)
            for i in range(1, 10):
                if "RW%d_GHZ" % i in header:
                    freq = str(header["RW%d_GHZ" % i])
                    rows.setdefault(freq, [])
                    rows[freq].append(header["RW%d" % i])
        if rows["tileName"]:
            tab = Table({k: np.array(v) for k, v in rows.items()})
            tab.write(fRelWeightsFileName)
    if os.path.exists(fRelWeightsFileName):
        return loadFRelWeights(fRelWeightsFileName)
    return {}


def tidyUp(config):
    """Fuse per-tile products into MEFs and clean up
    (``completeness.py:1671-1729``)."""
    photFilter = config.parDict.get("photFilter")
    fuseSpecs = []
    if photFilter is not None:
        fuseSpecs.append(("RMSMap_%s" % photFilter, config.selFnDir,
                          "RICE_1"))
    for baseFileName, baseDir, compression in fuseSpecs:
        outPath = os.path.join(baseDir, "%s.fits" % baseFileName)
        if os.path.exists(outPath):
            continue
        arrays = {}
        headers = {}
        for tileName in config.allTileNames:
            try:
                data, wcs = _loadTile(tileName, baseDir, baseFileName)
            except FileNotFoundError:
                continue
            arrays[tileName] = data
            headers[tileName] = wcs.header
        if arrays:
            nfits.write_mef(outPath, arrays, headers=headers,
                            compressionType=compression)
    # Tile area table
    areaPath = os.path.join(config.selFnDir, "tileAreas.fits")
    if not os.path.exists(areaPath):
        names = []
        areas = []
        for tileName in config.allTileNames:
            try:
                area = getTileTotalAreaDeg2(tileName, config.selFnDir)
            except FileNotFoundError:
                continue
            names.append(tileName)
            areas.append(area)
        if names:
            Table({"tileName": np.array(names),
                   "areaDeg2": np.array(areas)}).write(areaPath)


def calcCompleteness(RMSTab, SNRCut, tileName, mockSurvey,
                     scalingRelationDict, QFit, plotFileName=None, z=None,
                     method="fast", numDraws=2000000, numIterations=100,
                     verbose=False, rng=None):
    """Completeness on the (z, log10M) grid for one tile's noise
    distribution (``completeness.py:1267-1419``).

    Two methods, as in the reference:

    - ``'fast'``: applies measurement errors + intrinsic scatter to 'true'
      y0~ values on the grid, as an area-weighted log-normal survival-
      function sum over the tile's noise bins
      (reference ``completeness.py:1349-1391``).
    - ``'montecarlo'``: draws ``numIterations`` mock catalogs of
      ``numDraws`` clusters at the tile's area-weighted average noise and
      histograms detected/total on the (M, z) grid
      (reference ``completeness.py:1316-1344``).

    Returns the compMz grid (1d over log10M when ``z`` is given)."""
    tenToA0 = scalingRelationDict["tenToA0"]
    B0 = scalingRelationDict["B0"]
    Mpivot = scalingRelationDict["Mpivot"]
    sigma_int = scalingRelationDict["sigma_int"]
    zRange = mockSurvey.z if z is None else np.array([z])
    area = np.asarray(RMSTab["areaDeg2"], dtype=float)
    areaWeights = area / area.sum()
    y0RMS = np.asarray(RMSTab["y0RMS"], dtype=float)

    if method == "montecarlo":
        rng = rng or np.random.default_rng()
        trueMassCol = "true_M%d%s" % (mockSurvey.delta,
                                      mockSurvey.rhoType[0])
        y0Noise = float(np.average(y0RMS, weights=areaWeights))
        log10M = mockSurvey.log10M
        halfM = (log10M[1] - log10M[0]) / 2.0
        binEdges_log10M = np.concatenate([log10M - halfM,
                                          [log10M.max() + halfM]])
        halfZ = (mockSurvey.z[1] - mockSurvey.z[0]) / 2.0
        binEdges_z = np.concatenate([zRange - halfZ,
                                     [np.max(zRange) + halfZ]])
        allMz = np.zeros((len(log10M), len(zRange)))
        detMz = np.zeros_like(allMz)
        applyRel = scalingRelationDict.get("relativisticCorrection", True)
        for _ in range(numIterations):
            tab = mockSurvey.drawSample(
                y0Noise, scalingRelationDict, QFit, tileName=tileName,
                SNRLimit=SNRCut, applySNRCut=False, z=z, numDraws=numDraws,
                applyRelativisticCorrection=applyRel, rng=rng)
            if tab is None:
                continue
            trueM = np.log10(np.asarray(tab[trueMassCol]) * 1e14)
            zCol = np.asarray(tab["redshift"])
            allMz += np.histogram2d(trueM, zCol,
                                    [binEdges_log10M, binEdges_z])[0]
            det = np.asarray(tab["fixed_y_c"]) * 1e-4 > y0Noise * SNRCut
            detMz += np.histogram2d(trueM[det], zCol[det],
                                    [binEdges_log10M, binEdges_z])[0]
        compMz = np.ones(detMz.shape)
        mask = allMz != 0
        compMz[mask] = detMz[mask] / allMz[mask]
        compMz = compMz.T
        return compMz if z is None else compMz[0]

    if method != "fast":
        raise ValueError(
            "calcCompleteness only has 'fast' and 'montecarlo' methods "
            "available (got %r)" % method)

    compMz = np.zeros((len(zRange), len(mockSurvey.log10M)))
    for i, zk in enumerate(zRange):
        k = np.argmin(np.abs(mockSurvey.z - zk))
        # theta500/fRel splines work in log10 M500c; convert when the
        # survey mass definition differs (reference completeness.py:1360-1366)
        if mockSurvey.delta == 500 and mockSurvey.rhoType == "critical":
            log10M500cs = mockSurvey.log10M
        else:
            log10M500cs = np.log10(mockSurvey._toM500c(mockSurvey.M, zk))
        theta500s = interpolate.splev(log10M500cs,
                                      mockSurvey.theta500Splines[k])
        Qs = QFit.getQ(theta500s, zk, tileName=tileName)
        y0Grid = tenToA0 * mockSurvey.Ez[k] ** 2 \
            * (mockSurvey.M / Mpivot) ** (1 + B0) * Qs
        if scalingRelationDict.get("relativisticCorrection", True):
            fRels = interpolate.splev(log10M500cs,
                                      mockSurvey.fRelSplines[k])
            y0Grid = y0Grid * fRels
        y0Grid = np.where(y0Grid <= 0, 1e-9, y0Grid)
        # Log-normal survival sum with the 1/SNR error clamped below the
        # cut (reference completeness.py:1379-1391)
        log_y0 = np.log(y0Grid)
        comp = np.zeros(len(y0Grid))
        for j in range(len(y0RMS)):
            SNRGrid = y0Grid / y0RMS[j]
            log_y0Err = np.where(SNRGrid < SNRCut, 1.0 / SNRCut,
                                 1.0 / SNRGrid)
            log_totalErr = np.sqrt(log_y0Err ** 2 + sigma_int ** 2)
            comp = comp + areaWeights[j] * stats.norm.sf(
                np.log(SNRCut * y0RMS[j]), loc=log_y0, scale=log_totalErr)
        compMz[i] = comp
    return compMz if z is None else compMz[0]


def calcCompletenessContour(compMz, log10M, z, level=0.90):
    """Completeness contour on the (log10M, z) plane
    (``completeness.py:1131-1171``).

    The reference extracts matplotlib contour paths and takes the
    per-redshift median; here each redshift column's crossing of
    ``level`` is found directly by linear interpolation (deterministic,
    no matplotlib dependency).

    Returns (redshifts, log10M values) at the requested level, covering
    the redshifts where completeness actually crosses it.
    """
    compMz = np.asarray(compMz)
    cont_z, cont_log10M = [], []
    for zi in range(compMz.shape[0]):
        comp = compMz[zi]
        above = np.where(comp >= level)[0]
        if len(above) == 0 or above[0] == 0:
            if len(above) > 0 and above[0] == 0:
                cont_z.append(z[zi])
                cont_log10M.append(log10M[0])
            continue
        i1 = above[0]
        i0 = i1 - 1
        frac = (level - comp[i0]) / max(comp[i1] - comp[i0], 1e-30)
        cont_z.append(z[zi])
        cont_log10M.append(log10M[i0] + frac * (log10M[i1] - log10M[i0]))
    return np.array(cont_z), np.array(cont_log10M)


def makeMzCompletenessPlot(compMz, log10M, z, title, massLabel,
                           outFileName):
    """(log10M, z) completeness image with the 90% contour overlaid
    (``completeness.py:1174-1236``)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from . import plotSettings
        plotSettings.update_rcParams()
    except Exception as exc:  # plotting must never kill a survey run
        print("... WARNING: Mz completeness plot failed: %s" % exc)
        return
    cont_z, cont_log10M = calcCompletenessContour(compMz, log10M, z)
    fig, ax = plt.subplots(figsize=(9.5, 6.5))
    im = ax.pcolormesh(z, log10M, np.asarray(compMz).transpose() * 100,
                       cmap="rainbow", shading="auto")
    if len(cont_z) > 0:
        ax.plot(cont_z, cont_log10M, "k:", lw=3)
    if massLabel.startswith("M"):
        massLabel = massLabel[1:]
    ax.set_ylabel("log$_{10}$ ($M_{\\rm %s} / M_{\\odot}$)" % massLabel)
    ax.set_xlabel("$z$")
    ax.set_ylim(max(13.8, log10M.min()), min(15.4, log10M.max()))
    cb = fig.colorbar(im, pad=0.03)
    cb.set_label("Completeness (%)")
    if title != "full":
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(outFileName)
    plt.close(fig)


def makeMassLimitVRedshiftPlot(massLimit_90Complete, zRange, outFileName,
                               title=None):
    """90%-completeness mass limit vs redshift plot
    (``completeness.py:1577-1612``)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from . import plotSettings
        plotSettings.update_rcParams()
    except Exception as exc:
        print("... WARNING: mass-limit plot failed: %s" % exc)
        return
    plt.figure(figsize=(9, 6.5))
    if title is not None:
        plt.figtext(0.15, 0.2, title, ha="left", va="center")
    fine_z = np.linspace(zRange.min(), zRange.max(), 100)
    plt.plot(fine_z, np.interp(fine_z, zRange, massLimit_90Complete), "k-")
    plt.plot(zRange, massLimit_90Complete, "D", ms=8)
    plt.xlabel("$z$")
    plt.ylabel("$M_{\\rm 500c}$ (10$^{14}$ M$_{\\odot}$) [90% complete]")
    plt.xlim(0, max(2.0, float(zRange.max())))
    plt.savefig(outFileName)
    if outFileName.endswith(".pdf"):
        plt.savefig(outFileName[:-4] + ".png")
    plt.close()


def makeFullSurveyMassLimitMapPlot(z, config):
    """Full-area mass-limit map (FITS + plot) reprojected to a
    quarter-resolution version of the survey pixelisation
    (``completeness.py:1615-1668``)."""
    _stitchMassLimitMap(config, z)


def makeMassLimitMap(SNRCut, z, tileName, photFilterLabel, mockSurvey,
                     scalingRelationDict, QFit, diagnosticsDir, selFnDir,
                     completenessFraction=0.9):
    """Mass-limit map for one tile at redshift z
    (``completeness.py:1422-1551``): map each noise-map pixel to the mass
    at which completeness crosses ``completenessFraction``."""
    RMSMap, wcs = loadRMSMap(tileName, selFnDir, photFilterLabel)
    RMSMap = np.asarray(RMSMap)
    rmsVals = np.unique(RMSMap[RMSMap > 0])
    if len(rmsVals) == 0:
        return None
    # limit per noise level
    limits = np.zeros(len(rmsVals))
    RMSTabOne = Table({"areaDeg2": np.ones(1), "y0RMS": np.zeros(1)})
    for i, rms in enumerate(rmsVals):
        RMSTabOne["y0RMS"] = np.array([rms])
        comp = calcCompleteness(RMSTabOne, SNRCut, tileName, mockSurvey,
                                scalingRelationDict, QFit, z=z)
        above = np.where(comp >= completenessFraction)[0]
        limits[i] = 10 ** mockSurvey.log10M[above[0]] / 1e14 \
            if len(above) else np.nan
    massLimMap = np.zeros(RMSMap.shape)
    lut = dict(zip(rmsVals.tolist(), limits.tolist()))
    vals, inverse = np.unique(RMSMap, return_inverse=True)
    mapped = np.array([lut.get(v, 0.0) for v in vals.tolist()])
    massLimMap = mapped[inverse].reshape(RMSMap.shape)
    outDir = os.path.join(diagnosticsDir, tileName)
    os.makedirs(outDir, exist_ok=True)
    outFileName = os.path.join(
        outDir, "massLimitMap_z%s#%s.fits"
        % (str(z).replace(".", "p"), tileName))
    nfits.write_image(outFileName, massLimMap.astype(np.float32),
                      wcs.header, compressionType="RICE_1")
    return massLimMap


def makeMassLimitMapsAndPlots(config):
    """Mass-limit maps for each z in selFnOptions['massLimitMaps']
    (``bin/nemo:153-154`` epilogue)."""
    selFnOptions = config.parDict.get("selFnOptions", {})
    SNRCut = selFnOptions.get("fixedSNRCut", 5.0)
    massOptions = config.parDict["massOptions"]
    photFilterLabel = config.parDict["photFilter"]
    QSource = selFnOptions.get("QSource", "fit")
    Q = QFit(QSource=QSource, selFnDir=config.selFnDir,
             tileNames=config.allTileNames)
    mockSurvey = MockSurvey(5e13, 700.0, 0.0, 3.0, massOptions["H0"],
                            massOptions["Om0"], massOptions["Ob0"],
                            massOptions["sigma8"], massOptions["ns"],
                            delta=massOptions["delta"],
                            rhoType=massOptions["rhoType"],
                            transferFunction=massOptions.get(
                                "transferFunction", "boltzmann_camb"),
                            device=str(config.policy.device))
    for mlDict in selFnOptions.get("massLimitMaps", []):
        z = mlDict["z"]
        for tileName in config.allTileNames:
            try:
                makeMassLimitMap(SNRCut, z, tileName, photFilterLabel,
                                 mockSurvey, massOptions, Q,
                                 config.diagnosticsDir, config.selFnDir)
            except FileNotFoundError:
                continue
        _stitchMassLimitMap(config, z)


def _stitchMassLimitMap(config, z):
    """Quarter-resolution stitched mass-limit map + plot
    (``completeness.py:1625-1668`` in the reference)."""
    from . import maps as maps_mod
    if config.origWCS is None:
        return
    zStr = str(z).replace(".", "p")
    outFileName = os.path.join(config.diagnosticsDir,
                               "reproj_massLimitMap_z%s.fits" % zStr)
    shape, wcs = maps_mod.shrinkWCS(config.origShape, config.origWCS, 0.25)
    stitched = maps_mod.stitchTilesQuickLook(
        os.path.join(config.diagnosticsDir, "*",
                     "massLimitMap_z%s#*.fits" % zStr),
        outFileName, wcs, shape)
    if stitched is None:
        return
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from . import plotSettings
        plotSettings.update_rcParams()
        masked = np.ma.masked_where(stitched < 1e-6, stitched)
        plt.figure(figsize=(16, 5.7))
        plt.imshow(masked, origin="lower", cmap="rainbow")
        cb = plt.colorbar()
        cb.set_label("$M_{\\rm 500c}$ ($10^{14}$ M$_\\odot$) "
                     "[90%% complete], z = %s" % z)
        plt.savefig(outFileName.replace(".fits", ".pdf"),
                    bbox_inches="tight")
        plt.close()
    except Exception as exc:  # plotting must never kill a survey run
        print("... WARNING: mass-limit map plot failed: %s" % exc)
