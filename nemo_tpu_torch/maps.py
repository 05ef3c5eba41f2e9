"""Map and tile runtime: lazy tile loading and per-tile preprocessing.

Port of the host side of ``nemo_tpu/maps.py`` that the cluster search
runs: :class:`MapDict` (tile loading and the ``preprocess`` chain),
:class:`MapDictList`, :class:`TileDict`, the tiling helpers that
:mod:`startup` needs, and the stitched and quick-look maps of a tiled
run.  All of it is host numpy; the preprocess steps that
run device work in the JAX package (survey-mask apodisation, the CMB
substitution of contamination sims, source injection, beam convolution,
model subtraction) raise NotImplementedError naming their ROADMAP item.
"""

import os
import threading

import numpy as np

from . import catalogs
from .ops import imageops
from .utils import fits as nfits
from .utils.tables import Table
from .utils.wcs import WCS, calcAngSepDeg, clipUsingRADecCoords

_SIMS_TODO = "not ported yet (ROADMAP.md queue 1, item 10: sims and injection)"


def _notPorted(what):
    raise NotImplementedError("preprocess option '%s' is %s"
                              % (what, _SIMS_TODO))


# -----------------------------------------------------------------------------
def pixScalesRad(wcs, shape=None):
    """(dy, dx) pixel scales in radians at the map centre."""
    if shape is None:
        shape = (wcs.naxis2, wcs.naxis1)
    cy, cx = shape[0] // 2, shape[1] // 2
    ra0, dec0 = wcs.pix2wcs(cx, cy)
    ra1, dec1 = wcs.pix2wcs(cx + 1, cy + 1)
    dx = calcAngSepDeg(ra0, dec0, ra1, dec0)
    dy = calcAngSepDeg(ra0, dec0, ra0, dec1)
    return (float(np.radians(dy)), float(np.radians(dx)))


# Decompressed-file cache for tile clipping of maps that cannot be
# memory-mapped (tile-compressed / gzipped).  A tiled survey run clips
# every tile from the same full-survey files; without this, each tile
# pays a full RICE/gzip decode of the survey mask (214 decodes of a
# ~200 MB mask at DR5 scale).  Small LRU: a run alternates between at
# most a few such files.  Callers copy the returned array before
# mutating (loadTile does np.array(data)).
_FULL_READ_CACHE = {}
_FULL_READ_CACHE_MAX = 3
_FULL_READ_LOCK = threading.Lock()


def _readFullCached(path):
    """Whole-file read with a tiny keep-warm cache.  Locked: the batched
    engine's preprocessing prefetch thread can race a main-thread
    preprocess here (duplicated multi-GB reads; dict-mutation-during-
    iteration in the eviction loop)."""
    key = (str(path), os.path.getmtime(path))
    with _FULL_READ_LOCK:      # held across the read: a concurrent miss
        if key in _FULL_READ_CACHE:     # would duplicate a multi-GB read
            return _FULL_READ_CACHE[key]
        hdus = nfits.read(path)
        hdu = next(h for h in hdus if h.data is not None)
        while len(_FULL_READ_CACHE) >= _FULL_READ_CACHE_MAX:
            _FULL_READ_CACHE.pop(next(iter(_FULL_READ_CACHE)))
        _FULL_READ_CACHE[key] = (hdu.data, hdu.header)
        return _FULL_READ_CACHE[key]



# -----------------------------------------------------------------------------
class MapDict(dict):
    """A sky-map descriptor + per-tile preprocessing, mirroring
    ``nemo/maps.py:47-476``."""

    def __init__(self, inputDict, tileCoordsDict=None):
        super().__init__(inputDict)
        self.tileCoordsDict = tileCoordsDict
        self._maskKeys = ["pointSourceMask", "surveyMask", "flagMask",
                          "extendedMask"]
        self.validMapKeys = ["mapFileName", "weightsFileName"] + self._maskKeys

    def copy(self):
        return MapDict(self, tileCoordsDict=self.tileCoordsDict)

    def loadTile(self, mapKey, tileName, returnWCS=False):
        """Load (and clip) one tile of the map pointed to by ``mapKey``
        (``maps.py:83-172``)."""
        if mapKey not in self.validMapKeys:
            raise ValueError("mapKey must be one of %s" % self.validMapKeys)
        path = self.get(mapKey)
        if isinstance(path, np.ndarray):
            data = path
            wcs = self.tileCoordsDict and WCS(
                self.tileCoordsDict[tileName]["header"])
        elif os.path.isdir(str(path)):
            data, header = nfits.read_image(
                os.path.join(path, tileName + ".fits"))
            wcs = WCS(header)
        else:
            # Memory-map where possible: loading one tile of a survey-sized
            # map then costs O(tile) I/O, not a full-file read per tile.
            try:
                full, header = nfits.read_image_mmap(path)
            except (IOError, OSError, KeyError):
                full, header = _readFullCached(path)
            if self.tileCoordsDict is not None and \
                    tileName in self.tileCoordsDict:
                minX, maxX, minY, maxY = \
                    self.tileCoordsDict[tileName]["clippedSection"]
                if full.ndim == 3:
                    data = full[0, minY:maxY, minX:maxX]
                else:
                    data = full[minY:maxY, minX:maxX]
                wcs = WCS(self.tileCoordsDict[tileName]["header"])
            else:
                data = full[0] if full.ndim == 3 else full
                wcs = WCS(header)
        data = np.array(data)
        if data.dtype.byteorder == ">":
            data = data.astype(data.dtype.newbyteorder("="))

        if mapKey in self._maskKeys and data.dtype != np.uint8:
            data = data.astype(np.uint8)

        # Zero the overlap border of survey masks so area isn't counted
        # twice across tiles (maps.py:144-150)
        if mapKey == "surveyMask" and self.tileCoordsDict is not None and \
                tileName in self.tileCoordsDict:
            minX, maxX, minY, maxY = \
                self.tileCoordsDict[tileName]["areaMaskInClipSection"]
            data[:minY, :] = 0
            data[maxY:, :] = 0
            data[:, :minX] = 0
            data[:, maxX:] = 0

        # Optional CAR -> TAN reprojection (maps.py:152-167): may reduce
        # high-declination distortion biases at the cost of an extra
        # resampling (bicubic for maps, nearest for masks).
        if self.get("reprojectToTan"):
            from .utils.wcs import makeTanWCS, reprojectImage
            order = 0 if mapKey in self._maskKeys else 3
            tanWCS = makeTanWCS(wcs)
            data, footprint = reprojectImage(data, wcs, tanWCS, order=order)
            if mapKey in self._maskKeys:
                data = data.astype(np.uint8)
            wcs = tanWCS

        if returnWCS:
            return data, wcs
        return data

    def loadGeometry(self, tileName):
        """(shape, wcs) the preprocessed tile WOULD have, without reading
        any pixel data.

        Consumers that only apply cached filters (fitQ, forced-photometry
        reloads) need the tile geometry, not the maps; skipping the
        preprocessing chain saves ~1-2 s/tile of survey-map I/O.  Returns
        None when the geometry cannot be known without loading (no tile
        coords entry, or a shape-changing preprocess step is configured:
        RADecSection clipping / TAN reprojection).
        """
        if self.get("RADecSection") or self.get("reprojectToTan"):
            return None
        if self.tileCoordsDict is None or \
                tileName not in self.tileCoordsDict:
            return None
        entry = self.tileCoordsDict[tileName]
        minX, maxX, minY, maxY = entry["clippedSection"]
        return (maxY - minY, maxX - minX), WCS(entry["header"])

    def preprocess(self, tileName="PRIMARY", diagnosticsDir=None):
        """The per-tile preprocessing chain (``maps.py:175-475``)."""
        if self.get("_preprocessedTile") == tileName:
            return
        data, wcs = self.loadTile("mapFileName", tileName, returnWCS=True)
        data = np.array(data, dtype=np.float64)

        if "calibFactor" in self and self["calibFactor"] is not None:
            data = data * self["calibFactor"]

        if self.get("addNoise"):
            # extra white noise for simulation work (uK per pixel)
            rng = np.random.default_rng(self.get("seed"))
            data = data + rng.normal(0, float(self["addNoise"]), data.shape)

        if self.get("units") == "Jy/sr":
            # Historical fixed conversion factors (maps.py:218-225)
            conv = {148: 1.072480e9, 219: 1.318837e9}
            if int(self["obsFreqGHz"]) not in conv:
                raise ValueError("No Jy/sr conversion for %.0f GHz"
                                 % self["obsFreqGHz"])
            data = (data / conv[int(self["obsFreqGHz"])]) * 2.726 * 1e6

        if self.get("weightsFileName") is not None:
            weights = self.loadTile("weightsFileName", tileName)
            weights = np.array(weights, dtype=np.float64)
            if weights.ndim == 3:
                weights = weights[0]
            elif weights.ndim == 4:
                weights = weights[0, 0]
        else:
            weights = np.ones(data.shape)
        data[weights == 0] = 0

        if self.get("surveyMask") is not None:
            surveyMask = self.loadTile("surveyMask", tileName)
        else:
            surveyMask = np.ones(data.shape, dtype=np.uint8)
            surveyMask[weights == 0] = 0

        if self.get("apodizeUsingSurveyMask"):
            _notPorted("apodizeUsingSurveyMask")

        if self.get("pointSourceMask") is not None:
            psMask = self.loadTile("pointSourceMask", tileName)
        else:
            psMask = np.ones(data.shape, dtype=np.uint8)

        if self.get("flagMask") is not None:
            flagMask = self.loadTile("flagMask", tileName) * surveyMask
        else:
            flagMask = np.zeros(data.shape, dtype=np.uint8)

        if self.get("RADecSection"):
            RAMin, RAMax, decMin, decMax = self["RADecSection"]
            clip = clipUsingRADecCoords(data, wcs, RAMin, RAMax, decMin,
                                        decMax)
            data = clip["data"]
            weights = clipUsingRADecCoords(weights, wcs, RAMin, RAMax,
                                           decMin, decMax)["data"]
            psMask = clipUsingRADecCoords(psMask, wcs, RAMin, RAMax, decMin,
                                          decMax)["data"]
            surveyMask = clipUsingRADecCoords(surveyMask, wcs, RAMin, RAMax,
                                              decMin, decMax)["data"]
            flagMask = clipUsingRADecCoords(flagMask, wcs, RAMin, RAMax,
                                            decMin, decMax)["data"]
            wcs = clip["wcs"]
            if data.size == 0:
                raise ValueError("RADecSection clip returned empty array")

        # device work in the JAX package, not ported yet
        for key in ("CMBSimSeed", "injectSources"):
            if key in self:
                _notPorted(key)
        if self.get("applyBeamConvolution"):
            _notPorted("applyBeamConvolution")
        if "smoothKernel" in self:
            _notPorted("smoothKernel")

        # Hole-filling background (maps.py:355-365)
        holeFillingKeys = ["maskPointSourcesFromCatalog",
                           "maskAndFillFromCatalog", "extendedMask"]
        bckData = None
        if any(self.get(k) is not None and k in self
               for k in holeFillingKeys):
            pixRad = (10.0 / 60.0) / wcs.getPixelSizeDeg()
            bckData = imageops.median_filter_host(data, int(pixRad))

        if self.get("maskPointSourcesFromCatalog"):
            cats = self["maskPointSourcesFromCatalog"]
            if not isinstance(cats, list):
                cats = [cats]
            psMask = np.ones(data.shape, dtype=np.uint8)
            for catalogInfo in cats:
                if isinstance(catalogInfo, dict):
                    catalogPath = catalogInfo["path"]
                    fluxCutJy = catalogInfo.get("fluxCutJy", 0.0)
                else:
                    catalogPath = catalogInfo
                    fluxCutJy = 0.0
                tab = catalogPath if isinstance(catalogPath, Table) \
                    else Table.read(catalogPath)
                if "fluxJy" in tab.keys():
                    tab = tab[np.asarray(tab["fluxJy"]) > fluxCutJy]
                tab = catalogs.getCatalogWithinImage(tab, data.shape, wcs)
                for row in tab:
                    if "rArcmin" in tab.keys():
                        maskRadiusArcmin = row["rArcmin"]
                    elif "ellipse_A" in tab.keys():
                        xPixArcmin = (wcs.getXPixelSizeDeg()
                                      / np.cos(np.radians(row["decDeg"]))) * 60
                        maskRadiusArcmin = (row["ellipse_A"] / xPixArcmin) / 2
                    else:
                        raise ValueError(
                            "need 'rArcmin' or 'ellipse_A' column")
                    holeMask = _distance_mask(data.shape, wcs, row["RADeg"],
                                              row["decDeg"],
                                              maskRadiusArcmin / 60.0)
                    surveyMask[holeMask] = 0
                    psMask[holeMask] = 0
                    data[holeMask] = bckData[holeMask]

        if self.get("subtractModelFromCatalog"):
            _notPorted("subtractModelFromCatalog")

        if self.get("maskAndFillFromCatalog"):
            cats = self["maskAndFillFromCatalog"]
            if not isinstance(cats, list):
                cats = [cats]
            for tab in cats:
                if not isinstance(tab, Table):
                    tab = Table.read(tab)
                tab = catalogs.getCatalogWithinImage(tab, data.shape, wcs)
                if len(tab) > 0 and "ellipse_A" not in tab.keys():
                    raise ValueError("maskAndFillFromCatalog requires "
                                     "measureShapes: True")
                for row in tab:
                    xPixArcmin = (wcs.getXPixelSizeDeg()
                                  / np.cos(np.radians(row["decDeg"]))) * 60
                    maskRadiusArcmin = (row["ellipse_A"] / xPixArcmin) / 2
                    if self.get("maskHoleDilationFactor"):
                        maskRadiusArcmin *= self["maskHoleDilationFactor"]
                    holeMask = _distance_mask(data.shape, wcs, row["RADeg"],
                                              row["decDeg"],
                                              maskRadiusArcmin / 60.0)
                    surveyMask[holeMask] = 0
                    psMask[holeMask] = 0
                    data[holeMask] = bckData[holeMask]

        self["data"] = data
        self["weights"] = weights
        self["wcs"] = wcs
        self["surveyMask"] = surveyMask
        self["pointSourceMask"] = psMask
        self["flagMask"] = flagMask
        self["tileName"] = tileName
        self["_preprocessedTile"] = tileName

        if self["data"].shape != self["pointSourceMask"].shape or \
                self["data"].shape != self["surveyMask"].shape:
            raise ValueError("Map and mask dimensions do not match")


class MapDictList:
    """List of MapDicts sharing a tileCoordsDict (``maps.py:478-499``)."""

    def __init__(self, mapDictList, tileCoordsDict=None):
        self.mapDicts = [MapDict(m, tileCoordsDict=tileCoordsDict)
                         for m in mapDictList]

    def __iter__(self):
        return iter(self.mapDicts)

    def __getitem__(self, item):
        return self.mapDicts[item]

    def __len__(self):
        return len(self.mapDicts)


class TileDict(dict):
    """Tile-name -> 2-d array container with MEF / stitched writers
    (``maps.py:502-605``)."""

    def __init__(self, inputDict, tileCoordsDict=None):
        super().__init__(inputDict)
        self.tileCoordsDict = tileCoordsDict

    def copy(self):
        return TileDict(self, tileCoordsDict=self.tileCoordsDict)

    def saveMEF(self, outFileName, compressionType=None):
        headers = {}
        for tileName in self.keys():
            if self.tileCoordsDict and tileName in self.tileCoordsDict:
                headers[tileName] = self.tileCoordsDict[tileName]["header"]
        nfits.write_mef(outFileName, {k: np.asarray(v)
                                      for k, v in self.items()},
                        headers=headers, compressionType=compressionType)

    def saveStitchedFITS(self, outFileName, stitchedWCS,
                         compressionType=None):
        d = np.zeros((stitchedWCS.naxis2, stitchedWCS.naxis1))
        for tileName in self.keys():
            minX, maxX, minY, maxY = \
                self.tileCoordsDict[tileName]["clippedSection"]
            tile = np.asarray(self[tileName])
            h = min(maxY - minY, tile.shape[0])
            w = min(maxX - minX, tile.shape[1])
            d[minY:minY + h, minX:minX + w] = \
                np.maximum(d[minY:minY + h, minX:minX + w], tile[:h, :w])
        nfits.write_image(outFileName, d, stitchedWCS.header,
                          compressionType=compressionType)


def _distance_mask(shape, wcs, RADeg, decDeg, maxDistDeg):
    """Boolean mask of pixels within maxDistDeg of a position (bounded box,
    like ``makeDegreesDistanceMap``, ``maps.py:2414-2471``)."""
    degMap = np.full(shape, 1e6)
    degMap, _, _ = makeDegreesDistanceMap(degMap, wcs, RADeg, decDeg,
                                          maxDistDeg)
    return degMap < maxDistDeg


def makeDegreesDistanceMap(degreesMap, wcs, RADeg, decDeg, maxDistDegrees):
    """Fill (in place) a map with angular distance from a position, within
    a bounding box (``maps.py:2414-2471``)."""
    x0, y0 = wcs.wcs2pix(RADeg, decDeg)
    ra1, dec1 = wcs.pix2wcs(x0 + 1, y0 + 1)
    xPixScale = calcAngSepDeg(RADeg, decDeg, ra1, decDeg)
    yPixScale = calcAngSepDeg(RADeg, decDeg, RADeg, dec1)
    Y, X = degreesMap.shape
    xDistPix = int(round(maxDistDegrees / xPixScale))
    yDistPix = int(round(maxDistDegrees / yPixScale))
    minX = max(int(round(x0)) - xDistPix, 0)
    maxX = min(int(round(x0)) + xDistPix, X)
    minY = max(int(round(y0)) - yDistPix, 0)
    maxY = min(int(round(y0)) + yDistPix, Y)
    xDeg = (np.arange(X) - x0) * xPixScale
    yDeg = (np.arange(Y) - y0) * yPixScale
    block = np.sqrt(yDeg[minY:maxY, None] ** 2 + xDeg[None, minX:maxX] ** 2)
    degreesMap[minY:maxY, minX:maxX] = block
    return degreesMap, [minX, maxX], [minY, maxY]


# -----------------------------------------------------------------------------
def autotiler(surveyMask, wcs, targetTileWidth, targetTileHeight):
    """Break a survey mask into approximately equal tiles
    (``maps.py:691-791``): label connected mask regions, slice each into
    dec rows, stretch tile widths by 1/cos(dec), handle the 180-deg wrap.
    """
    from scipy import ndimage

    mapCentreRA, mapCentreDec = wcs.getCentreWCSCoords()
    skyWidth, skyHeight = wcs.getFullSizeSkyDeg()
    handle180Wrap = (mapCentreRA < 0.1 and skyWidth < 0.1) or skyWidth > 359.9

    segMap, numObjects = ndimage.label(np.asarray(surveyMask) > 0)
    fieldIDs = np.arange(1, numObjects + 1)
    maskSections = ndimage.find_objects(segMap)
    tileList = []
    for maskSection, f in zip(maskSections, fieldIDs):
        yMin = maskSection[0].start
        yMax = maskSection[0].stop - 1
        if yMax - yMin < 1000:  # skip stray blobs (maps.py:735)
            continue
        xc = int((maskSection[1].start + (maskSection[1].stop - 1)) / 2)
        RAc, decMin = wcs.pix2wcs(xc, yMin)
        RAc, decMax = wcs.pix2wcs(xc, yMax)
        numRows = int((decMax - decMin) / targetTileHeight)
        if numRows == 0:
            raise ValueError("targetTileHeight larger than map height")
        tileHeight = np.ceil(((decMax - decMin) / numRows) * 100) / 100

        for i in range(numRows):
            decBottom = decMin + i * tileHeight
            decTop = decMin + (i + 1) * tileHeight
            xc2, yBottom = wcs.wcs2pix(RAc, decBottom)
            xc2, yTop = wcs.wcs2pix(RAc, decTop)
            yBottom = int(yBottom)
            yTop = int(yTop)
            strip = segMap[min(yBottom, yTop):max(yBottom, yTop)]
            ys, xs = np.where(strip == f)
            if len(xs) == 0:
                continue
            xMin, xMax = xs.min(), xs.max()
            yc = int((yTop + yBottom) / 2)
            stripWidthDeg = (xMax - xMin) * wcs.getXPixelSizeDeg()
            RAMax, decc = wcs.pix2wcs(int(xMin), yc)
            RAMin, decc = wcs.pix2wcs(int(xMax), yc)
            stretch = 1 / np.cos(np.radians(decTop))
            numCols = max(int(stripWidthDeg / (targetTileWidth * stretch)), 1)
            tileWidth = np.ceil((stripWidthDeg / numCols) * 100) / 100
            for j in range(numCols):
                RALeft = RAMax - j * tileWidth
                RARight = RAMax - (j + 1) * tileWidth
                if RALeft < 0:
                    RALeft += 360
                if RARight < 0:
                    RARight += 360
                if handle180Wrap:
                    if RARight < 180.01 and RALeft < 180 + tileWidth \
                            and RALeft > 180.01:
                        RARight = 180.01
                tileList.append({
                    "tileName": "%d_%d_%d" % (f, i, j),
                    "RADecSection": [float(RARight), float(RALeft),
                                     float(decBottom), float(decTop)]})
    return tileList


def saveTilesDS9RegionsFile(parDict, DS9RegionFileName):
    """DS9 regions showing the tiling (``maps.py:794-817``)."""
    with open(DS9RegionFileName, "w") as f:
        f.write("# Region file format: DS9 version 4.1\n")
        f.write('global color=blue width=1 font="helvetica 10 normal"\n')
        f.write("fk5\n")
        for tileDict in parDict["tileDefinitions"]:
            ra0, ra1, dec0, dec1 = tileDict["RADecSection"]
            f.write("polygon(%.6f, %.6f, %.6f, %.6f, %.6f, %.6f, %.6f, "
                    '%.6f) # text="%s"\n'
                    % (ra0, dec0, ra0, dec1, ra1, dec1, ra1, dec0,
                       tileDict["tileName"]))


def checkMask(fileName):
    """Raise if a mask contains negative values (``maps.py:925-955``)."""
    data, _ = nfits.read_image(fileName)
    if np.any(np.asarray(data) < 0):
        raise ValueError("Mask file '%s' contains negative values" % fileName)


def chunkLoadMask(fileName, numChunks=8, dtype=np.uint8):
    """Memory-efficient full-survey mask load (``maps.py:873-922``).

    Survey masks are multi-GB at float64; the reference reads them in
    row chunks to bound peak memory.  Here the memory-mapped reader
    (:func:`utils.fits.read_image_mmap`) gives O(chunk) I/O when the
    file is uncompressed; compressed/gzipped files fall back to a full
    read.  Either way the result is converted to ``dtype`` in row
    chunks so peak memory stays ~map + chunk, not 2 x map-as-float64.

    Returns (mask array of ``dtype``, WCS).
    """
    try:
        src, header = nfits.read_image_mmap(fileName)
    except (IOError, OSError):
        src, header = nfits.read_image(fileName)
    out = np.empty(src.shape, dtype=dtype)
    rows = max(1, src.shape[0] // max(int(numChunks), 1))
    for i0 in range(0, src.shape[0], rows):
        out[i0:i0 + rows] = src[i0:i0 + rows]
    return out, WCS(header)



# -----------------------------------------------------------------------------
def smoothMap(data, wcs, RADeg="centre", decDeg="centre",
              smoothScaleDeg=5.0 / 60.0, policy=None):
    """Gaussian smoothing with a sky-scale kernel, on ``policy``'s device
    (host numpy in and out)."""
    from . import device as device_mod
    policy = policy or device_mod.CPU
    ra0, dec0 = wcs.getCentreWCSCoords()
    if RADeg != "centre":
        ra0 = float(RADeg)
    if decDeg != "centre":
        dec0 = float(decDeg)
    x0, y0 = wcs.wcs2pix(ra0, dec0)
    ra1, dec1 = wcs.pix2wcs(x0 + 1, y0 + 1)
    xPixScale = calcAngSepDeg(ra0, dec0, ra1, dec0)
    yPixScale = calcAngSepDeg(ra0, dec0, ra0, dec1)
    sy = smoothScaleDeg / yPixScale
    sx = smoothScaleDeg / xPixScale
    return imageops.gaussian_filter(policy.tensor(np.asarray(data)),
                                    (sy, sx)).cpu().numpy()


def subtractBackground(data, wcs, RADeg="centre", decDeg="centre",
                       smoothScaleDeg=30.0 / 60.0, policy=None):
    """High-pass via difference of Gaussians."""
    return data - smoothMap(data, wcs, RADeg=RADeg, decDeg=decDeg,
                            smoothScaleDeg=smoothScaleDeg, policy=policy)


# -----------------------------------------------------------------------------
def shrinkWCS(origShape, origWCS, scaleFactor):
    """Downsampled (shape, WCS) for quick-look images (``nemo/maps.py:
    820-850``): scaleFactor 0.25 gives quarter resolution."""
    ny, nx = origShape
    outShape = (int(round(ny * scaleFactor)), int(round(nx * scaleFactor)))
    hdr = origWCS.header.copy()
    for ax in (1, 2):
        if "CDELT%d" % ax in hdr:
            hdr["CDELT%d" % ax] = hdr["CDELT%d" % ax] / scaleFactor
        if "CD%d_%d" % (ax, ax) in hdr:
            hdr["CD%d_%d" % (ax, ax)] = hdr["CD%d_%d" % (ax, ax)] \
                / scaleFactor
        if "CRPIX%d" % ax in hdr:
            hdr["CRPIX%d" % ax] = (hdr["CRPIX%d" % ax] - 0.5) \
                * scaleFactor + 0.5
    hdr["NAXIS1"] = outShape[1]
    hdr["NAXIS2"] = outShape[0]
    return outShape, WCS(hdr)


def makeQuickLookMaps(config, scaleFactor=0.25):
    """Quarter-resolution stitched S/N maps for eyeballing tiled runs
    (``makeQuickLookMaps`` config option)."""
    import glob
    if config.origWCS is None:
        return
    outShape, outWCS = shrinkWCS(config.origShape, config.origWCS,
                                 scaleFactor)
    for f in config.parDict["mapFilters"]:
        pattern = os.path.join(config.filteredMapsDir, "*",
                               "%s#*_SNMap.fits" % f["label"])
        if not glob.glob(pattern):
            continue
        outFileName = os.path.join(
            config.filteredMapsDir, "quicklook_%s_SNMap.fits" % f["label"])
        stitchTilesQuickLook(pattern, outFileName, outWCS, outShape)


def stitchTilesQuickLook(filePattern, outFileName, outWCS, outShape,
                         fluxRescale=1.0):
    """Paste tile FITS files into one big map (``maps.py:1027-1080``)."""
    import glob
    outData = np.zeros(outShape)
    inFiles = glob.glob(filePattern)
    if len(inFiles) < 1:
        return None
    for f in inFiles:
        d, header = nfits.read_image(f)
        inWCS = WCS(header)
        coords = inWCS.pix2wcs(np.zeros(d.shape[0]), np.arange(d.shape[0]))
        yOut = np.round(outWCS.wcs2pix(coords[:, 0], coords[:, 1])[:, 1]
                        ).astype(int)
        coordsx = inWCS.pix2wcs(np.arange(d.shape[1]), np.zeros(d.shape[1]))
        xOut = np.round(outWCS.wcs2pix(coordsx[:, 0], coordsx[:, 1])[:, 0]
                        ).astype(int)
        ok_y = (yOut >= 0) & (yOut < outShape[0])
        ok_x = (xOut >= 0) & (xOut < outShape[1])
        outData[np.ix_(yOut[ok_y], xOut[ok_x])] += d[np.ix_(ok_y, ok_x)]
    nfits.write_image(outFileName, outData * fluxRescale, outWCS.header,
                      compressionType="RICE_1")
    return outData


def stitchTiles(config):
    """Stitch per-tile filtered maps, S/N maps and RMS maps into full-size
    maps (``maps.py:958-1024``).  Only filters with saveFilteredMaps: True
    have tiles on disk."""
    from . import completeness

    stitchSpecs = [
        (os.path.join(config.filteredMapsDir, "{tile}",
                      "{label}#{tile}_filteredMap.fits"),
         os.path.join(config.filteredMapsDir,
                      "stitched_{label}_filteredMap.fits"), None),
        (os.path.join(config.filteredMapsDir, "{tile}",
                      "{label}#{tile}_SNMap.fits"),
         os.path.join(config.filteredMapsDir,
                      "stitched_{label}_SNMap.fits"), None),
        (os.path.join(config.selFnDir, "{tile}",
                      "RMSMap_{label}#{tile}.fits"),
         os.path.join(config.selFnDir, "stitched_RMSMap_{label}.fits"),
         "RICE_1"),
    ]
    if config.origWCS is None:
        return
    for filterDict in config.parDict["mapFilters"]:
        if not filterDict["params"].get("saveFilteredMaps"):
            continue
        label = filterDict["label"]
        for pattern, outPattern, compression in stitchSpecs:
            outFileName = outPattern.format(label=label)
            if os.path.exists(outFileName):
                continue
            d = np.zeros((config.origWCS.naxis2, config.origWCS.naxis1))
            found = False
            for tileName in config.tileCoordsDict:
                f = pattern.format(tile=tileName, label=label)
                if not os.path.exists(f):
                    continue
                tileData, _ = nfits.read_image(f)
                try:
                    areaMask, _ = completeness.loadAreaMask(
                        tileName, config.selFnDir)
                except FileNotFoundError:
                    areaMask = np.ones(tileData.shape)
                minX, maxX, minY, maxY = \
                    config.tileCoordsDict[tileName]["clippedSection"]
                h = min(maxY - minY, tileData.shape[0])
                w = min(maxX - minX, tileData.shape[1])
                d[minY:minY + h, minX:minX + w] += \
                    (areaMask[:h, :w] * tileData[:h, :w])
                found = True
            if found:
                nfits.write_image(outFileName, d, config.origWCS.header,
                                  compressionType=compression)
