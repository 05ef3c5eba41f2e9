"""Map and tile runtime: tile loading, preprocessing, simulated skies, model
images, the source-injection test, tiling and stitching.

Port of ``nemo_tpu/maps.py``: :class:`MapDict` (tile loading and the
``preprocess`` chain, with the source-free CMB substitution of sky-sim
contamination runs, ``CMBSimSeed``), :class:`MapDictList`,
:class:`TileDict`, the tiling helpers that :mod:`startup` needs, the
simulated CMB and noise maps and their declination policy
(:func:`simCMBMap`, :func:`simNoiseMap`, :func:`resolveSimMethod`), model
images (:func:`makeModelImage`), beam convolution, source masking, the
injection test and its analyses, the contamination estimates, and the
stitched and quick-look maps of a tiled run.  Bookkeeping is host numpy;
the sims (``ops/grf.py``, ``ops/sht.py``), painting, beam convolution, the
survey-mask apodisation and the pixel window run as torch ops on a
:class:`~nemo_tpu_torch.device.Policy`'s device (a MapDict's ``policy``, the
CPU unless a config gives its own).
"""

import os
import threading

import numpy as np
import torch

from . import catalogs
from . import device as device_mod
from .models import cosmology as cosmo_mod
from .models import profiles, sz
from .models.beams import BeamProfile
from .ops import fourier, grf, imageops, sht
from .utils import fits as nfits
from .utils import timing
from .utils.tables import Table, vstack
from .utils.wcs import WCS, calcAngSepDeg, clipUsingRADecCoords

# Reference API-parity aliases: the unit conversions live in models/sz.py
convertToY = sz.convertToY
convertToDeltaT = sz.convertToDeltaT


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


def pixScaleXRadPerRow(wcs, shape=None):
    """Per-row x pixel scale in radians - on a CAR grid this varies as
    cos(dec) across the tile.  Feeds the declination-aware GRF synthesis
    (``ops.grf.gaussian_field_decaware``), which shrinks the flat-sky
    multipole distortion of the sims at high |dec|."""
    if shape is None:
        shape = (wcs.naxis2, wcs.naxis1)
    ny = shape[0]
    cx = float(shape[1] // 2)
    rows = np.arange(ny, dtype=float)
    out = wcs.pix2wcs(np.full(ny, cx), rows)
    ra0, dec0 = np.asarray(out)[:, 0], np.asarray(out)[:, 1]
    out1 = wcs.pix2wcs(np.full(ny, cx + 1.0), rows)
    ra1, dec1 = np.asarray(out1)[:, 0], np.asarray(out1)[:, 1]
    return np.radians(calcAngSepDeg(ra0, dec0, ra1, dec1))


# Declination policy for simulated skies: the reference synthesises
# CMB/1-f realisations through a curved-sky SHT everywhere; the flat path
# is dec-aware-banded but its residual multipole distortion reaches the
# damping tail above |dec| ~ 40 deg.  method="auto" therefore switches to
# the curved SHT path (ops/sht.py) when any part of the map lies above
# CURVED_SKY_DEC_DEG, and an explicit method="flat" on such a map warns.
CURVED_SKY_DEC_DEG = 40.0
# Band limit for auto-selected curved draws (Legendre cost ~ lmax^2 x
# rings): beyond l ~ 6000 the lensed TT power is < 1e-3 of its peak.
# Explicit method="curved" calls keep their own lmax semantics.
CURVED_AUTO_LMAX = 6000
SIM_METHOD_OVERRIDE = None      # set from the config key simCMBMethod

_warnedFlatHighDec = set()


def maxAbsDecDeg(wcs, shape):
    """Largest |dec| spanned by the map (centre column end rows)."""
    ny = shape[0]
    cx = float(shape[1] // 2)
    decs = [wcs.pix2wcs(cx, 0.0)[1], wcs.pix2wcs(cx, float(ny - 1))[1]]
    return float(np.max(np.abs(decs)))


def resolveSimMethod(wcs, shape, method="auto", context="sim"):
    """Resolve a simulation ``method`` ("auto"/"flat"/"curved") against
    the declination policy; warns (once per context) when flat-sky
    synthesis is explicitly forced on a high-|dec| map."""
    highDec = maxAbsDecDeg(wcs, shape) > CURVED_SKY_DEC_DEG
    if method == "auto":
        if SIM_METHOD_OVERRIDE in ("flat", "curved"):
            method = SIM_METHOD_OVERRIDE
        else:
            return "curved" if highDec else "flat"
    if method == "flat" and highDec and context not in _warnedFlatHighDec:
        import warnings
        warnings.warn(
            "flat-sky %s on a map reaching |dec| = %.1f deg (> %.0f): "
            "the flat multipole distortion is order-unity in the "
            "damping tail there; the reference uses a curved-sky SHT "
            "(pass method='curved' or config simCMBMethod: curved)"
            % (context, maxAbsDecDeg(wcs, shape), CURVED_SKY_DEC_DEG))
        _warnedFlatHighDec.add(context)
    return method


def simGenerator(policy, seed):
    """A ``torch.Generator`` on ``policy``'s device seeded with ``seed``:
    the sims' only source of randomness."""
    return torch.Generator(device=policy.device).manual_seed(int(seed))


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
    ``nemo/maps.py:47-476``.  ``policy`` is the device the preprocess
    steps' torch work runs on (default: the card; :func:`device.policy`
    raises when there is none)."""

    def __init__(self, inputDict, tileCoordsDict=None, policy=None):
        super().__init__(inputDict)
        self.tileCoordsDict = tileCoordsDict
        self.policy = policy or device_mod.policy("cuda")
        self._maskKeys = ["pointSourceMask", "surveyMask", "flagMask",
                          "extendedMask"]
        self.validMapKeys = ["mapFileName", "weightsFileName"] + self._maskKeys

    def copy(self):
        return MapDict(self, tileCoordsDict=self.tileCoordsDict,
                       policy=self.policy)

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
        timing.count("stage.map_reads")
        timing.count("stage.map_read_bytes", data.nbytes)
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
            P = self.policy
            apodMask = imageops.binary_dilate_cross(
                torch.as_tensor(surveyMask > 0, device=P.device), 120)
            apodMask = imageops.gaussian_filter(
                apodMask.to(P.dtype), 20).cpu().numpy()
            data = data * apodMask

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

        # Source-free CMB substitution for contamination sims
        if "CMBSimSeed" in self:
            P = self.policy
            seed = int(self["CMBSimSeed"])
            beam = BeamProfile(beamFileName=self["beamFileName"])
            # declination policy: curved-sky SHT above CURVED_SKY_DEC_DEG,
            # dec-aware banded GRF below
            if resolveSimMethod(wcs, data.shape, "auto",
                                context="CMBSimSeed") == "curved":
                randMap = sht.sim_cmb_map_curved(
                    data.shape, wcs, beamBell=beam.Bell, beamEll=beam.ell,
                    lmax=CURVED_AUTO_LMAX, dtype=P.dtype, device=P.device,
                    generator=simGenerator(P, seed))
            else:
                randMap = grf.sim_cmb_map(
                    data.shape, pixScalesRad(wcs, data.shape),
                    beamBell=beam.Bell, beamEll=beam.ell,
                    dx_rows=pixScaleXRadPerRow(wcs, data.shape),
                    device=P.device, generator=simGenerator(P, seed))
            randMap = randMap.cpu().numpy()
            randMap[weights == 0] = 0
            mask = data != 0
            whiteNoiseLevel = np.zeros(weights.shape)
            whiteNoiseLevel[weights != 0] = 1 / np.sqrt(
                weights[weights != 0])
            noise = grf.sim_noise_map(
                data.shape, whiteNoiseLevel, device=P.device,
                generator=simGenerator(P, seed + 1)).cpu().numpy()
            data = np.where(mask, randMap + noise, 0.0)

        # Injection of model objects (position-recovery / completeness sims)
        if "injectSources" in self:
            inj = self["injectSources"]
            GNFWParams = inj.get("GNFWParams", None)
            validAreaSection = None
            if self.tileCoordsDict is not None and \
                    tileName in self.tileCoordsDict:
                validAreaSection = \
                    self.tileCoordsDict[tileName]["areaMaskInClipSection"]
            modelMap = makeModelImage(
                data.shape, wcs, inj["catalog"], self["beamFileName"],
                obsFreqGHz=self["obsFreqGHz"],
                GNFWParams=GNFWParams if GNFWParams else "default",
                profile=inj.get("profile", "A10"),
                validAreaSection=validAreaSection,
                override=inj.get("override"), policy=self.policy)
            if modelMap is not None:
                modelMap[weights == 0] = 0
                data = data + modelMap

        if self.get("applyBeamConvolution"):
            data = convolveMapWithBeam(data, wcs, self["beamFileName"],
                                       policy=self.policy)

        if "smoothKernel" in self:
            if "smoothAttenuationFactor" in self:
                data = data * self["smoothAttenuationFactor"]
            data = convolveMapWithBeam(data, wcs, self["smoothKernel"],
                                       policy=self.policy)

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
            cats = self["subtractModelFromCatalog"]
            if not isinstance(cats, list):
                cats = [cats]
            for tab in cats:
                if not isinstance(tab, Table):
                    tab = Table.read(tab)
                tab = catalogs.getCatalogWithinImage(tab, data.shape, wcs)
                model = makeModelImage(data.shape, wcs, tab,
                                       self["beamFileName"],
                                       obsFreqGHz=self["obsFreqGHz"],
                                       policy=self.policy)
                if model is not None:
                    data = data - model
                    flagMask = flagMask + (model > 1)

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
    """List of MapDicts sharing a tileCoordsDict (``maps.py:478-499``) and
    a policy (default: the card)."""

    def __init__(self, mapDictList, tileCoordsDict=None, policy=None):
        self.mapDicts = [MapDict(m, tileCoordsDict=tileCoordsDict,
                                 policy=policy)
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
    (the card unless a CPU policy is given; host numpy in and out)."""
    policy = policy or device_mod.policy("cuda")
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
    """High-pass via difference of Gaussians, the smoothing on
    ``policy``'s device (the card unless a CPU policy is given)."""
    return data - smoothMap(data, wcs, RADeg=RADeg, decDeg=decDeg,
                            smoothScaleDeg=smoothScaleDeg, policy=policy)


# -----------------------------------------------------------------------------
# Simulation

def simCMBMap(shape, wcs, noiseLevel=None, beam=None, seed=None,
              method="auto", lmax=None, policy=None):
    """Simulated CMB map (host float64 array) on ``policy``'s device (the
    card unless a CPU policy is given).

    ``method="flat"`` draws a dec-aware flat-sky GRF; ``method="curved"``
    synthesises the realisation through the spherical-harmonic transform on
    the map's iso-latitude rings (``ops/sht.py``, its Legendre contraction
    in the policy's dtype); ``method="auto"`` picks curved above
    ``CURVED_SKY_DEC_DEG`` (band-limited at ``CURVED_AUTO_LMAX``), flat
    below - see :func:`resolveSimMethod`."""
    P = policy or device_mod.policy("cuda")
    if seed is None:
        seed = np.random.randint(0, 2 ** 31 - 1)
    gen = simGenerator(P, seed)
    beamEll = beamBell = None
    if beam is not None:
        if isinstance(beam, str):
            beam = BeamProfile(beamFileName=beam)
        beamEll, beamBell = beam.ell, beam.Bell
    if method == "auto" and lmax is None:
        lmax = CURVED_AUTO_LMAX \
            if resolveSimMethod(wcs, shape, "auto") == "curved" else None
    method = resolveSimMethod(wcs, shape, method, context="simCMBMap")
    if method == "curved":
        return sht.sim_cmb_map_curved(
            shape, wcs, beamBell=beamBell, beamEll=beamEll,
            noiseLevel=noiseLevel, lmax=lmax, dtype=P.dtype,
            device=P.device, generator=gen).cpu().numpy()
    if method != "flat":
        raise ValueError("simCMBMap method must be 'flat' or 'curved'")
    ClTT = None
    if lmax is not None:
        # honour the band limit on the flat path too: zero C_l above lmax
        ClTT = grf.lensedClTT()
        ClTT[int(lmax) + 1:] = 0.0
    return grf.sim_cmb_map(shape, pixScalesRad(wcs, shape),
                           beamBell=beamBell, beamEll=beamEll,
                           noiseLevel=noiseLevel, ClTT=ClTT,
                           dx_rows=pixScaleXRadPerRow(wcs, shape),
                           device=P.device, generator=gen).cpu().numpy()


def simNoiseMap(shape, noiseLevel, wcs=None, lKnee=None, alpha=-3,
                noiseMode="perPixel", seed=None, method="auto", policy=None):
    """White or 1/f noise map (host float64 array) on ``policy``'s device
    (the card unless a CPU policy is given).

    ``method="curved"`` (1/f only) shapes the atmosphere through the
    curved-sky alm round trip; the flat path shapes the same N_l on the
    tile's Fourier grid.  ``method="auto"`` picks curved for 1/f noise
    above ``CURVED_SKY_DEC_DEG`` (white noise always draws flat)."""
    P = policy or device_mod.policy("cuda")
    if seed is None:
        seed = np.random.randint(0, 2 ** 31 - 1)
    gen = simGenerator(P, seed)
    if noiseMode == "perSquareArcmin":
        if lKnee is not None:
            raise ValueError("1/f noise requires noiseMode='perPixel'")
        arcmin2Map = getPixelAreaArcmin2Map(shape, wcs)
        noiseLevel = noiseLevel / arcmin2Map
    if method == "auto":
        method = "flat" if (lKnee is None or wcs is None) \
            else resolveSimMethod(wcs, shape, "auto")
    elif wcs is not None:
        method = resolveSimMethod(wcs, shape, method,
                                  context="simNoiseMap")
    if method == "curved":
        if lKnee is None:
            raise ValueError("method='curved' applies to 1/f noise only")
        return sht.sim_noise_map_curved(
            shape, wcs, noiseLevel, lKnee, alpha=alpha, dtype=P.dtype,
            device=P.device, generator=gen).cpu().numpy()
    pix = pixScalesRad(wcs, shape) if wcs is not None else None
    return grf.sim_noise_map(shape, noiseLevel, pix_scales_rad=pix,
                             lKnee=lKnee, alpha=alpha, device=P.device,
                             generator=gen).cpu().numpy()


def addWhiteNoise(mapData, noisePerPix, seed=None):
    rng = np.random.default_rng(seed)
    return mapData + rng.normal(0, noisePerPix, mapData.shape)


def convolveMapWithBeam(data, wcs, beam, maxDistDegrees=1.0, policy=None):
    """Beam-convolve a map: an exact multiply by B_ell in Fourier space, on
    ``policy``'s device (the card unless a CPU policy is given; host numpy
    in and out)."""
    P = policy or device_mod.policy("cuda")
    if isinstance(beam, str):
        beam = BeamProfile(beamFileName=beam)
    pix = pixScalesRad(wcs, data.shape)
    lmap = fourier.rmodlmap(data.shape, pix)
    Bl2d = np.interp(lmap, beam.ell, beam.Bell, right=0.0)
    fm = fourier.rfft2(P.tensor(np.asarray(data)))
    return fourier.irfft2(fm * P.tensor(Bl2d), data.shape).cpu().numpy()


# -----------------------------------------------------------------------------
def makeModelImage(shape, wcs, catalog, beamFileName, obsFreqGHz=None,
                   GNFWParams="default", profile="A10", cosmoModel=None,
                   applyPixelWindow=True, override=None,
                   validAreaSection=None, minSNR=-99, TCMBAlpha=0,
                   asDevice=False, policy=None):
    """Paint model clusters or point sources into a blank map, on
    ``policy``'s device (the card unless a CPU policy is given).

    Three routes, as the reference: clusters with one ``override`` model
    (z, M500) for every row, painted together with per-row amplitudes
    ``y_c``; clusters row by row (``true_M500c`` or the ``template``
    name); point sources (``deltaT_c``), painted together with the beam.
    Returns None when no object lies in the map (or in
    ``validAreaSection``), else the (float64, writable) host map, or with
    ``asDevice`` the tensor on the policy's device."""
    P = policy or device_mod.policy("cuda")
    if isinstance(catalog, str):
        catalog = Table.read(catalog)
    catalog = catalogs.getCatalogWithinImage(catalog, shape, wcs)

    SNRKey = None
    for k in ("SNR", "fixed_SNR"):
        if k in catalog.keys():
            SNRKey = k
            break
    if SNRKey is not None:
        catalog = catalog[np.asarray(catalog[SNRKey]) > minSNR]

    if validAreaSection is not None and len(catalog) > 0:
        x0, x1, y0, y1 = validAreaSection
        coords = wcs.wcs2pix(np.asarray(catalog["RADeg"], dtype=float),
                             np.asarray(catalog["decDeg"], dtype=float))
        x = coords[:, 0]
        y = coords[:, 1]
        catalog = catalog[(x >= x0) & (x < x1) & (y >= y0) & (y < y1)]

    if len(catalog) == 0:
        return None

    cosmoModel = cosmoModel or cosmo_mod.fiducialCosmoModel()
    pix = pixScalesRad(wcs, shape)
    # dec-aware per-row x scales: the true angular distances at any
    # declination, and tiled painting agrees with full-map painting
    dxRows = pixScaleXRadPerRow(wcs, shape)
    onDevice = {"returnDevice": True, "dx_rows": dxRows,
                "device": P.device, "dtype": P.dtype}

    beam = BeamProfile(beamFileName=beamFileName)

    isCluster = ("y_c" in catalog.keys() or "true_y_c" in catalog.keys())
    coords = wcs.wcs2pix(np.asarray(catalog["RADeg"], dtype=float),
                         np.asarray(catalog["decDeg"], dtype=float))
    xs, ys = coords[:, 0], coords[:, 1]
    if isCluster:
        makeSignalMap = profiles.makeArnaudModelSignalMap if profile == "A10" \
            else profiles.makeBattagliaModelSignalMap
        if override is not None:
            z = override["redshift"]
            M500 = override["M500"]
            y0s = np.asarray(catalog["y_c"], dtype=float) * 1e-4
            theta500 = cosmo_mod.calcTheta500Arcmin(z, M500, cosmoModel)
            maxSizeDeg = _quantizeSizeDeg(5 * theta500 / 60)
            modelMap = makeSignalMap(
                z, M500, shape, pix, beam=beam, ys=ys, xs=xs,
                GNFWParams=GNFWParams, amplitude=y0s,
                maxSizeDeg=maxSizeDeg, cosmoModel=cosmoModel, **onDevice)
            if obsFreqGHz is not None:
                modelMap = sz.convertToDeltaT(modelMap,
                                              obsFrequencyGHz=obsFreqGHz,
                                              TCMBAlpha=TCMBAlpha, z=z)
        else:
            modelMap = torch.zeros(shape, dtype=P.dtype, device=P.device)
            for i, row in enumerate(catalog):
                if "true_M500c" in catalog.keys():
                    M500 = row["true_M500c"] * 1e14
                    z = row["redshift"]
                    y0 = row["true_y_c"] * 1e-4
                else:
                    if "template" not in catalog.keys():
                        raise ValueError("No M500, z, or template column "
                                         "found in catalog")
                    bits = str(row["template"]).split("#")[0].split("_")
                    M500 = float(bits[1][1:].replace("p", "."))
                    z = float(bits[2][1:].replace("p", "."))
                    y0 = row["y_c"] * 1e-4
                theta500 = cosmo_mod.calcTheta500Arcmin(z, M500, cosmoModel)
                maxSizeDeg = _quantizeSizeDeg(5 * theta500 / 60)
                signalMap = makeSignalMap(
                    z, M500, shape, pix, beam=beam, ys=[ys[i]], xs=[xs[i]],
                    GNFWParams=GNFWParams, amplitude=y0,
                    maxSizeDeg=maxSizeDeg, cosmoModel=cosmoModel,
                    **onDevice)
                if obsFreqGHz is not None:
                    signalMap = sz.convertToDeltaT(
                        signalMap, obsFrequencyGHz=obsFreqGHz,
                        TCMBAlpha=TCMBAlpha, z=z)
                modelMap = modelMap + signalMap
    else:
        # point sources, all sharing the beam profile: painted together
        amps = np.asarray(catalog["deltaT_c"], dtype=float)
        numFWHM = 5.0
        maxSizeDeg = _quantizeSizeDeg((beam.FWHMArcmin * numFWHM) / 60)
        modelMap = profiles.makeBeamModelSignalMap(
            shape, pix, beam, ys=ys, xs=xs, amplitude=amps,
            maxSizeDeg=maxSizeDeg, **onDevice)

    if applyPixelWindow:
        modelMap = fourier.apply_pixel_window(modelMap, pow=1.0)
    if asDevice:
        return modelMap
    return modelMap.cpu().numpy().astype(np.float64)


def _quantizeSizeDeg(sizeDeg, steps=(0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 15.0)):
    """Painting truncation radius rounded up to one of a few steps (the
    JAX package's rule, kept so both packages paint the same windows)."""
    for s in steps:
        if sizeDeg <= s:
            return s
    return steps[-1]


def maskOutSources(mapData, wcs, catalog, radiusArcmin=7.0, mask=0.0,
                   growMaskedArea=1.0):
    """Blank circular regions at catalog positions (``maps.py:1083-1157``)."""
    maskMap = np.zeros(mapData.shape)
    maskedData = np.array(mapData, dtype=np.float64)
    rng = np.random.default_rng(1234)
    for row in catalog:
        holeMask = _distance_mask(mapData.shape, wcs, row["RADeg"],
                                  row["decDeg"],
                                  (radiusArcmin * growMaskedArea) / 60.0)
        if mask == "whiteNoise":
            annulus = _distance_mask(mapData.shape, wcs, row["RADeg"],
                                     row["decDeg"],
                                     2 * radiusArcmin / 60.0) & ~holeMask
            vals = maskedData[annulus]
            maskedData[holeMask] = rng.normal(vals.mean(), vals.std(),
                                              holeMask.sum())
        else:
            maskedData[holeMask] = mask
        maskMap[holeMask] = 1.0
    return {"data": maskedData, "mask": maskMap}


def applyPointSourceMask(maskFileName, mapData, mapWCS, mask=0.0,
                         radiusArcmin=2.8):
    """Blank map regions under a point-source mask file
    (``maps.py:1160-1209``)."""
    psMask, _ = nfits.read_image(maskFileName)
    out = np.array(mapData)
    out[np.asarray(psMask) == 0] = mask
    return out


# -----------------------------------------------------------------------------
def getPixelAreaArcmin2Map(shape, wcs):
    """Pixel area in arcmin^2 vs position (``maps.py:1461-1482``)."""
    RACentre, decCentre = wcs.getCentreWCSCoords()
    x0, y0 = wcs.wcs2pix(RACentre, decCentre)
    x1 = x0 + 1
    ys = np.arange(shape[0], dtype=float)
    ra0, dec0 = wcs.pix2wcs(np.full(shape[0], x0), ys)[:, 0], \
        wcs.pix2wcs(np.full(shape[0], x0), ys)[:, 1]
    ra1, dec1 = wcs.pix2wcs(np.full(shape[0], x1), ys + 1)[:, 0], \
        wcs.pix2wcs(np.full(shape[0], x1), ys + 1)[:, 1]
    xPixScale = calcAngSepDeg(ra0, dec0, ra1, dec0)
    yPixScale = calcAngSepDeg(ra0, dec0, ra0, dec1)
    pixAreas = xPixScale * yPixScale * 3600.0
    return np.tile(pixAreas[:, None], (1, shape[1]))


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


def makeExtendedSourceMask(config, tileName):
    """Find extended sources via a difference-of-Gaussians band-pass and
    threshold, writing a per-tile extended mask and wiring it into the
    config's map dicts (``maps.py:2474-2533``).

    The two background subtractions and the dilation run on
    ``config.policy``'s device; the global clip, the median and the
    size cut (``scipy.ndimage.label``) on the host, as in the JAX
    package."""
    from scipy import ndimage

    P = config.policy
    settings = config.parDict["findAndMaskExtended"]
    maskCube = []
    wcs = None
    for mapDict in config.unfilteredMapsDictList:
        data, wcs = mapDict.loadTile("mapFileName", tileName, returnWCS=True)
        data = np.asarray(data, dtype=float)
        weights = mapDict.loadTile("weightsFileName", tileName) \
            if mapDict.get("weightsFileName") else np.ones(data.shape)
        weights = np.asarray(weights, dtype=float)
        if weights.ndim == 3:
            weights = weights[0]
        valid = weights > 0
        whiteNoiseLevel = np.zeros(weights.shape)
        whiteNoiseLevel[valid] = 1 / np.sqrt(weights[valid])
        # Band-pass to isolate extended scales
        s = subtractBackground(data, wcs,
                               smoothScaleDeg=settings["bigScaleDeg"],
                               policy=P) \
            - subtractBackground(data, wcs,
                                 smoothScaleDeg=settings["smallScaleDeg"],
                                 policy=P)
        # Global 3-sigma clipped noise, scaled by the white-noise map
        mean, sigma = 0.0, 1e6
        vals = s.ravel()
        for _ in range(10):
            sel = np.abs(vals - mean) < 3 * sigma
            mean, sigma = np.mean(vals[sel]), np.std(vals[sel])
        med = np.median(whiteNoiseLevel[valid])
        if med > 0:
            whiteNoiseLevel[valid] *= sigma / med
        snr = np.zeros(s.shape)
        snr[valid] = s[valid] / whiteNoiseLevel[valid]
        extendedMask = (snr > settings["thresholdSigma"]).astype(np.uint8)
        if settings.get("dilationPix", 0) > 0:
            extendedMask = imageops.binary_dilate_cross(
                torch.as_tensor(extendedMask > 0, device=P.device),
                settings["dilationPix"]).cpu().numpy().astype(np.uint8)
        maskCube.append(extendedMask)
    extendedMask = (np.sum(maskCube, axis=0) > 0).astype(np.uint8)

    if settings.get("minSizeArcmin2", 0) > 0:
        arcmin2Map = getPixelAreaArcmin2Map(extendedMask.shape, wcs)
        segMap, numObjects = ndimage.label(extendedMask)
        for i in range(1, numObjects + 1):
            sel = segMap == i
            if arcmin2Map[sel].sum() < settings["minSizeArcmin2"]:
                extendedMask[sel] = 0

    outDir = os.path.join(config.diagnosticsDir, "extendedMask")
    os.makedirs(outDir, exist_ok=True)
    nfits.write_image(os.path.join(outDir, tileName + ".fits"),
                      extendedMask, wcs.header, compressionType="PLIO_1")
    for mapDict in config.unfilteredMapsDictList:
        mapDict["extendedMask"] = outDir
    return extendedMask


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



# -----------------------------------------------------------------------------
def sourceInjectionTest(config, rng=None):
    """Inject objects with known properties, re-run the finder with cached
    filters, and record position/flux recovery vs S/N
    (``maps.py:1902-2199``).

    Returns a Table with columns RADeg, decDeg, sourceInjectionModel,
    [theta500Arcmin,] SNR, rArcmin, inFlux, outFlux, noiseLevel, tileName.
    """
    from . import pipelines
    from .models import cosmology as cosmo_mod

    realExclusionRadiusArcmin = 5.0
    rng = rng or np.random.default_rng(config.parDict.get("seed"))

    numIterations = config.parDict.get("sourceInjectionIterations", 1)
    if "sourceInjectionModels" in config.parDict:
        clusterMode = True
        sourceInjectionModelList = config.parDict["sourceInjectionModels"]
        fluxCol = "y_c"
        noiseLevelCol = "err_y_c"
        fiducial = cosmo_mod.fiducialCosmoModel()
        for m in sourceInjectionModelList:
            theta = cosmo_mod.calcTheta500Arcmin(m["redshift"], m["M500"],
                                                 fiducial)
            m["label"] = "%.2f" % theta
            m["theta500Arcmin"] = theta
    else:
        clusterMode = False
        sourceInjectionModelList = [{"label": "pointSource"}]
        fluxCol = "deltaT_c"
        noiseLevelCol = "err_deltaT_c"
    numSourcesPerTile = config.parDict.get("sourcesPerTile", 300)

    catFileName = os.path.join(
        config.rootOutDir, "%s_optimalCatalog.fits"
        % os.path.split(config.rootOutDir)[-1])
    if not os.path.exists(catFileName):
        raise FileNotFoundError("Catalog %s needed for injection test"
                                % catFileName)
    realCatalog = Table.read(catFileName)

    results = {m["label"]: {"RADeg": [], "decDeg": [], "SNR": [],
                            "rArcmin": [], "inFlux": [], "outFlux": [],
                            "noiseLevel": [], "tileName": []}
               for m in sourceInjectionModelList}
    allInputCatalogs = []

    for modelCount, model in enumerate(sourceInjectionModelList, 1):
        print(">>> Source injection model: %d/%d"
              % (modelCount, len(sourceInjectionModelList)))
        for it in range(numIterations):
            config.restoreConfig()
            for filtDict in config.parDict["mapFilters"]:
                filtDict["params"]["GNFWParams"] = \
                    config.parDict["GNFWParams"]
                filtDict["params"]["saveFilteredMaps"] = False
                filtDict["params"]["savePlots"] = False
            # Reference filter only (maps.py:2019-2025)
            photFilter = config.parDict["photFilter"]
            filtDict = next(
                (f for f in config.parDict["mapFilters"]
                 if photFilter is None or f["label"] == photFilter),
                config.parDict["mapFilters"][0])
            config.parDict["mapFilters"] = [filtDict]

            if "ArnaudModel" in filtDict["class"]:
                ampRange = config.parDict.get(
                    "sourceInjectionAmplitudeRange", [0.001, 10])
                if ampRange == "auto":
                    ampRange = [np.min(realCatalog["fixed_y_c"]) * 0.5,
                                np.max(realCatalog["fixed_y_c"])]
                distribution = config.parDict.get(
                    "sourceInjectionDistribution", "linear")
                mockCatalog = catalogs.generateTestCatalog(
                    config, numSourcesPerTile,
                    amplitudeColumnName=fluxCol, amplitudeRange=ampRange,
                    amplitudeDistribution=distribution, maskDilationPix=20,
                    seed=rng.integers(0, 2 ** 31 - 1))
                injectSources = {"catalog": mockCatalog,
                                 "GNFWParams": config.parDict["GNFWParams"],
                                 "override": model, "profile": "A10"}
            elif "Beam" in filtDict["class"]:
                ampRange = config.parDict.get(
                    "sourceInjectionAmplitudeRange", [1, 1000])
                distribution = config.parDict.get(
                    "sourceInjectionDistribution", "log")
                mockCatalog = catalogs.generateTestCatalog(
                    config, numSourcesPerTile,
                    amplitudeColumnName=fluxCol, amplitudeRange=ampRange,
                    amplitudeDistribution=distribution, maskDilationPix=20,
                    seed=rng.integers(0, 2 ** 31 - 1))
                injectSources = {"catalog": mockCatalog, "override": model,
                                 "profile": None}
            else:
                raise ValueError("No injection catalog generator for "
                                 "filter class '%s'" % filtDict["class"])
            if "theta500Arcmin" in model:
                mockCatalog["theta500Arcmin"] = model["theta500Arcmin"]
            allInputCatalogs.append(mockCatalog)

            for mapDict in config.unfilteredMapsDictList:
                mapDict["injectSources"] = injectSources
                mapDict["_preprocessedTile"] = None  # force re-preprocess

            if len(mockCatalog) == 0:
                continue
            recCatalog = pipelines.filterMapsAndMakeCatalogs(
                config, useCachedFilters=True, useCachedRMSMap=True,
                writeAreaMask=False, writeFlagMask=False, verbose=False)
            if len(recCatalog) > 0:
                recCatalog = catalogs.removeCrossMatched(
                    recCatalog, realCatalog,
                    radiusArcmin=realExclusionRadiusArcmin)
            if len(recCatalog) == 0:
                continue
            x_mock, x_rec, rDeg = catalogs.crossMatch(
                mockCatalog, recCatalog,
                radiusArcmin=realExclusionRadiusArcmin)
            # Bright injected objects recovered far off position signal a
            # pipeline problem (reference maps.py:2115-2131)
            offsets = np.asarray(rDeg, dtype=float)
            snrs = np.asarray(x_rec["SNR"], dtype=float)
            bad = np.logical_and(offsets > 1.5, snrs > 10)
            if bad.any():
                msg = ("Recovered %d bright injected source(s) at "
                       "> 1.5 arcmin offset" % int(bad.sum()))
                if config.parDict.get("haltOnPositionRecoveryProblem"):
                    raise RuntimeError(msg)
                print("... Warning: %s ..." % msg)
            r = results[model["label"]]
            r["RADeg"] += list(np.asarray(x_rec["RADeg"]))
            r["decDeg"] += list(np.asarray(x_rec["decDeg"]))
            r["SNR"] += list(np.asarray(x_rec["SNR"]))
            r["rArcmin"] += list(rDeg)
            r["inFlux"] += list(np.asarray(x_mock[fluxCol]))
            r["outFlux"] += list(np.asarray(x_rec[fluxCol]))
            r["noiseLevel"] += list(np.asarray(x_rec[noiseLevelCol]))
            r["tileName"] += list(np.asarray(x_rec["tileName"]))

    # Collect everything (maps.py:2151-2186)
    cols = {"RADeg": [], "decDeg": [], "sourceInjectionModel": [],
            "SNR": [], "rArcmin": [], "inFlux": [], "outFlux": [],
            "noiseLevel": [], "tileName": []}
    theta500s = []
    for model in sourceInjectionModelList:
        label = model["label"]
        n = len(results[label]["SNR"])
        cols["sourceInjectionModel"] += [label] * n
        if "theta500Arcmin" in model:
            theta500s += [model["theta500Arcmin"]] * n
        for key in ("RADeg", "decDeg", "SNR", "rArcmin", "inFlux",
                    "outFlux", "noiseLevel", "tileName"):
            cols[key] += results[label][key]
    resultsTable = Table({k: np.array(v) for k, v in cols.items()})
    if len(theta500s) == len(resultsTable):
        resultsTable["theta500Arcmin"] = np.array(theta500s)

    allInputTab = vstack(allInputCatalogs)
    allInputTab.rename_column(fluxCol, "inFlux")
    allInputTab = catalogs.removeCrossMatched(
        allInputTab, realCatalog, radiusArcmin=realExclusionRadiusArcmin)
    allInputTab.write(os.path.join(config.selFnDir,
                                   "sourceInjectionInputCatalog.fits"))
    config.restoreConfig()
    for mapDict in config.unfilteredMapsDictList:
        mapDict.pop("injectSources", None)
        mapDict["_preprocessedTile"] = None
    return resultsTable


def positionRecoveryAnalysis(posRecTable, plotFileName,
                             percentiles=[50, 95, 99.7], plotRawData=True,
                             pickleFileName=None, selFnDir=None):
    """Fit the position-recovery model offset(SNR) and plot
    (``maps.py:2202-2344``)."""
    import pickle
    from scipy.optimize import curve_fit

    snr = np.asarray(posRecTable["SNR"], dtype=float)
    rArcmin = np.asarray(posRecTable["rArcmin"], dtype=float)
    binEdges = np.linspace(max(snr.min(), 4.0), min(snr.max(), 20.0), 11)
    fitResults = {}
    for percentile in percentiles:
        centres, values = [], []
        for i in range(len(binEdges) - 1):
            sel = (snr >= binEdges[i]) & (snr < binEdges[i + 1])
            if sel.sum() >= 5:
                centres.append((binEdges[i] + binEdges[i + 1]) / 2)
                values.append(np.percentile(rArcmin[sel], percentile))
        centres = np.array(centres)
        values = np.array(values)
        params = None
        if len(centres) >= 3:
            try:
                params, _ = curve_fit(catalogs._posRecFitFunc, centres,
                                      values, p0=[1.16, 0.7, 38.0],
                                      maxfev=20000)
            except Exception:
                params = None
        fitResults[percentile] = {"centres": centres, "values": values,
                                  "params": params}
    if pickleFileName is not None:
        with open(pickleFileName, "wb") as f:
            pickle.dump(fitResults, f)
    if selFnDir is not None and fitResults.get(99.7, {}).get("params") \
            is not None:
        with open(os.path.join(selFnDir, "positionRecoveryModel.pkl"),
                  "wb") as f:
            pickle.dump({"func": "posRecFitFunc",
                         "params": fitResults[99.7]["params"]}, f)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(9, 6.5))
        if plotRawData:
            plt.plot(snr, rArcmin, ".", alpha=0.3, label="raw")
        for percentile, d in fitResults.items():
            if len(d["centres"]):
                plt.plot(d["centres"], d["values"], "o-",
                         label="%.1f%%" % percentile)
        plt.semilogy()
        plt.xlabel("SNR")
        plt.ylabel("offset (arcmin)")
        plt.legend()
        plt.savefig(plotFileName)
        plt.close(fig)
    except Exception:
        pass
    return fitResults


def noiseBiasAnalysis(sourceInjTable, plotFileName=None,
                      sourceInjectionModel=None):
    """Quantify flux 'optimization bias' vs S/N from source-injection
    results (``maps.py:2347-2368``): the ratio outFlux/inFlux binned by
    recovered SNR, fit with the reference's snr-fold model."""
    from scipy.optimize import curve_fit

    tab = sourceInjTable
    if sourceInjectionModel is not None and \
            "sourceInjectionModel" in tab.keys():
        tab = tab[np.asarray(tab["sourceInjectionModel"])
                  == sourceInjectionModel]
    snr = np.asarray(tab["SNR"], dtype=float)
    ratio = np.asarray(tab["outFlux"], dtype=float) \
        / np.asarray(tab["inFlux"], dtype=float)
    binEdges = np.linspace(max(4.0, snr.min()), min(snr.max(), 20.0), 11)
    centres, med = [], []
    for i in range(len(binEdges) - 1):
        sel = (snr >= binEdges[i]) & (snr < binEdges[i + 1])
        if sel.sum() >= 5:
            centres.append((binEdges[i] + binEdges[i + 1]) / 2)
            med.append(np.median(ratio[sel]))
    centres = np.array(centres)
    med = np.array(med)

    def biasFunc(s, snrFold, pedestal, norm):
        return norm * np.exp(-s / snrFold) + pedestal

    params = None
    if len(centres) >= 3:
        try:
            params, _ = curve_fit(biasFunc, centres, med,
                                  p0=[2.0, 1.0, 0.5], maxfev=20000)
        except Exception:
            params = None
    if plotFileName is not None:
        try:
            from . import plotSettings
            plotSettings.update_rcParams()
            import matplotlib.pyplot as plt
            plt.figure(figsize=(9, 6.5))
            plt.plot(snr, ratio, ".", alpha=0.3)
            plt.plot(centres, med, "o-", label="median")
            plt.axhline(1.0, color="k", ls="--")
            plt.xlabel("SNR")
            plt.ylabel("outFlux / inFlux")
            plt.legend()
            plt.savefig(plotFileName)
            plt.close()
        except Exception:
            pass
    return {"func": biasFunc, "params": params, "binCentres": centres,
            "medianRatio": med}


# -----------------------------------------------------------------------------
# Contamination estimates

def estimateContaminationFromInvertedMaps(config, imageDict=None):
    """Run the finder on sign-inverted maps to estimate the contamination
    rate (``maps.py:1589-1619``)."""
    from . import pipelines
    invertedCatalog = pipelines.filterMapsAndMakeCatalogs(
        config, useCachedFilters=True, invertMap=True, writeAreaMask=False,
        writeFlagMask=False, verbose=False)
    return invertedCatalog


def estimateContaminationFromSkySim(config, imageDict=None, numSkySims=None,
                                    seedBase=8000):
    """Run the finder on source-free CMB+noise sims made on the fly
    (``maps.py:1485-1586``).  Returns a list of catalogs, one per sim."""
    from . import pipelines
    if numSkySims is None:
        numSkySims = config.parDict.get("numSkySims", 10)
    catalogsList = []
    for i in range(numSkySims):
        config.restoreConfig()
        for mapDict in config.unfilteredMapsDictList:
            mapDict["CMBSimSeed"] = seedBase + i
            mapDict["_preprocessedTile"] = None
        simCatalog = pipelines.filterMapsAndMakeCatalogs(
            config, useCachedFilters=True, writeAreaMask=False,
            writeFlagMask=False, verbose=False)
        catalogsList.append(simCatalog)
    config.restoreConfig()
    for mapDict in config.unfilteredMapsDictList:
        mapDict.pop("CMBSimSeed", None)
        mapDict["_preprocessedTile"] = None
    return catalogsList


def plotContamination(contamTabDict, diagnosticsDir):
    """Contamination-rate plots + interpolated useful-fraction text files
    (``maps.py:1622-1665``).  Consumes the tables produced by
    :func:`estimateContamination` (keys ``<label>_<SNRKey>``)."""
    for k, tab in contamTabDict.items():
        SNRKey = "fixed_SNR" if "fixed" in k else "SNR"
        if SNRKey not in tab.keys():
            continue
        cuts = np.asarray(tab[SNRKey], dtype=float)
        contam = np.asarray(tab["contaminationRate"], dtype=float)
        try:
            from . import plotSettings
            plotSettings.update_rcParams()
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            plt.figure(figsize=(9, 6.5))
            plt.plot(cuts, contam, "k-")
            plt.xlabel(SNRKey.replace("_", " "))
            plt.ylabel("Contamination fraction > %s" % SNRKey)
            plt.xlim(cuts.min(), cuts.max())
            plt.ylim(-0.05, 0.6)
            plt.savefig(os.path.join(diagnosticsDir,
                                     "%s_contaminationEstimate.pdf" % k))
            plt.close()
        except Exception as exc:  # plotting must never kill a survey run
            print("... WARNING: contamination plot failed: %s" % exc)
        fineSNRs = np.linspace(cuts.min(), cuts.max(), 1000)
        fineContam = np.interp(fineSNRs, cuts, contam)
        outTxt = os.path.join(
            diagnosticsDir, "%s_contaminationEstimate_usefulFractions.txt"
            % k)
        with open(outTxt, "w") as f:
            for frac in (0.4, 0.3, 0.2, 0.1, 0.05, 0.01):
                SNRf = fineSNRs[np.argmin(abs(fineContam - frac))]
                line = ("... contamination fraction = %.2f for %s > %.3f"
                        " ..." % (frac, SNRKey, SNRf))
                print(line)
                f.write(line + "\n")


def estimateContamination(contamSimDict, imageDict, SNRKeys, label,
                          diagnosticsDir=None):
    """Contamination fraction vs S/N cut, comparing sim (source-free)
    detections against the real catalog (``maps.py:1668-1731``)."""
    simCatalog = contamSimDict
    realCatalog = imageDict
    out = {}
    for SNRKey in SNRKeys:
        cuts = np.linspace(4.0, 10.0, 13)
        contamRate = np.zeros(len(cuts))
        for i, cut in enumerate(cuts):
            nSim = int(np.sum(np.asarray(simCatalog[SNRKey]) > cut)) \
                if len(simCatalog) > 0 and SNRKey in simCatalog.keys() else 0
            nReal = int(np.sum(np.asarray(realCatalog[SNRKey]) > cut)) \
                if len(realCatalog) > 0 and SNRKey in realCatalog.keys() \
                else 0
            contamRate[i] = nSim / nReal if nReal > 0 else 0.0
        tab = Table({SNRKey: cuts,
                     "contaminationRate": contamRate})
        out[label + "_" + SNRKey] = tab
        if diagnosticsDir is not None:
            tab.write(os.path.join(
                diagnosticsDir, "contaminationEstimate_%s_%s.fits"
                % (label, SNRKey)))
    return out


def saveFITS(outputFileName, mapData, wcs, compressionType=None):
    """Write a map to FITS with NEMOVER provenance (``maps.py:2371``)."""
    nfits.write_image(outputFileName, mapData,
                      wcs.header if wcs is not None else None,
                      compressionType=compressionType)
