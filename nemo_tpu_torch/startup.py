"""Configuration parsing and pipeline set-up.

Port of ``nemo_tpu/startup.py`` (itself a rebuild of ``nemo/startUp.py``);
the YAML schema is the reference's, so existing configs run unmodified.
PyYAML is imported only by the functions that read or write YAML: a config
given as a dict goes through :func:`parseConfigDict` and needs no YAML at
all.  :class:`NemoConfig` carries the device policy
(:mod:`nemo_tpu_torch.device`) that the pipeline runs on.
"""

import copy
import os
import pickle
import time

import numpy as np

from . import device as device_mod
from . import maps
from .utils import fits as nfits
from .utils.wcs import WCS


def parseConfigFile(parDictFileName, verbose=False):
    """Parse a Nemo .yml config (``startUp.py:21-199``): the YAML load,
    :func:`parseConfigDict`, and the file's ctime provenance stamp."""
    import yaml
    with open(parDictFileName) as stream:
        parDict = yaml.safe_load(stream)
    parDict = parseConfigDict(parDict)
    # config-file provenance stamp (startUp.py:179; set-but-unread in the
    # reference too - kept for parsed-dict parity)
    parDict["_file_last_modified_ctime"] = os.path.getctime(parDictFileName)
    return parDict


def parseConfigDict(parDict):
    """Parse a config dict exactly as :func:`parseConfigFile` parses a
    file: mask-key hoisting, allFilters deep-merge, photFilter save flags,
    defaults, renames.  Updates and returns ``parDict``."""
    maskKeys = ["pointSourceMask", "surveyMask", "flagMask",
                "maskPointSourcesFromCatalog", "apodizeUsingSurveyMask",
                "maskSubtractedPointSources", "RADecSection",
                "maskHoleDilationFactor", "reprojectToTan"]
    for mapDict in parDict["unfilteredMaps"]:
        for k in maskKeys:
            mapDict[k] = parDict.get(k, None) if k in parDict else \
                mapDict.get(k, None)
        if "weightsType" not in mapDict:
            mapDict["weightsType"] = "invVar"

    # allFilters defaults deep-merged into each mapFilters entry (3 levels)
    if "allFilters" in parDict:
        merged = []
        for filterDict in parDict["mapFilters"]:
            newDict = copy.deepcopy(parDict["allFilters"])
            _deep_merge(newDict, filterDict, depth=3)
            merged.append(newDict)
        parDict["mapFilters"] = merged

    if "photFilter" not in parDict:
        parDict["photFilter"] = None
    else:
        for filtDict in parDict["mapFilters"]:
            if filtDict["label"] == parDict["photFilter"]:
                filtDict["params"]["saveRMSMap"] = True
                filtDict["params"]["saveFreqWeightMap"] = True
                filtDict["params"]["saveFilter"] = True

    if parDict.get("noiseMaskCatalog"):
        # The reference copies this into filter params under the same name
        # (startUp.py:93-95) but its consumer is the noiseModelCatalog
        # machinery - route it there so the objects are actually subtracted
        # from the noise-model maps.
        for filtDict in parDict["mapFilters"]:
            filtDict["params"]["noiseMaskCatalog"] = \
                parDict["noiseMaskCatalog"]
            existing = filtDict["params"].get("noiseModelCatalog") or []
            if not isinstance(existing, list):
                existing = [existing]
            filtDict["params"]["noiseModelCatalog"] = \
                existing + [parDict["noiseMaskCatalog"]]

    if "tileDefinitions" in parDict and \
            isinstance(parDict["tileDefinitions"], list):
        seen = set()
        for tileDef in parDict["tileDefinitions"]:
            tileDef["tileName"] = tileDef["tileName"].upper()
            if tileDef["tileName"] in seen:
                raise ValueError("Duplicate tileName '%s'"
                                 % tileDef["tileName"])
            seen.add(tileDef["tileName"])
    if "tileNameList" in parDict:
        parDict["tileNameList"] = [t.upper()
                                   for t in parDict["tileNameList"]]

    defaults = {
        "reprojectToTan": False,
        "catalogCuts": [],
        "measureShapes": False,
        "rejectBorder": 0,
        "undoPixelWindow": True,
        "fitQ": False,
        "calcSelFn": False,
        "useTiling": False,
        "GNFWParams": "default",
        "forcedPhotometryCatalog": None,
        "removeRings": True,
        "ringThresholdSigma": 3,
        "haltOnPositionRecoveryProblem": False,
        "useInterpolator": True,
        "thresholdSigma": 4.0,
        "minObjPix": 3,
        "findCenterOfMass": True,
        "objIdent": "ACT-CL",
        "longNames": False,
        "twoPass": None,
    }
    for key, val in defaults.items():
        if key not in parDict:
            parDict[key] = val

    # Simulated-sky geometry policy: "auto" (default; curved-sky SHT
    # above maps.CURVED_SKY_DEC_DEG, dec-aware flat GRF below), or an
    # explicit "flat"/"curved" override applied to every auto call.
    simMethod = parDict.get("simCMBMethod")
    if simMethod is not None:
        if simMethod not in ("flat", "curved", "auto"):
            raise ValueError("simCMBMethod must be 'flat', 'curved' or "
                             "'auto'")
        from . import maps as maps_mod
        maps_mod.SIM_METHOD_OVERRIDE = None if simMethod == "auto" \
            else simMethod

    if "selFnOptions" in parDict:
        parDict["selFnOptions"].setdefault("method", "fast")
        if parDict["selFnOptions"]["method"] not in ("fast", "injection"):
            raise ValueError("selFn method must be 'fast' or 'injection'")
        if "QSource" not in parDict["selFnOptions"]:
            parDict["selFnOptions"]["QSource"] = \
                "fit" if parDict["fitQ"] else "injection"

    if "stitchTiles" not in parDict:
        parDict["stitchTiles"] = bool(parDict["useTiling"])

    # batched-engine options (parallel/engine.py); "auto" = on with a GPU
    for key in ("useDeviceDetection", "bankPaintBatch"):
        value = parDict.get(key, "auto")
        if not (isinstance(value, bool) or value == "auto"):
            raise ValueError("%s must be true, false or 'auto'" % key)
    for key in ("deviceBatchSize", "deviceDetectionMaxObjects"):
        if key in parDict and (isinstance(parDict[key], bool)
                               or not isinstance(parDict[key], int)
                               or parDict[key] < 1):
            raise ValueError("%s must be a positive integer" % key)

    for filtDict in parDict["mapFilters"]:
        filtDict["params"]["GNFWParams"] = parDict["GNFWParams"]

    massDefaults = {"tenToA0": 4.95e-5, "B0": 0.08, "Mpivot": 3.0e14,
                    "sigma_int": 0.2, "relativisticCorrection": True,
                    "rhoType": "critical", "delta": 500, "H0": 70.0,
                    "Om0": 0.3, "Ob0": 0.05, "sigma8": 0.80, "ns": 0.95,
                    "concMassRelation": "Bhattacharya13"}
    parDict.setdefault("massOptions", {})
    for key, val in massDefaults.items():
        parDict["massOptions"].setdefault(key, val)

    # renamed / removed keys (startUp.py:181-194)
    oldKeyMap = {"makeTileDir": "useTiling", "tileDefLabel": None,
                 "twoPass": None,
                 "clusterInjectionModels": "sourceInjectionModels"}
    for k, new in oldKeyMap.items():
        if k in parDict and new is None and k != "twoPass":
            del parDict[k]
        elif k in parDict and isinstance(new, str):
            parDict[new] = parDict[k]
            del parDict[k]
    return parDict


def _deep_merge(base, override, depth=3):
    for key, val in override.items():
        if depth > 0 and isinstance(val, dict) and \
                isinstance(base.get(key), dict):
            _deep_merge(base[key], val, depth=depth - 1)
        else:
            base[key] = val


class NemoConfig:
    """Pipeline configuration object (``startUp.py:202-417``).

    Args mirror the reference; ``MPIEnabled`` is accepted for CLI
    compatibility (one process runs every tile).  ``config`` is a .yml
    path, or a dict already parsed by :func:`parseConfigDict`.
    ``device``/``x64`` set the device policy (:func:`device.policy`):
    "cuda" (float32, float64 with ``x64``) or "cpu" (float64).
    """

    def __init__(self, config, makeOutputDirs=True, setUpMaps=True,
                 writeTileInfo=False, selFnDir=None, calcSelFn=False,
                 sourceInjectionTest=False, MPIEnabled=False,
                 divideTilesByProcesses=True, verbose=True,
                 strictMPIExceptions=True, device="cuda", x64=False):
        self.policy = device_mod.policy(device, x64=x64)
        self.MPIEnabled = False
        self.rank = 0
        self.size = 1
        self.comm = None
        self.verbose = verbose
        self._timeStarted = time.time()

        if isinstance(config, str):
            self.parDict = parseConfigFile(config, verbose=verbose)
            self.configFileName = config
        elif isinstance(config, dict):
            self.parDict = config
            self.configFileName = ""
        else:
            raise ValueError("config must be a path or a dict")

        if calcSelFn:
            self.parDict["calcSelFn"] = True
        if sourceInjectionTest:
            self.parDict["sourceInjectionTest"] = True

        # Fail early with a clear message when input files are missing
        if setUpMaps:
            missing = []
            for mapDict in self.parDict.get("unfilteredMaps", []):
                for key in ("mapFileName", "weightsFileName",
                            "beamFileName"):
                    path = mapDict.get(key)
                    if path and isinstance(path, str) \
                            and not os.path.exists(path):
                        missing.append("%s: %s" % (key, path))
            maskPath = self.parDict.get("surveyMask")
            if maskPath and isinstance(maskPath, str) \
                    and not os.path.exists(maskPath):
                missing.append("surveyMask: %s" % maskPath)
            if missing:
                raise FileNotFoundError(
                    "Input file(s) named in the config do not exist:\n  "
                    + "\n  ".join(missing))

        # original map WCS/shape (for stitching)
        try:
            hdus = nfits.read(self.parDict["unfilteredMaps"][0]["mapFileName"])
            hdu = next(h for h in hdus if h.data is not None)
            self.origWCS = WCS(hdu.header)
            self.origShape = (self.origWCS.naxis2, self.origWCS.naxis1)
        except Exception:
            self.origWCS = None
            self.origShape = None

        self._origParDict = copy.deepcopy(self.parDict)

        if "outputDir" in self.parDict:
            self.rootOutDir = os.path.abspath(self.parDict["outputDir"])
        else:
            if self.configFileName.find(".yml") == -1 and makeOutputDirs:
                raise ValueError("Config file must have .yml extension")
            self.rootOutDir = os.path.join(
                os.getcwd(),
                os.path.split(self.configFileName.replace(".yml", ""))[-1])
        self.filteredMapsDir = os.path.join(self.rootOutDir, "filteredMaps")
        self.diagnosticsDir = os.path.join(self.rootOutDir, "diagnostics")
        self.selFnDir = os.path.join(self.rootOutDir, "selFn")
        self.mocksDir = os.path.join(self.rootOutDir, "mocks")
        if makeOutputDirs:
            for d in (self.rootOutDir, self.diagnosticsDir,
                      self.filteredMapsDir, self.selFnDir):
                os.makedirs(d, exist_ok=True)
        if selFnDir is not None:
            self.selFnDir = selFnDir

        if setUpMaps:
            self._setUpMaps(writeTileInfo=writeTileInfo)
        else:
            pkl = os.path.join(self.selFnDir, "tileCoordsDict.pkl")
            if not os.path.exists(pkl):
                raise FileNotFoundError(
                    "setUpMaps=False requires a previous run to have "
                    "created %s" % pkl)
            with open(pkl, "rb") as f:
                self.tileCoordsDict = pickle.load(f)
            self.tileNames = list(self.tileCoordsDict.keys())
            self.unfilteredMapsDictList = maps.MapDictList(
                self.parDict["unfilteredMaps"],
                tileCoordsDict=self.tileCoordsDict, policy=self.policy)
            self._origUnfilteredMapsDictList = copy.deepcopy(
                self.unfilteredMapsDictList)

        if "tileNameList" in self.parDict:
            newList = [n for n in self.tileNames
                       if n in self.parDict["tileNameList"]]
            if not newList:
                raise ValueError("tileNameList does not match any tiles")
            self.tileNames = newList

        self.allTileNames = list(self.tileNames)
        self._injectFFTBucket()

        if makeOutputDirs:
            for tileName in self.tileNames:
                for d in (self.diagnosticsDir, self.filteredMapsDir,
                          self.selFnDir):
                    os.makedirs(os.path.join(d, tileName), exist_ok=True)

        self._identifyFilterSets()

    # ------------------------------------------------------------------
    def _identifyFilterSets(self):
        """Multi-pass filter sets (``startUp.py:420-439``)."""
        self.filterSets = []
        self.filterSetOptions = {}
        self.filterSetLabels = {}
        if "filterSetOptions" in self.parDict:
            self.filterSetOptions = self.parDict["filterSetOptions"]
            for filtDict in self.parDict["mapFilters"]:
                for f in filtDict.get("filterSets", []):
                    if f not in self.filterSets:
                        self.filterSets.append(f)
            self.filterSets.sort()
            for setNum in self.filterSetOptions:
                self.filterSetLabels[setNum] = \
                    self.filterSetOptions[setNum].get("label")

    def addAutoTileDefinitions(self, DS9RegionFileName=None,
                               cacheFileName=None):
        """Run the autotiler if tileDefinitions is a target-size dict
        (``startUp.py:442-494``)."""
        if cacheFileName is not None and os.path.exists(cacheFileName):
            import yaml
            with open(cacheFileName) as stream:
                self.parDict["tileDefinitions"] = yaml.safe_load(stream)
            return
        td = self.parDict.get("tileDefinitions")
        if isinstance(td, dict):
            if td.get("mask"):
                surveyMaskPath = td["mask"]
                # memory-efficient load (reference startUp.py:466)
                surveyMask, wcs = maps.chunkLoadMask(surveyMaskPath)
                if surveyMask.ndim == 3:
                    surveyMask = surveyMask[0]
                surveyMask = (surveyMask != 0).astype(np.uint8)
            else:
                surveyMaskPath = \
                    self.parDict["unfilteredMaps"][0]["mapFileName"]
                data, header = nfits.read_image(surveyMaskPath)
                data = np.asarray(data)
                if data.ndim == 3:
                    data = data[0]
                surveyMask = (data != 0).astype(np.uint8)
                wcs = WCS(header)
            self._tileDefinitionsMaskPath = surveyMaskPath
            self.parDict["tileDefinitions"] = maps.autotiler(
                surveyMask, wcs, td["targetTileWidthDeg"],
                td["targetTileHeightDeg"])
            if self.verbose:
                print("... breaking map into %d tiles"
                      % len(self.parDict["tileDefinitions"]))
            if DS9RegionFileName is not None:
                maps.saveTilesDS9RegionsFile(self.parDict, DS9RegionFileName)
            if cacheFileName is not None:
                import yaml
                with open(cacheFileName, "w") as f:
                    f.write(yaml.dump(self.parDict["tileDefinitions"]))

    def getTileCoordsDict(self):
        """Pixel-coordinate tiling info (``startUp.py:497-600``)."""
        clipCoordsDict = {}
        wcsPath = getattr(self, "_tileDefinitionsMaskPath",
                          self.parDict["unfilteredMaps"][0]["mapFileName"])
        hdus = nfits.read(wcsPath)
        hdu = next(h for h in hdus if h.data is not None)
        wcs = WCS(hdu.header)
        extName = hdu.name if hdu.name else "PRIMARY"

        if not self.parDict["useTiling"]:
            clipCoordsDict[extName] = {
                "clippedSection": [0, wcs.naxis1, 0, wcs.naxis2],
                "header": dict(wcs.header),
                "areaMaskInClipSection": [0, wcs.naxis1, 0, wcs.naxis2],
                "reprojectToTan": self.parDict["reprojectToTan"]}
            return clipCoordsDict

        tileOverlapDeg = self.parDict["tileOverlapDeg"]
        shape = (wcs.naxis2, wcs.naxis1)
        dummy = np.empty(shape, dtype=np.uint8)
        for tileDict in self.parDict["tileDefinitions"]:
            name = tileDict["tileName"]
            ra0, ra1, dec0, dec1 = tileDict["RADecSection"]
            x0, y0 = wcs.wcs2pix(ra0, dec0)
            x1, y1 = wcs.wcs2pix(ra1, dec1)
            xMin, xMax = min(x0, x1), max(x0, x1)
            yMin, yMax = min(y0, y1), max(y0, y1)
            ra0c, dec0c = wcs.pix2wcs(xMin, yMin)
            ra1c, dec1c = wcs.pix2wcs(xMax, yMax)
            # grow by the overlap, staying inside the map
            # (startUp.py:546-563)
            pixPerDeg = 1.0 / wcs.getPixelSizeDeg()
            if xMin - tileOverlapDeg * pixPerDeg > 0:
                ra0c = ra0c + tileOverlapDeg
            if xMax + tileOverlapDeg * pixPerDeg < shape[1]:
                ra1c = ra1c - tileOverlapDeg
            if yMin - tileOverlapDeg * pixPerDeg > 0:
                dec0c = dec0c - tileOverlapDeg
            if yMax + tileOverlapDeg * pixPerDeg < shape[0]:
                dec1c = dec1c + tileOverlapDeg
            clip = maps.clipUsingRADecCoords(dummy, wcs, ra1c, ra0c, dec0c,
                                             dec1c)
            # interior (non-overlap) region within the clip
            ra0i, dec0i = wcs.pix2wcs(xMin, yMin)
            ra1i, dec1i = wcs.pix2wcs(xMax, yMax)
            cx0, cy0 = clip["wcs"].wcs2pix(ra0i, dec0i)
            cx1, cy1 = clip["wcs"].wcs2pix(ra1i, dec1i)
            header = dict(clip["wcs"].header)
            # Per-tile noise-region boxes for the real-space matched
            # filter: stamped into the tile header as NRAMIN/NRAMAX/
            # NDEMIN/NDEMAX (the reference's tileDeck convention, read
            # back at filters.py:1084-1086 when noiseParams
            # RADecSection == 'tileNoiseRegions').  Tiles without an
            # explicit entry use their own definition region shrunk by
            # autoBorderDeg (docs/config.rst: "the area of the tile
            # minus autoBorderDeg").
            tnr = self.parDict.get("tileNoiseRegions")
            if tnr:
                if name in tnr:
                    nra0, nra1, nde0, nde1 = tnr[name]
                else:
                    border = float(tnr.get("autoBorderDeg", 0.5))
                    tra0, tra1, tde0, tde1 = tileDict["RADecSection"]
                    sRA = 1.0 if tra1 >= tra0 else -1.0
                    sDec = 1.0 if tde1 >= tde0 else -1.0
                    nra0, nra1 = tra0 + sRA * border, tra1 - sRA * border
                    nde0, nde1 = tde0 + sDec * border, tde1 - sDec * border
                header["NRAMIN"] = float(nra0)
                header["NRAMAX"] = float(nra1)
                header["NDEMIN"] = float(nde0)
                header["NDEMAX"] = float(nde1)
            clipCoordsDict[name] = {
                "clippedSection": clip["clippedSection"],
                "header": header,
                "areaMaskInClipSection": [int(round(cx0)), int(round(cx1)),
                                          int(round(cy0)), int(round(cy1))],
                "reprojectToTan": self.parDict["reprojectToTan"]}
        return clipCoordsDict

    def _injectFFTBucket(self):
        """Survey-wide FFT pad bucket.

        Pad every (large-enough) tile to ONE 5-smooth working shape, as
        the JAX package does (there it bounds recompilation); tiles
        smaller than half the bucket area keep their own padShape.  The
        padded shape fixes the filter's Fourier grid, so the port keeps
        the same rule to build the same filters.  The bucket is stored in
        each filter's params so every construction site derives the
        identical working shape."""
        from .ops import fourier
        shapes = []
        for c in self.tileCoordsDict.values():
            x0, x1, y0, y1 = c["clippedSection"]
            shapes.append((int(y1 - y0), int(x1 - x0)))
        if not shapes:
            return
        bucket = [fourier.good_fft_size(max(s[0] for s in shapes)),
                  fourier.good_fft_size(max(s[1] for s in shapes))]
        for parDict in (self.parDict, self._origParDict):
            for filtDict in parDict.get("mapFilters", []):
                filtDict.setdefault("params", {})
                filtDict["params"]["_fftPadBucket"] = list(bucket)

    def _setUpMaps(self, writeTileInfo=False):
        maskKeys = ["surveyMask", "pointSourceMask"]
        for key in maskKeys:
            if self.parDict.get(key):
                maps.checkMask(self.parDict[key])
        self._checkWCSConsistency()
        if writeTileInfo:
            DS9RegionFileName = os.path.join(self.selFnDir, "tiles.reg")
            cacheFileName = os.path.join(self.selFnDir,
                                         "tileDefinitions.yml")
        else:
            DS9RegionFileName = None
            cacheFileName = None
        self.addAutoTileDefinitions(DS9RegionFileName=DS9RegionFileName,
                                    cacheFileName=cacheFileName)
        self.tileCoordsDict = self.getTileCoordsDict()
        assert self.tileCoordsDict != {}
        if writeTileInfo:
            with open(os.path.join(self.selFnDir, "tileCoordsDict.pkl"),
                      "wb") as f:
                pickle.dump(self.tileCoordsDict, f)
        self.tileNames = list(self.tileCoordsDict.keys())
        self.unfilteredMapsDictList = maps.MapDictList(
            self.parDict["unfilteredMaps"],
            tileCoordsDict=self.tileCoordsDict, policy=self.policy)
        self._origUnfilteredMapsDictList = copy.deepcopy(
            self.unfilteredMapsDictList)

    def _checkWCSConsistency(self):
        """All maps/masks must share a WCS (``startUp.py:651-678``)."""
        mapKeys = ["mapFileName", "weightsFileName", "pointSourceMask",
                   "surveyMask", "flagMask"]
        ref = None
        for mapDict in self.parDict["unfilteredMaps"]:
            for key in mapKeys:
                if mapDict.get(key):
                    # header-only: survey maps are ~GB, the check needs WCS
                    wcs = WCS(nfits.read_image_header(mapDict[key]))
                    if ref is None:
                        ref = wcs
                    else:
                        same = (ref.ctype1 == wcs.ctype1
                                and ref.ctype2 == wcs.ctype2
                                and ref.naxis1 == wcs.naxis1
                                and ref.naxis2 == wcs.naxis2
                                and ref.getXPixelSizeDeg()
                                == wcs.getXPixelSizeDeg()
                                and ref.getYPixelSizeDeg()
                                == wcs.getYPixelSizeDeg())
                        if not same:
                            raise ValueError(
                                "WCS of %s is not consistent with other "
                                "maps" % mapDict[key])

    def restoreConfig(self):
        """Restore parDict/maps to the state in the config file
        (``startUp.py:681-687``)."""
        self.parDict = copy.deepcopy(self._origParDict)
        self.unfilteredMapsDictList = copy.deepcopy(
            self._origUnfilteredMapsDictList)

    def setFilterSet(self, setNum):
        """Activate one multi-pass filter set (``startUp.py:690-770``)."""
        self.restoreConfig()
        options = None
        if setNum in self.filterSetOptions:
            options = self.filterSetOptions[setNum]
            options.setdefault("saveCatalog", False)
            options.setdefault("maskHoleDilationFactor", None)
            options.setdefault("addSiphonedFromSets", None)
            options.setdefault("ignoreSurveyMask", False)

        permittedOverrides = ["thresholdSigma", "objIdent",
                              "findCenterOfMass", "measureShapes"]
        if options is not None:
            for override in permittedOverrides:
                if override in options:
                    self.parDict[override] = options[override]

        saveKeys = ["saveFilteredMaps", "saveFilter", "saveRMSMap",
                    "savePlots", "saveDS9Regions"]
        filtersToActivate = []
        for filtDict in self.parDict["mapFilters"]:
            if setNum in filtDict.get("filterSets", []):
                if options is not None:
                    if "mapToUse" in options:
                        filtDict["params"]["mapToUse"] = options["mapToUse"]
                    if "noiseModelCatalogFromSets" in options:
                        filtDict["params"]["noiseModelCatalog"] = [
                            self.filterSetOptions[i]["catalog"]
                            for i in options["noiseModelCatalogFromSets"]]
                if setNum != self.filterSets[-1]:
                    for saveKey in saveKeys:
                        if saveKey in filtDict["params"]:
                            filtDict["params"][saveKey] = False
                    self.parDict["forcedPhotometryCatalog"] = None
                if isinstance(options, dict) and \
                        "saveFilteredMaps" in options:
                    filtDict["params"]["saveFilteredMaps"] = \
                        options["saveFilteredMaps"]
                filtersToActivate.append(filtDict)
        self.parDict["mapFilters"] = filtersToActivate

        if options is not None and "subtractModelFromSets" in options:
            for mapDict in self.unfilteredMapsDictList:
                for idx in options["subtractModelFromSets"]:
                    if "mapToUse" in self.filterSetOptions[idx] and \
                            mapDict.get("label") != \
                            self.filterSetOptions[idx]["mapToUse"]:
                        continue
                    mapDict["subtractModelFromCatalog"] = \
                        self.filterSetOptions[idx]["catalog"]

        if options is not None and "maskAndFillFromSets" in options:
            for mapDict in self.unfilteredMapsDictList:
                for idx in options["maskAndFillFromSets"]:
                    if "mapToUse" in self.filterSetOptions[idx] and \
                            mapDict.get("label") != \
                            self.filterSetOptions[idx]["mapToUse"]:
                        continue
                    mapDict["maskAndFillFromCatalog"] = \
                        self.filterSetOptions[idx]["catalog"]

        if options is not None:
            for mapDict in self.unfilteredMapsDictList:
                mapDict["maskHoleDilationFactor"] = \
                    options["maskHoleDilationFactor"]
                if options["ignoreSurveyMask"]:
                    mapDict["surveyMask"] = None
