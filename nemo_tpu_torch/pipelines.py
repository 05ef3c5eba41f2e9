"""Pipeline orchestration: filter + detect -> optimal catalog.

Port of the tile loop of ``nemo_tpu/pipelines.py``.  Per tile, each
filter is built and applied on ``config.policy``'s device and objects are
detected and measured on the host; with ``useDeviceBatching: true`` the
batched engine (:mod:`.parallel.engine`) filters chunks of tiles in one
device call per (chunk, filter), optionally detecting objects on the
device too, and streams each result into the same catalog stage.  The
cached-filter, cached-RMS-map and cached-filtered-map reruns (source
injection, forced photometry, nemoMass) reload the saved filters and
selection-function products, and :func:`makeRMSTables` writes the
noise-area tables the selection function reads.  :func:`makeMockClusterCatalog`
draws mock catalogs from a selection function (``nemoMock``) and
:func:`extractSpec` extracts SEDs at catalog positions (``nemoSpec``).
"""

import os
import time

import numpy as np

from . import catalogs, filters, maps, photometry
from .utils import fits as nfits
from .utils.tables import Table, vstack
from .utils.timing import GLOBAL_TIMER


def filterMapsAndMakeCatalogs(config, rootOutDir=None, useCachedFilters=False,
                              useCachedRMSMap=False,
                              useCachedFilteredMaps=False, measureFluxes=True,
                              invertMap=False, verbose=True,
                              writeAreaMask=False, writeFlagMask=False):
    """Filter maps and construct the optimal catalog, including multi-pass
    filterSets."""
    if config.filterSets != [] and not useCachedFilters \
            and not useCachedFilteredMaps:
        if rootOutDir is None:
            rootOutDir = config.rootOutDir
        for setNum in config.filterSets:
            print(">>> Filter set: %d" % setNum)
            config.setFilterSet(setNum)
            if setNum == config.filterSets[-1]:
                writeAreaMask = True
                writeFlagMask = True
            config.filterSetOptions[setNum]["catalog"] = \
                _filterMapsAndMakeCatalogs(config, verbose=True,
                                           writeAreaMask=writeAreaMask,
                                           writeFlagMask=writeFlagMask)
            if config.filterSetOptions[setNum]["addSiphonedFromSets"] \
                    is not None:
                toStack = [config.filterSetOptions[setNum]["catalog"]]
                for sip in config.filterSetOptions[setNum][
                        "addSiphonedFromSets"]:
                    toStack.append(config.filterSetOptions[sip]["catalog"])
                config.filterSetOptions[setNum]["catalog"] = vstack(toStack)
            if config.filterSetOptions[setNum]["saveCatalog"]:
                label = config.filterSetOptions[setNum].get(
                    "label", "filterSet%d" % setNum)
                outFileName = os.path.join(rootOutDir,
                                           label + "_catalog.fits")
                catalogs.writeCatalog(
                    config.filterSetOptions[setNum]["catalog"], outFileName)
                catalogs.catalog2DS9(
                    config.filterSetOptions[setNum]["catalog"],
                    outFileName.replace(".fits", ".reg"))
        catalog = config.filterSetOptions[config.filterSets[-1]]["catalog"]
    else:
        catalog = _filterMapsAndMakeCatalogs(
            config, rootOutDir=rootOutDir, useCachedFilters=useCachedFilters,
            useCachedFilteredMaps=useCachedFilteredMaps,
            useCachedRMSMap=useCachedRMSMap, measureFluxes=measureFluxes,
            invertMap=invertMap, verbose=verbose,
            writeAreaMask=writeAreaMask, writeFlagMask=writeFlagMask)
    if verbose:
        print("... filtering and catalogs done: %.1f sec since start"
              % (time.time() - config._timeStarted))
    return catalog


def _filterMapsAndMakeCatalogs(config, rootOutDir=None,
                               useCachedFilters=False, useCachedRMSMap=False,
                               useCachedFilteredMaps=False,
                               measureFluxes=True, invertMap=False,
                               verbose=True, writeAreaMask=False,
                               writeFlagMask=False):
    """Single-pass tile x filter loop."""
    from . import completeness
    from .ops import fourier

    if rootOutDir is not None:
        filteredMapsDir = os.path.join(rootOutDir, "filteredMaps")
        diagnosticsDir = os.path.join(rootOutDir, "diagnostics")
        for d in (rootOutDir, filteredMapsDir, diagnosticsDir):
            os.makedirs(d, exist_ok=True)
    else:
        rootOutDir = config.rootOutDir
        filteredMapsDir = config.filteredMapsDir
        diagnosticsDir = config.diagnosticsDir

    # photFilter first, so fixed_ columns can be measured
    photFilter = config.parDict["photFilter"]
    filtersList = []
    if photFilter is not None:
        filtersList += [f for f in config.parDict["mapFilters"]
                        if f["label"] == photFilter]
    filtersList += [f for f in config.parDict["mapFilters"]
                    if photFilter is None or f["label"] != photFilter]
    undoPixelWindow = not useCachedRMSMap

    catalogDict = {}
    areaMaskDict = maps.TileDict({}, tileCoordsDict=config.tileCoordsDict)
    flagMaskDict = maps.TileDict({}, tileCoordsDict=config.tileCoordsDict)
    photMaps = {}   # tileName -> phot-filter maps, while the tile is live

    def _processFilteredMap(f, tileName, filteredMapDict):
        """Everything downstream of one (tile, filter) filtered map:
        cached-RMS S/N recompute, optional map writes, detection or forced
        photometry, flux measurement, catalog entry."""
        label = f["label"] + "#" + tileName
        catalogDict[label] = {}
        if f["params"].get("saveDS9Regions"):
            DS9RegionsPath = os.path.join(
                filteredMapsDir, tileName, "%s_filteredMap.reg" % label)
        else:
            DS9RegionsPath = None

        if "deviceDetections" in filteredMapDict:
            # device detection: segmentation, statistics and the sub-pixel
            # S/N + flux reads ran on the device; the catalog comes from
            # those O(K) values
            with GLOBAL_TIMER.stage("findObjects"):
                catalog = photometry.catalogFromDeviceDetections(
                    filteredMapDict,
                    threshold=config.parDict["thresholdSigma"],
                    minObjPix=config.parDict["minObjPix"],
                    findCenterOfMass=config.parDict["findCenterOfMass"],
                    objIdent=config.parDict["objIdent"],
                    longNames=config.parDict["longNames"],
                    useInterpolator=config.parDict["useInterpolator"],
                    DS9RegionsPath=DS9RegionsPath)
            if writeAreaMask and tileName not in areaMaskDict \
                    and filteredMapDict.get("surveyMask") is not None:
                areaMaskDict[tileName] = np.array(
                    filteredMapDict["surveyMask"], dtype=np.uint8)
            if writeFlagMask and tileName not in flagMaskDict:
                flagMaskDict[tileName] = np.asarray(
                    filteredMapDict["flagMask"], dtype=np.uint8)
            catalogDict[label]["catalog"] = catalog
            return

        if useCachedRMSMap and photFilter is not None:
            # S/N against the selection function's RMS map (the reference,
            # pipelines.py:216-232), then the pixel window is undone
            RMSMap, _ = completeness.loadRMSMap(tileName, config.selFnDir,
                                                photFilter)
            validMask = RMSMap > 0
            SNMap = np.array(filteredMapDict["data"])
            SNMap[validMask] = SNMap[validMask] / RMSMap[validMask]
            filteredMapDict["SNMap"] = SNMap
            mask = filteredMapDict["data"] == 0
            d = fourier.apply_pixel_window(
                config.policy.tensor(np.asarray(filteredMapDict["data"])),
                pow=-1.0).cpu().numpy()
            d[mask] = 0
            filteredMapDict["data"] = d

        if f["params"].get("saveFilteredMaps"):
            filteredMapFileName = os.path.join(
                filteredMapsDir, tileName, "%s_filteredMap.fits" % label)
            SNMapFileName = os.path.join(filteredMapsDir, tileName,
                                         "%s_SNMap.fits" % label)
            hdr = dict(filteredMapDict["wcs"].header)
            hdr["BUNIT"] = filteredMapDict["mapUnits"]
            if filteredMapDict.get("beamSolidAngle_nsr"):
                hdr["BEAMNSR"] = filteredMapDict["beamSolidAngle_nsr"]
                hdr["FREQGHZ"] = filteredMapDict["obsFreqGHz"]
            os.makedirs(os.path.dirname(filteredMapFileName),
                        exist_ok=True)
            nfits.write_image(filteredMapFileName,
                              filteredMapDict["data"], hdr)
            nfits.write_image(SNMapFileName, filteredMapDict["SNMap"],
                              hdr)

        if f["label"] == photFilter:
            photMaps[tileName] = {"SNMap": filteredMapDict["SNMap"],
                                  "data": filteredMapDict["data"]}
        # a device-detection overflow tile carries the reference filter's
        # maps with it (parallel/engine.py overflow fallback)
        photFilteredMapDict = photMaps.get(tileName) \
            or filteredMapDict.get("photMapsDict")

        if config.parDict.get("forcedPhotometryCatalog"):
            catalog = photometry.makeForcedPhotometryCatalog(
                filteredMapDict,
                config.parDict["forcedPhotometryCatalog"],
                useInterpolator=config.parDict["useInterpolator"],
                DS9RegionsPath=DS9RegionsPath)
        else:
            with GLOBAL_TIMER.stage("findObjects"):
                catalog = photometry.findObjects(
                    filteredMapDict,
                    threshold=config.parDict["thresholdSigma"],
                    minObjPix=config.parDict["minObjPix"],
                    findCenterOfMass=config.parDict["findCenterOfMass"],
                    removeRings=config.parDict["removeRings"],
                    ringThresholdSigma=config.parDict["ringThresholdSigma"],
                    rejectBorder=config.parDict["rejectBorder"],
                    objIdent=config.parDict["objIdent"],
                    longNames=config.parDict["longNames"],
                    useInterpolator=config.parDict["useInterpolator"],
                    measureShapes=config.parDict["measureShapes"],
                    invertMap=invertMap, DS9RegionsPath=DS9RegionsPath)

        if writeAreaMask and tileName not in areaMaskDict:
            areaMaskDict[tileName] = np.array(
                filteredMapDict["surveyMask"], dtype=np.uint8)
        if writeFlagMask and tileName not in flagMaskDict:
            flagMaskDict[tileName] = np.asarray(
                filteredMapDict["flagMask"], dtype=np.uint8)

        if measureFluxes:
            with GLOBAL_TIMER.stage("measureFluxes"):
                photometry.measureFluxes(
                    catalog, filteredMapDict, config.diagnosticsDir,
                    photFilteredMapDict=photFilteredMapDict,
                    useInterpolator=config.parDict["useInterpolator"])
        elif photFilter is not None and len(catalog) > 0:
            photometry.getSNRValues(
                catalog, photFilteredMapDict["SNMap"],
                filteredMapDict["wcs"], prefix="fixed_",
                useInterpolator=config.parDict["useInterpolator"],
                invertMap=invertMap)
        catalogDict[label]["catalog"] = catalog

    if config.parDict.get("useDeviceBatching") and not useCachedFilteredMaps:
        _runBatched(config, filtersList, catalogDict, photMaps,
                    _processFilteredMap, diagnosticsDir, useCachedFilters,
                    undoPixelWindow, measureFluxes, invertMap, verbose)

    for tileName in config.tileNames:
        if verbose:
            print(">>> Making filtered maps - tileName = %s" % tileName)
        for f in filtersList:
            label = f["label"] + "#" + tileName
            if "catalog" in catalogDict.get(label, {}):
                continue    # already streamed through the batched engine
            filteredMapFileName = os.path.join(
                filteredMapsDir, tileName, "%s_filteredMap.fits" % label)
            if useCachedFilteredMaps and os.path.exists(filteredMapFileName):
                filteredMapDict = _loadCachedFilteredMap(
                    config, f, tileName, filteredMapFileName,
                    os.path.join(filteredMapsDir, tileName,
                                 "%s_SNMap.fits" % label))
            else:
                with GLOBAL_TIMER.stage("filterMaps"):
                    filteredMapDict = filters.filterMaps(
                        config.unfilteredMapsDictList, f, tileName,
                        diagnosticsDir=diagnosticsDir,
                        selFnDir=config.selFnDir, verbose=True,
                        undoPixelWindow=undoPixelWindow,
                        useCachedFilter=useCachedFilters,
                        policy=config.policy)
            _processFilteredMap(f, tileName, filteredMapDict)
            del filteredMapDict
        photMaps.pop(tileName, None)

    with GLOBAL_TIMER.stage("makeOptimalCatalog"):
        optimalCatalog = catalogs.makeOptimalCatalog(
            catalogDict, constraintsList=config.parDict["catalogCuts"])
        # tile-overlap duplicates
        if len(config.tileNames) > 1 and len(optimalCatalog) > 0:
            optimalCatalog, numDuplicatesFound, names = \
                catalogs.removeDuplicates(optimalCatalog)

    if writeAreaMask and len(areaMaskDict) > 0:
        areaMaskDict.saveMEF(os.path.join(config.selFnDir, "areaMask.fits"),
                             compressionType="PLIO_1")
        if config.parDict["stitchTiles"] and config.origWCS is not None:
            areaMaskDict.saveStitchedFITS(
                os.path.join(config.selFnDir, "stitched_areaMask.fits"),
                config.origWCS, compressionType="PLIO_1")
    if writeFlagMask and len(flagMaskDict) > 0:
        flagMaskDict.saveMEF(os.path.join(config.selFnDir, "flagMask.fits"),
                             compressionType="PLIO_1")
        if config.parDict["stitchTiles"] and config.origWCS is not None:
            flagMaskDict.saveStitchedFITS(
                os.path.join(config.selFnDir, "stitched_flagMask.fits"),
                config.origWCS, compressionType="PLIO_1")

    return optimalCatalog


def _loadCachedFilteredMap(config, f, tileName, filteredMapFileName,
                           SNMapFileName):
    """A filtered map and its S/N map saved by an earlier run, with the
    selection function's area mask, as the filter stage returns them."""
    from . import completeness
    from .utils.wcs import WCS

    print("... loading cached filtered map %s" % filteredMapFileName)
    data, header = nfits.read_image(filteredMapFileName)
    filteredMapDict = {"data": np.asarray(data, dtype=np.float64),
                       "wcs": WCS(header),
                       "mapUnits": header.get("BUNIT", "yc")}
    if "BEAMNSR" in header:
        filteredMapDict["beamSolidAngle_nsr"] = header["BEAMNSR"]
        filteredMapDict["obsFreqGHz"] = header["FREQGHZ"]
    sn, _ = nfits.read_image(SNMapFileName)
    filteredMapDict["SNMap"] = np.asarray(sn, dtype=np.float64)
    filteredMapDict["surveyMask"], _ = completeness.loadAreaMask(
        tileName, config.selFnDir)
    filteredMapDict["flagMask"] = np.zeros(filteredMapDict["data"].shape,
                                           dtype=np.uint8)
    filteredMapDict["label"] = f["label"]
    filteredMapDict["tileName"] = tileName
    return filteredMapDict


def makeRMSTables(config):
    """Noise-level vs area tables per tile and footprint
    (``pipelines.py:357-451``)."""
    from . import completeness

    if config.parDict["photFilter"] is None:
        return None
    photFilterLabel = config.parDict["photFilter"]

    footprintsList = list(config.parDict.get("selFnFootprints", []))

    selFnCollection = {"full": []}
    for footprintDict in footprintsList:
        selFnCollection.setdefault(footprintDict["label"], [])

    for tileName in config.tileNames:
        RMSTab = completeness.getRMSTab(tileName, photFilterLabel,
                                        config.selFnDir)
        selFnCollection["full"].append(
            {"tileName": tileName, "RMSTab": RMSTab,
             "tileAreaDeg2": float(np.sum(RMSTab["areaDeg2"]))})
        for footprintDict in footprintsList:
            completeness.makeIntersectionMask(
                tileName, config.selFnDir, footprintDict["label"],
                masksList=footprintDict["maskList"])
            tileAreaDeg2 = completeness.getTileTotalAreaDeg2(
                tileName, config.selFnDir,
                footprintLabel=footprintDict["label"])
            if tileAreaDeg2 > 0:
                RMSTab = completeness.getRMSTab(
                    tileName, photFilterLabel, config.selFnDir,
                    footprintLabel=footprintDict["label"])
                selFnCollection[footprintDict["label"]].append(
                    {"tileName": tileName, "RMSTab": RMSTab,
                     "tileAreaDeg2": float(np.sum(RMSTab["areaDeg2"]))})

    for footprint in selFnCollection:
        label = "" if footprint == "full" else "_" + footprint
        outFileName = os.path.join(config.selFnDir,
                                   "RMSTab%s.fits" % label)
        tabList = []
        for selFnDict in selFnCollection[footprint]:
            tileTab = selFnDict["RMSTab"]
            tileTab["tileName"] = np.array([selFnDict["tileName"]]
                                           * len(tileTab))
            tabList.append(tileTab)
        if tabList:
            tab = vstack(tabList)
            tab.sort("y0RMS")
            tab.write(outFileName)

    # footprint columns on the catalog
    catFileName = os.path.join(
        config.rootOutDir,
        "%s_optimalCatalog.fits" % os.path.split(config.rootOutDir)[-1])
    if os.path.exists(catFileName) and footprintsList:
        tab = Table.read(catFileName)
        from .utils.wcs import WCS
        for footprintDict in footprintsList:
            for maskPath in footprintDict["maskList"]:
                m, header = nfits.read_image(maskPath)
                tab = catalogs.addFootprintColumnToCatalog(
                    tab, footprintDict["label"], np.asarray(m), WCS(header))
        catalogs.writeCatalog(tab, catFileName)
        catalogs.writeCatalog(tab, catFileName.replace(".fits", ".csv"))


def _runBatched(config, filtersList, catalogDict, photMaps,
                processFilteredMap, diagnosticsDir, useCachedFilters,
                undoPixelWindow, measureFluxes, invertMap, verbose):
    """The ``useDeviceBatching`` branch: every eligible filter runs over
    all tiles through the batched engine, and each result streams through
    ``processFilteredMap`` as its chunk completes.  Host-only filters of a
    mixed bank run tile-locally inside the sink, so peak memory stays one
    chunk whatever the bank.  Cached-filter reruns (injection tests) apply
    the saved filters with the engine's given-filter step; the cached-RMS
    rerun (``undoPixelWindow`` False) detects on the host, against the
    selection function's RMS maps."""
    from .parallel import engine as batch_engine

    # a cached-filter rerun reloads a saved real-space kernel on the host
    # engine (its loadFilter honours the kernel cache), as the JAX package
    # does
    eligible = [f for f in filtersList
                if batch_engine.eligibleForBatch(f, config.parDict)
                and not (useCachedFilters and f["params"].get("saveFilter")
                         and f["class"] in batch_engine._REALSPACE_CLASSES)]
    if not eligible:
        return
    eligibleLabels = set(f["label"] for f in eligible)
    fullStream = eligibleLabels == set(f["label"] for f in filtersList)
    pendingTiles = {}

    def consume(label, tileName, res):
        pendingTiles.setdefault(tileName, {})[label] = res
        if not eligibleLabels <= set(pendingTiles[tileName]):
            return True
        byLabel = pendingTiles.pop(tileName)
        # filtersList is photFilter-first, so the fixed_ reference maps
        # exist before any other filter's fluxes are measured
        for f in filtersList:
            if f["label"] in byLabel:
                processFilteredMap(f, tileName, byLabel.pop(f["label"]))
            elif f["label"] not in eligibleLabels:
                # host-only filter of a mixed bank: run it now, tile-local
                with GLOBAL_TIMER.stage("filterMaps"):
                    fmd = filters.filterMaps(
                        config.unfilteredMapsDictList, f, tileName,
                        diagnosticsDir=diagnosticsDir,
                        selFnDir=config.selFnDir, verbose=verbose,
                        undoPixelWindow=undoPixelWindow,
                        useCachedFilter=useCachedFilters,
                        policy=config.policy)
                processFilteredMap(f, tileName, fmd)
                del fmd
        photMaps.pop(tileName, None)
        return True

    # Device detection needs the whole bank batched (the fixed_ reads use
    # the reference filter's device-resident maps) and the default
    # catalog stage; "auto" = on when the policy device is a GPU (the JAX
    # package: on the TPU).
    dd = config.parDict.get("useDeviceDetection", "auto")
    reasons = []
    if not ((dd is True) or (dd == "auto"
                             and config.policy.device.type == "cuda")):
        reasons.append("useDeviceDetection=%r on %s"
                       % (dd, config.policy.device.type))
    if not fullStream:
        reasons.append("mixed filter bank (host-only labels present)")
    if not measureFluxes:
        reasons.append("measureFluxes off")
    if not undoPixelWindow:
        reasons.append("cached RMS rerun")
    for key, on in (("forced photometry",
                     config.parDict.get("forcedPhotometryCatalog")),
                    ("inverted map", invertMap),
                    ("removeRings", config.parDict["removeRings"]),
                    ("measureShapes", config.parDict["measureShapes"])):
        if on:
            reasons.append(key)
    detectParams = None
    if not reasons:
        detectParams = (
            float(config.parDict["thresholdSigma"]),
            # a DR5-sized tile carries ~70-100 noise peaks above 4 sigma;
            # 512 keeps real tiles inside the budget, and a tile over it
            # falls back to host detection
            int(config.parDict.get("deviceDetectionMaxObjects", 512)),
            128,
            bool(config.parDict["findCenterOfMass"]),
            16)
    if verbose:
        print("... device detection: %s" % (
            "ON (O(K) downloads per tile)" if detectParams is not None
            else "OFF (%s)" % "; ".join(reasons)), flush=True)

    # one multi-filter call: each tile is loaded and preprocessed once
    # for the whole bank
    with GLOBAL_TIMER.stage("filterMapsBatched"):
        batch_engine.batchFilterTilesMulti(
            config, eligible, undoPixelWindow=undoPixelWindow,
            verbose=verbose, consume=consume, detectParams=detectParams,
            diagnosticsDir=diagnosticsDir,
            useCachedFilters=useCachedFilters)


def makeMockClusterCatalog(config, numMocksToMake=1, combineMocks=False,
                           writeCatalogs=True, writeInfo=True, verbose=True,
                           QSource="fit"):
    """Generate mock cluster catalogs (``pipelines.py:454-641``).

    The mass function's Boltzmann transfer is solved on
    ``config.policy``'s device (the ``boltzmann_rk4`` kernel on the card,
    unless this process has already solved it for the same cosmology);
    the draws are host numpy, one generator fed through every tile in tile
    order, as in the JAX package."""
    from . import completeness
    from .mock import MockSurvey
    from .models.qfit import QFit
    from .utils.wcs import WCS

    os.makedirs(config.mocksDir, exist_ok=True)
    applyPoissonScatter = config.parDict.get("applyPoissonScatter", True)
    applyIntrinsicScatter = config.parDict.get("applyIntrinsicScatter", True)
    applyNoiseScatter = config.parDict.get("applyNoiseScatter", True)

    Q = QFit(QSource=QSource, selFnDir=config.selFnDir,
             tileNames=config.allTileNames)
    photFilterLabel = config.parDict["photFilter"]
    thresholdSigma = config.parDict["thresholdSigma"]
    scalingRelationDict = config.parDict["massOptions"]

    RMSTab = Table.read(os.path.join(config.selFnDir, "RMSTab.fits"))
    RMSMapDict = {}
    wcsDict = {}
    areaDeg2Dict = {}
    totalAreaDeg2 = 0.0
    rmsMEF = os.path.join(config.selFnDir,
                          "RMSMap_%s.fits" % photFilterLabel)
    perTile = not os.path.exists(rmsMEF)
    for tileName in config.tileNames:
        if perTile:
            RMSMapDict[tileName], wcsDict[tileName] = completeness.loadRMSMap(
                tileName, config.selFnDir, photFilterLabel)
        else:
            data, header = nfits.read_image(rmsMEF, ext=tileName)
            RMSMapDict[tileName] = np.asarray(data)
            wcsDict[tileName] = WCS(header)
        sel = np.asarray(RMSTab["tileName"]) == tileName
        areaDeg2 = float(np.sum(np.asarray(RMSTab["areaDeg2"])[sel]))
        areaDeg2Dict[tileName] = areaDeg2
        totalAreaDeg2 += areaDeg2

    seed = config.parDict.get("seed", None)

    massOptions = config.parDict["massOptions"]
    mockSurvey = MockSurvey(5e13, totalAreaDeg2, 0.0, 2.0,
                            massOptions["H0"], massOptions["Om0"],
                            massOptions["Ob0"], massOptions["sigma8"],
                            massOptions["ns"], delta=massOptions["delta"],
                            rhoType=massOptions["rhoType"],
                            enableDrawSample=True,
                            transferFunction=massOptions.get(
                                "transferFunction", "boltzmann_camb"),
                            device=config.policy.device)

    catList = []
    rng = np.random.default_rng(seed)
    for i in range(numMocksToMake):
        mockTabsList = []
        for tileName in config.tileNames:
            if RMSMapDict[tileName].sum() == 0 or \
                    areaDeg2Dict[tileName] < 0.5:
                continue
            mockTab = mockSurvey.drawSample(
                RMSMapDict[tileName], scalingRelationDict, QFit=Q,
                wcs=wcsDict[tileName], photFilterLabel=photFilterLabel,
                tileName=tileName, makeNames=True, SNRLimit=thresholdSigma,
                applySNRCut=True, areaDeg2=areaDeg2Dict[tileName],
                applyPoissonScatter=applyPoissonScatter,
                applyIntrinsicScatter=applyIntrinsicScatter,
                applyNoiseScatter=applyNoiseScatter,
                rng=rng)
            if mockTab is not None and len(mockTab) > 0:
                mockTabsList.append(mockTab)
        tab = vstack(mockTabsList)
        catList.append(tab)
        if writeCatalogs:
            mockFileName = os.path.join(config.mocksDir,
                                        "mockCatalog_%d.csv" % (i + 1))
            tab.meta["QSOURCE"] = QSource
            catalogs.writeCatalog(tab, mockFileName)
            catalogs.writeCatalog(tab, mockFileName.replace(".csv", ".fits"))

    if combineMocks:
        tab = vstack(catList)
        tab.meta["QSOURCE"] = QSource
        tab.write(os.path.join(config.mocksDir,
                               "mockCatalog_combined.fits"))

    if writeInfo:
        mockKeys = ["massOptions", "makeMockCatalogs", "applyPoissonScatter",
                    "applyIntrinsicScatter", "applyNoiseScatter"]
        with open(os.path.join(config.mocksDir, "mockParameters.txt"),
                  "w") as f:
            for m in mockKeys:
                if m in config.parDict:
                    f.write("%s: %s\n" % (m, config.parDict[m]))
    return catList


def extractSpec(config, tab, method="CAP", diskRadiusArcmin=4.0,
                highPassFilter=False, estimateErrors=True,
                saveFilteredMaps=False):
    """Spectral energy distribution extraction at catalog positions
    (``pipelines.py:644-1051``).

    Maps are first PSF-matched to the lowest-resolution beam, moved to the
    front: W(l) = B_ref(l) / B(l), zeroed where B(l) falls below 10%, is
    made on the host and applied by an rfft2, a multiply and an irfft2 on
    ``config.policy``'s device.

    Methods: 'CAP' (compensated aperture photometry, Schaan et al. 2020
    style) or 'matchedFilter' (per-template matched filter, Saro et al.
    2014 style).
    """
    from .models.beams import BeamProfile
    from .ops import fourier

    P = config.policy
    # Reference beam = lowest resolution; reorder maps so it's first
    beams_ = [BeamProfile(beamFileName=m["beamFileName"])
              for m in config.unfilteredMapsDictList]
    refIndex = int(np.argmax([b.FWHMArcmin for b in beams_]))
    mapsList = list(config.unfilteredMapsDictList)
    mapsList.insert(0, mapsList.pop(refIndex))
    beams_.insert(0, beams_.pop(refIndex))
    refBeam = beams_[0]

    def _psf_match(data, wcs, beam):
        pix = maps.pixScalesRad(wcs, data.shape)
        lmap = np.asarray(fourier.rmodlmap(data.shape, pix))
        Bl = np.interp(lmap, beam.ell, beam.Bell, right=0.0)
        Bref = np.interp(lmap, refBeam.ell, refBeam.Bell, right=0.0)
        W = np.where(Bl > 0.1, Bref / np.where(Bl > 0.1, Bl, 1.0), 0.0)
        fm = fourier.rfft2(P.tensor(data))
        return fourier.irfft2(fm * P.tensor(W), data.shape).cpu().numpy()

    if method == "CAP":
        return _extractSpecCAP(config, tab, mapsList, beams_, _psf_match,
                               diskRadiusArcmin=diskRadiusArcmin,
                               highPassFilter=highPassFilter,
                               estimateErrors=estimateErrors)
    elif method == "matchedFilter":
        return _extractSpecMatchedFilter(config, tab, mapsList, beams_,
                                         _psf_match,
                                         saveFilteredMaps=saveFilteredMaps)
    raise ValueError("method must be 'CAP' or 'matchedFilter'")


def _extractSpecCAP(config, tab, mapsList, beams_, psf_match,
                    diskRadiusArcmin=4.0, highPassFilter=False,
                    estimateErrors=True, rng=None):
    """Compensated-aperture photometry SED (``pipelines.py:973-1050``):
    host numpy apart from ``psf_match`` and the high-pass filter's
    smoothing, which run on ``config.policy``'s device."""
    from .models import sz
    rng = rng or np.random.default_rng(707)
    innerR = diskRadiusArcmin
    outerR = diskRadiusArcmin * np.sqrt(2)
    catalogList = []
    for tileName in config.tileNames:
        mapDictList = []
        freqLabels = []
        for i, mapDict in enumerate(mapsList):
            md = mapDict.copy()
            md.preprocess(tileName=tileName)
            if i > 0:
                md["data"] = psf_match(md["data"], md["wcs"], beams_[i])
            if highPassFilter:
                md["data"] = maps.subtractBackground(
                    md["data"], md["wcs"], smoothScaleDeg=(2 * outerR) / 60,
                    policy=config.policy)
            freqLabels.append(int(round(md["obsFreqGHz"])))
            mapDictList.append(md)
        wcs = mapDictList[0]["wcs"]
        shape = mapDictList[0]["data"].shape
        pixAreaMap = maps.getPixelAreaArcmin2Map(shape, wcs)
        maxSizeDeg = (outerR * 1.2) / 60
        tileTab = catalogs.getCatalogWithinImage(tab, shape, wcs)
        if len(tileTab) == 0:
            continue
        for label in freqLabels:
            tileTab["diskT_uKArcmin2_%s" % label] = np.zeros(len(tileTab))
            tileTab["err_diskT_uKArcmin2_%s" % label] = \
                np.zeros(len(tileTab))
            tileTab["diskSNR_%s" % label] = np.zeros(len(tileTab))

        def cap_flux(ra, dec, d):
            degreesMap = np.full(shape, 1e6)
            degreesMap, _, _ = maps.makeDegreesDistanceMap(
                degreesMap, wcs, ra, dec, maxSizeDeg)
            inner = degreesMap < innerR / 60
            outer = (degreesMap >= innerR / 60) & (degreesMap < outerR / 60)
            return (d[inner] * pixAreaMap[inner]).sum() \
                - (d[outer] * pixAreaMap[outer]).sum()

        for i in range(len(tileTab)):
            ra = float(np.asarray(tileTab["RADeg"])[i])
            dec = float(np.asarray(tileTab["decDeg"])[i])
            for md, label in zip(mapDictList, freqLabels):
                tileTab["diskT_uKArcmin2_%s" % label][i] = \
                    cap_flux(ra, dec, md["data"])

        if estimateErrors:
            randTab = catalogs.generateRandomSourcesCatalog(
                mapDictList[0]["surveyMask"], wcs, 500,
                seed=rng.integers(0, 2 ** 31 - 1))
            randFluxes = {label: np.zeros(len(randTab))
                          for label in freqLabels}
            for i in range(len(randTab)):
                ra = float(np.asarray(randTab["RADeg"])[i])
                dec = float(np.asarray(randTab["decDeg"])[i])
                for md, label in zip(mapDictList, freqLabels):
                    randFluxes[label][i] = cap_flux(ra, dec, md["data"])
            for label in freqLabels:
                SNRSign = -1 if sz.fSZ(float(label)) < 0 else 1
                noise = np.percentile(np.abs(randFluxes[label]), 68.3)
                tileTab["err_diskT_uKArcmin2_%s" % label] = noise
                tileTab["diskSNR_%s" % label] = SNRSign * np.asarray(
                    tileTab["diskT_uKArcmin2_%s" % label]) / noise
        catalogList.append(tileTab)
    return vstack(catalogList)


def _extractSpecMatchedFilter(config, tab, mapsList, beams_, psf_match,
                              saveFilteredMaps=False,
                              noiseMethod="dataMap"):
    """Per-template matched-filter SED (``pipelines.py:873-970``).

    Each (tile, template) filter is built from the reference band on
    ``config.policy``'s device; every further band is PSF-matched,
    filtered, its grid RMS taken (the ``rms_cells`` kernel on the card)
    and its pixel window undone there too.  Forced photometry, flux
    measurement and the cross-match are host numpy.  The filter caches go
    under ``nemoSpecCache/<basename of rootOutDir>`` in the working
    directory, as in the JAX package."""
    import copy as copy_mod

    from .ops import fourier
    from .utils.wcs import WCS

    P = config.policy
    cacheDir = os.path.join("nemoSpecCache",
                            os.path.basename(config.rootOutDir))
    os.makedirs(cacheDir, exist_ok=True)

    baseFilter = {"class": "ArnaudModelMatchedFilter",
                  "params": {"noiseParams": {"method": noiseMethod,
                                             "noiseGridArcmin": 40.0},
                             "saveFilteredMaps": bool(saveFilteredMaps),
                             "saveRMSMap": False,
                             "savePlots": False, "saveDS9Regions": False,
                             "saveFilter": False, "outputUnits": "yc",
                             "edgeTrimArcmin": 0.0,
                             "GNFWParams": "default"}}
    filtersList = []
    for t in np.unique(np.asarray(tab["template"])):
        newDict = copy_mod.deepcopy(baseFilter)
        newDict["params"]["M500MSun"] = float(
            str(t).split("_M")[-1].split("_")[0])
        newDict["params"]["z"] = float(
            str(t).split("_z")[-1].replace("p", "."))
        newDict["label"] = str(t)
        filtersList.append(newDict)

    catalogList = []
    for tileName in config.tileNames:
        diagnosticsDir = os.path.join(cacheDir, tileName)
        os.makedirs(diagnosticsDir, exist_ok=True)
        for f in filtersList:
            tempTileTab = None
            filterObj = None
            filteredMapDict = None
            for i, mapDict in enumerate(mapsList):
                if tempTileTab is None:
                    header = config.tileCoordsDict[tileName]["header"]
                    wcs = WCS(header)
                    shape = (wcs.naxis2, wcs.naxis1)
                    tempTileTab = catalogs.getCatalogWithinImage(tab, shape,
                                                                 wcs)
                    tempTileTab = tempTileTab[
                        np.asarray(tempTileTab["template"]) == f["label"]]
                if tempTileTab is None or len(tempTileTab) == 0:
                    continue
                if i == 0:
                    filteredMapDict, filterObj = filters.filterMaps(
                        [mapDict], f, tileName,
                        diagnosticsDir=diagnosticsDir, selFnDir=cacheDir,
                        verbose=False, undoPixelWindow=True,
                        returnFilter=True, policy=P)
                else:
                    md = mapDict.copy()
                    md.preprocess(tileName=tileName)
                    matched = psf_match(md["data"], md["wcs"], beams_[i])
                    filtered = filterObj.applyFilter(
                        np.stack([matched]))
                    RMSMap = np.asarray(filterObj.makeNoiseMap(filtered))
                    SNMap = np.zeros(filtered.shape)
                    mask = RMSMap > 0
                    SNMap[mask] = filtered[mask] / RMSMap[mask]
                    filteredMapDict = dict(filteredMapDict)
                    filteredMapDict["SNMap"] = SNMap
                    filteredMapDict["data"] = fourier.apply_pixel_window(
                        P.tensor(filtered), pow=-1.0).cpu().numpy()
                freqTileTab = photometry.makeForcedPhotometryCatalog(
                    filteredMapDict, tempTileTab,
                    useInterpolator=config.parDict["useInterpolator"])
                photometry.measureFluxes(
                    freqTileTab, filteredMapDict, cacheDir,
                    useInterpolator=config.parDict["useInterpolator"],
                    ycObsFreqGHz=mapDict["obsFreqGHz"])
                if len(freqTileTab) == 0:
                    tempTileTab = None
                    continue
                tempTileTab, freqTileTab, rDeg = catalogs.crossMatch(
                    tempTileTab, freqTileTab, radiusArcmin=2.5)
                suff = "_%d" % mapDict["obsFreqGHz"]
                for colName in ("deltaT_c", "y_c", "SNR"):
                    tempTileTab[colName + suff] = freqTileTab[colName]
                    if "err_" + colName in freqTileTab.keys():
                        tempTileTab["err_" + colName + suff] = \
                            freqTileTab["err_" + colName]
            if tempTileTab is not None and len(tempTileTab) > 0:
                catalogList.append(tempTileTab)
    return vstack(catalogList)
