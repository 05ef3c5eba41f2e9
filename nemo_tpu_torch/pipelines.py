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
noise-area tables the selection function reads.
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
