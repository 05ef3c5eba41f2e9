"""Pipeline orchestration: filter + detect -> optimal catalog.

Port of the host (per-tile) loop of ``nemo_tpu/pipelines.py``: each tile's
filters are built and applied on ``config.policy``'s device, then objects
are detected and measured on the host.  The batched multi-tile engine
(``useDeviceBatching: true``) and the cached-RMS / cached-filtered-map
reruns are not ported yet.
"""

import os
import time

import numpy as np

from . import catalogs, filters, maps, photometry
from .utils.tables import vstack
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
    if config.parDict.get("useDeviceBatching"):
        raise NotImplementedError(
            "useDeviceBatching: true (the batched multi-tile engine) is not "
            "ported yet (ROADMAP.md queue 1, item 8: slice 2, the batched "
            "step on one GPU); set it to false")
    if useCachedRMSMap or useCachedFilteredMaps:
        raise NotImplementedError(
            "cached RMS-map / filtered-map reruns need the completeness "
            "module, not ported yet (ROADMAP.md queue 1, item 9: Q fit, "
            "selection function, masses)")

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

    catalogDict = {}
    areaMaskDict = maps.TileDict({}, tileCoordsDict=config.tileCoordsDict)
    flagMaskDict = maps.TileDict({}, tileCoordsDict=config.tileCoordsDict)
    photMaps = {}   # tileName -> phot-filter maps, while the tile is live

    def _processFilteredMap(f, tileName, filteredMapDict):
        """Everything downstream of one (tile, filter) filtered map:
        optional map writes, detection or forced photometry, flux
        measurement, catalog entry."""
        from .utils import fits as nfits
        label = f["label"] + "#" + tileName
        catalogDict[label] = {}
        if f["params"].get("saveDS9Regions"):
            DS9RegionsPath = os.path.join(
                filteredMapsDir, tileName, "%s_filteredMap.reg" % label)
        else:
            DS9RegionsPath = None

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
        photFilteredMapDict = photMaps.get(tileName)

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

    for tileName in config.tileNames:
        if verbose:
            print(">>> Making filtered maps - tileName = %s" % tileName)
        for f in filtersList:
            with GLOBAL_TIMER.stage("filterMaps"):
                filteredMapDict = filters.filterMaps(
                    config.unfilteredMapsDictList, f, tileName,
                    diagnosticsDir=diagnosticsDir,
                    selFnDir=config.selFnDir,
                    verbose=True, undoPixelWindow=True,
                    useCachedFilter=useCachedFilters, policy=config.policy)
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
