#!/usr/bin/env python
"""nemo command (PyTorch port): filter maps and find clusters / sources.

Same flags and output layout as ``nemo_tpu.cli.nemo_main``, plus
``--device``; ``--profile`` traces one warm chunk of the batched engine
into ``diagnostics/profile/trace.json``.  Runs the filter and catalog
stage (per tile, or batched over tiles with ``useDeviceBatching: true``),
then the epilogue as the JAX CLI does: the Q fit (``fitQ``), the RMS
tables, the fRel weights and the fused selection-function products, the
stitched and quick-look maps, with ``-I`` (or ``sourceInjectionTest``) the
source-injection test and its position recovery analysis, and with ``-S``
(or ``calcSelFn``) the completeness and mass-limit maps.  The batched
engine splits each chunk over every card (``parallel/mesh.py``);
``NEMO_TPU_MULTIHOST=1`` joins a torch.distributed process group first
(``parallel/multihost.py``).

    python -m nemo_tpu_torch.cli.nemo_main config.yml --device cuda
"""

import argparse
import os
import shutil
import sys

from nemo_tpu_torch import catalogs, completeness, maps, pipelines, startup
from nemo_tpu_torch.models import qfit
from nemo_tpu_torch.utils.timing import GLOBAL_TIMER, profile_trace


def makeParser():
    parser = argparse.ArgumentParser("nemo")
    parser.add_argument("configFileName", help="A .yml configuration file.")
    parser.add_argument("-S", "--calc-selection-function", dest="calcSelFn",
                        action="store_true", default=False,
                        help="Calculate completeness in terms of cluster "
                             "mass; output under selFn/.")
    parser.add_argument("-I", "--run-source-injection-test",
                        dest="sourceInjectionTest", action="store_true",
                        default=False,
                        help="Run a source injection test, using the "
                             "settings given in the config file.")
    parser.add_argument("-f", "--forced-photometry-catalog",
                        dest="forcedCatalogFileName", default=None,
                        help="Perform forced photometry at positions in "
                             "this catalog instead of detecting objects.")
    parser.add_argument("-M", "--mpi", dest="MPIEnabled",
                        action="store_true", default=False,
                        help="Accepted for compatibility; one process runs "
                             "every tile.")
    parser.add_argument("-T", "--tiling-check", dest="tilingCheck",
                        action="store_true", default=False,
                        help="Stop after the tiling stage.")
    parser.add_argument("-n", "--no-strict-errors",
                        dest="noStrictMPIExceptions", action="store_true",
                        default=False, help="Compatibility no-op.")
    parser.add_argument("-x", "--x64", dest="x64", action="store_true",
                        default=False,
                        help="Use float64 on CUDA (the CPU always runs in "
                             "float64).")
    parser.add_argument("--device", dest="device", default="cuda",
                        choices=("cuda", "cpu"),
                        help="Device to run on (default cuda; fails if no "
                             "CUDA device is present).")
    parser.add_argument("--profile-dir", dest="profileDir", default=None,
                        help="Capture a torch.profiler trace of the "
                             "filtering stage into this directory.")
    parser.add_argument("--profile", dest="profileChunk",
                        action="store_true", default=False,
                        help="Capture ONE warm tile-chunk's device trace "
                             "into diagnostics/profile/ (per-chunk "
                             "budgets land in diagnostics/"
                             "chunk_budgets.jsonl regardless).")
    return parser


def main(argv=None):
    args = makeParser().parse_args(argv)
    # Multi-process runtime: no-op unless NEMO_TPU_MULTIHOST=1
    # (parallel/multihost.py documents the launch contract); must run
    # before first device use.
    from nemo_tpu_torch.parallel import multihost
    multihost.initialize_from_env(args.device)

    config = startup.NemoConfig(args.configFileName,
                                calcSelFn=args.calcSelFn,
                                sourceInjectionTest=args.sourceInjectionTest,
                                MPIEnabled=args.MPIEnabled,
                                writeTileInfo=True, device=args.device,
                                x64=args.x64)
    if args.tilingCheck:
        print(">>> Tiling check: this config has %d tiles."
              % len(config.allTileNames))
        sys.exit()
    print("... device: %s (%s)" % (config.policy.device,
                                   str(config.policy.dtype).split(".")[-1]))

    config.parDict["forcedPhotometryCatalog"] = args.forcedCatalogFileName
    if config.parDict["forcedPhotometryCatalog"] is not None:
        label = os.path.splitext(
            os.path.basename(config.parDict["forcedPhotometryCatalog"]))[0]
        label = label + "_" + os.path.basename(config.rootOutDir) \
            + "_forcedCatalog"
        optimalCatalogFileName = label + ".csv"
    else:
        optimalCatalogFileName = os.path.join(
            config.rootOutDir, "%s_optimalCatalog.csv"
            % os.path.split(config.rootOutDir)[-1])

    if args.profileChunk:
        from nemo_tpu_torch.parallel import engine as batch_engine
        batch_engine.PROFILE_CHUNK_DIR = os.path.join(
            config.diagnosticsDir, "profile")
    if not os.path.exists(optimalCatalogFileName):
        with profile_trace(args.profileDir):
            optimalCatalog = pipelines.filterMapsAndMakeCatalogs(
                config, writeAreaMask=True, writeFlagMask=True)
        writeOptimalCatalog(optimalCatalog, optimalCatalogFileName)
    else:
        print("... already made catalog %s" % optimalCatalogFileName)

    if config.parDict.get("photFilter") and config.parDict.get("fitQ"):
        if not os.path.exists(os.path.join(config.selFnDir, "QFit.fits")):
            with GLOBAL_TIMER.stage("fitQ"):
                qfit.fitQ(config)

    with GLOBAL_TIMER.stage("makeRMSTables"):
        pipelines.makeRMSTables(config)

    sourceInjTable = None
    sourceInjPath = os.path.join(config.selFnDir,
                                 "sourceInjectionData.fits")
    if not os.path.exists(sourceInjPath):
        if config.parDict.get("sourceInjectionTest"):
            with GLOBAL_TIMER.stage("sourceInjectionTest"):
                sourceInjTable = maps.sourceInjectionTest(config)
    else:
        print("... already made source injection data %s" % sourceInjPath)
    if sourceInjTable is not None:
        sourceInjTable.write(sourceInjPath)
    if sourceInjTable is not None and len(sourceInjTable) == 0:
        # e.g. a cluster config run with -I but without
        # sourceInjectionModels: nothing recovered
        print("... WARNING: source injection test recovered no objects "
              "(cluster configs need sourceInjectionModels) - skipping "
              "position recovery analysis")
    elif sourceInjTable is not None:
        maps.positionRecoveryAnalysis(
            sourceInjTable,
            os.path.join(config.diagnosticsDir, "positionRecovery.pdf"),
            percentiles=[50, 95, 99.7], plotRawData=True,
            pickleFileName=os.path.join(config.diagnosticsDir,
                                        "positionRecovery.pkl"),
            selFnDir=config.selFnDir)

    if config.parDict.get("stitchTiles") and len(config.tileNames) > 1:
        with GLOBAL_TIMER.stage("stitchTiles"):
            maps.stitchTiles(config)
    if config.parDict.get("makeQuickLookMaps"):
        with GLOBAL_TIMER.stage("makeQuickLookMaps"):
            maps.makeQuickLookMaps(config)

    with GLOBAL_TIMER.stage("tidyUp"):
        completeness.getFRelWeights(config)
        completeness.tidyUp(config)

    if config.parDict.get("calcSelFn"):
        selFnConfigPath = os.path.join(config.selFnDir, "config.yml")
        if not os.path.exists(selFnConfigPath):
            shutil.copy(args.configFileName, selFnConfigPath)
        with GLOBAL_TIMER.stage("completeness"):
            completeness.completenessByFootprint(config)
            selFnOptions = config.parDict.get("selFnOptions", {})
            if selFnOptions.get("massLimitMaps"):
                completeness.makeMassLimitMapsAndPlots(config)

    print(GLOBAL_TIMER.report())
    with open(os.path.join(config.diagnosticsDir, "timings.json"),
              "w") as f:
        f.write(GLOBAL_TIMER.to_json() + "\n")


def writeOptimalCatalog(optimalCatalog, optimalCatalogFileName):
    """Write the optimal catalog as .csv, .fits and a DS9 .reg file."""
    if len(optimalCatalog) > 0:
        optimalCatalog = catalogs.flagTileBoundarySplits(optimalCatalog)
        optimalCatalog.sort("name")
    catalogs.writeCatalog(optimalCatalog, optimalCatalogFileName)
    catalogs.writeCatalog(optimalCatalog,
                          optimalCatalogFileName.replace(".csv", ".fits"))
    catalogs.catalog2DS9(optimalCatalog,
                         optimalCatalogFileName.replace(".csv", ".reg"),
                         addInfo=[{"key": "SNR", "fmt": "%.1f"}])
    return optimalCatalog


if __name__ == "__main__":
    main()
