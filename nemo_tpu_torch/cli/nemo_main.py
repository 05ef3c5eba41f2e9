#!/usr/bin/env python
"""nemo command (PyTorch port): filter maps and find clusters / sources.

Same flags and output layout as ``nemo_tpu.cli.nemo_main``, plus
``--device``.  Runs the filter and catalog stage (per tile, or batched over
tiles with ``useDeviceBatching: true``), then stitches the tiles' maps and
makes quick-look maps as the JAX CLI does.  The stages that are not ported
yet fail before any work (fitQ, the selection function, source injection)
or are reported as skipped (the selection-function epilogue).

    python -m nemo_tpu_torch.cli.nemo_main config.yml --device cuda
"""

import argparse
import os
import sys

from nemo_tpu_torch import catalogs, maps, pipelines, startup
from nemo_tpu_torch.utils.timing import GLOBAL_TIMER, profile_trace


def makeParser():
    parser = argparse.ArgumentParser("nemo")
    parser.add_argument("configFileName", help="A .yml configuration file.")
    parser.add_argument("-S", "--calc-selection-function", dest="calcSelFn",
                        action="store_true", default=False,
                        help="Calculate completeness in terms of cluster "
                             "mass (not ported yet).")
    parser.add_argument("-I", "--run-source-injection-test",
                        dest="sourceInjectionTest", action="store_true",
                        default=False,
                        help="Run a source injection test (not ported yet).")
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
    return parser


def _notPortedConfig(config, args):
    """Names of requested stages that the port does not run yet."""
    todo = []
    if config.parDict.get("fitQ"):
        todo.append("fitQ (ROADMAP.md queue 1, item 9)")
    if config.parDict.get("calcSelFn"):
        todo.append("calcSelFn / -S (ROADMAP.md queue 1, item 9)")
    if args.sourceInjectionTest or config.parDict.get("sourceInjectionTest"):
        todo.append("source injection / -I (ROADMAP.md queue 1, item 10)")
    return todo


def main(argv=None):
    args = makeParser().parse_args(argv)
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
    todo = _notPortedConfig(config, args)
    if todo:
        raise SystemExit("nemo (PyTorch port): not ported yet: %s"
                         % "; ".join(todo))
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

    if not os.path.exists(optimalCatalogFileName):
        with profile_trace(args.profileDir):
            optimalCatalog = pipelines.filterMapsAndMakeCatalogs(
                config, writeAreaMask=True, writeFlagMask=True)
        writeOptimalCatalog(optimalCatalog, optimalCatalogFileName)
    else:
        print("... already made catalog %s" % optimalCatalogFileName)

    print("... selection-function epilogue (makeRMSTables, getFRelWeights, "
          "tidyUp) not ported yet (ROADMAP.md queue 1, item 9): skipped")

    if config.parDict.get("stitchTiles") and len(config.tileNames) > 1:
        with GLOBAL_TIMER.stage("stitchTiles"):
            maps.stitchTiles(config)
    if config.parDict.get("makeQuickLookMaps"):
        with GLOBAL_TIMER.stage("makeQuickLookMaps"):
            maps.makeQuickLookMaps(config)

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
