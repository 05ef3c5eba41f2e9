#!/usr/bin/env python
"""nemoCatalogCheck (PyTorch port): cross-check an external catalog against
a nemo run.

Same flags, outputs and wording as ``nemo_tpu.cli.nemoCatalogCheck_main``
(``bin/nemoCatalogCheck:25-106``), plus ``--device`` for the selection
function: reports which objects in the external catalog fall in the valid
survey area, which were detected and which are missing, and writes the
in-mask and missed tables (+ DS9 region file) in the working directory.

    python -m nemo_tpu_torch.cli.nemoCatalogCheck_main config.yml ext.fits
"""

import argparse
import os

import numpy as np


def makeParser():
    parser = argparse.ArgumentParser("nemoCatalogCheck")
    parser.add_argument("configFileName",
                        help="A .yml configuration file; the nemo output "
                             "is assumed to be in the directory named "
                             "after it (minus the .yml extension).")
    parser.add_argument("catFileName", metavar="catalogFileName",
                        help="Object catalog to check against nemo "
                             "output (.fits); needs name, RADeg (or ra, "
                             "RA) and decDeg (or dec, DEC) columns.")
    parser.add_argument("-r", "--match-radius", "--radius-arcmin",
                        dest="matchRadiusArcmin", type=float, default=2.5,
                        help="Cross-matching radius in arcmin.")
    parser.add_argument("-S", "--fixed-SNR-cut", dest="fixedSNRCut",
                        type=float, default=4.0,
                        help="Cut in fixed_SNR used to select nemo "
                             "cluster candidates.")
    parser.add_argument("--device", dest="device", default="cuda",
                        choices=("cuda", "cpu"),
                        help="Device to run on (default cuda; fails if no "
                             "CUDA device is present).")
    return parser


def main(argv=None):
    args = makeParser().parse_args(argv)
    from nemo_tpu_torch import __version__, catalogs, completeness, startup
    from nemo_tpu_torch.utils.tables import Table

    config = startup.NemoConfig(args.configFileName, makeOutputDirs=False,
                                setUpMaps=False, verbose=False,
                                device=args.device)
    outputLabel = os.path.split(args.configFileName)[-1].replace(".yml",
                                                                 "")
    optimalCatalogFileName = os.path.join(
        config.rootOutDir, "%s_optimalCatalog.fits"
        % os.path.split(config.rootOutDir)[-1])
    nemoTab = Table.read(optimalCatalogFileName)
    extTab = Table.read(args.catFileName)
    raKey, decKey = catalogs.getTableRADecKeys(extTab)
    # negative RA convention fix (reference bin/nemoCatalogCheck:56-58)
    ras = np.asarray(extTab[raKey], dtype=float)
    extTab[raKey] = np.where(ras < 0, 360.0 - np.abs(ras), ras)

    selFn = completeness.SelFn(config.selFnDir, args.fixedSNRCut,
                               configFileName=args.configFileName,
                               enableCompletenessCalc=False,
                               setUpAreaMask=True, device=args.device)
    inMask = selFn.checkCoordsInAreaMask(np.asarray(extTab[raKey]),
                                         np.asarray(extTab[decKey]))
    maxPossibleMatches = int(inMask.sum())
    extTab["inMask"] = inMask
    print("... %d/%d objects in %s are in the valid area mask for %s ..."
          % (maxPossibleMatches, len(extTab), args.catFileName,
             config.rootOutDir))

    inMaskName = os.path.split(args.catFileName)[-1].replace(
        ".fits", "_inMask_%s.fits" % outputLabel)
    withinMaskTab = extTab[inMask]
    withinMaskTab.meta["NEMOVER"] = __version__
    withinMaskTab.write(inMaskName)

    # Cross matching: missed = in-mask objects with no nemo counterpart
    missing = catalogs.removeCrossMatched(
        extTab, nemoTab, radiusArcmin=args.matchRadiusArcmin)
    missTab = missing[np.asarray(missing["inMask"], dtype=bool)] \
        if len(missing) > 0 else missing
    print("... %d/%d maximum possible matches in %s are found within "
          "%.1f arcmin of an object in the %s catalog"
          % (maxPossibleMatches - len(missTab), maxPossibleMatches,
             args.catFileName, args.matchRadiusArcmin, config.rootOutDir))
    print("... %d/%d maximum possible matches in %s are NOT found within "
          "%.1f arcmin of an object in the %s catalog"
          % (len(missTab), maxPossibleMatches, args.catFileName,
             args.matchRadiusArcmin, config.rootOutDir))

    missedName = os.path.split(args.catFileName)[-1].replace(
        ".fits", "_missed_in_%s.fits"
        % os.path.split(optimalCatalogFileName)[-1].replace(".fits", ""))
    missTab.meta["NEMOVER"] = __version__
    missTab.write(missedName)
    print("... written missed objects table to %s" % missedName)

    idKeyToUse = None
    for k in ["name", "id", "ID", "Name", "NAME", "Cluster"]:
        if k in missTab.keys():
            idKeyToUse = k
            break
    if idKeyToUse is not None and len(missTab) > 0:
        regFileName = missedName.replace(".fits", ".reg")
        catalogs.catalog2DS9(missTab, regFileName, idKeyToUse=idKeyToUse)
        print("... written missed objects DS9 region file to %s"
              % regFileName)


if __name__ == "__main__":
    main()
