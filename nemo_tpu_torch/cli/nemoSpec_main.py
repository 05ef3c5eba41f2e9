#!/usr/bin/env python
"""nemoSpec (PyTorch port): extract SEDs at catalog positions from
multi-frequency maps.

Same flags as ``nemo_tpu.cli.nemoSpec_main``, plus ``--device``: the
PSF matching, and with ``-m matchedFilter`` the filters and the grid RMS
(the ``rms_cells`` kernel on the card), run on that device; CAP
photometry is host numpy.  Run from the directory that should hold the
``nemoSpecCache/`` of the matched-filter method.

    python -m nemo_tpu_torch.cli.nemoSpec_main config.yml cat.fits -m CAP
"""

import argparse

import numpy as np


def makeParser():
    parser = argparse.ArgumentParser("nemoSpec")
    parser.add_argument("configFileName")
    parser.add_argument("catFileName", help="Catalog with name, RADeg, "
                                            "decDeg columns.")
    parser.add_argument("-o", "--output", dest="outFileName", default=None)
    parser.add_argument("-m", "--method", dest="method", default="CAP",
                        help="'CAP' or 'matchedFilter'.")
    parser.add_argument("-r", "--radius-arcmin", "--disk-radius-arcmin",
                        dest="diskRadiusArcmin", type=float, default=4.0)
    parser.add_argument("-w", "-S", "--write-maps", "--save-filtered-maps",
                        dest="saveFilteredMaps", action="store_true",
                        default=False)
    parser.add_argument("-z", "--redshift-catalog",
                        dest="redshiftCatFileName", default=None,
                        help="Redshift catalog (.fits) cross-matched onto "
                             "the output.")
    parser.add_argument("-M", "--mpi", dest="MPIEnabled",
                        action="store_true", default=False)
    parser.add_argument("-n", "--no-strict-errors",
                        dest="noStrictMPIExceptions", action="store_true",
                        default=False,
                        help="Accepted for reference compatibility "
                             "(single-process: no effect).")
    parser.add_argument("--device", dest="device", default="cuda",
                        choices=("cuda", "cpu"),
                        help="Device to run on (default cuda; fails if no "
                             "CUDA device is present).")
    return parser


def main(argv=None):
    args = makeParser().parse_args(argv)
    from nemo_tpu_torch import catalogs, pipelines, startup
    from nemo_tpu_torch.utils.tables import Table

    config = startup.NemoConfig(args.configFileName, writeTileInfo=True,
                                device=args.device)
    tab = Table.read(args.catFileName)
    specTab = pipelines.extractSpec(config, tab, method=args.method,
                                    diskRadiusArcmin=args.diskRadiusArcmin,
                                    saveFilteredMaps=args.saveFilteredMaps)
    if args.redshiftCatFileName is not None:
        zTab = Table.read(args.redshiftCatFileName)
        specM, zM, _ = catalogs.crossMatch(specTab, zTab, radiusArcmin=2.5)
        if len(specM) > 0:
            zByName = {n: z for n, z in zip(np.asarray(specM["name"]),
                                            np.asarray(zM["redshift"]))}
            specTab["redshift"] = np.array(
                [zByName.get(n, -99.0)
                 for n in np.asarray(specTab["name"])])
    outFileName = args.outFileName or \
        args.catFileName.replace(".fits", "_spec.fits")
    catalogs.writeCatalog(specTab, outFileName)
    print("... wrote %s" % outFileName)


if __name__ == "__main__":
    main()
