#!/usr/bin/env python
"""nemoMass (PyTorch port): cluster mass inference from y0~ measurements
and redshifts.

Same flags as ``nemo_tpu.cli.nemoMass_main``, plus ``--device`` and
``--x64``: cross-matches the optimal catalog against the redshift
catalog (or, with ``-c``, reads a catalog and runs forced photometry on the
cached filtered maps where it has no fixed_y_c), then infers M500c (and
other mass definitions) from fixed_y_c through the UPP-style scaling
relation with Eddington de-biasing, every row in one batched computation
on the device.

    python -m nemo_tpu_torch.cli.nemoMass_main config.yml --device cuda
"""

import argparse
import os

import numpy as np


def makeParser():
    parser = argparse.ArgumentParser("nemoMass")
    parser.add_argument("configFileName")
    parser.add_argument("-c", "--catalog", dest="catFileName", default=None)
    parser.add_argument("-o", "--output", dest="outFileName", default=None)
    parser.add_argument("-Q", "--Q-source", dest="QSource", default="fit")
    parser.add_argument("-x", "--x-match-arcmin", dest="xMatchArcmin",
                        default=2.5, type=float)
    parser.add_argument("-z", "--z-column", dest="zColumnName", default=None)
    parser.add_argument("-e", "--z-error-column", dest="zErrColumnName",
                        default=None)
    parser.add_argument("-F", "--forced-photometry", dest="forcedPhotometry",
                        action="store_true", default=False)
    parser.add_argument("-M", "--mpi", dest="MPIEnabled",
                        action="store_true", default=False)
    parser.add_argument("-n", "--no-strict-errors", action="store_true",
                        default=False)
    parser.add_argument("--x64", dest="x64", action="store_true",
                        default=False,
                        help="Use float64 on CUDA (the CPU always runs in "
                             "float64).")
    parser.add_argument("--device", dest="device", default="cuda",
                        choices=("cuda", "cpu"),
                        help="Device to run on (default cuda; fails if no "
                             "CUDA device is present).")
    return parser


def _fixRedshiftColumns(zTab, zColumnName=None, zErrColumnName=None):
    if zColumnName is not None:
        zTab.rename_column(zColumnName, "redshift")
    if zErrColumnName is not None:
        zTab.rename_column(zErrColumnName, "redshiftErr")
    if "redshift" not in zTab.keys():
        for p in ("z", "Z", "REDSHIFT", "Redshift", "z_cl", "Photz"):
            if p in zTab.keys():
                zTab.rename_column(p, "redshift")
                break
        else:
            raise KeyError("No redshift column found")
    if "redshiftErr" not in zTab.keys():
        for p in ("zErr", "dz"):
            if p in zTab.keys():
                zTab.rename_column(p, "redshiftErr")
                break
        else:
            zTab["redshiftErr"] = np.zeros(len(zTab))
    return zTab


def calcMassTable(tab, massOptions, Q, fRelWeightsDict, mockSurvey,
                  otherMassEstimates=None, dtype=None):
    """Mass columns for every row (``bin/nemoMass:103-215``), computed on
    the mock survey's device in ``dtype`` (default: the device policy's)."""
    from nemo_tpu_torch.models import scaling

    otherMassEstimates = otherMassEstimates or [
        {"delta": 200, "rhoType": "matter"}]
    for d in otherMassEstimates:
        # cosmology.convertMassDef implements Bhattacharya13 (the
        # reference's default, bin/nemoMass:331); never silently swap a
        # requested concentration-mass relation for a different one
        if d.get("concMassRelation") not in (None, "Bhattacharya13"):
            raise ValueError(
                "otherMassEstimates: unsupported concMassRelation %r "
                "(only Bhattacharya13 is implemented)"
                % d["concMassRelation"])
    massOptions.setdefault("relativisticCorrection", True)
    massOptions.setdefault("Ez_gamma", 2)
    massOptions.setdefault("onePlusRedshift_power", 0.0)

    label = mockSurvey.mdefLabel
    labels = [label] + ["M%d%s" % (d["delta"], d["rhoType"][0])
                        for d in otherMassEstimates]
    colNames = []
    for lab in labels:
        colNames += [lab, lab + "Uncorr"]
        if "rescaleFactor" in massOptions:
            colNames.append(lab + "Cal")
    for c in colNames:
        tab[c] = np.zeros(len(tab))
        tab[c + "_errPlus"] = np.zeros(len(tab))
        tab[c + "_errMinus"] = np.zeros(len(tab))
    tab["Q"] = np.zeros(len(tab))

    y_c = np.asarray(tab["fixed_y_c"], dtype=float)
    err_y_c = np.asarray(tab["fixed_err_y_c"], dtype=float)
    zs = np.asarray(tab["redshift"], dtype=float)
    zErrs = np.asarray(tab["redshiftErr"], dtype=float)
    tiles = np.asarray(tab["tileName"]) if "tileName" in tab.keys() \
        else np.array([None] * len(tab))

    # All rows go through one batched device computation
    # (scaling.calcMassBatch) instead of the reference's per-cluster loop.
    valid = np.nonzero((y_c > 0) & ~np.isnan(zs))[0]
    if len(valid) == 0:
        return tab
    res = scaling.calcMassBatch(
        y_c[valid] * 1e-4, err_y_c[valid] * 1e-4, zs[valid], zErrs[valid],
        Q, mockSurvey, tenToA0=massOptions["tenToA0"], B0=massOptions["B0"],
        Mpivot=massOptions["Mpivot"], sigma_int=massOptions["sigma_int"],
        Ez_gamma=massOptions["Ez_gamma"],
        onePlusRedshift_power=massOptions["onePlusRedshift_power"],
        applyRelativisticCorrection=massOptions["relativisticCorrection"],
        tileNames=[tiles[i] for i in valid], dtype=dtype)
    for c in (label, label + "_errPlus", label + "_errMinus",
              label + "Uncorr", label + "Uncorr_errPlus",
              label + "Uncorr_errMinus", "Q"):
        col = np.asarray(tab[c], dtype=float)
        col[valid] = res[c]
        tab[c] = col

    if "rescaleFactor" in massOptions:
        rf = massOptions["rescaleFactor"]
        rfErr = massOptions.get("rescaleFactorErr", 0.0)
        cal = res[label] / rf
        calPlus = cal * np.sqrt(
            (res[label + "_errPlus"] / res[label]) ** 2 + (rfErr / rf) ** 2)
        calMinus = cal * np.sqrt(
            (res[label + "_errMinus"] / res[label]) ** 2 + (rfErr / rf) ** 2)
        for c, vals in ((label + "Cal", cal),
                        (label + "Cal_errPlus", calPlus),
                        (label + "Cal_errMinus", calMinus)):
            col = np.asarray(tab[c], dtype=float)
            col[valid] = vals
            tab[c] = col
        res[label + "Cal"] = cal
        res[label + "Cal_errPlus"] = calPlus
        res[label + "Cal_errMinus"] = calMinus
        suffixes = ("", "Uncorr", "Cal")
    else:
        suffixes = ("", "Uncorr")

    for suffix in suffixes:
        base = res[label + suffix]
        basePlus = res[label + suffix + "_errPlus"]
        baseMinus = res[label + suffix + "_errMinus"]
        good = base > 0
        for d in otherMassEstimates:
            thisLabel = "M%d%s" % (d["delta"], d["rhoType"][0])
            colM = np.asarray(tab[thisLabel + suffix], dtype=float)
            colP = np.asarray(tab[thisLabel + suffix + "_errPlus"],
                              dtype=float)
            colN = np.asarray(tab[thisLabel + suffix + "_errMinus"],
                              dtype=float)
            if good.any():
                # one vectorised (M, z) conversion for the whole catalog
                rows = valid[good]
                masses = mockSurvey.cosmoModel.convertMassDef(
                    base[good] * 1e14, zs[rows], massOptions["delta"],
                    massOptions["rhoType"], d["delta"],
                    d["rhoType"]) / 1e14
                masses = np.atleast_1d(masses)
                ratio = masses / base[good]
                colM[rows] = masses
                colP[rows] = basePlus[good] * ratio
                colN[rows] = baseMinus[good] * ratio
            tab[thisLabel + suffix] = colM
            tab[thisLabel + suffix + "_errPlus"] = colP
            tab[thisLabel + suffix + "_errMinus"] = colN
    return tab


def main(argv=None):
    args = makeParser().parse_args(argv)
    from nemo_tpu_torch import catalogs, completeness, pipelines, startup
    from nemo_tpu_torch.mock import MockSurvey
    from nemo_tpu_torch.models.qfit import QFit
    from nemo_tpu_torch.utils.tables import Table

    config = startup.NemoConfig(args.configFileName, makeOutputDirs=False,
                                setUpMaps=False, verbose=False,
                                device=args.device, x64=args.x64)
    massOptions = config.parDict["massOptions"]

    if args.catFileName is None:
        optimalCatalogFileName = os.path.join(
            config.rootOutDir, "%s_optimalCatalog.fits"
            % os.path.split(config.rootOutDir)[-1])
        nemoTab = Table.read(optimalCatalogFileName)
        zTab = _fixRedshiftColumns(
            Table.read(massOptions["redshiftCatalog"]),
            args.zColumnName, args.zErrColumnName)
        zMatched, nemoMatched, _ = catalogs.crossMatch(
            zTab, nemoTab, radiusArcmin=args.xMatchArcmin)
        tab = nemoMatched
        tab["redshift"] = zMatched["redshift"]
        tab["redshiftErr"] = zMatched["redshiftErr"]
        outFileName = args.outFileName or optimalCatalogFileName.replace(
            "_optimalCatalog.fits", "_mass.fits")
    else:
        tab = _fixRedshiftColumns(Table.read(args.catFileName),
                                  args.zColumnName, args.zErrColumnName)
        needForced = args.forcedPhotometry or \
            "fixed_y_c" not in tab.keys()
        if needForced:
            config = startup.NemoConfig(args.configFileName,
                                        setUpMaps=True, verbose=False,
                                        device=args.device, x64=args.x64)
            config.parDict["forcedPhotometryCatalog"] = tab
            config.parDict["thresholdSigma"] = -100
            config.parDict["mapFilters"] = [
                f for f in config.parDict["mapFilters"]
                if f["label"] == config.parDict["photFilter"]]
            forcedTab = pipelines.filterMapsAndMakeCatalogs(
                config, useCachedFilteredMaps=True)
            zMatched, forcedMatched, _ = catalogs.crossMatch(tab, forcedTab)
            forcedMatched["redshift"] = zMatched["redshift"]
            forcedMatched["redshiftErr"] = zMatched["redshiftErr"]
            tab = forcedMatched
        outFileName = args.outFileName or \
            os.path.basename(args.catFileName).replace(".fits",
                                                       "_mass.fits")

    Q = QFit(QSource=args.QSource, selFnDir=config.selFnDir)
    fRelWeightsDict = completeness.getFRelWeights(config)

    minMass, zMin, zMax = 1e13, 0.0, 3.0
    mockSurvey = MockSurvey(minMass, 700.0, zMin, zMax, massOptions["H0"],
                            massOptions["Om0"], massOptions["Ob0"],
                            massOptions["sigma8"], massOptions["ns"],
                            delta=massOptions["delta"],
                            rhoType=massOptions["rhoType"],
                            transferFunction=massOptions.get(
                                "transferFunction", "boltzmann_camb"),
                            device=str(config.policy.device))
    # Extra mass definitions from the config (reference
    # bin/nemoMass:327-331; defaults to M200m inside calcMassTable)
    otherMassEstimates = None
    if config.parDict.get("otherMassEstimates") and \
            config.parDict.get("massOptions") is not None:
        otherMassEstimates = config.parDict["otherMassEstimates"]
    tab = calcMassTable(tab, massOptions, Q, fRelWeightsDict, mockSurvey,
                        otherMassEstimates=otherMassEstimates,
                        dtype=config.policy.dtype)

    # Mock-recovery report when the input catalog carries truth columns
    # (reference bin/nemoMass:400-427)
    for trueCol, recCol in (("true_M500c", "M500c"),
                            ("true_M500", "M500c"),
                            ("true_M200m", "M200m")):
        if trueCol in tab.keys() and recCol in tab.keys():
            true = np.asarray(tab[trueCol], dtype=float)
            rec = np.asarray(tab[recCol], dtype=float)
            sel = (true > 0) & (rec > 0)
            if sel.sum() > 0:
                print("... median %s / %s = %.3f (1.000 if mass recovery "
                      "is unbiased) ..."
                      % (recCol, trueCol, float(np.median(rec[sel]
                                                          / true[sel]))))

    catalogs.writeCatalog(tab, outFileName)
    print("... wrote %s" % outFileName)


if __name__ == "__main__":
    main()
