#!/usr/bin/env python
"""nemoModel: paint model sky maps (clusters or point sources) from a
catalog, optionally adding a CMB realisation, white / 1-f noise, and
extra pre-computed signal maps.

Port of ``nemo_tpu/cli/nemoModel_main.py`` with its flag surface:
``pointsources-N`` test catalogs, ``-N`` accepting a level / 'Nsb'
surface-brightness level / inverse-variance map path, ``-A/--add-map``,
``--split-noise-test``, ``-T/--break-map-into-tiles``, ``-a/--tcmb-alpha``
and header-keyword cosmology overrides.  The painting and the sims (the
flat GRF, or with ``--curved-cmb`` and for 1/f noise above
``maps.CURVED_SKY_DEC_DEG`` the curved-sky SHT and its Legendre kernel)
run on ``--device`` (default cuda):

    python -m nemo_tpu_torch.cli.nemoModel_main catalog.fits mask.fits \
        beam.txt out.fits -C --curved-cmb -N 20 --lknee 2000 -S 42
"""

import argparse
import os

import numpy as np


def makeParser():
    parser = argparse.ArgumentParser("nemoModel")
    parser.add_argument("catalogFileName", metavar="catalog",
                        help="Path to a Nemo FITS-table catalog, or "
                             "'pointsources-N' to generate a test catalog "
                             "of N random sources (written to "
                             "outputFileName_inputCatalog.fits). "
                             "Cosmological parameters may be given in the "
                             "FITS header via the OM0, OB0, H0, SIGMA8, NS "
                             "keywords (cluster models only).")
    parser.add_argument("templateFileName", metavar="maskFileName",
                        help="FITS image defining the output pixelisation "
                             "(a mask or map); non-zero regions define "
                             "tiles when -T/-M is used.")
    parser.add_argument("beamFileName", help="Beam profile text file.")
    parser.add_argument("outputFileName", help="Output FITS map.")
    parser.add_argument("-f", "--frequency-GHz", dest="obsFreqGHz",
                        type=float, default=150.0,
                        help="Evaluate cluster SZ signals at this "
                             "frequency (default: 150.0).")
    parser.add_argument("-s", "--scale-signals", dest="scale", type=float,
                        default=1.0,
                        help="Scale the catalog's y_c values by this "
                             "factor (as the reference, bin/nemoModel:"
                             "207-209, only the y_c column is scaled; "
                             "point-source amplitudes are untouched).")
    parser.add_argument("-p", "--profile", dest="profile", default="A10",
                        help="Cluster profile: A10 or B12.")
    parser.add_argument("-C", "--add-cmb", "--CMB", dest="addCMB",
                        action="store_true", default=False,
                        help="Add a CMB realisation (also writes "
                             "_signalOnly and _signalAndCMB debug maps, "
                             "as the reference does).")
    parser.add_argument("--curved-cmb", dest="curvedCMB",
                        action="store_true", default=False,
                        help="Synthesise the CMB through the curved-sky "
                             "SHT (ops/sht.py) instead of the flat-sky "
                             "GRF; exact at all declinations.")
    parser.add_argument("--cmb-lmax", dest="cmbLmax", type=int,
                        default=None,
                        help="Band limit for --curved-cmb (default: "
                             "min(spectrum extent, ring Nyquist)).")
    parser.add_argument("-N", "--add-noise", "--noise-level",
                        dest="addNoise", default="0.0",
                        help="White noise to add: a number (uK per "
                             "pixel), a number with an 'sb' suffix (e.g. "
                             "40sb: constant surface brightness per "
                             "square arcmin, adjusted for pixel-scale "
                             "variation), or a path to an inverse-"
                             "variance map on the same pixelisation as "
                             "the mask.")
    parser.add_argument("-k", "--lknee", dest="lKnee", type=float,
                        default=None,
                        help="If given, the noise is 1/f with "
                             "N_l = (1 + l/lknee)^-3 (use with -N; e.g. "
                             "2000 for ACT f090, 3000 for f150).")
    parser.add_argument("-A", "--add-map", dest="addMap", default=None,
                        help="Path to a FITS map (same pixelisation as "
                             "the mask) added to the output sim map - "
                             "e.g. Galactic dust or large-scale noise "
                             "components.  Scale with --add-map-scaling.")
    parser.add_argument("--add-map-scaling", dest="addMapScaling",
                        default=1.0,
                        help="Multiply the --add-map map by this factor.")
    parser.add_argument("--split-noise-test", dest="splitNoiseTest",
                        action="store_true", default=False,
                        help="With -N and -C: double the white-noise "
                             "level in one half of the map and write a "
                             "matching .ivar.fits weights map.")
    parser.add_argument("-T", "--break-map-into-tiles",
                        dest="breakIntoTiles", action="store_true",
                        default=False,
                        help="Paint large maps tile by tile using the "
                             "autotiler (bounds peak memory); turned on "
                             "automatically with -M.")
    parser.add_argument("-a", "--tcmb-alpha", dest="TCMBAlpha",
                        type=float, default=0.0,
                        help="Cluster models only: CMB temperature "
                             "evolves as T(z) = T0*(1+z)^(1-TCMBAlpha); "
                             "needs a 'redshift' catalog column.")
    parser.add_argument("-S", "--seed", dest="seed", type=int,
                        default=None,
                        help="Random seed for the CMB / source-catalog "
                             "realisations (not the noise).")
    parser.add_argument("-M", "--mpi", dest="MPIEnabled",
                        action="store_true", default=False,
                        help="Accepted for reference compatibility; "
                             "tiles are processed through the device "
                             "mesh in one process.")
    parser.add_argument("-n", "--no-strict-errors",
                        dest="noStrictMPIExceptions", action="store_true",
                        default=False,
                        help="Accepted for reference compatibility "
                             "(single-process: no effect).")
    parser.add_argument("--device", dest="device", default="cuda",
                        choices=("cuda", "cpu"),
                        help="Device the painting and the sims run on "
                             "(default cuda; fails if no CUDA device is "
                             "present).")
    return parser


def _parseNoiseArg(addNoise, shape, wcs):
    """Reference noise-argument semantics (``bin/nemoModel:146-171``):
    number = uK per pixel; 'Nsb' = uK per square arcmin; otherwise a path
    to an inverse-variance map (converted to per-pixel sigma)."""
    from ..utils import fits as nfits
    from ..utils.wcs import WCS

    if isinstance(addNoise, str) and addNoise.endswith("sb"):
        return float(addNoise[:-2]), "perSquareArcmin"
    try:
        return float(addNoise), "perPixel"
    except ValueError:
        pass
    ivar, ivarHeader = nfits.read_image(addNoise)
    ivar = np.asarray(ivar)
    if ivar.ndim == 3:
        ivar = ivar[0]
    sigma = np.zeros_like(ivar, dtype=float)
    valid = ivar > 1e-7
    sigma[valid] = np.sqrt(1.0 / ivar[valid])
    if sigma.shape != tuple(shape):
        # Same pixelisation required (reference asserts this); a LARGER
        # ivar map is clipped to the mask footprint by WCS offset
        # (deterministic equivalent of the reference's iterative
        # clipUsingRADecCoords loop, bin/nemoModel:278-299).
        ivarWCS = WCS(ivarHeader)
        ra0, dec0 = wcs.pix2wcs(0.0, 0.0)
        x0, y0 = ivarWCS.wcs2pix(float(ra0), float(dec0))
        x0, y0 = int(round(float(x0))), int(round(float(y0)))
        if x0 < 0 or y0 < 0 or y0 + shape[0] > sigma.shape[0] \
                or x0 + shape[1] > sigma.shape[1]:
            raise ValueError(
                "inverse-variance map does not cover the mask footprint "
                "(mask %s at offset (%d, %d) of ivar %s)"
                % (tuple(shape), y0, x0, sigma.shape))
        sigma = sigma[y0:y0 + shape[0], x0:x0 + shape[1]]
    return sigma, "perPixel"


def main(argv=None):
    args = makeParser().parse_args(argv)
    from .. import catalogs, maps, startup
    from .. import device as device_mod
    from ..models import cosmology
    from ..utils import fits as nfits
    from ..utils.tables import Table
    from ..utils.wcs import WCS

    P = device_mod.policy(args.device)

    if args.addMap is not None and not os.path.exists(args.addMap):
        raise FileNotFoundError(args.addMap)

    data, header = nfits.read_image(args.templateFileName)
    data = np.asarray(data)
    if data.ndim == 3:
        data = data[0]
    wcs = WCS(header)
    shape = data.shape

    baseDir = os.path.split(args.outputFileName)[0]
    if baseDir:
        os.makedirs(baseDir, exist_ok=True)

    addNoise, noiseMode = _parseNoiseArg(args.addNoise, shape, wcs)

    # 'pointsources-N' generates (and saves) a random test catalog
    # (reference bin/nemoModel:173-188)
    if args.catalogFileName.startswith("pointsources"):
        try:
            numSources = int(args.catalogFileName.split("-")[-1])
        except ValueError:
            raise ValueError("Use format pointsources-N, e.g. "
                             "pointsources-100 generates a test catalog "
                             "of 100 sources.")
        if numSources > 0:
            catalog = catalogs.generateRandomSourcesCatalog(
                data, wcs, numSources, seed=args.seed)
            catalog.write(args.outputFileName.replace(
                ".fits", "_inputCatalog.fits"))
        else:
            catalog = Table({"RADeg": np.zeros(0), "decDeg": np.zeros(0)})
    else:
        catalog = Table.read(args.catalogFileName)

    # Optional fiducial-cosmology override from catalog header keywords
    # (cluster painted sizes only; reference bin/nemoModel:192-205)
    keywords = ["OM0", "OB0", "H0", "SIGMA8", "NS"]
    meta = getattr(catalog, "meta", {}) or {}
    cosmoModel = None
    if all(k in meta for k in keywords):
        print(">>> Using cosmology specified in header for catalog %s "
              "[only affects painted cluster sizes]"
              % args.catalogFileName)
        cosmoModel = cosmology.FlatLCDM(
            H0=float(meta["H0"]), Om0=float(meta["OM0"]),
            Ob0=float(meta["OB0"]), sigma8=float(meta["SIGMA8"]),
            ns=float(meta["NS"]), device=args.device)

    # Signal scaling applies to cluster y_c only (reference :207-209)
    if args.scale != 1.0 and "y_c" in catalog.keys():
        catalog["y_c"] = np.asarray(catalog["y_c"]) * args.scale

    if args.MPIEnabled or args.breakIntoTiles:
        # Paint tile by tile through the autotiler and stitch - bounds
        # peak painting memory exactly as the reference's -T/-M path
        # (bin/nemoModel:121-140, 212-264)
        parDict = {
            "unfilteredMaps": [{"mapFileName": args.templateFileName,
                                "obsFreqGHz": args.obsFreqGHz,
                                "beamFileName": args.beamFileName,
                                "units": "uK"}],
            "mapFilters": [], "useTiling": True, "reprojectToTan": False,
            "tileOverlapDeg": 1.0,
            "tileDefinitions": {"mask": args.templateFileName,
                                "targetTileWidthDeg": 10.0,
                                "targetTileHeightDeg": 5.0}}
        config = startup.NemoConfig(parDict, MPIEnabled=False,
                                    makeOutputDirs=False, setUpMaps=True,
                                    writeTileInfo=False, verbose=False,
                                    device=args.device)
        modelMap = np.zeros(shape)
        print(">>> Building models in tiles ...")
        for tileName in config.tileNames:
            print("... %s ..." % tileName)
            entry = config.tileCoordsDict[tileName]
            minX, maxX, minY, maxY = entry["clippedSection"]
            tileShape = (maxY - minY, maxX - minX)
            tileWCS = WCS(entry["header"])
            tileModel = maps.makeModelImage(
                tileShape, tileWCS, catalog, args.beamFileName,
                obsFreqGHz=args.obsFreqGHz, profile=args.profile,
                cosmoModel=cosmoModel, TCMBAlpha=args.TCMBAlpha,
                validAreaSection=entry["areaMaskInClipSection"], policy=P)
            if tileModel is not None:
                modelMap[minY:maxY, minX:maxX] += np.asarray(tileModel)
    else:
        modelMap = maps.makeModelImage(shape, wcs, catalog,
                                       args.beamFileName,
                                       obsFreqGHz=args.obsFreqGHz,
                                       profile=args.profile,
                                       cosmoModel=cosmoModel,
                                       TCMBAlpha=args.TCMBAlpha, policy=P)
        if modelMap is None:
            modelMap = np.zeros(shape)
        modelMap = np.asarray(modelMap)

    if args.addCMB:
        # Debug intermediates, as the reference writes (:266-273)
        nfits.write_image(args.outputFileName.replace(
            ".fits", "_signalOnly.fits"), modelMap, wcs.header)
        modelMap = modelMap + maps.simCMBMap(
            shape, wcs, beam=args.beamFileName, seed=args.seed,
            method="curved" if args.curvedCMB else "flat",
            lmax=args.cmbLmax, policy=P)
        nfits.write_image(args.outputFileName.replace(
            ".fits", "_signalAndCMB.fits"), modelMap, wcs.header)

    scalarNoise = np.ndim(addNoise) == 0
    if (not scalarNoise) or addNoise > 0 or args.lKnee is not None:
        noiseSeed = None if args.seed is None else args.seed + 1
        modelMap = modelMap + maps.simNoiseMap(
            shape, addNoise, wcs=wcs, lKnee=args.lKnee,
            noiseMode=noiseMode, seed=noiseSeed, policy=P)

    if args.splitNoiseTest:
        # Abrupt noise-level change test (reference :302-309): double
        # the white noise in the bottom half + a matching ivar map
        if not scalarNoise:
            raise ValueError("--split-noise-test needs a numeric -N")
        half = shape[0] // 2
        rng = np.random.default_rng(
            None if args.seed is None else args.seed + 2)
        modelMap[:half] += rng.normal(0, 2 * addNoise, (half, shape[1]))
        weights = np.ones(shape) * addNoise
        weights[:half] *= 2
        weights = np.power(weights, -2)
        nfits.write_image(args.outputFileName.replace(
            ".fits", ".ivar.fits"), weights, wcs.header)

    if args.addMap is not None:
        extra, _ = nfits.read_image(args.addMap)
        extra = np.asarray(extra)
        if extra.ndim == 3:
            extra = extra[0]
        modelMap = modelMap + float(args.addMapScaling) * extra

    nfits.write_image(args.outputFileName, modelMap, wcs.header)
    print("... wrote %s" % args.outputFileName)


if __name__ == "__main__":
    main()
