"""Catalog construction and manipulation.

Rebuild of ``nemo/catalogs.py`` on the native Table class: optimal-catalog
merging, duplicate removal across tile overlaps, IAU names, DS9 regions,
sky cross-matching (scipy cKDTree on unit vectors instead of astropy
SkyCoord), constraint selection with a safe parser instead of ``eval``
(``nemo/catalogs.py:438``).
"""

import datetime
import operator

import numpy as np
from scipy.spatial import cKDTree

from . import __version__
from .utils.tables import Table, vstack
from .utils.wcs import calcAngSepDeg

XMATCH_RADIUS_DEG = 1.4 / 60.0  # catalog matching radius (catalogs.py:25)

COLUMN_NAMES = [
    "name", "RADeg", "decDeg", "SNR", "numSigPix", "template", "tileName",
    "flags", "galacticLatDeg", "deltaT_c", "err_deltaT_c", "y_c", "err_y_c",
    "Y500_sr", "err_Y500_sr", "fluxJy", "err_fluxJy", "redshift",
    "redshiftErr", "ellipse_PA", "ellipse_A", "ellipse_B", "ellipse_x0",
    "ellipse_y0", "ellipse_e",
] + ["fixed_" + k for k in ("deltaT_c", "err_deltaT_c", "y_c", "err_y_c")]


# -- coordinates ---------------------------------------------------------------
# J2000 equatorial -> galactic rotation matrix (IAU standard)
_EQ2GAL = np.array([
    [-0.0548755604, -0.8734370902, -0.4838350155],
    [+0.4941094279, -0.4448296300, +0.7469822445],
    [-0.8676661490, -0.1980763734, +0.4559837762]])


def _unit_vectors(raDeg, decDeg):
    ra = np.radians(np.asarray(raDeg, dtype=float))
    dec = np.radians(np.asarray(decDeg, dtype=float))
    return np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                     np.sin(dec)], axis=-1)


def galacticLatDeg(raDeg, decDeg):
    """Galactic latitude b for J2000 equatorial coordinates."""
    v = _unit_vectors(raDeg, decDeg)
    g = v @ _EQ2GAL.T
    return float(np.degrees(np.arcsin(np.clip(g[..., 2], -1, 1)))) \
        if np.isscalar(raDeg) else np.degrees(np.arcsin(np.clip(g[..., 2],
                                                                -1, 1)))


def nearestNeighbours(ra1, dec1, ra2, dec2, nthneighbor=1):
    """For each (ra1, dec1), index + separation (deg) of nearest in set 2.

    nthneighbor = 2 with identical sets gives 'nearest other object',
    matching astropy match_coordinates_sky usage at ``catalogs.py:538``.
    """
    v1 = np.atleast_2d(_unit_vectors(ra1, dec1))
    v2 = np.atleast_2d(_unit_vectors(ra2, dec2))
    tree = cKDTree(v2)
    dist, idx = tree.query(v1, k=nthneighbor)
    if nthneighbor > 1:
        dist = dist[:, -1]
        idx = idx[:, -1]
    sep = np.degrees(2 * np.arcsin(np.clip(dist / 2.0, 0, 1)))
    return idx, sep


# -- names ----------------------------------------------------------------------
def _truncate(value, decimals):
    factor = 10 ** decimals
    return np.floor(value * factor + 1e-10) / factor


def _ra_string(RADeg, long=False):
    hours = (RADeg / 360.0) * 24
    HH = int(hours)
    mins = (hours - HH) * 60
    if long:
        MM = int(mins)
        secs = _truncate((mins - MM) * 60, 1)
        return "%02d%02d%04.1f" % (HH, MM, secs)
    return "%02d%04.1f" % (HH, _truncate(mins, 1))


def _dec_string(decDeg, long=False):
    sign = "+" if decDeg > 0 else "-"
    d = abs(decDeg)
    DD = int(d)
    mins = (d - DD) * 60
    if long:
        MM = int(mins)
        secs = _truncate((mins - MM) * 60, 1)
        return "%s%02d%02d%04.1f" % (sign, DD, MM, secs)
    return "%s%02d%02d" % (sign, DD, int(mins))


def makeName(RADeg, decDeg, prefix="ACT-CL"):
    """IAU-style name: prefix JHHMM.m+/-DDMM (``catalogs.py:259-274``)."""
    return "%s J%s%s" % (prefix, _ra_string(RADeg), _dec_string(decDeg))


def makeLongName(RADeg, decDeg, prefix="ACT-CL"):
    """Long IAU name: prefix JHHMMSS.s+/-DDMMSS.s."""
    return "%s J%s%s" % (prefix, _ra_string(RADeg, long=True),
                         _dec_string(decDeg, long=True))


# -- selection -------------------------------------------------------------------
_OPS = {"<": operator.lt, ">": operator.gt, "<=": operator.le,
        ">=": operator.ge, "==": operator.eq, "=": operator.eq,
        "!=": operator.ne}


def selectFromCatalog(catalog, constraintsList):
    """Apply constraints like "SNR > 5.0" (``catalogs.py:421-440``) using a
    safe parser rather than eval."""
    out = catalog
    for constraintString in constraintsList or []:
        key, op, value = constraintString.split()
        if op not in _OPS:
            raise ValueError("Unsupported operator %r" % op)
        col = np.asarray(out[key])
        try:
            value = float(value)
        except ValueError:
            value = value.strip("'\"")
        out = out[_OPS[op](col, value)]
    return out


# -- conversions ------------------------------------------------------------------
def catalogListToTab(catalogList, keysToWrite=None):
    """List of object dicts -> Table (``catalogs.py:443-468``)."""
    keysToWrite = keysToWrite or COLUMN_NAMES
    availKeys = list(catalogList[0].keys())
    tab = Table()
    for key in keysToWrite:
        if key in availKeys:
            tab[key] = np.array([obj[key] if obj[key] is not None else -99
                                 for obj in catalogList])
    return tab


def tabToCatalogList(tab):
    return [dict(row) for row in tab]


def getTableRADecKeys(tab):
    """Find the RA, dec column names (covers common variants)."""
    raKeys = ["RADeg", "RA", "ra", "RADeg_1", "raDeg"]
    decKeys = ["decDeg", "DEC", "dec", "Dec", "decDeg_1"]
    ra = next((k for k in raKeys if k in tab.keys()), None)
    dec = next((k for k in decKeys if k in tab.keys()), None)
    if ra is None or dec is None:
        raise KeyError("Could not identify RA/dec columns in %s"
                       % tab.keys())
    return ra, dec


# -- I/O -------------------------------------------------------------------------
def writeCatalog(catalog, outFileName, constraintsList=None):
    """Write with version metadata (``catalogs.py:492-517``)."""
    if isinstance(catalog, list) and len(catalog) == 0:
        return None
    cut = selectFromCatalog(catalog, constraintsList or [])
    cut.meta["NEMOVER"] = __version__
    cut.write(outFileName, overwrite=True)


def catalog2DS9(catalog, outFileName, constraintsList=None, addInfo=None,
                idKeyToUse="name", RAKeyToUse="RADeg", decKeyToUse="decDeg",
                color="cyan", showNames=True, writeNemoInfo=True,
                coordSys="fk5", regionShape="point", width=1):
    """Write a DS9 region file (``catalogs.py:192-256``)."""
    cut = selectFromCatalog(catalog, constraintsList or [])
    addInfo = addInfo or []
    with open(outFileName, "w") as f:
        comment = "# DS9 region file"
        if writeNemoInfo:
            comment += " generated by nemo_tpu (version: %s on %s)" % (
                __version__, datetime.date.today().isoformat())
        f.write(comment + "\n")
        f.write('global dashlist=8 3 width=%d font="helvetica 10 normal" '
                "select=1 highlite=1 dash=0 fixed=0 edit=1 move=1 delete=1 "
                "include=1 source=1\n" % width)
        for obj in cut:
            info = ""
            for d in addInfo:
                if info:
                    info += " "
                info += d["fmt"] % obj[d["key"]]
            if info:
                info = " [" + info + "]"
            label = (str(obj[idKeyToUse]) if showNames else "") + info
            if regionShape == "point":
                f.write("%s;point(%.6f,%.6f) # point=cross color={%s} "
                        "text={%s}\n" % (coordSys, obj[RAKeyToUse],
                                         obj[decKeyToUse], color, label))
            else:
                f.write('%s;circle(%.6f,%.6f,360") # color={%s} text={%s}\n'
                        % (coordSys, obj[RAKeyToUse], obj[decKeyToUse],
                           color, label))


# -- merging / duplicates ----------------------------------------------------------
def makeOptimalCatalog(catalogDict, constraintsList=None):
    """Keep the highest-SNR detection of each object across all filtered
    maps (``catalogs.py:149-189``)."""
    allCatalogs = [catalogDict[k]["catalog"] for k in catalogDict
                   if len(catalogDict[k]["catalog"]) > 0]
    if len(allCatalogs) == 0:
        return Table({"SNR": np.array([]), "RADeg": np.array([]),
                      "decDeg": np.array([])})
    allCat = vstack(allCatalogs)
    ra = np.asarray(allCat["RADeg"], dtype=float)
    dec = np.asarray(allCat["decDeg"], dtype=float)
    snr = np.asarray(allCat["SNR"], dtype=float)
    v = _unit_vectors(ra, dec)
    tree = cKDTree(v)
    chord = 2 * np.sin(np.radians(XMATCH_RADIUS_DEG) / 2)
    groups = tree.query_ball_point(v, chord)
    toRemove = np.zeros(len(allCat), dtype=bool)
    for i, idxs in enumerate(groups):
        if len(idxs) > 1:
            idxs = np.array(idxs)
            best = idxs[np.argmax(snr[idxs])]
            toRemove[idxs[idxs != best]] = True
    merged = allCat[~toRemove]
    merged.sort(["RADeg", "decDeg"])
    return selectFromCatalog(merged, constraintsList or [])


def removeDuplicates(tab):
    """Remove duplicates across overlapping tiles, keeping the highest SNR
    (``catalogs.py:520-565``).

    Returns (table, numDuplicatesFound, names of duplicates)."""
    if len(tab) <= 1:
        return tab, len(tab) - 0 if len(tab) == 1 else 0, []
    ra = np.asarray(tab["RADeg"], dtype=float)
    dec = np.asarray(tab["decDeg"], dtype=float)
    idx, sep = nearestNeighbours(ra, dec, ra, dec, nthneighbor=2)
    dupMask = sep < XMATCH_RADIUS_DEG
    noDupTab = tab[~dupMask]
    dupTab = tab[dupMask]
    if dupMask.sum() == 0:
        return tab, 0, []
    dra = np.asarray(dupTab["RADeg"], dtype=float)
    ddec = np.asarray(dupTab["decDeg"], dtype=float)
    dsnr = np.asarray(dupTab["SNR"], dtype=float)
    keepMask = np.zeros(len(dupTab), dtype=bool)
    v = _unit_vectors(dra, ddec)
    tree = cKDTree(v)
    chord = 2 * np.sin(np.radians(XMATCH_RADIUS_DEG) / 2)
    for i in range(len(dupTab)):
        idxs = np.array(tree.query_ball_point(v[i], chord))
        best = idxs[dsnr[idxs] == dsnr[idxs].max()][0]
        keepMask[best] = True
    keepTab = vstack([dupTab[keepMask], noDupTab])
    keepTab.sort("RADeg")
    return keepTab, len(dupTab), list(dupTab["name"]) if "name" in dupTab else []


def flagTileBoundarySplits(tab, xMatchRadiusArcmin=2.5):
    """Flag potential deblends across tile borders (``catalogs.py:568-620``)."""
    tab["tileBoundarySplit"] = np.zeros(len(tab), dtype=bool)
    if len(tab) <= 1:
        return tab
    ra = np.asarray(tab["RADeg"], dtype=float)
    dec = np.asarray(tab["decDeg"], dtype=float)
    idx, sep = nearestNeighbours(ra, dec, ra, dec, nthneighbor=2)
    rDeg = xMatchRadiusArcmin / 60.0
    close = sep < rDeg
    tiles = np.asarray(tab["tileName"])
    split = close & (tiles[idx] != tiles)
    tab["tileBoundarySplit"] = split
    return tab


# -- cross matching ------------------------------------------------------------------
def crossMatch(refCatalog, matchCatalog, radiusArcmin=2.5):
    """Cross-match two catalogs (``catalogs.py:766-806``).

    Returns (refMatched, matched, separations in arcmin)."""
    raRef, decRef = getTableRADecKeys(refCatalog)
    raM, decM = getTableRADecKeys(matchCatalog)
    if len(refCatalog) == 0 or len(matchCatalog) == 0:
        return refCatalog[np.array([], dtype=int)], \
            matchCatalog[np.array([], dtype=int)], np.array([])
    idx, sep = nearestNeighbours(np.asarray(refCatalog[raRef], dtype=float),
                                 np.asarray(refCatalog[decRef], dtype=float),
                                 np.asarray(matchCatalog[raM], dtype=float),
                                 np.asarray(matchCatalog[decM], dtype=float))
    good = sep < radiusArcmin / 60.0
    return refCatalog[good], matchCatalog[idx[good]], sep[good] * 60.0


def removeCrossMatched(refCatalog, matchCatalog, radiusArcmin=2.5):
    """Remove objects in refCatalog matched by matchCatalog
    (``catalogs.py:809-824``)."""
    raRef, decRef = getTableRADecKeys(refCatalog)
    raM, decM = getTableRADecKeys(matchCatalog)
    idx, sep = nearestNeighbours(np.asarray(refCatalog[raRef], dtype=float),
                                 np.asarray(refCatalog[decRef], dtype=float),
                                 np.asarray(matchCatalog[raM], dtype=float),
                                 np.asarray(matchCatalog[decM], dtype=float))
    return refCatalog[sep >= radiusArcmin / 60.0]


def _posRecFitFunc(snr, snrFold, pedestal, norm):
    """Position-recovery model (``catalogs.py:96-103``)."""
    return norm * np.exp(-snr / snrFold) + pedestal


def checkCrossMatch(distArcmin, fixedSNR, z=None, addRMpc=0.5,
                    fitSNRFold=1.164, fitPedestal=0.685, fitNorm=38.097,
                    cosmo=None):
    """Model-based cross-match validity (``catalogs.py:106-146``)."""
    maxRadiusArcmin = _posRecFitFunc(fixedSNR, fitSNRFold, fitPedestal,
                                     fitNorm)
    addArcmin = 0.0
    if z is not None and z > 0:
        from .models import cosmology
        cosmo = cosmo or cosmology.fiducialCosmoModel()
        da = cosmo.angularDiameterDistance(z)
        addArcmin = np.degrees(addRMpc / da) * 60.0
    maxRadiusArcmin = np.sqrt(maxRadiusArcmin ** 2 + addArcmin ** 2)
    return distArcmin < maxRadiusArcmin


# -- geometry helpers -------------------------------------------------------------
def getCatalogWithinImage(tab, shape, wcs, mask=None):
    """Cut a catalog to objects inside a map (``catalogs.py:855-893``)."""
    if len(tab) == 0:
        return tab
    raKey, decKey = getTableRADecKeys(tab)
    coords = wcs.wcs2pix(np.asarray(tab[raKey], dtype=float),
                         np.asarray(tab[decKey], dtype=float))
    x = coords[:, 0]
    y = coords[:, 1]
    inImage = (x >= 0) & (x < shape[1]) & (y >= 0) & (y < shape[0])
    if mask is not None:
        xi = np.clip(np.round(x).astype(int), 0, shape[1] - 1)
        yi = np.clip(np.round(y).astype(int), 0, shape[0] - 1)
        inImage &= np.asarray(mask)[yi, xi] > 0
    return tab[inImage]


def addFootprintColumnToCatalog(tab, label, areaMask, wcs):
    """Add footprint_<label> bool column (``catalogs.py:895-922``)."""
    col = np.zeros(len(tab), dtype=bool)
    raKey, decKey = getTableRADecKeys(tab)
    coords = wcs.wcs2pix(np.asarray(tab[raKey], dtype=float),
                         np.asarray(tab[decKey], dtype=float))
    x = np.round(coords[:, 0]).astype(int)
    y = np.round(coords[:, 1]).astype(int)
    ok = (x >= 0) & (x < areaMask.shape[1]) & (y >= 0) & \
         (y < areaMask.shape[0])
    col[ok] = np.asarray(areaMask)[y[ok], x[ok]] > 0
    key = "footprint_%s" % label
    if key in tab.keys():
        tab[key] = np.asarray(tab[key]) | col
    else:
        tab[key] = col
    return tab


# -- random/test catalogs ------------------------------------------------------------
def generateRandomSourcesCatalog(mapData, wcs, numSources, seed=None,
                                 amplitudeRange=(100.0, 1000.0)):
    """Random point-source catalog within a map footprint
    (``catalogs.py:623-680``); amplitude distribution is a steep power law
    roughly like the 148 GHz source counts."""
    rng = np.random.default_rng(seed)
    ys, xs = np.where(np.asarray(mapData) != 0)
    pick = rng.integers(0, len(ys), numSources)
    coords = wcs.pix2wcs(xs[pick].astype(float), ys[pick].astype(float))
    # steep power-law amplitudes
    u = rng.uniform(0, 1, numSources)
    lo, hi = amplitudeRange
    amp = lo * (hi / lo) ** (u ** 3)
    tab = Table({
        "name": np.array(["fake_%d" % (i + 1) for i in range(numSources)]),
        "RADeg": coords[:, 0], "decDeg": coords[:, 1],
        "deltaT_c": amp,
    })
    return tab


def generateTestCatalog(config, numSourcesPerTile, amplitudeColumnName="y_c",
                        amplitudeRange=(0.001, 10), amplitudeDistribution="linear",
                        selFn=None, avoidanceRadiusArcmin=5.0,
                        maskDilationPix=0, label="testCatalog", tileNames=None,
                        seed=None):
    """Random positions within the survey mask with a minimum separation
    and random amplitudes, for source-injection tests
    (``catalogs.py:683-763``)."""
    rng = np.random.default_rng(seed)
    from . import completeness
    from scipy import ndimage
    rows = []
    lo, hi = amplitudeRange
    for tileName in (tileNames or config.tileNames):
        areaMask, wcs = completeness.loadAreaMask(tileName, config.selFnDir)
        areaMask = np.asarray(areaMask) > 0
        if maskDilationPix > 0:
            # shrink the valid area so objects aren't painted at mask edges
            areaMask = ndimage.binary_erosion(areaMask,
                                              iterations=maskDilationPix)
        ys, xs = np.where(areaMask)
        if len(ys) == 0:
            continue
        got = 0
        chosen_ra = []
        chosen_dec = []
        attempts = 0
        while got < numSourcesPerTile and \
                attempts < numSourcesPerTile * 100:
            attempts += 1
            i = rng.integers(0, len(ys))
            ra, dec = wcs.pix2wcs(float(xs[i]), float(ys[i]))
            if chosen_ra:
                seps = calcAngSepDeg(ra, dec, np.array(chosen_ra),
                                     np.array(chosen_dec))
                if np.min(seps) < avoidanceRadiusArcmin / 60.0:
                    continue
            chosen_ra.append(ra)
            chosen_dec.append(dec)
            got += 1
            if amplitudeDistribution == "linear":
                amp = rng.uniform(lo, hi)
            elif amplitudeDistribution == "log":
                amp = 10 ** rng.uniform(np.log10(lo), np.log10(hi))
            else:
                raise ValueError("amplitudeDistribution must be 'linear' "
                                 "or 'log'")
            rows.append({"name": "%s_%s_%d" % (label, tileName, got),
                         "RADeg": ra, "decDeg": dec, "tileName": tileName,
                         amplitudeColumnName: amp})
    if not rows:
        return Table()
    return catalogListToTab(rows, keysToWrite=["name", "RADeg", "decDeg",
                                               "tileName",
                                               amplitudeColumnName])
