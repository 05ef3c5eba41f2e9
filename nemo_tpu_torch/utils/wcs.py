"""Native World Coordinate System support (CAR and TAN projections).

The reference package uses astLib.astWCS + astropy.wcs for all sky<->pixel
transforms (e.g. ``nemo/maps.py:83-172`` tile loading, ``nemo/filters.py:214``
radians maps).  ACT/SO maps are CAR (plate carree) with CRVAL2 = 0 and
optionally TAN for reprojected tiles, so we implement exactly those two
projections natively, vectorised with numpy on the host.

Pixel convention: all public methods take/return **0-based** pixel coords
(numpy convention), matching astWCS's behaviour that the reference relies on.
"""

import numpy as np

from . import fits as nfits


def calcAngSepDeg(ra0, dec0, ra1, dec1):
    """Great-circle separation in degrees (vectorised haversine).

    Mirrors astLib.astCoords.calcAngSepDeg as used throughout the reference
    (e.g. ``nemo/catalogs.py:173``, ``nemo/photometry.py:507``).
    """
    ra0 = np.radians(np.asarray(ra0, dtype=np.float64))
    dec0 = np.radians(np.asarray(dec0, dtype=np.float64))
    ra1 = np.radians(np.asarray(ra1, dtype=np.float64))
    dec1 = np.radians(np.asarray(dec1, dtype=np.float64))
    dra = ra1 - ra0
    ddec = dec1 - dec0
    a = np.sin(ddec / 2) ** 2 + np.cos(dec0) * np.cos(dec1) * np.sin(dra / 2) ** 2
    a = np.clip(a, 0.0, 1.0)
    return np.degrees(2 * np.arcsin(np.sqrt(a)))


def shiftRADec(ra0, dec0, deltaRA, deltaDec):
    """Shift a position by angular offsets (degrees), like astCoords.shiftRADec."""
    dec1 = dec0 + deltaDec
    ra1 = ra0 + deltaRA / np.cos(np.radians(dec1))
    return ra1, dec1


class WCS:
    """A minimal FITS WCS for CAR (CRVAL2 = 0) and TAN projections.

    Args:
        header: a dict-like FITS header containing NAXIS1/2, CTYPE1/2,
            CRVAL1/2, CRPIX1/2 and CDELT1/2 (or CD matrix).
    """

    def __init__(self, header):
        self.header = nfits.Header()
        for k, v in dict(header).items():
            self.header[k] = v
        h = self.header
        self.ctype1 = str(h.get("CTYPE1", "RA---CAR")).strip()
        self.ctype2 = str(h.get("CTYPE2", "DEC--CAR")).strip()
        self.projection = self.ctype1[-3:]
        if self.projection not in ("CAR", "TAN"):
            raise ValueError("Unsupported projection %r (CAR/TAN only)"
                             % self.projection)
        self.crval1 = float(h.get("CRVAL1", 0.0))
        self.crval2 = float(h.get("CRVAL2", 0.0))
        self.crpix1 = float(h.get("CRPIX1", 1.0))
        self.crpix2 = float(h.get("CRPIX2", 1.0))
        if "CD1_1" in h:
            self.cdelt1 = float(h["CD1_1"])
            self.cdelt2 = float(h["CD2_2"])
        else:
            self.cdelt1 = float(h["CDELT1"])
            self.cdelt2 = float(h["CDELT2"])
            # Diagonal PC matrix folds into the pixel scales.  (The
            # reference ZAPS PC keys entirely, astWCS zapKeywords at
            # nemo/maps.py callers via startUp.py:313 - i.e. silently
            # assumes identity; honouring a diagonal PC is strictly
            # more correct and identical for standard ACT/SO maps.)
            if "PC1_1" in h:
                self.cdelt1 *= float(h["PC1_1"])
                self.cdelt2 *= float(h.get("PC2_2", 1.0))
                if float(h.get("PC1_2", 0.0)) != 0.0 \
                        or float(h.get("PC2_1", 0.0)) != 0.0:
                    import warnings
                    warnings.warn("Off-diagonal PC matrix ignored "
                                  "(rotated WCS unsupported)")
        self.naxis1 = int(h.get("NAXIS1", 0))
        self.naxis2 = int(h.get("NAXIS2", 0))
        if self.projection == "CAR" and abs(self.crval2) > 1e-9:
            raise ValueError("CAR WCS requires CRVAL2 = 0 (ACT/SO standard)")

    # ------------------------------------------------------------------
    def copy(self):
        return WCS(self.header)

    def updateFromHeader(self):
        self.__init__(self.header)

    # ------------------------------------------------------------------
    def pix2wcs(self, x, y):
        """0-based pixel coords -> (RA, dec) in decimal degrees.

        Accepts scalars or arrays; returns matching scalars/arrays.
        For list inputs, returns an array of shape (n, 2) to mirror the
        astWCS behaviour the reference relies on.
        """
        x_in, y_in = x, y
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        ix = (x + 1.0 - self.crpix1) * self.cdelt1  # deg in intermediate frame
        iy = (y + 1.0 - self.crpix2) * self.cdelt2
        if self.projection == "CAR":
            ra = self.crval1 + ix
            dec = iy
        else:  # TAN (gnomonic) with full spherical rotation
            rx = np.radians(ix)
            ry = np.radians(iy)
            rho = np.sqrt(rx ** 2 + ry ** 2)
            c = np.arctan(rho)
            dec0 = np.radians(self.crval2)
            with np.errstate(invalid="ignore", divide="ignore"):
                sinc = np.sin(c)
                cosc = np.cos(c)
                dec = np.where(
                    rho == 0, dec0,
                    np.arcsin(cosc * np.sin(dec0)
                              + np.where(rho == 0, 0, ry * sinc * np.cos(dec0)
                                         / np.where(rho == 0, 1, rho))))
                ra = np.radians(self.crval1) + np.arctan2(
                    rx * sinc,
                    rho * np.cos(dec0) * cosc - ry * np.sin(dec0) * sinc)
            ra = np.degrees(ra)
            dec = np.degrees(dec)
        ra = np.mod(ra, 360.0)
        if np.isscalar(x_in) and np.isscalar(y_in):
            return float(ra), float(dec)
        if isinstance(x_in, (list, np.ndarray)) and np.ndim(x_in) >= 1:
            return np.stack([np.atleast_1d(ra), np.atleast_1d(dec)], axis=-1)
        return ra, dec

    def wcs2pix(self, ra, dec):
        """(RA, dec) degrees -> 0-based pixel coords (x, y)."""
        ra_in = ra
        ra = np.asarray(ra, dtype=np.float64)
        dec = np.asarray(dec, dtype=np.float64)
        if self.projection == "CAR":
            dra = ra - self.crval1
            # wrap into [-180, 180) around the reference value
            dra = (dra + 180.0) % 360.0 - 180.0
            ix = dra
            iy = dec
        else:
            ra_r = np.radians(ra)
            dec_r = np.radians(dec)
            ra0 = np.radians(self.crval1)
            dec0 = np.radians(self.crval2)
            cosc = (np.sin(dec0) * np.sin(dec_r)
                    + np.cos(dec0) * np.cos(dec_r) * np.cos(ra_r - ra0))
            with np.errstate(divide="ignore", invalid="ignore"):
                ix = np.degrees(np.cos(dec_r) * np.sin(ra_r - ra0) / cosc)
                iy = np.degrees((np.cos(dec0) * np.sin(dec_r)
                                 - np.sin(dec0) * np.cos(dec_r)
                                 * np.cos(ra_r - ra0)) / cosc)
        x = ix / self.cdelt1 + self.crpix1 - 1.0
        y = iy / self.cdelt2 + self.crpix2 - 1.0
        if np.isscalar(ra_in) and np.ndim(x) == 0:
            return float(x), float(y)
        if isinstance(ra_in, (list, np.ndarray)) and np.ndim(ra_in) >= 1:
            return np.stack([np.atleast_1d(x), np.atleast_1d(y)], axis=-1)
        return x, y

    # ------------------------------------------------------------------
    def getPixelSizeDeg(self):
        return float(abs(self.cdelt2))

    def getXPixelSizeDeg(self):
        return float(abs(self.cdelt1))

    def getYPixelSizeDeg(self):
        return float(abs(self.cdelt2))

    def getCentreWCSCoords(self):
        return self.pix2wcs(self.naxis1 / 2.0, self.naxis2 / 2.0)

    def getFullSizeSkyDeg(self):
        """(width, height) of image on sky in degrees (at the equator for CAR)."""
        return (abs(self.cdelt1) * self.naxis1, abs(self.cdelt2) * self.naxis2)

    def getImageMinMaxWCSCoords(self):
        """[RAMin, RAMax, decMin, decMax] of the image corners."""
        corners_x = [0, self.naxis1 - 1]
        corners_y = [0, self.naxis2 - 1]
        ras, decs = [], []
        for cx in corners_x:
            for cy in corners_y:
                r, d = self.pix2wcs(cx, cy)
                ras.append(r)
                decs.append(d)
        # RA decreases with x for standard maps; handle simple (non-wrapped) case
        return [min(ras), max(ras), min(decs), max(decs)]

    def coordsAreInImage(self, ra, dec):
        x, y = self.wcs2pix(ra, dec)
        return (0 <= x < self.naxis1) and (0 <= y < self.naxis2)


def clipUsingPixelCoords(data, wcs, xMin, xMax, yMin, yMax):
    """Clip a pixel box [yMin:yMax, xMin:xMax]; returns dict with clipped
    data, new WCS and the clipped section (like astImages)."""
    xMin = int(max(0, xMin))
    yMin = int(max(0, yMin))
    xMax = int(min(data.shape[-1], xMax))
    yMax = int(min(data.shape[-2], yMax))
    clipped = data[..., yMin:yMax, xMin:xMax]
    header = wcs.header.copy()
    header["NAXIS1"] = xMax - xMin
    header["NAXIS2"] = yMax - yMin
    header["CRPIX1"] = wcs.crpix1 - xMin
    header["CRPIX2"] = wcs.crpix2 - yMin
    newWCS = WCS(header)
    return {"data": clipped, "wcs": newWCS,
            "clippedSection": [xMin, xMax, yMin, yMax]}


def clipUsingRADecCoords(data, wcs, RAMin, RAMax, decMin, decMax):
    """Clip a map to the given RA, dec range (mirrors
    astImages.clipUsingRADecCoords used at ``nemo/maps.py:277`` and
    ``nemo/startUp.py:566``)."""
    x0, y0 = wcs.wcs2pix(RAMin, decMin)
    x1, y1 = wcs.wcs2pix(RAMax, decMax)
    xMin = int(round(min(x0, x1)))
    xMax = int(round(max(x0, x1)))
    yMin = int(round(min(y0, y1)))
    yMax = int(round(max(y0, y1)))
    return clipUsingPixelCoords(data, wcs, xMin, xMax, yMin, yMax)


def makeWCS(shape, pixScaleDeg, centreRADeg=0.0, centreDecDeg=0.0,
            projection="CAR"):
    """Construct a WCS for a new map of the given shape/(y, x) pixel scale."""
    ny, nx = shape
    header = nfits.Header()
    header["NAXIS1"] = nx
    header["NAXIS2"] = ny
    header["CTYPE1"] = "RA---" + projection
    header["CTYPE2"] = "DEC--" + projection
    header["CUNIT1"] = "deg"
    header["CUNIT2"] = "deg"
    header["CDELT1"] = -abs(pixScaleDeg)
    header["CDELT2"] = abs(pixScaleDeg)
    if projection == "CAR":
        # Reference pixel pinned to dec = 0 (CAR requirement)
        header["CRVAL1"] = centreRADeg
        header["CRVAL2"] = 0.0
        header["CRPIX1"] = nx / 2.0 + 0.5
        header["CRPIX2"] = ny / 2.0 + 0.5 - centreDecDeg / abs(pixScaleDeg)
    else:
        header["CRVAL1"] = centreRADeg
        header["CRVAL2"] = centreDecDeg
        header["CRPIX1"] = nx / 2.0 + 0.5
        header["CRPIX2"] = ny / 2.0 + 0.5
    return WCS(header)


def loadWCSFromHeaderText(path):
    """Build a WCS from a text dump of a FITS header (one card per line).

    This replicates the reference test harness trick of generating synthetic
    survey masks from stored header text (``tests/lib/NemoTests.py:135-142``).
    """
    header = nfits.Header()
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip() or line.strip() == "END":
                continue
            if "=" not in line:
                continue
            key = line.split("=")[0].strip()
            val = line.split("=", 1)[1]
            if "/" in val and not val.strip().startswith("'"):
                val = val.split("/")[0]
            header[key] = nfits._parse_value(val)
    return WCS(header)


def makeTanWCS(wcs, pixScale=0.5 / 60.0):
    """TAN WCS covering the same sky footprint as the given (CAR) WCS
    (parity with ``nemo/maps.py:608-640``)."""
    RADeg, decDeg = wcs.getCentreWCSCoords()
    xSizeDeg, ySizeDeg = wcs.getFullSizeSkyDeg()
    xSizePix = int(xSizeDeg / pixScale)
    ySizePix = int(ySizeDeg / pixScale)
    header = nfits.Header()
    header["NAXIS1"] = xSizePix
    header["NAXIS2"] = ySizePix
    header["CTYPE1"] = "RA---TAN"
    header["CTYPE2"] = "DEC--TAN"
    header["CRVAL1"] = RADeg
    header["CRVAL2"] = decDeg
    header["CRPIX1"] = xSizePix / 2.0 + 1
    header["CRPIX2"] = ySizePix / 2.0 + 1
    header["CDELT1"] = -(xSizeDeg / xSizePix)
    header["CDELT2"] = xSizeDeg / xSizePix
    header["CUNIT1"] = "DEG"
    header["CUNIT2"] = "DEG"
    return WCS(header)


def reprojectImage(data, inWCS, outWCS, outShape=None, order=3):
    """Resample a map from one WCS onto another via spline interpolation
    (replaces the reference's ``reproject.reproject_interp`` usage at
    ``nemo/maps.py:161``). order=0 for masks, 3 (bicubic) for maps.

    Returns (outData, footprint) where footprint marks pixels that mapped
    inside the input image.
    """
    from scipy import ndimage as snd
    if outShape is None:
        outShape = (outWCS.naxis2, outWCS.naxis1)
    yy, xx = np.mgrid[0:outShape[0], 0:outShape[1]]
    coords = outWCS.pix2wcs(xx.ravel().astype(float),
                            yy.ravel().astype(float))
    pix = inWCS.wcs2pix(coords[:, 0], coords[:, 1])
    xin = pix[:, 0].reshape(outShape)
    yin = pix[:, 1].reshape(outShape)
    footprint = ((xin >= 0) & (xin <= data.shape[1] - 1)
                 & (yin >= 0) & (yin <= data.shape[0] - 1))
    out = snd.map_coordinates(np.asarray(data, dtype=float),
                              [yin, xin], order=order, mode="constant",
                              cval=0.0)
    out[~footprint] = 0
    return out, footprint
