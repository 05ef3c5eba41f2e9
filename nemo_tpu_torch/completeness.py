"""Survey selection function and completeness: the tile loaders.

Port of the part of ``nemo_tpu/completeness.py`` that the filter and
catalog stage needs (the area-mask loader the stitched maps read).  The
selection function itself (SelFn, RMS tables, Q, masses) is ROADMAP.md
queue 1, item 9.
"""

import os

import numpy as np

from .utils import fits as nfits
from .utils.wcs import WCS


# -----------------------------------------------------------------------------
def _loadTile(tileName, baseDir, baseFileName, extension="fits"):
    """Load a tile image from MEF-or-per-tile-file layouts
    (``completeness.py:797-828``)."""
    cand1 = os.path.join(baseDir, "%s#%s.%s" % (baseFileName, tileName,
                                                extension))
    cand2 = os.path.join(baseDir, tileName,
                         "%s#%s.%s" % (baseFileName, tileName, extension))
    cand3 = os.path.join(baseDir, "%s.%s" % (baseFileName, extension))
    for fileName in (cand1, cand2, cand3):
        if os.path.exists(fileName):
            break
    else:
        raise FileNotFoundError("No %s found for tile %s under %s"
                                % (baseFileName, tileName, baseDir))
    # Prefer the extension named after the tile; else first with data.
    # read_image seeks to (and decodes) only the wanted extension - a
    # fused survey MEF holds one extension per tile, and loading them
    # all per call made the per-tile loaders O(N^2) across a run.
    try:
        data, header = nfits.read_image(fileName, ext=tileName)
    except nfits.ExtensionNotFound:
        # per-tile files carry no EXTNAME: take the first image HDU.
        # (Only this exact miss falls through - a KeyError raised while
        # DECODING a malformed tile-named extension must propagate, not
        # silently return the wrong tile's data.)
        data, header = nfits.read_image(fileName)
    return np.asarray(data), WCS(header)


def loadAreaMask(tileName, selFnDir):
    return _loadTile(tileName, selFnDir, "areaMask")
