"""Host-side utilities: FITS I/O, WCS, tables, config parsing, logging."""

from . import fits, tables, wcs  # noqa: F401
from .tables import Table, vstack  # noqa: F401
from .wcs import WCS, calcAngSepDeg  # noqa: F401
