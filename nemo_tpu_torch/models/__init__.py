"""Signal models: beams, GNFW profiles, SZ spectra, cosmology, templates."""

from . import beams, cosmology, gnfw, profiles, sz  # noqa: F401
