"""Beam profiles (instrument PSF) and their harmonic transforms.

Native replacement for ``nemo/signals.py:82-137`` (BeamProfile): reads
ACT-format text files that contain either a real-space profile
(theta_deg, response) or a harmonic transform (ell, B_ell), and converts
between the two with the flat-sky FFTLog Hankel transform (the reference
uses curved-sky Legendre transforms via pixell; the difference is O(theta^2)
~ 1e-5 for arcminute beams).
"""

import numpy as np

from ..ops.hankel import RadialFourierTransform


class BeamProfile:
    """Beam described by a real-space radial profile and harmonic B_ell.

    Attributes:
        profile1d: response, unit peak, from the centre outwards.
        rDeg: angular radius in degrees for profile1d.
        ell, Bell: harmonic-space transform (unit normalised at ell -> 0).
        FWHMArcmin: estimated full width at half maximum.
        solidAngle_nsr: beam solid angle in nanosteradians if the input file
            declares one in a comment line ('... solid angle = X nsr'),
            else 0 (used for Jy flux conversions, ``nemo/filters.py:173-192``).
    """

    def __init__(self, beamFileName=None, profile1d=None, rDeg=None):
        self.solidAngle_nsr = 0.0
        if beamFileName is not None:
            self.solidAngle_nsr = _parse_solid_angle(beamFileName)
            beamData = np.loadtxt(beamFileName).transpose()
            if beamData[0][1] - beamData[0][0] >= 1:
                # (ell, B_ell) transform file
                self.ell = beamData[0]
                self.Bell = beamData[1]
                self.rDeg = np.linspace(0.0, 0.5, 1800)
                prof = _harm_to_profile(self.ell, self.Bell, self.rDeg)
                self.profile1d = prof / prof[0]
            else:
                # (theta_deg, response) profile file
                self.rDeg = beamData[0]
                self.profile1d = beamData[1]
                self.ell, self.Bell = _profile_to_harm(self.rDeg,
                                                       self.profile1d)
        else:
            self.profile1d = np.asarray(profile1d)
            self.rDeg = np.asarray(rDeg)
            self.ell, self.Bell = _profile_to_harm(self.rDeg, self.profile1d)

        self.FWHMArcmin = self.rDeg[
            np.argmin(np.abs(self.profile1d - 0.5))] * 60 * 2


def _profile_to_harm(rDeg, profile1d, lmax=50000):
    """B(l) of a radial real-space profile, unit-normalised at l=0."""
    rft = RadialFourierTransform()
    fr = np.interp(rft.r, np.radians(rDeg), profile1d, left=profile1d[0],
                   right=0.0)
    Fl = rft.real2harm(fr)
    l, Fl = rft.unpad(rft.l, Fl)
    ell = np.arange(0, lmax + 1, dtype=float)
    Bell = np.interp(ell, l, Fl)
    Bell = Bell / Bell[0]
    return ell, Bell


def _harm_to_profile(ell, Bell, rDeg):
    """Real-space radial profile of a harmonic transform B_ell."""
    rft = RadialFourierTransform()
    # Zero beyond the tabulated ell range: end-clamping (as np.interp does
    # by default) would extend a constant plateau to l ~ 1e7 on our log
    # grid and alias into a spike at r = 0.
    Fl = np.interp(rft.l, ell, Bell, right=0.0)
    fr = rft.harm2real(Fl)
    r, fr = rft.unpad(rft.r, fr)
    return np.interp(np.radians(rDeg), r, fr)


def _parse_solid_angle(beamFileName):
    """Extract 'solid angle = X nsr' from header comments
    (``nemo/filters.py:179-191``)."""
    try:
        with open(beamFileName) as f:
            for line in f:
                if "solid angle" in line:
                    return float(line.split("=")[1].split()[0])
    except Exception:
        pass
    return 0.0


def makeGaussianBeamFile(path, FWHMArcmin, solidAngle_nsr=None,
                         maxRDeg=0.5, npts=1800):
    """Write a synthetic Gaussian beam profile in ACT text format.

    Used by tests and simulations; the real pipeline reads measured beams.
    """
    sigmaDeg = (FWHMArcmin / 60.0) / (2 * np.sqrt(2 * np.log(2)))
    r = np.linspace(0, maxRDeg, npts)
    prof = np.exp(-r ** 2 / (2 * sigmaDeg ** 2))
    if solidAngle_nsr is None:
        solidAngle_nsr = 2 * np.pi * np.radians(sigmaDeg) ** 2 * 1e9
    with open(path, "w") as f:
        f.write("# Gaussian beam, FWHM = %.3f arcmin, solid angle = %.1f nsr\n"
                % (FWHMArcmin, solidAngle_nsr))
        for ri, pi in zip(r, prof):
            f.write("%.8e %.8e\n" % (ri, pi))
    return path
