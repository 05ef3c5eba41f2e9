"""The signal model a filter bank is built from, frozen for the benchmark.

A cluster template is fixed by its configuration alone: the Arnaud et al.
(2010) GNFW pressure profile integrated along the line of sight, scaled to
theta500 by the fiducial flat LCDM cosmology, convolved with the band's
beam in harmonic space, and the non-relativistic SZ spectrum.  These are
definitions, not the work under test, so they are copied here as the
nemo model defines them (host numpy, float64), and later changes to the
program cannot move them.  Nothing here imports the program.
"""

import numpy as np
from scipy.special import loggamma

# Arnaud et al. (2010) universal pressure profile
A10 = {"P0": 8.403, "c500": 1.177, "gamma": 0.3081, "alpha": 1.0510,
       "beta": 5.4905}

# fiducial cosmology: H0 70, Om0 0.3, photons at TCMB0 and 3.044
# massless neutrinos
C_KM_S = 299792.458
G_MSUN = 4.301e-9
TCMB0 = 2.7255
NEFF = 3.044

# SZ spectrum constants
TCMB = 2.72548
H_PLANCK = 6.62607015e-34
K_B = 1.380649e-23


def fSZ(freqGHz):
    """Non-relativistic SZ spectral shape x coth(x/2) - 4."""
    x = (H_PLANCK * np.asarray(freqGHz) * 1e9) / (K_B * TCMB)
    return x * ((np.exp(x) + 1) / (np.exp(x) - 1)) - 4.0


def y_to_uK(y, freqGHz):
    """Compton y -> CMB temperature decrement in uK at ``freqGHz``."""
    return y * fSZ(freqGHz) * (TCMB * 1e6)


def theta500_arcmin(z, M500, H0=70.0, Om0=0.3, zmax=12.0, ngrid=4096):
    """Angular radius of R500c (arcmin): R500 from 500 times the critical
    density at z, over the angular diameter distance (trapezoid rule for
    the comoving distance on a 4096-point z grid)."""
    h = H0 / 100.0
    og = 2.47282e-5 * (TCMB0 / 2.7255) ** 4 / h ** 2
    orad = og + og * (7.0 / 8.0) * (4.0 / 11.0) ** (4.0 / 3.0) * NEFF
    ol = 1.0 - Om0 - orad

    def Ez(zz):
        return np.sqrt(Om0 * (1 + zz) ** 3 + orad * (1 + zz) ** 4 + ol)

    zg = np.linspace(0.0, zmax, ngrid)
    einv = 1.0 / Ez(zg)
    chi = np.concatenate([[0.0], np.cumsum((einv[1:] + einv[:-1]) / 2
                                           * np.diff(zg))])
    DA = np.interp(z, zg, (C_KM_S / H0) * chi) / (1 + z)
    rhoCrit = 3 * H0 ** 2 / (8 * np.pi * G_MSUN) * Ez(z) ** 2
    R500 = (3 * M500 / (4 * np.pi * 500 * rhoCrit)) ** (1.0 / 3.0)
    return np.degrees(np.arctan(R500 / DA)) * 60.0


def gnfw_cylindrical(params=A10, bmin=1e-6, bmax=100.0, npts=300,
                     tol=1e-6, tmax=30.0, nt=1024):
    """Unit-peak line-of-sight integral of the GNFW profile on a log grid
    of b = r / R500, cut where successive values change by < ``tol``
    (y(b) = b * integral P(b cosh t) cosh t dt, trapezoid in t)."""
    G, A, B = params["gamma"], params["alpha"], params["beta"]
    c500, P0 = params["c500"], params["P0"]
    b = np.logspace(np.log10(bmin), np.log10(bmax), npts)
    t = np.linspace(0.0, tmax, nt)
    cosh = np.cosh(t)
    cx = b[:, None] * cosh[None, :] * c500
    prof = P0 * cx ** -G * (1 + cx ** A) ** ((G - B) / A)
    y = b * np.trapezoid(prof * cosh[None, :], t, axis=1)
    idx = np.where(np.abs(np.diff(y)) < tol)[0]
    if len(idx) > 0 and idx[0] > 0:
        b, y = b[:idx[0] + 1], y[:idx[0] + 1]
    return b, y / y.max()


class Hankel:
    """Order-0 Hankel transform pair by FFTLog on reciprocal log grids
    (r in radians, l = 1 / r reversed), 1024 points padded by 256."""

    def __init__(self, rrange=(1e-7, 10.0), n=1024, pad=256):
        self.pad = pad
        self.n = n + 2 * pad
        lo, hi = np.log(rrange[0]), np.log(rrange[1])
        self.dlog = (hi - lo) / (n - 1)
        self.r = np.exp(lo + (np.arange(self.n) - pad) * self.dlog)
        self.l = 1.0 / self.r[::-1]

    def _transform(self, f, x, k):
        eta = np.fft.fftfreq(self.n) * (2 * np.pi / self.dlog)
        A = np.fft.fft(f * x) / self.n * np.exp(-1j * eta * np.log(x[0]))
        M = np.exp(1j * eta * np.log(2.0) + loggamma((1 + 1j * eta) / 2)
                   - loggamma((1 - 1j * eta) / 2))
        vals = np.fft.fft(A * M * np.exp(-1j * eta * np.log(k[0])))
        return np.real(vals) / k

    def real2harm(self, f):
        return 2 * np.pi * self._transform(np.asarray(f, float), self.r,
                                           self.l)

    def harm2real(self, F):
        return self._transform(np.asarray(F, float), self.l, self.r) \
            / (2 * np.pi)

    def unpad(self, a):
        return a[self.pad:self.n - self.pad]


def beam_bell(rDeg, profile, lmax=50000):
    """(ell, B_ell) of a radial beam profile, unit at ell = 0."""
    h = Hankel()
    fr = np.interp(h.r, np.radians(rDeg), profile, left=profile[0],
                   right=0.0)
    F = h.real2harm(fr)
    ell = np.arange(0, lmax + 1, dtype=float)
    bell = np.interp(ell, h.unpad(h.l), h.unpad(F))
    return ell, bell / bell[0]


def read_beam(path):
    """(rDeg, profile) columns of a beam profile text file."""
    d = np.loadtxt(path).T
    return d[0], d[1]


def template_table(M500, z, beamPath, amplitude=None):
    """Radial table ``(r_rad, v, scale)`` of a beam-convolved A10 cluster
    template: the painted template is ``scale * interp(r, r_rad, v)``.
    ``amplitude`` scales the unconvolved unit peak (the table is then
    normalised to its own peak and the peak carried in ``scale``)."""
    b, prof = gnfw_cylindrical()
    rDeg = b * theta500_arcmin(z, M500) / 60.0
    h = Hankel()
    rprof = np.interp(h.r, np.radians(rDeg), prof, left=prof[0], right=0.0)
    ell, bell = beam_bell(*read_beam(beamPath))
    lbeam = np.interp(h.l, ell, bell, right=0.0)
    conv = h.harm2real(h.real2harm(rprof) * lbeam)
    r, conv = h.unpad(h.r), h.unpad(conv)
    scale = 1.0
    if amplitude is not None:
        scale = conv[0] * amplitude
        conv = conv / conv[0]
    sign = -1.0 if conv[0] < 0 else 1.0
    return r, np.abs(conv), sign * scale


def gaussian_beam_profile(fwhmArcmin, maxRDeg=0.5, npts=1800):
    """(rDeg, profile) of a Gaussian beam."""
    sigma = (fwhmArcmin / 60.0) / (2 * np.sqrt(2 * np.log(2)))
    r = np.linspace(0, maxRDeg, npts)
    return r, np.exp(-r ** 2 / (2 * sigma ** 2))
