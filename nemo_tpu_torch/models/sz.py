"""Sunyaev-Zel'dovich spectral functions and unit conversions.

Native equivalents of ``nemo/signals.py:350-375`` (fSZ),
``signals.py:1132-1204`` (relativistic corrections, Itoh et al. 1998),
``nemo/maps.py:652-688`` (y <-> delta-T) and
``nemo/photometry.py:460-493`` (delta-T <-> Jy/sr).
All functions are plain array math (numpy or jax.numpy alike).
"""

import numpy as np

TCMB = 2.72548  # K, as signals.py:51

# SI constants
H_PLANCK = 6.62607015e-34
K_B = 1.380649e-23
C_LIGHT = 2.99792458e8
M_E = 9.1093837015e-31
E_CHARGE = 1.602176634e-19


def fSZ(obsFrequencyGHz, TCMBAlpha=0.0, z=None):
    """Non-relativistic SZ spectral shape f(x) = x coth(x/2) - 4."""
    x = (H_PLANCK * np.asarray(obsFrequencyGHz) * 1e9) / (K_B * TCMB)
    if TCMBAlpha != 0 and z is not None:
        x = x * np.power(1 + z, TCMBAlpha)
    return x * ((np.exp(x) + 1) / (np.exp(x) - 1)) - 4.0


def convertToY(mapData, obsFrequencyGHz=148.0):
    """delta-T (uK CMB) -> Compton y at the given frequency."""
    return (mapData / (TCMB * 1e6)) / fSZ(obsFrequencyGHz)


def convertToDeltaT(mapData, obsFrequencyGHz=148.0, TCMBAlpha=0.0, z=None):
    """Compton y -> delta-T (uK CMB) at the given frequency."""
    return mapData * fSZ(obsFrequencyGHz, TCMBAlpha=TCMBAlpha, z=z) * (TCMB * 1e6)


def _planck_conversion(obsFreqGHz):
    """dB/dT-style conversion factor used for delta-T <-> Jy/sr."""
    nu = obsFreqGHz * 1e9
    x = H_PLANCK * nu / (K_B * TCMB)
    # 2 (kB T)^3 / (h c)^2 * x^4 e^x / (e^x - 1)^2, in Jy/sr per K:
    cNu = 2 * (K_B * TCMB) ** 3 / (H_PLANCK ** 2 * C_LIGHT ** 2) \
        * x ** 4 / (4 * np.sinh(x / 2.0) ** 2)
    return cNu * 1e26  # SI W/m^2/Hz/sr -> Jy/sr


def deltaTToJyPerSr(deltaT_uK, obsFreqGHz):
    """delta-T (uK) -> Jy/sr (photometry.py:460-474)."""
    return deltaT_uK * 1e-6 / TCMB * _planck_conversion(obsFreqGHz)


def JyPerSrToDeltaT(JySr, obsFreqGHz):
    """Jy/sr -> delta-T (uK) (photometry.py:477-493)."""
    return JySr * TCMB * 1e6 / _planck_conversion(obsFreqGHz)


# -- relativistic SZ corrections (Itoh et al. 1998) ---------------------------
# Y_n are polynomials in Xt = x coth(x/2) with coefficients multiplying
# powers of St^2 = (x / sinh(x/2))^2; tables below list, for each Y_n, the
# coefficient rows [St^0, St^2, St^4, ...], each row being ascending powers
# of Xt.  Transcribed from Itoh, Kohyama & Nozawa (1998), eqs. 2.26-2.30.
_Y_TABLES = [
    # Y0
    [[-4.0, 1.0]],
    # Y1
    [[-10.0, 47.0 / 2, -42.0 / 5, 7.0 / 10],
     [-21.0 / 5, 7.0 / 5]],
    # Y2
    [[-15.0 / 2, 1023.0 / 8, -868.0 / 5, 329.0 / 5, -44.0 / 5, 11.0 / 30],
     [-434.0 / 5, 658.0 / 5, -242.0 / 5, 143.0 / 30],
     [-44.0 / 5, 187.0 / 60]],
    # Y3
    [[15.0 / 2, 2505.0 / 8, -7098.0 / 5, 14253.0 / 10, -18594.0 / 35,
      12059.0 / 140, -128.0 / 21, 16.0 / 105],
     [-7098.0 / 10, 14253.0 / 5, -102267.0 / 35, 156767.0 / 140,
      -1216.0 / 7, 64.0 / 7],
     [-18594.0 / 35, 205003.0 / 280, -1920.0 / 7, 1024.0 / 35],
     [-544.0 / 21, 992.0 / 105]],
    # Y4
    [[-135.0 / 32, 30375.0 / 128, -62391.0 / 10, 614727.0 / 40,
      -124389.0 / 10, 355703.0 / 80, -16568.0 / 21, 7516.0 / 105,
      -22.0 / 7, 11.0 / 210],
     [-62391.0 / 20, 614727.0 / 20, -1368279.0 / 20, 4624139.0 / 80,
      -157396.0 / 7, 30064.0 / 7, -2717.0 / 7, 2761.0 / 210],
     [-124389.0 / 10, 6046951.0 / 160, -248520.0 / 7, 481024.0 / 35,
      -15972.0 / 7, 18689.0 / 140],
     [-70414.0 / 21, 465992.0 / 105, -11792.0 / 7, 19778.0 / 105],
     [-682.0 / 7, 7601.0 / 210]],
]


def _itoh_Y(n, Xt, St2):
    total = 0.0
    for k, row in enumerate(_Y_TABLES[n]):
        poly = 0.0
        for c in row[::-1]:
            poly = poly * Xt + c
        total = total + poly * St2 ** k
    return total


def calcFRel(z, M500, Ez, obsFreqGHz=148.0):
    """Relativistic correction fRel = 1 + delta_SZE(x, T_e).

    T_e from the Arnaud et al. (2005) M-T relation, exactly as the reference
    (``signals.py:1148-1204``); Itoh et al. (1998) frequency dependence.
    """
    M500 = np.asarray(M500, dtype=float)
    # Arnaud et al. (2005) M-T relation
    A, B = 3.84e14, 1.71
    TkeV = 5.0 * np.power((Ez * M500) / A, 1.0 / B)
    TKelvin = TkeV * ((1000 * E_CHARGE) / K_B)
    thetae = (K_B * TKelvin) / (M_E * C_LIGHT ** 2)

    X = (H_PLANCK * obsFreqGHz * 1e9) / (K_B * TCMB)
    Xt = X * (np.cosh(X / 2.0) / np.sinh(X / 2.0))
    St2 = (X / np.sinh(X / 2.0)) ** 2

    series = 0.0
    for n in range(5):
        series = series + _itoh_Y(n, Xt, St2) * thetae ** n
    deltaSZE = ((X ** 3) / (np.exp(X) - 1)) \
        * ((thetae * X * np.exp(X)) / (np.exp(X) - 1)) * series
    return 1 + deltaSZE


def calcWeightedFRel(z, M500, Ez, fRelWeightsDict):
    """Frequency-weighted fRel (signals.py:1132-1145)."""
    fRels, weights = [], []
    for obsFreqGHz, w in fRelWeightsDict.items():
        if w > 0:
            fRels.append(calcFRel(z, M500, Ez, obsFreqGHz=float(obsFreqGHz)))
            weights.append(w)
    return np.average(np.array(fRels), axis=0, weights=weights)
