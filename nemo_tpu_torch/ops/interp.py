"""Interpolation helpers.

Two regimes:

* ``subpixel_values``: host-side cubic-spline reads at a handful of catalog
  positions, matching the reference's use of
  ``scipy.interpolate.RectBivariateSpline`` (``nemo/photometry.py:77,121``)
  exactly - evaluated on windowed cutouts for speed (the interpolating
  spline's influence decays by ~0.27 per knot, so a 16-pixel margin is
  exact to float precision).
* ``interp_radial_profile``: device-side jnp.interp of 1-d radial tables,
  used by the signal painters.
"""

import functools

import numpy as np
from scipy import interpolate as sinterp


_WINDOW = 24  # half-width of the spline window; 24 knots margin >> exact


@functools.lru_cache(maxsize=8)
def notaknot_spline_setup(P):
    """Knots + value->coefficient matrix of the 1-d not-a-knot cubic
    interpolating spline on the integer grid ``0..P-1`` - the spline
    family scipy's ``RectBivariateSpline`` builds at ``s=0`` (FITPACK
    ``regrid``: interpolating knots exclude the 2nd and 2nd-to-last data
    points).  The matrix comes from scipy itself (splines of the identity
    columns), so spline VALUES computed from it reproduce scipy's to
    rounding error; the device detection path uses it to evaluate the
    sub-pixel S/N and flux reads on-chip
    (reference ``nemo/photometry.py:121-124``).

    Returns ``(t, M)``: knots ``(P + 4,)`` and ``(P, P)`` float64 with
    B-spline coefficients ``c = M @ values``.
    """
    spl = sinterp.make_interp_spline(np.arange(P), np.eye(P), k=3, axis=0)
    return np.asarray(spl.t), np.asarray(spl.c)


def subpixel_values(mapData, ys, xs, window=_WINDOW):
    """Cubic-spline interpolated values of a 2-d map at float (y, x) coords.

    Equivalent to RectBivariateSpline(arange(ny), arange(nx), map, kx=3,
    ky=3)(y, x) from the reference, evaluated via local windows.
    """
    mapData = np.asarray(mapData)
    ys = np.atleast_1d(np.asarray(ys, dtype=float))
    xs = np.atleast_1d(np.asarray(xs, dtype=float))
    ny, nx = mapData.shape
    out = np.zeros(len(ys))
    for i, (y, x) in enumerate(zip(ys, xs)):
        y0 = int(np.clip(np.floor(y) - window, 0, max(ny - 2 * window, 0)))
        x0 = int(np.clip(np.floor(x) - window, 0, max(nx - 2 * window, 0)))
        y1 = min(ny, y0 + 2 * window + 1)
        x1 = min(nx, x0 + 2 * window + 1)
        cut = mapData[y0:y1, x0:x1]
        if cut.shape[0] < 4 or cut.shape[1] < 4:
            out[i] = mapData[int(round(np.clip(y, 0, ny - 1))),
                             int(round(np.clip(x, 0, nx - 1)))]
            continue
        spl = sinterp.RectBivariateSpline(
            np.arange(y0, y1), np.arange(x0, x1), cut, kx=3, ky=3)
        out[i] = spl(y, x)[0][0]
    return out


def subpixel_value(mapData, y, x, window=_WINDOW):
    return float(subpixel_values(mapData, [y], [x], window=window)[0])
