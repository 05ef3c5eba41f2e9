"""Gaussian random field simulation: CMB and instrument-noise maps on a flat
tile, as torch tensors.

Port of ``nemo_tpu/ops/grf.py``: a tile's Fourier modes are drawn with
<|F(l)|^2> = N_pix * C(l) / Omega_pix, so that the empirical 2-d power
spectrum matches the input C_l (the curved-sky counterpart is
:mod:`~nemo_tpu_torch.ops.sht`).  Every function that draws takes an
explicit ``torch.Generator`` on its device, and also the draw itself (the
white field), so that the arithmetic after the draw can be held to the
JAX package's on the same numbers.
"""

import os

import numpy as np
import torch

from . import _exact, fourier
from .paint import interp

# Approximate lensed CMB TT spectrum: log-interpolated anchors of
# D_l = l(l+1)C_l/2pi in uK^2 through the acoustic peak structure.  Used
# for the damping tail beyond the bundled table's last multipole.
_DL_ANCHORS_L = np.array([2, 10, 30, 60, 100, 150, 220, 300, 412, 537, 620,
                          686, 810, 920, 1020, 1120, 1250, 1400, 1600, 1800,
                          2000, 2300, 2600, 3000, 4000, 6000, 10000])
_DL_ANCHORS_D = np.array([1000, 950, 1000, 1150, 1400, 2500, 5750, 3900,
                          1650, 2550, 2100, 1850, 2500, 1850, 1300, 1250,
                          900, 550, 320, 190, 110, 55, 28, 12, 2.0, 0.1,
                          1e-3])

LENSED_CL_TABLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "lensed_cl_tt.txt")


def approxLensedClTT(lmax=12000):
    """Analytic stand-in C_l (uK^2) for l = 0..lmax."""
    ell = np.arange(lmax + 1, dtype=float)
    Dl = np.exp(np.interp(np.log(np.maximum(ell, 2)),
                          np.log(_DL_ANCHORS_L), np.log(_DL_ANCHORS_D)))
    with np.errstate(divide="ignore", invalid="ignore"):
        Cl = 2 * np.pi * Dl / (ell * (ell + 1))
    Cl[:2] = 0.0
    return Cl


_lensedDlCache = {}


def lensedClTT(lmax=12000):
    """Lensed CMB TT C_l (uK^2) for l = 0..lmax.

    Reconstructed from the port's copy of the CAMB table,
    ``nemo_tpu_torch/data/lensed_cl_tt.txt`` (cubic spline in log D_l);
    beyond the table's last multipole the analytic damping-tail curve is
    continued, rescaled to join the table continuously.  Raises
    FileNotFoundError if the table is missing: an analytic stand-in would
    change every sim silently.
    """
    if lmax in _lensedDlCache:
        return _lensedDlCache[lmax].copy()
    if not os.path.exists(LENSED_CL_TABLE):
        raise FileNotFoundError("the lensed CMB TT table is missing: %s"
                                % LENSED_CL_TABLE)
    tab = np.loadtxt(LENSED_CL_TABLE)
    lAnchor, DlAnchor = tab[:, 0], tab[:, 1]
    from scipy.interpolate import CubicSpline

    cs = CubicSpline(lAnchor, np.log(DlAnchor))
    lTabMax = int(lAnchor[-1])
    ell = np.arange(lmax + 1, dtype=float)
    Dl = np.zeros(lmax + 1)
    top = min(lmax, lTabMax)
    Dl[2:top + 1] = np.exp(cs(ell[2:top + 1]))
    if lmax > lTabMax:
        tailL = ell[lTabMax + 1:]
        tail = np.exp(np.interp(np.log(tailL), np.log(_DL_ANCHORS_L),
                                np.log(_DL_ANCHORS_D)))
        joinRef = np.exp(np.interp(np.log(lTabMax),
                                   np.log(_DL_ANCHORS_L),
                                   np.log(_DL_ANCHORS_D)))
        Dl[lTabMax + 1:] = tail * (DlAnchor[-1] / joinRef)
    with np.errstate(divide="ignore", invalid="ignore"):
        Cl = 2 * np.pi * Dl / (ell * (ell + 1))
    Cl[:2] = 0.0
    if len(_lensedDlCache) > 8:
        _lensedDlCache.clear()
    _lensedDlCache[lmax] = Cl
    return Cl.copy()


def draw_normal(shape, dtype, device, generator, what):
    """Every draw of the sims: a standard-normal field from ``generator``.
    ``what`` names the drawing function (a test that replays another
    package's draws patches this one function)."""
    if generator is None:
        raise ValueError("%s needs a generator or the draw" % what)
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=device)


def _white(shape, dtype, device, generator, white, what):
    """The draw: ``white`` as given, else :func:`draw_normal`."""
    if white is None:
        return draw_normal(shape, dtype, device, generator, what)
    if isinstance(white, np.ndarray):
        white = np.array(white)         # a writable copy for torch
    return torch.as_tensor(white, device=device).to(dtype)


def gaussian_field(shape, pix_scales_rad, ell, Cl, dtype=torch.float64,
                   device="cuda", generator=None, white=None):
    """A real GRF with isotropic power spectrum C(l) on a flat tile: rfft a
    white map, shape by sqrt(C(l)/Omega_pix), transform back."""
    dy, dx = pix_scales_rad
    lmap = fourier.rmodlmap_graph(shape, pix_scales_rad, device=device)
    Cl2d = interp(lmap, torch.as_tensor(ell, dtype=lmap.dtype, device=device),
                  torch.as_tensor(Cl, dtype=lmap.dtype, device=device),
                  right=0.0)
    omega_pix = dy * dx
    amp = _exact.sqrt(torch.clamp(Cl2d, min=0.0) / omega_pix)
    white = _white(shape, dtype, device, generator, white, "gaussian_field")
    F = torch.fft.rfft2(white)
    return torch.fft.irfft2(F * amp, s=tuple(shape))


def gaussian_field_decaware(shape, dy, dx_rows, ell, Cl, n_bands=9,
                            dtype=torch.float64, device="cuda",
                            generator=None, white=None):
    """GRF on a CAR tile honouring the cos(dec)-varying x pixel scale: ONE
    white field shaped at ``n_bands`` reference scales spanning
    [min(dx), max(dx)], each row blending the two nearest bands linearly
    (the bands share their Fourier phases, so the blend interpolates the
    shaping amplitude).  The bands are a loop over reference scales."""
    ny, nx = shape
    white = _white(shape, dtype, device, generator, white,
                   "gaussian_field_decaware")
    F = torch.fft.rfft2(white)
    dx_rows = torch.as_tensor(dx_rows, device=device).to(dtype)
    dxLo = torch.min(dx_rows)
    dxHi = torch.max(dx_rows)
    dxs = torch.linspace(float(dxLo), float(dxHi), n_bands, dtype=dtype,
                         device=device)
    ellA = torch.as_tensor(ell, device=device).to(dtype)
    ClA = torch.as_tensor(Cl, device=device).to(dtype)
    lyf = torch.as_tensor(np.fft.fftfreq(ny) * 2 * np.pi, device=device
                          ).to(dtype)
    lxf = torch.as_tensor(np.fft.rfftfreq(nx) * 2 * np.pi, device=device
                          ).to(dtype)
    bands = []
    for b in range(n_bands):
        dx_b = dxs[b]
        lmap = _exact.sqrt((lyf / dy)[:, None] ** 2
                          + (lxf / dx_b)[None, :] ** 2)
        Cl2d = interp(lmap, ellA, ClA, right=0.0)
        amp = _exact.sqrt(torch.clamp(Cl2d, min=0.0) / (dy * dx_b))
        bands.append(torch.fft.irfft2(F * amp, s=tuple(shape)))
    bands = torch.stack(bands)                          # (B, ny, nx)
    t = (dx_rows - dxLo) / torch.clamp(dxHi - dxLo, min=1e-300) \
        * (n_bands - 1)
    b0 = torch.clamp(torch.floor(t).to(torch.int64), 0, n_bands - 2)
    w = torch.clamp(t - b0, 0.0, 1.0)[:, None]
    rows = torch.arange(ny, device=device)
    return (1.0 - w) * bands[b0, rows, :] + w * bands[b0 + 1, rows, :]


def dec_band_count(dx_rows, target_frac=0.02, max_bands=16):
    """Number of reference scales so adjacent bands differ by less than
    ``target_frac`` in dl/l (host-side; 1 means a single-scale draw is
    already accurate to the target)."""
    dx_rows = np.asarray(dx_rows, dtype=float)
    spread = dx_rows.max() / max(dx_rows.min(), 1e-300) - 1.0
    if spread <= target_frac:
        return 1
    return int(np.clip(np.ceil(spread / target_frac) + 1, 2, max_bands))


def sim_cmb_map(shape, pix_scales_rad, beamBell=None, beamEll=None,
                noiseLevel=None, ClTT=None, dtype=torch.float64,
                dx_rows=None, device="cuda", generator=None, white=None,
                noise_white=None):
    """Simulated (optionally beam-convolved) CMB map plus white noise, a
    tensor on ``device``.

    The beam is applied to C_l (amplitude, the reference's
    ``ps *= lbeam``).  ``dx_rows`` (per-row x pixel scale in radians)
    switches on the declination-aware banded synthesis
    (:func:`gaussian_field_decaware`).  Draws, in order, the field's white
    map and, with ``noiseLevel``, the noise's from ``generator``; ``white``
    and ``noise_white`` give them instead."""
    if ClTT is None:
        Cl = lensedClTT()
    else:
        Cl = np.asarray(ClTT)
    ell = np.arange(len(Cl), dtype=float)
    if beamBell is not None:
        lbeam = np.interp(ell, np.asarray(beamEll), np.asarray(beamBell))
        Cl = Cl * lbeam  # NOTE: reference multiplies C_l by B_l (not B_l^2)
    nBands = 1 if dx_rows is None else dec_band_count(dx_rows)
    if nBands > 1:
        m = gaussian_field_decaware(shape, pix_scales_rad[0], dx_rows, ell,
                                    Cl, n_bands=nBands, dtype=dtype,
                                    device=device, generator=generator,
                                    white=white)
    else:
        m = gaussian_field(shape, pix_scales_rad, ell, Cl, dtype=dtype,
                           device=device, generator=generator, white=white)
    if noiseLevel is not None:
        m = m + sim_noise_map(shape, noiseLevel, dtype=dtype, device=device,
                              generator=generator, white=noise_white)
    return m


def sim_noise_map(shape, noiseLevel, pix_scales_rad=None, lKnee=None,
                  alpha=-3.0, lmax_atm=6000, dtype=torch.float64,
                  device="cuda", generator=None, white=None):
    """White or 1/f ('atmospheric') noise map, a tensor on ``device``: with
    ``lKnee`` the modes up to ``lmax_atm`` are shaped by
    N_l = (lKnee/l)^-alpha + 1 while higher modes stay white, then scaled
    by the per-pixel noise level."""
    noiseLevel = torch.as_tensor(noiseLevel, device=device).to(dtype)
    white = _white(shape, dtype, device, generator, white, "sim_noise_map")
    zero = torch.zeros((), dtype=dtype, device=device)
    if lKnee is None:
        if noiseLevel.ndim == 0:
            return white * noiseLevel
        return torch.where(noiseLevel > 0, white * noiseLevel, zero)
    if pix_scales_rad is None:
        raise ValueError("pix_scales_rad needed for 1/f noise")
    lmap = fourier.rmodlmap_graph(shape, pix_scales_rad, device=device)
    Nl = torch.where(lmap > 0, (lKnee / torch.clamp(lmap, min=1e-9))
                     ** -alpha + 1.0, torch.zeros_like(lmap))
    shape_l = torch.where(lmap <= lmax_atm, _exact.sqrt(Nl),
                          torch.ones_like(lmap))
    shaped = fourier.irfft2(fourier.rfft2(white) * shape_l, s=shape)
    if noiseLevel.ndim == 0:
        return shaped * noiseLevel
    return torch.where(noiseLevel > 0, shaped * noiseLevel, zero)
