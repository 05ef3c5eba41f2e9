"""Flat-sky Fourier primitives on torch tensors (cuFFT on the card).

Port of ``nemo_tpu/ops/fourier.py``; the conventions are the same:

* ``rfft2``/``irfft2`` are plain unnormalised real transforms over the
  last two axes (numpy normalisation); the matched-filter normalisation is
  fixed by the explicit signal calibration, so only internal consistency
  matters.
* The pixel window is the separable sinc in cycles-per-pixel units
  (pixell ``enmap.calc_window``).
* ``apod_mask`` is the cosine taper of ``enmap.apod``.
"""

import functools

import numpy as np
import torch

from . import _exact


def rfft2(m):
    """Real-input 2-d FFT over the last two axes (half grid)."""
    return torch.fft.rfft2(m)


def irfft2(fm, s):
    """Inverse of :func:`rfft2` back to a real (s[0], s[1]) map."""
    return torch.fft.irfft2(fm, s=tuple(int(v) for v in s))


@functools.lru_cache(maxsize=64)
def _apod_profile(n, width):
    prof = np.ones(n)
    if width > 0:
        ramp = (1 - np.cos(np.linspace(0, np.pi, width))) / 2
        prof[:width] = ramp
        prof[-width:] = ramp[::-1]
    return prof


def apod_mask(shape, width, device=None, dtype=torch.float64):
    """2-d cosine apodisation window for a map of the given (ny, nx) shape
    (formed in float64 on the host, then cast)."""
    ny, nx = shape[-2], shape[-1]
    wy = _apod_profile(ny, int(width))
    wx = _apod_profile(nx, int(width))
    return torch.as_tensor(wy[:, None] * wx[None, :], dtype=dtype,
                           device=device)


@functools.lru_cache(maxsize=64)
def _window_1d(n):
    return np.sinc(np.fft.fftfreq(n))


@functools.lru_cache(maxsize=64)
def _window_half_1d(ny, nx, pow):
    wy = _window_1d(ny) ** pow
    wx = np.sinc(np.fft.rfftfreq(nx)) ** pow
    return wy, wx


def apply_pixel_window(m, pow=1.0):
    """Multiply/divide out the map pixel window in Fourier space (pixell
    ``enmap.apply_window`` equivalent), on the half grid."""
    ny, nx = m.shape[-2], m.shape[-1]
    fm = torch.fft.rfft2(m)
    wy, wx = _window_half_1d(ny, nx, pow)
    wy = torch.as_tensor(wy, dtype=m.dtype, device=m.device)
    wx = torch.as_tensor(wx, dtype=m.dtype, device=m.device)
    fm = fm * (wy[:, None] * wx[None, :])
    return torch.fft.irfft2(fm, s=(ny, nx))


@functools.lru_cache(maxsize=64)
def rlaxes(shape, pix_scales_rad):
    """(ly, lx) for the rfft half grid: ly in fftfreq order, lx ascending."""
    ny, nx = shape[-2], shape[-1]
    dy, dx = pix_scales_rad
    ly = 2 * np.pi * np.fft.fftfreq(ny, d=dy)
    lx = 2 * np.pi * np.fft.rfftfreq(nx, d=dx)
    return ly, lx


@functools.lru_cache(maxsize=64)
def rmodlmap(shape, pix_scales_rad):
    """|l| on the rfft half grid (host numpy)."""
    ly, lx = rlaxes(shape, pix_scales_rad)
    return np.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2)


def rmodlmap_graph(shape, pix_scales_rad, device=None,
                   dtype=torch.float64):
    """|l| on the rfft half grid as a tensor on ``device``, formed there
    from the 1-d axes."""
    ly, lx = rlaxes(shape, pix_scales_rad)
    ly = torch.as_tensor(ly, dtype=dtype, device=device)
    lx = torch.as_tensor(lx, dtype=dtype, device=device)
    return _exact.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2)


def radial_distance_map(shape, pix_scales_rad, center=None):
    """Map of angular distance (radians) from a reference point.

    Replicates ``MapFilter.makeRadiansMap`` (``nemo/filters.py:214-239``):
    flat-sky distances with x/y pixel scales fixed at the map centre, centre
    pixel at (floor coords of) shape/2.
    """
    ny, nx = shape[-2], shape[-1]
    dy, dx = pix_scales_rad
    if center is None:
        cy, cx = ny // 2, nx // 2
    else:
        cy, cx = center
    yy = (np.arange(ny) - cy) * dy
    xx = (np.arange(nx) - cx) * dx
    return np.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)


@functools.lru_cache(maxsize=512)
def good_fft_size(n):
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= n.

    Kept exactly as the JAX package has it: the padded size fixes the
    filter's Fourier grid, so a different choice would change the filter
    (and break parity), not just the speed.
    """
    best = None
    p2 = 1
    while p2 < 2 * n:
        p23 = p2
        while p23 < 2 * n:
            p235 = p23
            while p235 < n:
                p235 *= 5
            if best is None or p235 < best:
                best = p235
            p23 *= 3
        p2 *= 2
    return int(best)


def pad_to(m, shape):
    """Zero-pad the last two axes up to `shape` (at the high ends, so pixel
    coordinates of existing content are unchanged)."""
    ny, nx = m.shape[-2], m.shape[-1]
    py, px = shape
    if (py, px) == (ny, nx):
        return m
    return torch.nn.functional.pad(m, (0, px - nx, 0, py - ny))


def crop_to(m, shape):
    """Crop the last two axes down to `shape` (inverse of pad_to)."""
    return m[..., :shape[0], :shape[1]]


def _dft_phase(k, pos, n, rdtype):
    """exp(2 pi i k pos / n) for integer (k, pos) tensors, with k * pos
    reduced mod n in integers first: the phase argument then stays in
    [0, 2 pi) instead of reaching ~2 pi n, so float32 keeps its digits (the
    reduction is exact in real arithmetic)."""
    arg = torch.remainder(k * pos, n).to(rdtype) * (2 * np.pi / n)
    return torch.polar(torch.ones_like(arg), arg)


def windowed_irfft2(G, y0, x0, ny, nx, wlen):
    """``irfft2(G, s=(ny, nx))`` on the ``wlen x wlen`` window anchored at
    integer offsets ``(y0, x0)``, without the full inverse transform: two
    small complex matmuls against DFT basis vectors (backward
    normalisation), with the Hermitian half grid's interior columns
    counted twice.

    Args:
        G: (B..., F..., ny, nx//2+1) complex half-grid spectra.
        y0, x0: python ints, or int tensors of shape (B...) (one window
            origin per leading batch entry, broadcast over F...).
        ny, nx: full-grid shape.
        wlen: window size.
    Returns:
        (B..., F..., wlen, wlen) real window values.
    """
    nxh = G.shape[-1]
    dev = G.device
    rdtype = torch.float64 if G.dtype == torch.complex128 else torch.float32
    y0 = torch.as_tensor(y0, dtype=torch.int64, device=dev)
    x0 = torch.as_tensor(x0, dtype=torch.int64, device=dev)
    ar = torch.arange(wlen, dtype=torch.int64, device=dev)
    ys = y0[..., None] + ar                                   # (B..., w)
    xs = x0[..., None] + ar
    ky = torch.arange(ny, dtype=torch.int64, device=dev)
    kx = torch.arange(nxh, dtype=torch.int64, device=dev)
    wx = torch.where((kx == 0) | ((nx % 2 == 0) & (kx == nx // 2)),
                     1.0, 2.0).to(rdtype)
    ex = _dft_phase(kx[:, None], xs[..., None, :], nx, rdtype) \
        * wx[:, None]                                         # (B.., nxh, w)
    ey = _dft_phase(ky[:, None], ys[..., None, :], ny, rdtype)  # (B.., ny, w)
    extra = G.ndim - 2 - y0.ndim        # the F... axes the origin spans
    for _ in range(extra):
        ex = ex[..., None, :, :]
        ey = ey[..., None, :, :]
    M1 = torch.matmul(G, ex.to(G.dtype))                     # (..., ny, w)
    out = torch.matmul(ey.to(G.dtype).transpose(-1, -2), M1)  # (..., w, w)
    return torch.real(out) / (ny * nx)
