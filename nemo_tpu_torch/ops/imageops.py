"""Image-space operators with scipy.ndimage-parity semantics, in torch.

Port of ``nemo_tpu/ops/imageops.py``: the separable Gaussian smoothing of
the noise covariance (``gaussian_filter``, mode 'reflect'), its exact
full-grid form from an rfft half grid, the van Herk min/max filters of the
edge trim, the 4-connected binary dilation, and the reflect-boundary 2-d
convolution of the real-space matched filter (``convolve2d_reflect`` and
its band-summed and tile-batched forms).
"""

import functools

import numpy as np
import torch

from . import fourier


@functools.lru_cache(maxsize=32)
def _gaussian_weights(sigma, truncate=4.0):
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    w /= w.sum()
    return w, radius


def _symmetric_index(n, radius, device):
    """Source indices of an n-long axis padded by ``radius`` on both sides
    in numpy's mode='symmetric' (scipy's 'reflect'): the edge pixel is
    repeated, and pads wider than the axis keep reflecting.
    ``torch.nn.functional.pad(mode='reflect')`` does NOT repeat the edge."""
    i = torch.arange(-radius, n + radius, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


# Above this many taps a 1-d correlation on the CPU goes through the FFT:
# torch's CPU conv1d unfolds a copy of the map per tap (481 taps for the
# 30' background subtraction at 0.5', ~5 GB and ~1 s a pass on an 896 x
# 1536 tile).  The noise covariance's smoothing (25 taps) stays direct.
_CPU_FFT_TAPS = 64


def _correlate1d_fft(moved, w):
    """Valid 1-d correlation of the last axis of ``moved`` (padded by the
    window's radius on both sides) with weights ``w``, through the FFT."""
    n = moved.shape[-1]
    L = fourier.good_fft_size(n)
    full = torch.fft.irfft(torch.fft.rfft(moved, n=L)
                           * torch.fft.rfft(torch.flip(w, (0,)), n=L), n=L)
    return full[..., w.shape[0] - 1:n]


def _correlate1d_reflect(m, weights, radius, axis):
    """1-d correlation along ``axis`` with scipy's 'reflect' boundary
    (numpy 'symmetric')."""
    axis = axis % m.ndim
    padded = torch.index_select(
        m, axis, _symmetric_index(m.shape[axis], radius, m.device))
    moved = padded.movedim(axis, -1)
    lead_shape = moved.shape[:-1]
    if m.device.type == "cpu" and len(weights) > _CPU_FFT_TAPS:
        w = torch.as_tensor(np.ascontiguousarray(weights), dtype=m.dtype)
        return _correlate1d_fft(moved, w).movedim(-1, axis)
    flat = moved.reshape(-1, 1, moved.shape[-1])
    w = torch.as_tensor(np.ascontiguousarray(weights[::-1]), dtype=m.dtype,
                        device=m.device)
    # conv1d is a cross-correlation: the flipped weights make it the
    # correlation ndimage computes (the weights are symmetric anyway)
    out = torch.nn.functional.conv1d(flat, w.reshape(1, 1, -1))
    return out.reshape(lead_shape + (out.shape[-1],)).movedim(-1, axis)


def gaussian_filter(m, sigma, truncate=4.0):
    """scipy.ndimage.gaussian_filter parity (mode='reflect').

    ``sigma`` may be a scalar or per-axis (sy, sx) for the last two axes.
    """
    if np.isscalar(sigma):
        sigma = (sigma, sigma)
    sy, sx = sigma
    out = m
    if sy > 0:
        wy, ry = _gaussian_weights(float(sy), truncate)
        out = _correlate1d_reflect(out, wy, ry, axis=out.ndim - 2)
    if sx > 0:
        wx, rx = _gaussian_weights(float(sx), truncate)
        out = _correlate1d_reflect(out, wx, rx, axis=out.ndim - 1)
    return out


def hermitian_extend(half, nxFull):
    """Reconstruct the FULL (unshifted-layout) Fourier grid of a real
    map's power/covariance from its rfft half grid: for real input
    full[ky, nx - j] = full[(-ky) % ny, j], so the missing columns are the
    ky-flipped mirror of columns nx-ncol..1."""
    ncol = half.shape[-1]
    src = half[..., :, 1:nxFull - ncol + 1]
    # ky-flip: out[ky] = in[(-ky) % ny] == roll(reverse(in), 1)
    mirror = torch.roll(torch.flip(src, dims=(-2,)), 1, dims=-2)
    return torch.cat([half, torch.flip(mirror, dims=(-1,))], dim=-1)


def gaussian_filter_rfft_fullgrid(half, sigma, nxFull, truncate=4.0):
    """Smooth an rfft-half-grid covariance exactly as the reference smooths
    the full complex grid: Hermitian-extend, smooth with 'reflect'
    boundaries on the full grid, crop back to the half grid."""
    ncol = half.shape[-1]
    full = hermitian_extend(half, nxFull)
    return gaussian_filter(full, sigma, truncate)[..., :ncol]


def _sliding_extremum_1d(m, size, is_min, axis):
    """van Herk / Gil-Werman sliding min (or max) along one axis: O(1) work
    per pixel for any window, from per-block prefix and suffix running
    extrema.  Out-of-bounds pixels are +inf (min) / -inf (max), which for
    an extremum filter equals scipy's 'reflect'."""
    size = int(size)
    lo = size // 2
    m = m.movedim(axis, -1)
    n = m.shape[-1]
    total = n + lo + size
    nblocks = -(-total // size)
    padded_len = nblocks * size
    init = float("inf") if is_min else float("-inf")
    x = torch.nn.functional.pad(m, (lo, padded_len - n - lo), value=init)
    blocks = x.reshape(m.shape[:-1] + (nblocks, size))
    cum = torch.cummin if is_min else torch.cummax
    prefix = cum(blocks, dim=-1).values.reshape(m.shape[:-1] + (padded_len,))
    suffix = torch.flip(cum(torch.flip(blocks, dims=(-1,)), dim=-1).values,
                        dims=(-1,)).reshape(m.shape[:-1] + (padded_len,))
    # window for out[i] in padded coords: [i, i + size - 1]
    a = suffix[..., :n]
    b = prefix[..., size - 1:size - 1 + n]
    out = torch.minimum(a, b) if is_min else torch.maximum(a, b)
    return out.movedim(-1, axis)


def minimum_filter(m, size):
    """scipy.ndimage.rank_filter(m, 0, size=(size, size)) parity; windows
    span [i - size//2, i + size - 1 - size//2] (scipy's origin 0)."""
    out = _sliding_extremum_1d(m, size, True, m.ndim - 2)
    return _sliding_extremum_1d(out, size, True, m.ndim - 1)


def maximum_filter(m, size):
    """Max filter with the same centring conventions as minimum_filter."""
    out = _sliding_extremum_1d(m, size, False, m.ndim - 2)
    return _sliding_extremum_1d(out, size, False, m.ndim - 1)


def binary_dilate_cross(mask, iterations=1):
    """Binary dilation with a 3x3 cross (4-connectivity), like
    ``mahotas.dilate`` with its default structuring element."""
    m = mask.to(torch.float32)
    for _ in range(int(iterations)):
        up = torch.zeros_like(m)
        up[..., :-1, :] = m[..., 1:, :]
        down = torch.zeros_like(m)
        down[..., 1:, :] = m[..., :-1, :]
        left = torch.zeros_like(m)
        left[..., :, :-1] = m[..., :, 1:]
        right = torch.zeros_like(m)
        right[..., :, 1:] = m[..., :, :-1]
        m = torch.maximum(m, torch.maximum(torch.maximum(up, down),
                                           torch.maximum(left, right)))
    return m > 0


def _reflect_pad(m, ky, kx):
    """Pad the last two axes by an odd kernel's half-widths in numpy's
    mode='symmetric' (scipy's 'reflect': the edge pixel repeats)."""
    iy = _symmetric_index(m.shape[-2], ky // 2, m.device)
    ix = _symmetric_index(m.shape[-1], kx // 2, m.device)
    return m.index_select(-2, iy).index_select(-1, ix)


def _check_odd(kernels, name):
    ky, kx = kernels.shape[-2:]
    if ky % 2 == 0 or kx % 2 == 0:
        raise ValueError("%s requires odd-sized kernels" % name)


def _conv_sum(padded, kern):
    """The kernels' valid convolution with the padded maps, summed over
    bands, through the FFT on either device: padded (T, nf, Y, X), kern
    (T, nf, ky, kx) -> (T, Y - ky + 1, X - kx + 1).  The transform is the
    convolution itself, so no kernel flip.  Measured on an H100 (700 W) for
    16 x 2 x 896 x 1536 float32 with 29 x 29 kernels: 2.1 ms, where cuDNN's
    grouped float32 ``conv2d`` (TF32 off) took 100 ms, ~1% of its bound,
    with a 4.7x larger error against float64.  On the CPU, torch's float64
    ``conv2d`` unfolds a ky*kx times copy of the map (~9 GB a band at that
    size).  The transform agrees with the direct sum to ~1e-14 of the peak
    in float64."""
    Y, X = padded.shape[-2:]
    ky, kx = kern.shape[-2:]
    s = (fourier.good_fft_size(Y), fourier.good_fft_size(X))
    prod = torch.fft.rfft2(padded, s=s) \
        * torch.fft.rfft2(kern.to(padded.dtype), s=s)
    full = torch.fft.irfft2(torch.sum(prod, dim=-3), s=s)
    return full[..., ky - 1:Y, kx - 1:X]


def convolve2d_reflect(m, kernel):
    """scipy.ndimage.convolve(m, kernel, mode='reflect') for an odd-sized
    2-d kernel, over the last two axes of ``m`` (the real-space matched
    filter's kernels are odd by construction)."""
    _check_odd(kernel, "convolve2d_reflect")
    ky, kx = kernel.shape
    padded = _reflect_pad(m, ky, kx)
    flat = padded.reshape((-1, 1) + padded.shape[-2:])
    kern = torch.as_tensor(kernel, device=m.device).expand(
        flat.shape[0], 1, ky, kx)
    out = _conv_sum(flat, kern)
    return out.reshape(m.shape[:-2] + out.shape[-2:])


def convolve2d_reflect_sum(m, kernels):
    """``sum_f ndimage.convolve(m[f], kernels[f], mode='reflect')`` for maps
    (nf, ny, nx) and per-band odd kernels (nf, ky, kx): the bands are
    summed in the transform domain, inside the convolution."""
    _check_odd(kernels, "convolve2d_reflect_sum")
    ky, kx = kernels.shape[-2:]
    return _conv_sum(_reflect_pad(m, ky, kx)[None],
                     torch.as_tensor(kernels, device=m.device)[None])[0]


def convolve2d_reflect_sum_batch(m, kernels):
    """:func:`convolve2d_reflect_sum` for a tile batch: maps (T, nf, ny, nx)
    and each tile's own kernels (T, nf, ky, kx) -> (T, ny, nx), in one
    batch of transforms.  Calls are counted in
    ``convolve2d_reflect_sum_batch.calls``."""
    _check_odd(kernels, "convolve2d_reflect_sum")
    convolve2d_reflect_sum_batch.calls += 1
    ky, kx = kernels.shape[-2:]
    return _conv_sum(_reflect_pad(m, ky, kx),
                     torch.as_tensor(kernels, device=m.device))


convolve2d_reflect_sum_batch.calls = 0


def median_filter_host(m, size):
    """Host-side median filter (scipy), used only for preprocessing hole
    filling; not on the device path."""
    from scipy import ndimage
    return ndimage.median_filter(np.asarray(m), int(size))
