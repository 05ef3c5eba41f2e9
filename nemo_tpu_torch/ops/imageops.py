"""Image-space operators with scipy.ndimage-parity semantics, in torch.

Port of ``nemo_tpu/ops/imageops.py``: the separable Gaussian smoothing of
the noise covariance (``gaussian_filter``, mode 'reflect'), its exact
full-grid form from an rfft half grid, the van Herk min/max filters of the
edge trim, and the 4-connected binary dilation.
"""

import functools

import numpy as np
import torch


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


def _correlate1d_reflect(m, weights, radius, axis):
    """1-d correlation along ``axis`` with scipy's 'reflect' boundary
    (numpy 'symmetric')."""
    axis = axis % m.ndim
    padded = torch.index_select(
        m, axis, _symmetric_index(m.shape[axis], radius, m.device))
    moved = padded.movedim(axis, -1)
    lead_shape = moved.shape[:-1]
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


def median_filter_host(m, size):
    """Host-side median filter (scipy), used only for preprocessing hole
    filling; not on the device path."""
    from scipy import ndimage
    return ndimage.median_filter(np.asarray(m), int(size))
