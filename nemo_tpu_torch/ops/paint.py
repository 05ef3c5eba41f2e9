"""Radial-profile painting on torch tensors.

Port of ``nemo_tpu/ops/paint.py``: centred templates (the filter bank's
signal templates) and :func:`paint_objects`, many objects sharing one
radial profile at sub-pixel positions (model images, injection, model
subtraction).  The JAX package scans the objects one at a time; here every
window of a chunk of objects is evaluated at once and summed into the
canvas in object order, so the sum is the scan's own and the same on
every call (see :func:`_accumulate_in_order`).
"""

import numpy as np
import torch

from . import _exact


def interp(x, xp, fp, left=None, right=None):
    """``jnp.interp`` on tensors, formula for formula: torch has no interp.

    ``xp`` must be increasing.  A point on a knot returns that knot's
    value; points beyond the table get ``left``/``right`` (default: the
    end values).
    """
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    x0 = xp[i - 1]
    f0 = fp[i - 1]
    df = fp[i] - f0
    dx = xp[i] - x0
    delta = x - x0
    eps = np.spacing(torch.finfo(xp.dtype).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0,
                    f0 + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * df)
    left = fp[0] if left is None else left
    right = fp[-1] if right is None else right
    f = torch.where(x < xp[0], torch.as_tensor(left, dtype=f.dtype,
                                               device=f.device), f)
    return torch.where(x > xp[-1], torch.as_tensor(right, dtype=f.dtype,
                                                   device=f.device), f)


def _pad_table(rp, vp, dtype, size=None):
    """Pad a radial table to a bucketed length with strictly increasing
    radii beyond its end and zero values: interp then returns 0 there,
    identical to the unpadded right=0 behaviour.  Kept from the JAX
    package (where the bucket bounds recompilation) so both packages
    interpolate the same knots."""
    n = len(rp)
    if size is None:
        size = _table_bucket(n)
    rpad = np.empty(size, dtype=dtype)
    vpad = np.zeros(size, dtype=dtype)
    rpad[:n] = rp
    vpad[:n] = vp
    relStep = 1e-6 if dtype == np.float32 else 1e-9
    eps = abs(rp[-1]) * relStep + 1e-30
    rpad[n:] = rp[-1] + eps * np.arange(1, size - n + 1)
    return rpad, vpad


def _table_bucket(n):
    """Power-of-two bucket size with >= 1 pad slot (the zero landing)."""
    size = 256
    while size < n + 1:
        size *= 2
    return size


def paint_templates_centered_batch(shape, pix_scales_rad, tables,
                                   center=None, device=None,
                                   dtype=torch.float64):
    """Paint a batch of centred radial profiles in one call: the distance
    grid is computed once and every table (padded to a common bucket, as
    :func:`paint_template_centered` pads one) is interpolated on it.

    Args:
        shape: (ny, nx).
        pix_scales_rad: (dy, dx) radians/pixel at tile centre.
        tables: sequence of (r_prof, v_prof) pairs (radians -> amplitude;
            zero outside the table).
        center: optional float (cy, cx); default (ny/2, nx/2).
    Returns:
        (len(tables), ny, nx) tensor on ``device`` in ``dtype``; each plane
        equals :func:`paint_template_centered` of its table.
    """
    ny, nx = int(shape[0]), int(shape[1])
    if center is None:
        center = (ny / 2.0, nx / 2.0)
    npDtype = np.dtype(np.float64 if dtype == torch.float64 else np.float32)
    size = _table_bucket(max(len(r) for r, _ in tables))
    padded = [_pad_table(np.asarray(r), np.asarray(v), npDtype, size=size)
              for r, v in tables]

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    scales = t(np.asarray(pix_scales_rad, dtype=npDtype))
    c = t(np.asarray(center, dtype=npDtype))
    yy = (torch.arange(ny, dtype=dtype, device=device) - c[0]) * scales[0]
    xx = (torch.arange(nx, dtype=dtype, device=device) - c[1]) * scales[1]
    r = _exact.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
    out = torch.empty((len(tables), ny, nx), dtype=dtype, device=device)
    for i, (rp, vp) in enumerate(padded):
        vp = t(vp)
        out[i] = interp(r, t(rp), vp, left=vp[0], right=0.0)
    return out


def paint_template_centered(shape, pix_scales_rad, r_prof, v_prof,
                            center=None, device=None, dtype=torch.float64):
    """Paint one unit-amplitude radial profile centred on the map.

    Args:
        shape: (ny, nx).
        pix_scales_rad: (dy, dx) radians/pixel at tile centre.
        r_prof, v_prof: radial profile table (radians -> amplitude); values
            outside the table are zero (splev ext=1 semantics).
        center: optional float (cy, cx) pixel coords; default (ny/2, nx/2).
    Returns:
        (ny, nx) tensor on ``device`` in ``dtype``.
    """
    ny, nx = int(shape[0]), int(shape[1])
    if center is None:
        center = (ny / 2.0, nx / 2.0)
    npDtype = np.float64 if dtype == torch.float64 else np.float32
    rp, vp = _pad_table(np.asarray(r_prof), np.asarray(v_prof),
                        np.dtype(npDtype))
    scales = np.asarray(pix_scales_rad, dtype=npDtype)
    c = np.asarray(center, dtype=npDtype)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    scales, c = t(scales), t(c)
    yy = (torch.arange(ny, dtype=dtype, device=device) - c[0]) * scales[0]
    xx = (torch.arange(nx, dtype=dtype, device=device) - c[1]) * scales[1]
    r = _exact.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
    vp = t(vp)
    return interp(r, t(rp), vp, left=vp[0], right=0.0)


def _accumulate_in_order(canvas, index, values):
    """``canvas.view(-1)[index] += values`` with the contributions to each
    pixel added one at a time in the order they come in ``index``.

    A stable sort by pixel gives each contribution its rank among those of
    its pixel (its sorted position less that of its pixel's first
    contribution, found by a binary search; a cumulative max would scan
    the whole chunk in one row); rank r of every pixel is then added in
    one pass, and no pass writes a pixel twice.  So each pixel sums its
    contributions in their given (object) order, as a scan does, with no
    atomics: the result is bitwise the same on every call and device."""
    flat = canvas.view(-1)
    sortedIdx, perm = torch.sort(index, stable=True)
    pos = torch.arange(sortedIdx.shape[0], device=index.device)
    rank = pos - torch.searchsorted(sortedIdx, sortedIdx)
    byRank = torch.argsort(rank, stable=True)
    idx = sortedIdx[byRank]
    vals = values[perm[byRank]]
    start = 0
    for count in torch.bincount(rank).tolist():
        sl = slice(start, start + count)
        flat[idx[sl]] = flat[idx[sl]] + vals[sl]
        start += count


# bytes a window pixel takes while its chunk is painted: the distance, the
# interpolation's temporaries, the value, the pixel index and the sort's
# permutations and ranks
_BYTES_PER_WINDOW_PIXEL = 160
_HOST_CHUNK_BYTES = 2 ** 28


def _chunk_budget(device):
    """Working memory for one chunk of windows: a quarter of the card's free
    memory, so a catalog of any common size paints in one chunk (one host
    sync), or 256 MiB of host memory on the CPU."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 4
    return _HOST_CHUNK_BYTES


def paint_objects(shape, pix_scales_rad, ys, xs, amps, r_prof, v_prof,
                  rmax_rad, dx_rows=None, device=None, dtype=torch.float64,
                  chunk_bytes=None):
    """Paint many objects sharing a radial profile into a (ny, nx) canvas.

    The reference's rules (``nemo_tpu/ops/paint.py:paint_objects``): a
    window of (2wy+1) x (2wx+1) pixels around each object, wy =
    ceil(rmax/dy) and wx = ceil(rmax/min(dx_rows)), each capped at the
    canvas; window origins at floor(y) - wy, clamped into the canvas padded
    by a window and a pixel, as ``lax.dynamic_slice`` clamps; the distance
    with each window row's own x scale; ``amp x interp(r, profile)`` with
    the profile zeroed beyond ``rmax_rad``, ``left`` = its first value and
    ``right`` = 0.

    Args:
        ys, xs: float 0-based pixel coords of object centres (inside the
            map; callers pre-filter).
        amps: peak amplitudes, one per object or one for all.
        r_prof, v_prof: shared radial profile table (unit peak, radians).
        rmax_rad: truncation radius; sets the window size.
        dx_rows: optional (ny,) per-row x pixel scales in radians; without
            it ``pix_scales_rad[1]`` serves every row.
        chunk_bytes: working-memory budget (default: ``_chunk_budget``);
            objects are painted in chunks of windows that fit it, in order.
    Returns:
        (ny, nx) tensor on ``device`` in ``dtype``.
    """
    paint_objects.calls += 1
    ny, nx = int(shape[0]), int(shape[1])
    dy, dx = pix_scales_rad
    npDtype = np.dtype(np.float64 if dtype == torch.float64 else np.float32)
    if dx_rows is None:
        dxr = np.full(ny, dx, dtype=npDtype)
    else:
        dxr = np.asarray(dx_rows, dtype=npDtype)
        if dxr.shape != (ny,):
            raise ValueError("dx_rows must have shape (ny,)")
    wy = min(int(np.ceil(rmax_rad / dy)), ny)
    wx = min(int(np.ceil(rmax_rad / float(dxr.min()))), nx)
    # dx per padded-canvas row, edge rows replicated
    dx_pad = np.empty(ny + 2 * wy + 2, dtype=npDtype)
    dx_pad[wy + 1:wy + 1 + ny] = dxr
    dx_pad[:wy + 1] = dxr[0]
    dx_pad[wy + 1 + ny:] = dxr[-1]
    # window origins and sub-pixel offsets from float64 positions: the
    # offset y - floor(y) is exact, so (k - wy) - offset rounds once, to
    # the same float64 value as the reference's (floor(y) - wy + k) - y,
    # and in float32 it keeps the sub-pixel position that a float32 y of
    # a survey-sized map (y ~ 4000: ulp 2.4e-4 px) would lose
    ys = np.atleast_1d(np.asarray(ys, dtype=np.float64))
    xs = np.atleast_1d(np.asarray(xs, dtype=np.float64))
    fy, fx = np.floor(ys), np.floor(xs)
    amps = np.array(np.broadcast_to(
        np.atleast_1d(np.asarray(amps, dtype=npDtype)), ys.shape))
    r_prof = np.asarray(r_prof, dtype=npDtype)
    v_prof = np.where(r_prof <= rmax_rad, np.asarray(v_prof, dtype=npDtype),
                      0.0).astype(npDtype)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    rp, vp = t(r_prof), t(v_prof)
    dyT = t(npDtype.type(dy))
    dxPad = t(dx_pad)
    Hc, Wc = ny + 2 * wy + 2, nx + 2 * wx + 2
    canvas = torch.zeros((Hc, Wc), dtype=dtype, device=device)
    iyOff = torch.arange(-wy, wy + 1, dtype=dtype, device=device)
    ixOff = torch.arange(-wx, wx + 1, dtype=dtype, device=device)
    iyInt = torch.arange(2 * wy + 1, device=device)
    ixInt = torch.arange(2 * wx + 1, device=device)
    winPix = (2 * wy + 1) * (2 * wx + 1)
    if chunk_bytes is None:
        chunk_bytes = _chunk_budget(device)
    per = max(1, int(chunk_bytes // (winPix * _BYTES_PER_WINDOW_PIXEL)))
    for c0 in range(0, ys.shape[0], per):
        sl = slice(c0, c0 + per)
        oy, ox = t(ys[sl] - fy[sl]), t(xs[sl] - fx[sl])
        amp = t(amps[sl])
        yy = (iyOff[None, :] - oy[:, None]) * dyT
        # window starts floor(y) - wy in the padded canvas, clamped as
        # dynamic_slice clamps
        sy = torch.clamp(torch.as_tensor(fy[sl], device=device).to(
            torch.int64) + 1, 0, Hc - (2 * wy + 1))
        sx = torch.clamp(torch.as_tensor(fx[sl], device=device).to(
            torch.int64) + 1, 0, Wc - (2 * wx + 1))
        rows = sy[:, None] + iyInt[None, :]
        dxw = dxPad[rows]
        xx = ixOff[None, :] - ox[:, None]
        r = _exact.sqrt(yy[:, :, None] ** 2
                       + (dxw[:, :, None] * xx[:, None, :]) ** 2)
        vals = amp[:, None, None] * interp(r, rp, vp, left=vp[0], right=0.0)
        index = rows[:, :, None] * Wc + (sx[:, None] + ixInt[None, :])[
            :, None, :]
        _accumulate_in_order(canvas, index.reshape(-1), vals.reshape(-1))
    return canvas[wy + 1:wy + 1 + ny, wx + 1:wx + 1 + nx]


paint_objects.calls = 0
