"""Radial-profile template painting on torch tensors.

Port of the centred-template part of ``nemo_tpu/ops/paint.py`` (the filter
bank's signal templates).  ``paint_objects`` (many objects at sub-pixel
positions, used by the sims and model images) is not ported yet.
"""

import numpy as np
import torch


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
    r = torch.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
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
    r = torch.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
    vp = t(vp)
    return interp(r, t(rp), vp, left=vp[0], right=0.0)
