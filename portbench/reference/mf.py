"""Plain reference of a multi-frequency matched-filter cluster search on
one tile, written from nemo's definition of each stage.

For each filter of the bank: the Fourier matched filter
filt = N^-1 (w |s|) from the band x band noise power of the apodised,
zero-padded tile (smoothed with a Gaussian of 3 pixels on the full
Fourier grid, reflecting at its edges) and the band's beam-convolved
template; its calibration (the filtered y0 = 2e-4 template, pixel window
applied, read at the tile centre); the filtered map; the grid RMS (3
sigma clipped in 40' cells with half-cell overlaps, written in cell
order); the S/N map and its masks (edge trim, survey and apodisation);
4-connected segmentation above the threshold, S/N-weighted centroids
and bicubic spline reads; then the optimal catalog (the highest-S/N
detection within 1.4' over the bank), with the photometry filter's
fixed_ columns.

Plain torch in float64 (or, for the control, in float32:
:class:`Precision`), scipy for labelling, minimum filters and splines.
It imports nothing of the program.
"""

import numpy as np
import torch
from scipy import ndimage
from scipy.interpolate import RectBivariateSpline

from . import model

Y0 = 2e-4               # calibration amplitude (Compton y)
XMATCH_DEG = 1.4 / 60.0
SPLINE_HALF = 16        # 33 x 33 spline windows


def good_fft_size(n):
    """Smallest integer >= n with no prime factor above 5."""
    m = n
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def pad_shape(shape, bucket):
    """The FFT working shape of a map: the survey's bucket (the 5-smooth
    sizes of its largest tile) where the map fills at least half of it,
    else the map's own 5-smooth sizes."""
    ny, nx = shape
    bH, bW = bucket
    if bH >= ny and bW >= nx and ny * nx >= 0.5 * bH * bW:
        return (bH, bW)
    return (good_fft_size(ny), good_fft_size(nx))


def apod_profile(n, width):
    prof = np.ones(n)
    ramp = (1 - np.cos(np.linspace(0, np.pi, width))) / 2
    prof[:width] = ramp
    prof[-width:] = ramp[::-1]
    return prof


def ang_sep_deg(ra0, dec0, ra1, dec1):
    ra0, dec0, ra1, dec1 = (np.radians(np.asarray(v, dtype=float))
                            for v in (ra0, dec0, ra1, dec1))
    a = np.sin((dec1 - dec0) / 2) ** 2 \
        + np.cos(dec0) * np.cos(dec1) * np.sin((ra1 - ra0) / 2) ** 2
    return np.degrees(2 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0))))


class Precision:
    """float64; or, for the control, float32 (the precision below the
    configuration's float64)."""

    def __init__(self, control=None):
        self.control = control
        self.real = torch.float32 if control else torch.float64


def _interp(x, xp, fp):
    """np.interp(x, xp, fp, left=fp[0], right=0) on tensors."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    f = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], torch.zeros_like(f), f)


def paint_centred(shape, scales, table, dev, prec):
    """scale * interp(r) of a radial table about (ny / 2, nx / 2)."""
    r, v, scale = table
    ny, nx = shape
    yy = (torch.arange(ny, dtype=torch.float64, device=dev) - ny / 2.0) \
        * scales[0]
    xx = (torch.arange(nx, dtype=torch.float64, device=dev) - nx / 2.0) \
        * scales[1]
    rr = torch.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
    out = _interp(rr, torch.as_tensor(r, device=dev),
                  torch.as_tensor(v, device=dev)) * scale
    return out.to(prec.real)


def pixel_window(m, power):
    """Multiply (power 1) or divide (power -1) the separable sinc pixel
    window in Fourier space over the last two axes."""
    ny, nx = m.shape[-2:]
    wy = torch.as_tensor(np.sinc(np.fft.fftfreq(ny)) ** power,
                         dtype=m.dtype, device=m.device)
    wx = torch.as_tensor(np.sinc(np.fft.rfftfreq(nx)) ** power,
                         dtype=m.dtype, device=m.device)
    return torch.fft.irfft2(torch.fft.rfft2(m) * (wy[:, None] * wx[None]),
                            s=(ny, nx))


def _gauss_smooth_reflect(m, sigma=3.0, truncate=4.0):
    """Separable Gaussian correlation of the last two axes, boundaries
    reflected with the edge pixel repeated (scipy.ndimage's 'reflect')."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    w = torch.as_tensor(w / w.sum(), dtype=m.dtype, device=m.device)
    for axis in (-2, -1):
        n = m.shape[axis]
        idx = torch.arange(-radius, n + radius, device=m.device) % (2 * n)
        idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
        p = torch.index_select(m, m.ndim + axis, idx).movedim(axis, -1)
        lead = p.shape[:-1]
        out = torch.nn.functional.conv1d(p.reshape(-1, 1, p.shape[-1]),
                                         w.reshape(1, 1, -1))
        m = out.reshape(lead + (n,)).movedim(-1, axis)
    return m


def cell_edges(n, grid):
    return np.linspace(0, n, int(n / grid + 1), dtype=int)


def cell_windows(ny, nx, grid):
    """(y0, y1, x0, x1) of each noise cell's window (cell plus half a
    cell of overlap on each side, clipped to the tile), in the order the
    cells are written."""
    ov = grid // 2
    ye, xe = cell_edges(ny, grid), cell_edges(nx, grid)
    out = []
    for i in range(len(ye) - 1):
        for k in range(len(xe) - 1):
            out.append((max(ye[i] - ov, 0), min(ye[i + 1] + ov, ny),
                        max(xe[k] - ov, 0), min(xe[k + 1] + ov, nx)))
    return out


def clipped_rms(values, valid, prec, n_iter=10):
    """3-sigma clipped RMS of each row of ``values`` over its valid
    entries (10 clips on |v| < |mean + 3 rms|, a clip that empties the
    set keeps the previous statistics); also the clip stages each row
    needs before its threshold repeats."""
    def stats(mask):
        n = mask.sum(dim=1)
        nn = torch.clamp(n, min=1).to(values.dtype)
        mf = mask.to(values.dtype)
        mean = (values * mf).sum(dim=1) / nn
        var = (mf * (values - mean[:, None]) ** 2).sum(dim=1) / nn
        return mean, torch.sqrt(var), n

    mean, rms, n0 = stats(valid)
    stages = torch.ones_like(n0)
    done = n0 == 0
    last = None
    for _ in range(n_iter):
        thr = torch.abs(mean + 3.0 * rms)
        if last is not None:
            done |= thr == last
        stages += (~done).to(stages.dtype)
        last = thr
        m = valid & (torch.abs(values) < thr[:, None])
        newMean, newRms, nm = stats(m)
        mean = torch.where(nm > 0, newMean, mean)
        rms = torch.where(nm > 0, newRms, rms)
    return torch.where(n0 > 0, rms, torch.zeros_like(rms)), stages


def rms_map(filtered, grid, prec):
    """Grid RMS map of a (ny, nx) filtered map (zero pixels invalid) and
    each cell's (pixels in its window, clip stages)."""
    ny, nx = filtered.shape
    wins = cell_windows(ny, nx, grid)
    hMax = max(y1 - y0 for y0, y1, _, _ in wins)
    wMax = max(x1 - x0 for _, _, x0, x1 in wins)
    vals = torch.zeros((len(wins), hMax * wMax), dtype=filtered.dtype,
                       device=filtered.device)
    valid = torch.zeros_like(vals, dtype=torch.bool)
    for c, (y0, y1, x0, x1) in enumerate(wins):
        blk = torch.zeros((hMax, wMax), dtype=filtered.dtype,
                          device=filtered.device)
        blk[:y1 - y0, :x1 - x0] = filtered[y0:y1, x0:x1]
        vals[c] = blk.reshape(-1)
        valid[c] = (blk != 0).reshape(-1)
    cells, stages = clipped_rms(vals, valid, prec)
    cells = cells.cpu().numpy()
    out = np.zeros((ny, nx))
    for c, (y0, y1, x0, x1) in enumerate(wins):
        if cells[c] > 0:
            out[y0:y1, x0:x1] = cells[c]
    extents = np.array([(y1 - y0) * (x1 - x0) for y0, y1, x0, x1 in wins])
    return out, extents, stages.cpu().numpy()


def spline_read(m, y, x):
    """Bicubic spline through a 33 x 33 window of ``m`` around (y, x),
    anchored at floor(pos) - 16 and clamped into the map, the window kept
    whole (as device detection reads it)."""
    ny, nx = m.shape
    P = 2 * SPLINE_HALF + 1
    y0 = int(np.clip(np.floor(y) - SPLINE_HALF, 0, max(ny - P, 0)))
    x0 = int(np.clip(np.floor(x) - SPLINE_HALF, 0, max(nx - P, 0)))
    y1, x1 = min(ny, y0 + P), min(nx, x0 + P)
    spl = RectBivariateSpline(np.arange(y0, y1), np.arange(x0, x1),
                              m[y0:y1, x0:x1], kx=3, ky=3)
    return float(spl(y, x)[0][0])


def noise_solve(maps, apod, padShape, dev, prec):
    """(A, fMaps): the band x band noise power of the apodised,
    zero-padded maps, smoothed on the full Fourier grid and cut to the
    real-transform half grid, as (PY, PX // 2 + 1, nf, nf); and the
    maps' half-grid transforms."""
    nf = maps.shape[0]
    PY, PX = padShape
    dataApod = pad(maps * apod[None], padShape, dev, prec)
    F = torch.fft.fft2(dataApod)
    prods = torch.real(F[:, None] * torch.conj(F[None, :]))
    N = _gauss_smooth_reflect(prods.reshape(nf * nf, PY, PX))
    N = N.reshape(nf, nf, PY, PX)[..., :PX // 2 + 1]
    return N.permute(2, 3, 0, 1), torch.fft.rfft2(dataApod)


def pad(a, padShape, dev, prec):
    """Zero-pad the last two axes of a host array up to ``padShape``."""
    a = torch.as_tensor(np.asarray(a), device=dev)
    out = torch.zeros(a.shape[:-2] + tuple(padShape), dtype=prec.real,
                      device=dev)
    out[..., :a.shape[-2], :a.shape[-1]] = a.to(prec.real)
    return out


def matched_filter(A, shape, padShape, scales, M500, z, bands, dev, prec):
    """filt = N^-1 (w |s|) on the half grid, (nf, PY, PX // 2 + 1): the
    templates painted at the map's centre at its true shape, zero-padded."""
    nf = A.shape[-1]
    w = torch.as_tensor([model.fSZ(f) for f, _ in bands], dtype=prec.real,
                        device=dev)
    tmpl = pad(torch.stack([
        paint_centred(shape, scales, model.template_table(M500, z, beam),
                      dev, prec) for _, beam in bands]).cpu().numpy(),
        padShape, dev, prec)
    S = torch.abs(torch.fft.rfft2(tmpl))
    b = S.permute(1, 2, 0) * w
    singular = torch.linalg.det(A) == 0
    Asafe = torch.where(singular[..., None, None],
                        torch.eye(nf, dtype=prec.real, device=dev), A)
    filt = torch.linalg.solve(Asafe, b)
    return torch.where(singular[..., None], torch.zeros_like(filt),
                       filt).permute(2, 0, 1)


def tail(filtered, ny, nx, survey, params, prec, dev, padShape=None):
    """The S/N stage of a filtered map (zero-padded to ``padShape`` or at
    its true shape): grid RMS on the true shape, S/N, the edge-trim,
    survey and apodisation masks and the pixel window undone on the
    masked signal.  Returns (SN, out, RMS, cell extents, clip stages)."""
    PY, PX = padShape or (ny, nx)
    f64 = filtered.to(torch.float64)
    f64[ny:] = 0
    f64[:, nx:] = 0
    RMS, extents, stages = rms_map(f64[:ny, :nx], params["gridPix"], prec)
    RMSpad = np.zeros((PY, PX))
    RMSpad[:ny, :nx] = RMS
    fNp = f64.cpu().numpy()
    psNp = np.zeros((PY, PX))
    psNp[:ny, :nx] = 1.0
    with np.errstate(divide="ignore", invalid="ignore"):
        SN = np.where(RMSpad > 0, fNp / np.maximum(RMSpad, 1e-30), 0.0)
    trim = params["trimPix"]
    if trim > 0:
        edge = ndimage.minimum_filter(np.abs(fNp + (1 - psNp)), size=trim,
                                      mode="reflect")
        edgeCheck = (edge > 0).astype(float)
    else:
        edgeCheck = np.ones_like(fNp)
    surveyPad = np.zeros((PY, PX))
    surveyPad[:ny, :nx] = survey
    apod = np.zeros((PY, PX))
    apod[:ny, :nx] = np.outer(apod_profile(ny, params["apodPix"]),
                              apod_profile(nx, params["apodPix"]))
    maskData = edgeCheck * surveyPad * psNp
    maskSN = maskData * (apod == 1)
    SN = SN * maskSN
    if prec.control:
        SN = torch.as_tensor(SN).to(prec.real).double().numpy()
    outMap = pixel_window(torch.as_tensor(fNp * maskData, device=dev),
                          -1.0).cpu().numpy()
    outMap = np.where(maskData != 0, outMap, 0.0)
    return SN, outMap, RMSpad * maskSN, extents, stages


def filter_tile(maps, surveyMask, scales, bank, phot, bands, params, dev,
                control=None):
    """Reference products of one tile through the Fourier matched filter.

    Args:
        maps: (nf, ny, nx) host array of the tile's band maps (uK).
        surveyMask: (ny, nx) host array.
        scales: (dy, dx) pixel scales at the tile centre, radians.
        bank: list of (label, M500, z) filters.
        phot: label of the photometry filter.
        bands: list of (freqGHz, beamPath) per band.
        params: dict with threshold, minObjPix, gridPix, trimPix, apodPix
            and the survey's FFT ``bucket``.
    Returns a dict: per label "filt" (nf, PY, PX // 2 + 1) float64 host,
    "signalNorm", "SN", "out", "RMS" (host (PY, PX) maps), "detections"
    (list of dicts y, x, SNR, numPix), "extents"/"stages" of the noise
    cells; and "shape", "padShape".
    """
    prec = Precision(control)
    nf, ny, nx = maps.shape
    padShape = pad_shape((ny, nx), params["bucket"])
    PY, PX = padShape
    apod = np.outer(apod_profile(ny, params["apodPix"]),
                    apod_profile(nx, params["apodPix"]))
    A, fMaps = noise_solve(maps, apod, padShape, dev, prec)
    cy, cx = ny // 2, nx // 2
    out = {"shape": (ny, nx), "padShape": padShape}
    for label, M500, z in bank:
        filt = matched_filter(A, (ny, nx), padShape, scales, M500, z, bands,
                              dev, prec)
        calib = pad(torch.stack([
            pixel_window(paint_centred(
                (ny, nx), scales,
                model.template_table(M500, z, beam,
                                     amplitude=model.y_to_uK(Y0, f)),
                dev, prec).to(torch.float64), 1.0)
            for f, beam in bands]).cpu().numpy(), padShape, dev, prec)
        fc = torch.fft.irfft2(torch.fft.rfft2(calib) * filt, s=padShape)
        peakBands = fc[:, cy, cx].to(torch.float64).cpu().numpy()
        peak = float(peakBands.sum())
        if peak == 0 or not np.isfinite(peak):
            peak = np.nan          # no calibration: the numbers fail
        filtered = torch.fft.irfft2(fMaps * filt, s=padShape).sum(0)
        SN, outMap, RMS, extents, stages = tail(
            filtered, ny, nx, surveyMask, params, prec, dev, padShape)
        out[label] = {
            "filt": filt.to(torch.float64).cpu().numpy(),
            "signalNorm": Y0 / peak, "scale": Y0 / peak,
            "SN": SN, "out": outMap, "RMS": RMS, "extents": extents,
            "stages": stages,
            "detections": detect(SN, params["threshold"],
                                 params["minObjPix"])}
    return out


def detect(SN, threshold, minObjPix):
    """4-connected components of S/N > threshold: S/N-weighted centroid,
    pixel count and the spline read of S/N at the centroid; kept when the
    component has more than ``minObjPix`` pixels and the read is above
    the threshold."""
    sig = SN > threshold
    lab, n = ndimage.label(sig)
    if n == 0:
        return []
    idx = np.arange(1, n + 1)
    wsum = ndimage.sum(SN, lab, idx)
    npix = ndimage.sum(sig, lab, idx)
    yy, xx = np.indices(SN.shape)
    ys = ndimage.sum(SN * yy, lab, idx) / wsum
    xs = ndimage.sum(SN * xx, lab, idx) / wsum
    out = []
    for y, x, k in zip(ys, xs, npix):
        if k <= minObjPix:
            continue
        snr = spline_read(SN, y, x)
        if snr > threshold:
            out.append({"y": float(y), "x": float(x), "SNR": snr,
                        "numPix": int(k)})
    return out


def optimal_rows(tileRef, bank, phot, pix2sky):
    """Rows of the optimal catalog of one tile: every filter's detections
    with the photometry filter's fixed_ reads, then the highest S/N kept
    within 1.4' (as nemo's makeOptimalCatalog)."""
    rows = []
    P = tileRef[phot]
    for label, _, _ in bank:
        for d in tileRef[label]["detections"]:
            ra, dec = pix2sky(d["x"], d["y"])
            fixedSNR = spline_read(P["SN"], d["y"], d["x"])
            val = spline_read(P["out"], d["y"], d["x"]) * P["scale"]
            rows.append(dict(d, template=label, RADeg=ra, decDeg=dec,
                             fixed_SNR=fixedSNR, fixed_y_c=val / 1e-4))
    if not rows:
        return []
    ra = np.array([r["RADeg"] for r in rows])
    dec = np.array([r["decDeg"] for r in rows])
    snr = np.array([r["SNR"] for r in rows])
    keep = np.ones(len(rows), dtype=bool)
    for i in range(len(rows)):
        near = np.nonzero(ang_sep_deg(ra[i], dec[i], ra, dec)
                          <= XMATCH_DEG)[0]
        if len(near) > 1:
            best = near[np.argmax(snr[near])]
            keep[near[near != best]] = False
    return [r for r, k in zip(rows, keep) if k]
