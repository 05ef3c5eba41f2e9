"""Local noise (RMS) map estimation on torch tensors.

Port of ``nemo_tpu/ops/noise.py``: the grid-cell 3-sigma-clipped RMS
estimator (reference ``MapFilter.makeNoiseMap``) with half-cell
overlapping windows whose overwrite order is reproduced by a host
candidate-cell plan.

The default estimator's per-cell statistics run through :func:`rms_cells`,
which launches the hand-written CUDA kernel ``csrc/rms_cells.cu`` (the
port of the TPU kernel ``_rms_cell_kernel``) on CUDA tensors and its plain
torch version :func:`_rms_cells_plain` on CPU tensors.  The kernel has two
variants, chosen by :func:`rms_cells_variant` from the window's bytes: the
window staged in shared memory, or streamed from L2 when it does not fit.
The per-tile host path is the kernel's batch of one tile (nT = 1).  The
percentile estimator stays in torch ops.
"""

import ctypes

import numpy as np
import torch

from .. import cuda_build


def cell_edges(n, gridSize):
    """Cell edges replicating the reference's chunking
    (``filters.py:417-422``): numChunks = n / gridSize (float),
    edges = linspace(0, n, int(numChunks + 1)) as ints."""
    numChunks = n / gridSize
    return np.linspace(0, n, int(numChunks + 1), dtype=int)


def _masked_mean_std(vals, mask):
    n = mask.sum(dim=1)
    safe_n = torch.clamp(n, min=1).to(vals.dtype)
    maskf = mask.to(vals.dtype)
    mean = (vals * maskf).sum(dim=1) / safe_n
    var = (maskf * (vals - mean[:, None]) ** 2).sum(dim=1) / safe_n
    return mean, torch.sqrt(var), n


def _cell_stats(windows, valid, n_iter=10, estimator="default"):
    """Per-cell RMS from (nCells, Wy*Wx) values + validity masks."""
    v = windows
    good = valid
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    if estimator == "percentile":
        # 68.3rd percentile of |values| over the valid set, matching
        # np.percentile's linear interpolation between order statistics.
        absv = torch.where(good, torch.abs(v),
                           torch.full_like(v, float("inf")))
        svals = torch.sort(absv, dim=1).values
        ngood = good.sum(dim=1)
        pos = 0.683 * (ngood - 1).to(v.dtype)
        lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, v.shape[1] - 1)
        hi = torch.clamp(lo + 1, 0, v.shape[1] - 1)
        whi = pos - lo.to(v.dtype)
        vlo = torch.gather(svals, 1, lo[:, None])[:, 0]
        vhi = torch.gather(svals, 1, hi[:, None])[:, 0]
        rms = vlo * (1 - whi) + vhi * whi
        rms = torch.where(ngood > 0, rms, zero)
        return torch.where(torch.isfinite(rms), rms, zero)

    # Default: 3-sigma clip (filters.py:468-477), seeded from the good
    # values, 10 iterations clipping on |v| < |mean + 3 std|; a clip that
    # empties the cell keeps the previous stats.
    mean, rms, n0 = _masked_mean_std(v, good)
    for _ in range(n_iter):
        clip = torch.abs(v) < torch.abs(mean + 3.0 * rms)[:, None]
        m = good & clip
        new_mean, new_rms, nm = _masked_mean_std(v, m)
        keep = nm > 0
        mean = torch.where(keep, new_mean, mean)
        rms = torch.where(keep, new_rms, rms)
    return torch.where(n0 > 0, rms, zero)


# -----------------------------------------------------------------------------
# The kernel: per-cell clipped RMS over windows of a padded map batch.

def _check_rms_cells_args(padded, tables, window):
    if not isinstance(padded, torch.Tensor) or padded.ndim != 3:
        raise ValueError("padded must be a (nT, PY, PX) tensor")
    if padded.dtype not in (torch.float32, torch.float64):
        raise ValueError("padded must be float32 or float64, got %s"
                         % padded.dtype)
    if not padded.is_contiguous():
        raise ValueError("padded must be contiguous")
    shape = tables[0].shape
    if len(shape) != 2 or shape[0] != padded.shape[0]:
        raise ValueError("cell tables must be (nT, nCells) with nT = %d"
                         % padded.shape[0])
    for t in tables:
        if t.dtype != torch.int32 or t.shape != shape \
                or t.device != padded.device or not t.is_contiguous():
            raise ValueError("cell tables must be contiguous int32 (nT, "
                             "nCells) tensors on the map's device")
    Wy, Wx = (int(w) for w in window)
    if Wy <= 0 or Wx <= 0:
        raise ValueError("window must be positive, got %r" % (window,))
    return Wy, Wx


def rms_cells(padded, starts_y, starts_x, lens_y, lens_x, window):
    """Per-cell 3-sigma-clipped RMS of a padded map batch.

    Args:
        padded: (nT, PY, PX) float32/float64 contiguous maps, zero outside
            the data (zero pixels are invalid by definition).
        starts_y/x: int32 (nT, nCells) window anchors in ``padded``.
        lens_y/x: int32 (nT, nCells) effective window extents
            (cell length + 2 * overlap; 0 marks an unused slot, whose RMS
            comes back 0).
        window: (Wy, Wx) bound on the extents (a longer extent is cut to
            it, as the TPU kernel's fixed window does).  It sizes the
            kernel's variant (:func:`rms_cells_variant`), so pass the
            largest extent in the tables rather than a looser bound.
    Returns:
        (nT, nCells) cell RMS in ``padded``'s dtype, on its device.

    A CUDA tensor launches ``csrc/rms_cells.cu`` in the variant
    :func:`rms_cells_variant` picks (and raises if the build, load or
    launch fails); a CPU tensor runs :func:`_rms_cells_plain`.
    """
    tables = (starts_y, starts_x, lens_y, lens_x)
    window = _check_rms_cells_args(padded, tables, window)
    if padded.device.type == "cpu":
        return _rms_cells_plain(padded, *tables, window)
    if padded.device.type == "cuda":
        return _rms_cells_cuda(padded, *tables, window)
    raise ValueError("rms_cells runs on cpu or cuda tensors, not %s"
                     % padded.device)


rms_cells.launches = 0
rms_cells.largest_nT = 0     # largest tile batch a launch has seen
rms_cells.variant_launches = {"staged": 0, "streaming": 0}

# Shared memory a staged window may take: the 232,448 B an H100 block may
# use, less the static reduction scratch (csrc/rms_cells.cu,
# kStagedMaxWindowBytes, checked against the library at load).
STAGED_MAX_WINDOW_BYTES = 232448 - 1024


def rms_cells_variant(window, dtype):
    """The kernel variant for a (Wy, Wx) window bound of ``dtype`` values:
    ``"staged"`` (the window copied into shared memory once) when it fits,
    else ``"streaming"`` (re-read from L2 on every sweep)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = int(window[0]) * int(window[1]) * itemsize
    return "staged" if nbytes <= STAGED_MAX_WINDOW_BYTES else "streaming"


_KERNELS = {("staged", torch.float32): "nemo_rms_cells_staged_f32",
            ("staged", torch.float64): "nemo_rms_cells_staged_f64",
            ("streaming", torch.float32): "nemo_rms_cells_f32",
            ("streaming", torch.float64): "nemo_rms_cells_f64"}


def _declare(lib):
    for name in _KERNELS.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p, ctypes.c_void_p]
    lib.nemo_rms_cells_staged_max_bytes.restype = ctypes.c_int
    lib.nemo_rms_cells_staged_max_bytes.argtypes = []
    if lib.nemo_rms_cells_staged_max_bytes() != STAGED_MAX_WINDOW_BYTES:
        raise RuntimeError("csrc/rms_cells.cu and ops/noise.py disagree on "
                           "the staged window limit")


def load_kernel():
    """Build (first call) and load the kernel library."""
    return cuda_build.load_library("rms_cells.cu", _declare)


def _rms_cells_cuda(padded, starts_y, starts_x, lens_y, lens_x, window,
                    variant=None):
    """Launch the kernel; ``variant`` (default :func:`rms_cells_variant`)
    is given explicitly only to time one variant against the other."""
    if not padded.is_cuda:
        raise ValueError("the CUDA rms_cells kernel needs CUDA tensors")
    if variant is None:
        variant = rms_cells_variant(window, padded.dtype)
    lib = load_kernel()
    nT, PY, PX = padded.shape
    nCells = starts_y.shape[1]
    Wy, Wx = window
    out = torch.empty((nT, nCells), dtype=padded.dtype, device=padded.device)
    fn = getattr(lib, _KERNELS[(variant, padded.dtype)])
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(padded.data_ptr(), starts_y.data_ptr(), starts_x.data_ptr(),
                 lens_y.data_ptr(), lens_x.data_ptr(), nT, nCells, PY, PX,
                 Wy, Wx, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("rms_cells %s kernel launch failed: CUDA error "
                           "%d" % (variant, err))
    rms_cells.launches += 1
    rms_cells.variant_launches[variant] += 1
    rms_cells.largest_nT = max(rms_cells.largest_nT, nT)
    return out


def _gather_windows(padded, starts_y, starts_x, lens_y, lens_x, window):
    """Every cell window of ``padded`` as (nT * nCells, Wy * Wx) values and
    validity (nonzero, inside the extent and inside the map)."""
    nT, PY, PX = padded.shape
    Wy, Wx = window
    dev = padded.device
    ar_y = torch.arange(Wy, device=dev)
    ar_x = torch.arange(Wx, device=dev)
    iy = starts_y.to(torch.int64)[..., None] + ar_y          # (nT, nC, Wy)
    ix = starts_x.to(torch.int64)[..., None] + ar_x
    in_y = (ar_y < lens_y[..., None]) & (iy >= 0) & (iy < PY)
    in_x = (ar_x < lens_x[..., None]) & (ix >= 0) & (ix < PX)
    tile = torch.arange(nT, device=dev)[:, None, None, None] * (PY * PX)
    idx = tile + iy.clamp(0, PY - 1)[..., :, None] * PX \
        + ix.clamp(0, PX - 1)[..., None, :]
    windows = padded.reshape(-1)[idx]                        # (nT,nC,Wy,Wx)
    valid = (windows != 0) & in_y[..., :, None] & in_x[..., None, :]
    n = nT * starts_y.shape[1]
    return windows.reshape(n, -1), valid.reshape(n, -1)


def _rms_cells_plain(padded, starts_y, starts_x, lens_y, lens_x, window):
    """Plain torch version of the kernel (same inputs, same semantics):
    gathers every window, masks, and runs :func:`_cell_stats`."""
    _rms_cells_plain.calls += 1
    windows, valid = _gather_windows(padded, starts_y, starts_x, lens_y,
                                     lens_x, window)
    return _cell_stats(windows, valid).reshape(starts_y.shape)


_rms_cells_plain.calls = 0


def _int32_table(a, nT, device):
    t = torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)
    if t.ndim == 1:
        t = t[None].expand(nT, -1)
    return t.contiguous()


# -----------------------------------------------------------------------------
def _expansion_plan(edges, n, npix, ov):
    """Static per-pixel candidate cells as run-length repeat plans.

    Returns (repeats0, valid0, repeats1, valid1): for the highest-priority
    (latest-written) covering cell c0 and the runner-up c1, the number of
    pixels mapped to each cell index (in order) plus validity masks.
    """
    pix = np.arange(npix)
    c0 = np.full(npix, -1)
    c1 = np.full(npix, -1)
    for i in range(n):
        cover = (pix >= edges[i] - ov) & (pix < edges[i + 1] + ov)
        c1[cover] = c0[cover]
        c0[cover] = i

    def plan(c):
        valid = c >= 0
        cc = np.clip(c, 0, n - 1)
        repeats = np.bincount(cc, minlength=n)
        return repeats, valid

    r0, v0 = plan(c0)
    r1, v1 = plan(c1)
    return (r0, v0, r1, v1)


def _assemble_rms(cellRMS, plan_y, plan_x, ny, nx):
    """Reference overwrite-order semantics via repeat expansion: priority
    (r0,c0) > (r0,c1) > (r1,c0) > (r1,c1); a zero cell RMS exposes the next
    candidate (filters.py:480-481)."""
    ry0, vy0, ry1, vy1 = plan_y
    rx0, vx0, rx1, vx1 = plan_x
    dev = cellRMS.device

    def expand(reps_y, reps_x):
        up = torch.repeat_interleave(
            cellRMS, torch.as_tensor(reps_y, device=dev), dim=0,
            output_size=ny)
        return torch.repeat_interleave(
            up, torch.as_tensor(reps_x, device=dev), dim=1, output_size=nx)

    out = torch.zeros((ny, nx), dtype=cellRMS.dtype, device=dev)
    for reps_y, vy, reps_x, vx in ((ry1, vy1, rx1, vx1),
                                   (ry1, vy1, rx0, vx0),
                                   (ry0, vy0, rx1, vx1),
                                   (ry0, vy0, rx0, vx0)):
        v = expand(reps_y, reps_x)
        ok = torch.as_tensor(vy, device=dev)[:, None] \
            & torch.as_tensor(vx, device=dev)[None, :] & (v > 0)
        out = torch.where(ok, v, out)
    return out


def _grid_geometry(ny, nx, gridSize, overlap_pix):
    ov = int(gridSize // 2) if overlap_pix is None else int(overlap_pix)
    ye = cell_edges(ny, gridSize)
    xe = cell_edges(nx, gridSize)
    nCy, nCx = len(ye) - 1, len(xe) - 1
    # fixed window covering the largest cell + overlap
    Wy = int(np.diff(ye).max() + 2 * ov)
    Wx = int(np.diff(xe).max() + 2 * ov)
    # anchors in the padded map (edge - ov + ov) and effective extents,
    # flattened in write order
    tables = (np.repeat(ye[:-1], nCx), np.tile(xe[:-1], nCy),
              np.repeat(np.diff(ye), nCx) + 2 * ov,
              np.tile(np.diff(xe), nCy) + 2 * ov)
    return ov, ye, xe, (Wy, Wx), tables


def _grid_cells(mapBatch, gridSize, overlap_pix, estimator, n_iter):
    """(nT, nCy, nCx) cell RMS on the batch's own (ny, nx) grid."""
    nT, ny, nx = mapBatch.shape
    ov, ye, xe, (Wy, Wx), tables = _grid_geometry(ny, nx, gridSize,
                                                  overlap_pix)
    nCy, nCx = len(ye) - 1, len(xe) - 1
    # zero padding self-masks: zero pixels are invalid by definition
    padded = torch.nn.functional.pad(mapBatch, (ov, Wx, ov, Wy)).contiguous()
    tabs = [_int32_table(a, nT, mapBatch.device) for a in tables]
    # the kernel runs the default clip with its fixed 10 iterations (as
    # the TPU kernel); other estimators stay in torch ops
    if estimator == "default" and n_iter == 10:
        cells = rms_cells(padded, *tabs, (Wy, Wx))
    else:
        windows, valid = _gather_windows(padded, *tabs, (Wy, Wx))
        cells = _cell_stats(windows, valid, n_iter, estimator)
    return cells.reshape(nT, nCy, nCx), (ye, xe, ov)


def grid_rms_map(mapData, gridSize_pix, overlap_pix=None, estimator="default",
                 n_iter=10, return_cells=False):
    """Estimate the noise map over grid cells (numNoiseBins = 1 path).

    Args:
        mapData: 2-d filtered map tensor (nonzero pixels define the valid
            area).
        gridSize_pix: cell size in pixels (from noiseGridArcmin).
        overlap_pix: window overlap; defaults to gridSize // 2.
        estimator: 'default' (3-sigma clip) or 'percentile'.
        return_cells: return the (nCy, nCx) per-cell RMS grid instead of
            the full-resolution map.
    Returns:
        RMS map tensor, same shape (or the cell grid with ``return_cells``).
    """
    ny, nx = mapData.shape
    cells, (ye, xe, ov) = _grid_cells(mapData[None], int(gridSize_pix),
                                      overlap_pix, estimator, n_iter)
    cellRMS = cells[0]
    if return_cells:
        return cellRMS
    nCy, nCx = cellRMS.shape
    return _assemble_rms(cellRMS, _expansion_plan(ye, nCy, ny, ov),
                         _expansion_plan(xe, nCx, nx, ov), ny, nx)


def whole_map_rms(mapData, estimator="default", n_iter=10):
    """Single-cell variant (noiseGridArcmin = None path): the whole map is
    one cell, and the whole map is filled with its RMS (masks are
    re-applied later)."""
    ny, nx = mapData.shape
    if estimator == "default" and n_iter == 10:
        tabs = [_int32_table(a, 1, mapData.device)
                for a in ([0], [0], [ny], [nx])]
        rms = rms_cells(mapData[None].contiguous(), *tabs, (ny, nx))[0, 0]
    else:
        flat = mapData.reshape(1, -1)
        rms = _cell_stats(flat, flat != 0, n_iter, estimator)[0]
    return rms * torch.ones_like(mapData)


def assemble_rms_host(cellRMS, ny, nx, gridSize_pix, overlap_pix=None):
    """Host (numpy) expansion of a per-cell RMS grid to full resolution,
    numerically identical to the device ``_assemble_rms`` path."""
    cellRMS = np.asarray(cellRMS)
    nCy, nCx = cellRMS.shape
    gridSize = int(gridSize_pix)
    ov = int(gridSize // 2) if overlap_pix is None else int(overlap_pix)
    ye = cell_edges(ny, gridSize)
    xe = cell_edges(nx, gridSize)
    ry0, vy0, ry1, vy1 = _expansion_plan(ye, nCy, ny, ov)
    rx0, vx0, rx1, vx1 = _expansion_plan(xe, nCx, nx, ov)

    def expand(reps_y, reps_x):
        up = np.repeat(cellRMS, reps_y, axis=0)
        return np.repeat(up, reps_x, axis=1)

    out = np.zeros((ny, nx), dtype=cellRMS.dtype)
    for reps_y, vy, reps_x, vx in ((ry1, vy1, rx1, vx1),
                                   (ry1, vy1, rx0, vx0),
                                   (ry0, vy0, rx1, vx1),
                                   (ry0, vy0, rx0, vx0)):
        v = expand(reps_y, reps_x)
        ok = vy[:, None] & vx[None, :] & (v > 0)
        out[ok] = v[ok]
    return out


def n_cells(n, gridSize):
    """Cell count along one axis of an n-pixel tile (cell_edges' chunking;
    a tile smaller than one grid cell degenerates to a single cell)."""
    return max(len(cell_edges(int(n), int(gridSize))) - 1, 1)


def meta_window(gridSize_pix, padShape, overlap_pix=None):
    """Static (Wy, Wx, ov) window bounds for the per-tile (meta)
    estimator: linspace integer cell edges over any n <= padN give a max
    cell size <= min(padN, 2g), so one window covers every true tile shape
    a padShape bucket can hold."""
    g = int(gridSize_pix)
    ov = g // 2 if overlap_pix is None else int(overlap_pix)
    wy = min(int(padShape[0]), 2 * g) + 2 * ov
    wx = min(int(padShape[1]), 2 * g) + 2 * ov
    return wy, wx, ov


def cell_meta(shape, padShape, gridSize_pix, overlap_pix=None):
    """Per-tile noise-cell geometry at the tile's TRUE shape, padded to
    the static bounds implied by ``padShape``.

    Cell edges are linspace fractions of the TRUE tile dims (as the host
    engine lays them out); shipping each tile's geometry as data lets one
    padded batch carry tiles of different true shapes.

    Returns a dict of numpy arrays (stack over tiles, pass as ``meta`` to
    :func:`grid_rms_map_batch`):
      startsY/startsX/lensY/lensX: (nCellMax,) int32 flattened write-order
          cell anchors/extents (0-length = unused slot);
      c0y/c1y: (padNy,) int32 per-pixel highest/runner-up candidate cell
          row (-1 = none, incl. all padding rows); c0x/c1x likewise.
    """
    g = int(gridSize_pix)
    Wy, Wx, ov = meta_window(g, padShape, overlap_pix)
    ny, nx = int(shape[0]), int(shape[1])
    pNy, pNx = int(padShape[0]), int(padShape[1])
    nCyM, nCxM = n_cells(pNy, g), n_cells(pNx, g)

    def axis(n, npad, nCM, W):
        e = cell_edges(n, g)
        if len(e) < 2:
            e = np.array([0, n], dtype=int)
        nC = len(e) - 1
        if nC > nCM or (np.diff(e).max() + 2 * ov) > W:
            raise ValueError(
                "tile shape %r incompatible with the cell bounds of "
                "padShape %r (gridSize %d)" % (tuple(shape),
                                               tuple(padShape), g))
        starts = np.zeros(nCM, np.int32)
        lens = np.zeros(nCM, np.int32)
        starts[:nC] = e[:-1]
        lens[:nC] = np.diff(e)
        pix = np.arange(n)
        c0 = np.full(n, -1)
        c1 = np.full(n, -1)
        for i in range(nC):
            cover = (pix >= e[i] - ov) & (pix < e[i + 1] + ov)
            c1[cover] = c0[cover]
            c0[cover] = i
        c0p = np.full(npad, -1, np.int32)
        c1p = np.full(npad, -1, np.int32)
        c0p[:n] = c0
        c1p[:n] = c1
        return starts, lens, c0p, c1p

    sy, ly, c0y, c1y = axis(ny, pNy, nCyM, Wy)
    sx, lx, c0x, c1x = axis(nx, pNx, nCxM, Wx)
    startsY = np.repeat(sy, nCxM)
    startsX = np.tile(sx, nCyM)
    lensY = np.repeat(ly, nCxM)
    lensX = np.tile(lx, nCyM)
    unused = (lensY == 0) | (lensX == 0)
    lensY[unused] = 0
    lensX[unused] = 0
    return {"startsY": startsY.astype(np.int32),
            "startsX": startsX.astype(np.int32),
            "lensY": lensY.astype(np.int32),
            "lensX": lensX.astype(np.int32),
            "c0y": c0y, "c1y": c1y, "c0x": c0x, "c1x": c1x}


def cell_meta_batch(shapes, padShape, gridSize_pix, overlap_pix=None):
    """Stacked :func:`cell_meta` for a tile batch (dict of (nT, ...) numpy
    arrays, ready to pass as ``meta``)."""
    cache = {}
    metas = []
    for s in shapes:
        key = (int(s[0]), int(s[1]))
        if key not in cache:
            cache[key] = cell_meta(key, padShape, gridSize_pix,
                                   overlap_pix)
        metas.append(cache[key])
    return {k: np.stack([m[k] for m in metas]) for k in metas[0]}


def meta_cell_tables(meta, gridSize_pix, padShape, nT, device,
                     overlap_pix=None):
    """The :func:`rms_cells` arguments of a ``meta`` layout: the int32
    (starts_y, starts_x, lens_y, lens_x) tables on ``device`` (extents are
    cell length + 2 * overlap, 0 for an unused slot), the window (the
    largest extent in the tables, never more than :func:`meta_window`'s
    bound) and the (left, right, top, bottom) zero padding of the map."""
    Wy, Wx, ov = meta_window(gridSize_pix, padShape, overlap_pix)
    lensY = np.asarray(meta["lensY"])
    lensX = np.asarray(meta["lensX"])
    # unused slots (len 0) mask out entirely, not keep the 2*ov margin
    effY = np.where(lensY > 0, lensY + 2 * ov, 0)
    effX = np.where(lensX > 0, lensX + 2 * ov, 0)
    tabs = [_int32_table(a, nT, device) for a in (
        meta["startsY"], meta["startsX"], effY, effX)]
    window = (max(min(int(effY.max(initial=0)), Wy), 1),
              max(min(int(effX.max(initial=0)), Wx), 1))
    return tabs, window, (ov, Wx, ov, Wy)


def _assemble_rms_meta(cells, c0y, c1y, c0x, c1x):
    """Expand one tile's (nCy, nCx) cell grid to the padded pixel grid from
    per-pixel candidate indices, with _assemble_rms' overwrite priority
    ((r0,c0) > (r0,c1) > (r1,c0) > (r1,c1); a zero cell exposes the next
    candidate).  A gather where the JAX package uses one-hot matmuls: both
    are exact (each output is one cell value)."""
    dev = cells.device
    c0y, c1y, c0x, c1x = (torch.as_tensor(np.asarray(c, dtype=np.int64),
                                          device=dev)
                          for c in (c0y, c1y, c0x, c1x))

    def pick(cy, cx):
        v = cells[cy.clamp(min=0)][:, cx.clamp(min=0)]
        ok = (cy >= 0)[:, None] & (cx >= 0)[None, :]
        return torch.where(ok, v, torch.zeros_like(v))

    out = torch.zeros((c0y.shape[0], c0x.shape[0]), dtype=cells.dtype,
                      device=dev)
    for cy, cx in ((c1y, c1x), (c1y, c0x), (c0y, c1x), (c0y, c0x)):
        v = pick(cy, cx)
        out = torch.where(v > 0, v, out)
    return out


def grid_rms_map_batch(mapBatch, gridSize_pix, overlap_pix=None,
                       return_cells=False, meta=None):
    """Batched noise-map estimation (nT, ny, nx) -> (nT, ny, nx) through
    :func:`rms_cells`.  With ``return_cells`` the (nT, nCy, nCx) per-cell
    grid is returned instead (expand with :func:`assemble_rms_host`).

    ``meta`` (dict of stacked (nT, ...) arrays from :func:`cell_meta`)
    lays each tile's cells out on its TRUE shape (host-engine exact) inside
    the padded batch; without it the grid is laid out on ``mapBatch``'s
    own shape."""
    if mapBatch.ndim == 2:
        mapBatch = mapBatch[None]
    nT, ny, nx = mapBatch.shape
    gridSize = int(gridSize_pix)
    if meta is None:
        cells, (ye, xe, ov) = _grid_cells(mapBatch, gridSize, overlap_pix,
                                          "default", 10)
        if return_cells:
            return cells
        nCy, nCx = cells.shape[1:]
        plan_y = _expansion_plan(ye, nCy, ny, ov)
        plan_x = _expansion_plan(xe, nCx, nx, ov)
        return torch.stack([_assemble_rms(c, plan_y, plan_x, ny, nx)
                            for c in cells])

    nCy, nCx = n_cells(ny, gridSize), n_cells(nx, gridSize)
    tabs, window, pad = meta_cell_tables(meta, gridSize, (ny, nx), nT,
                                         mapBatch.device, overlap_pix)
    padded = torch.nn.functional.pad(mapBatch, pad).contiguous()
    cells = rms_cells(padded, *tabs, window).reshape(nT, nCy, nCx)
    if return_cells:
        return cells
    return torch.stack([
        _assemble_rms_meta(cells[i], meta["c0y"][i], meta["c1y"][i],
                           meta["c0x"][i], meta["c1x"][i])
        for i in range(nT)])
