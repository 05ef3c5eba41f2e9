"""On-device object detection: connected components + segment statistics.

Port of ``nemo_tpu/ops/detect.py``, the device replacement for the host
detection stage (scipy ``ndimage.label`` / ``center_of_mass`` /
``maximum_position``): the S/N map is segmented on the device and only
O(K) per-object statistics and sub-pixel reads come back to the host.

Algorithm (as the JAX package):

1. ``sigPix = SNMap > threshold``.
2. Connected components by 128 fixed passes of 4-neighbour label
   minimisation (Jacobi: every pass reads the previous pass's labels).  A
   component needing more passes splits, exactly as in the reference
   package; the optimal catalog's position dedup removes the duplicates.
   On CUDA tensors :func:`label_components_batch` launches the
   hand-written kernel ``csrc/label_components.cu`` (16 passes per launch
   in shared memory); on CPU tensors its plain torch version.
3. Each component's root (minimum flat index) is one object; a pixel's
   bucket is the ordinal of its root among all roots in flat order (an
   exclusive cumsum gathered at the label).  Roots beyond ``max_objects``
   go to an overflow bucket, and ``nObjects`` reports the true count.
4. Per-object statistics over a compacted buffer of the significant
   pixels (the JAX package's TPU formulation, ``compact``): the count and
   value-weighted sums are one one-hot matmul per tile (deterministic, no
   float atomics), the peak and first-maximum index are
   ``scatter_reduce`` max/min (exact in any order).  The buffer's size
   comes from one host sync per call; a tile with more than ``max_pix``
   significant pixels is forced over the object budget, so the caller
   falls back to host detection for it.

Every function takes a leading tile axis (the batch); the unbatched names
of the JAX package are thin wrappers over it.
"""

import ctypes
import threading

import numpy as np
import torch

from .. import cuda_build

_BIG = 2 ** 30
_INT32_MAX = int(np.iinfo(np.int32).max)
_MAXPIX = 65536     # per-map significant-pixel budget (JAX compact impl)


def label_components_batch(mask, n_iter=128):
    """4-connected component labels of a (T, ny, nx) bool mask: for mask
    pixels the minimum flat index of the component (after ``n_iter``
    passes), ``_BIG`` elsewhere.  int32.

    A CUDA tensor launches ``csrc/label_components.cu`` (and raises if the
    build, load or launch fails); a CPU tensor runs
    :func:`_label_components_plain`."""
    if not isinstance(mask, torch.Tensor) or mask.ndim != 3 \
            or mask.dtype != torch.bool:
        raise ValueError("mask must be a (T, ny, nx) bool tensor")
    n_iter = int(n_iter)
    if n_iter < 0:
        raise ValueError("n_iter must be >= 0, got %d" % n_iter)
    if mask.shape[1] * mask.shape[2] >= _BIG:
        raise ValueError("a map of %d x %d pixels overflows the int32 labels"
                         % tuple(mask.shape[1:]))
    if mask.device.type == "cpu":
        return _label_components_plain(mask, n_iter)
    if mask.device.type == "cuda":
        return _label_components_cuda(mask, n_iter)
    raise ValueError("label_components runs on cpu or cuda tensors, not %s"
                     % mask.device)


label_components_batch.launches = 0
label_components_batch.device_launches = {}  # launches by device
_COUNT_LOCK = threading.Lock()


def _declare_labels(lib):
    lib.nemo_label_passes_per_launch.restype = ctypes.c_int
    lib.nemo_label_passes_per_launch.argtypes = []
    fn = lib.nemo_label_components
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]


def load_label_kernel():
    """Build (first call) and load the labelling kernel's library."""
    return cuda_build.load_library("label_components.cu", _declare_labels)


def label_launch_count(n_iter, passes_per_launch):
    """Grid launches of one labelling call: one per ``passes_per_launch``
    passes, the last running the remainder (at least one launch, which
    turns the mask into initial labels)."""
    return max(1, -(-int(n_iter) // int(passes_per_launch)))


def _label_components_cuda(mask, n_iter):
    if not mask.is_cuda:
        raise ValueError("the CUDA label_components kernel needs CUDA tensors")
    lib = load_label_kernel()
    mask = mask.contiguous()
    T, ny, nx = mask.shape
    launches = label_launch_count(n_iter, lib.nemo_label_passes_per_launch())
    bufs = torch.empty((2, T, ny, nx), dtype=torch.int32, device=mask.device)
    changed = torch.zeros(launches, dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nemo_label_components(
            mask.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            changed.data_ptr(), T, ny, nx, n_iter, stream)
    if err != 0:
        raise RuntimeError("label_components kernel launch failed: CUDA "
                           "error %d" % err)
    with _COUNT_LOCK:     # shards on several cards launch from threads
        label_components_batch.launches += 1
        key = str(mask.device)
        label_components_batch.device_launches[key] = \
            label_components_batch.device_launches.get(key, 0) + 1
    return bufs[(launches - 1) % 2]


def _label_components_plain(mask, n_iter=128):
    """Plain torch version of the kernel: ``n_iter`` whole-batch Jacobi
    passes, each a copy, four in-place shifted minima and a mask fill."""
    _label_components_plain.calls += 1
    T, ny, nx = mask.shape
    flat = torch.arange(ny * nx, dtype=torch.int32,
                        device=mask.device).reshape(ny, nx)
    big = torch.full((), _BIG, dtype=torch.int32, device=mask.device)
    notMask = ~mask
    lab = torch.where(mask, flat, big)
    new = torch.empty_like(lab)
    for _ in range(n_iter):
        new.copy_(lab)
        new[:, :-1, :].clamp_(max=lab[:, 1:, :])
        new[:, 1:, :].clamp_(max=lab[:, :-1, :])
        new[:, :, :-1].clamp_(max=lab[:, :, 1:])
        new[:, :, 1:].clamp_(max=lab[:, :, :-1])
        new.masked_fill_(notMask, _BIG)
        lab, new = new, lab
    return lab


_label_components_plain.calls = 0


def label_components(mask, n_iter=128):
    """:func:`label_components_batch` of one 2-d mask."""
    return label_components_batch(mask[None], n_iter=n_iter)[0]


def detect_objects_batch(SNBatch, threshold, max_objects=128, n_iter=128,
                         max_pix=None):
    """Segment a (T, ny, nx) batch of masked S/N maps and reduce per-object
    statistics (see the module docstring).

    Returns a dict of (T, K) tensors: valid (bool), numPix, comY, comX
    (value-weighted centroid), peak, peakY, peakX (first maximum in scan
    order, float32), plus (T,) int32 nObjects.  Position entries of
    invalid buckets are unspecified (as in the JAX package).
    """
    if max_pix is None:
        max_pix = _MAXPIX
    T, ny, nx = SNBatch.shape
    N = ny * nx
    K, K1 = int(max_objects), int(max_objects) + 1
    dev, dt = SNBatch.device, SNBatch.dtype
    mask = SNBatch > threshold
    labels = label_components_batch(mask, n_iter=n_iter)
    flat = torch.arange(N, dtype=torch.int32, device=dev)
    maskFlat = mask.reshape(T, N)
    labFlat = labels.reshape(T, N)
    rootFlat = maskFlat & (labFlat == flat)
    nObjects = rootFlat.sum(dim=1, dtype=torch.int32)
    rootI = rootFlat.to(torch.int32)
    ordFlat = (torch.cumsum(rootI, dim=1) - rootI).to(torch.int32)
    bRaw = torch.gather(ordFlat, 1, torch.where(
        maskFlat, labFlat, torch.zeros_like(labFlat)).long())
    inBucket = maskFlat & (bRaw < K)
    seg = torch.where(inBucket, bRaw, torch.full_like(bRaw, K))

    # Compact the significant pixels per tile (flat order), one host sync.
    nSigPix = maskFlat.sum(dim=1, dtype=torch.int32)
    tIdx, pIdx = torch.nonzero(maskFlat, as_tuple=True)
    C = min(int(nSigPix.max()) if T else 0, int(max_pix))
    C = max(C, 1)
    start = torch.cumsum(nSigPix, 0) - nSigPix
    pos = torch.arange(tIdx.shape[0], device=dev) - start[tIdx]
    keep = pos < C
    tIdx, pIdx, pos = tIdx[keep], pIdx[keep], pos[keep]
    v = torch.zeros((T, C), dtype=dt, device=dev)
    segc = torch.full((T, C), K, dtype=torch.int64, device=dev)
    idxc = torch.zeros((T, C), dtype=torch.int64, device=dev)
    inb = torch.zeros((T, C), dtype=torch.bool, device=dev)
    occupied = torch.zeros((T, C), dtype=dt, device=dev)
    v[tIdx, pos] = SNBatch.reshape(T, N)[tIdx, pIdx]
    segc[tIdx, pos] = seg[tIdx, pIdx].long()
    idxc[tIdx, pos] = pIdx
    inb[tIdx, pos] = inBucket[tIdx, pIdx]
    occupied[tIdx, pos] = 1.0
    yy = torch.div(idxc, nx, rounding_mode="floor").to(dt)
    xx = torch.remainder(idxc, nx).to(dt)
    data4 = torch.stack([occupied, v, v * yy, v * xx], dim=2)    # (T, C, 4)
    oneHot = (segc[:, :, None] == torch.arange(K1, device=dev)).to(dt)
    sums = torch.bmm(oneHot.transpose(1, 2), data4)[:, :K]        # (T, K, 4)
    segIn = torch.where(inb, segc, torch.full_like(segc, K))
    peak = torch.full((T, K1), float("-inf"), dtype=dt, device=dev)
    peak.scatter_reduce_(1, segIn, torch.where(
        inb, v, torch.full_like(v, float("-inf"))), "amax",
        include_self=True)
    atPeak = inb & (v == torch.gather(peak, 1, segIn))
    peakIdx = torch.full((T, K1), _INT32_MAX, dtype=torch.int64, device=dev)
    peakIdx.scatter_reduce_(1, segIn, torch.where(
        atPeak, idxc, torch.full_like(idxc, _INT32_MAX)), "amin",
        include_self=True)
    peak, peakIdx = peak[:, :K], peakIdx[:, :K]
    nObjects = torch.where(nSigPix > max_pix,
                           torch.clamp(nObjects, min=K + 1), nObjects)

    count, sumV, sumVY, sumVX = sums.unbind(dim=2)
    safe = torch.clamp(sumV, min=1e-30)
    return {"valid": count > 0, "numPix": count,
            "comY": sumVY / safe, "comX": sumVX / safe, "peak": peak,
            "peakY": torch.div(peakIdx, nx,
                               rounding_mode="floor").to(torch.float32),
            "peakX": torch.remainder(peakIdx, nx).to(torch.float32),
            "nObjects": nObjects}


def detect_objects(SNMap, threshold, max_objects=128, n_iter=128,
                   max_pix=None):
    """:func:`detect_objects_batch` of one 2-d S/N map ((K,) outputs and a
    0-d nObjects)."""
    out = detect_objects_batch(SNMap[None], threshold,
                               max_objects=max_objects, n_iter=n_iter,
                               max_pix=max_pix)
    return {k: v[0] for k, v in out.items()}


def _anchors(pos, n, P, window):
    """Window origins ``clip(floor(pos) - window, 0, max(n - P, 0))`` (the
    anchoring of ``interp.subpixel_values``)."""
    a = torch.floor(pos).to(torch.int64) - window
    return torch.clamp(a, 0, max(n - P, 0))


def gather_cutouts_batch(maps, ys, xs, window=16):
    """(2*window+1)-square windows around float positions.

    Args:
        maps: (T, nMaps, ny, nx) stack.
        ys, xs: (T, K) float positions.
    Returns:
        (T, K, nMaps, P, P) values and (T, K) int64 y0, x0 anchors.  The
        window rows and columns are clamped into the map, as
        ``jax.lax.dynamic_slice`` clamps its start.
    """
    T, nMaps, ny, nx = maps.shape
    P = 2 * window + 1
    y0 = _anchors(ys, ny, P, window)
    x0 = _anchors(xs, nx, P, window)
    ar = torch.arange(P, device=maps.device)
    rows = torch.clamp(y0[..., None] + ar, 0, ny - 1)          # (T, K, P)
    cols = torch.clamp(x0[..., None] + ar, 0, nx - 1)
    flat = rows[..., :, None] * nx + cols[..., None, :]        # (T, K, P, P)
    K = ys.shape[1]
    src = maps.reshape(T, nMaps, ny * nx)
    cut = torch.gather(src, 2, flat.reshape(T, 1, K * P * P).expand(
        T, nMaps, K * P * P)).reshape(T, nMaps, K, P, P)
    return cut.permute(0, 2, 1, 3, 4), y0, x0


def gather_cutouts(maps3d, ys, xs, window=16):
    """:func:`gather_cutouts_batch` of one (nMaps, ny, nx) stack."""
    cut, y0, x0 = gather_cutouts_batch(maps3d[None], ys[None], xs[None],
                                       window=window)
    return cut[0], y0[0], x0[0]


def _bspline_basis4(t, u, nCoef):
    """The 4 non-zero cubic B-spline basis values at each point (Cox-de
    Boor against the fixed knot vector ``t``, as FITPACK's ``fpbspl``).

    Returns N (..., 4) for coefficients ``span-3..span`` and the int64
    knot-span indices (...)."""
    u = torch.clamp(u, t[3], t[nCoef])
    span = torch.clamp(torch.searchsorted(t, u.contiguous(), right=True) - 1,
                       3, nCoef - 1)
    left = [None] * 4
    right = [None] * 4
    for j in (1, 2, 3):
        left[j] = u - t[span + 1 - j]
        right[j] = t[span + j] - u
    N = [torch.ones_like(u), None, None, None]
    one = torch.ones((), dtype=u.dtype, device=u.device)
    for j in (1, 2, 3):
        saved = torch.zeros_like(u)
        for r in range(j):
            denom = right[r + 1] + left[j - r]
            temp = N[r] / torch.where(denom == 0, one, denom)
            N[r] = saved + right[r + 1] * temp
            saved = left[j - r] * temp
        N[j] = saved
    return torch.stack(N, dim=-1), span


def spline_values_from_cutouts(cut, y0, x0, ys, xs):
    """Not-a-knot bicubic spline values at float positions from
    :func:`gather_cutouts` windows (the host's windowed
    ``RectBivariateSpline`` read, ``interp.subpixel_values``).

    Args:
        cut: (K, nMaps, P, P) cutouts; y0, x0: (K,) anchors; ys, xs: (K,)
            positions (absolute map coordinates).
    Returns:
        (K, nMaps) spline values.
    """
    from . import interp as interp_ops

    K, nMaps, P, _ = cut.shape
    t_np, M_np = interp_ops.notaknot_spline_setup(P)
    dt = cut.dtype
    t = torch.as_tensor(t_np, dtype=dt, device=cut.device)
    M = torch.as_tensor(M_np, dtype=dt, device=cut.device)
    C = torch.matmul(torch.matmul(M, cut), M.T)          # M cut M^T
    Ny, iy = _bspline_basis4(t, ys.to(dt) - y0.to(dt), P)
    Nx, ix = _bspline_basis4(t, xs.to(dt) - x0.to(dt), P)
    ar = torch.arange(4, device=cut.device)
    rows = torch.clamp(iy - 3, 0, P - 4)[:, None] + ar            # (K, 4)
    cols = torch.clamp(ix - 3, 0, P - 4)[:, None] + ar
    kk = torch.arange(K, device=cut.device)[:, None, None, None]
    mm = torch.arange(nMaps, device=cut.device)[None, :, None, None]
    blk = C[kk, mm, rows[:, None, :, None], cols[:, None, None, :]]
    return torch.einsum("ka,kmab,kb->km", Ny, blk, Nx)


def nearest_values_batch(maps, ys, xs):
    """Rounded-pixel reads of a (T, nMaps, ny, nx) stack at (T, K) float
    positions, (T, K, nMaps); round-half-even matches the host's ``round``."""
    T, nMaps, ny, nx = maps.shape
    yi = torch.clamp(torch.round(ys).to(torch.int64), 0, ny - 1)
    xi = torch.clamp(torch.round(xs).to(torch.int64), 0, nx - 1)
    idx = (yi * nx + xi)[:, None, :].expand(T, nMaps, yi.shape[1])
    return torch.gather(maps.reshape(T, nMaps, ny * nx), 2,
                        idx).transpose(1, 2)


def nearest_values(maps3d, ys, xs):
    """:func:`nearest_values_batch` of one (nMaps, ny, nx) stack."""
    return nearest_values_batch(maps3d[None], ys[None], xs[None])[0]


def spline_values_batch(maps, ys, xs, window=16):
    """Sub-pixel reads of a (T, nMaps, ny, nx) stack at (T, K) positions:
    (spline (T, K, nMaps), nearest (T, K, nMaps))."""
    T, K = ys.shape
    cut, y0, x0 = gather_cutouts_batch(maps, ys, xs, window=window)
    P = cut.shape[-1]
    sp = spline_values_from_cutouts(
        cut.reshape(T * K, maps.shape[1], P, P), y0.reshape(-1),
        x0.reshape(-1), ys.reshape(-1), xs.reshape(-1))
    return sp.reshape(T, K, -1), nearest_values_batch(maps, ys, xs)


def spline_values(maps3d, ys, xs, window=16):
    """:func:`spline_values_batch` of one (nMaps, ny, nx) stack:
    (spline (K, nMaps), nearest (K, nMaps))."""
    sp, nn = spline_values_batch(maps3d[None], ys[None], xs[None],
                                 window=window)
    return sp[0], nn[0]
