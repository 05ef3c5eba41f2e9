"""The port's on-device detection (nemo_tpu_torch.ops.detect) against the
JAX package's (nemo_tpu.ops.detect), float64 on the CPU, on the same
numpy-seeded inputs.  The JAX side runs as its own tests run it (its CPU
default segment-statistics formulation, ``scatter``, and ``compact`` for
the significant-pixel budget).  Labels and integer statistics must be
exactly equal; float statistics agree to rtol 1e-12 and sub-pixel reads to
rtol 1e-10 (float64, summation order only)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nemo_tpu.ops import detect as jd
from nemo_tpu_torch.ops import detect as td
from nemo_tpu_torch.ops import interp as tinterp


def blob_map(seed, shape=(90, 120), nBlobs=9):
    """Noise plus Gaussian blobs of S/N 6-20 and one flat plateau (an
    exact tie for the first-maximum read)."""
    rng = np.random.default_rng(seed)
    sn = rng.normal(0, 1.3, shape)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for _ in range(nBlobs):
        y, x = rng.uniform(5, shape[0] - 5), rng.uniform(5, shape[1] - 5)
        s = rng.uniform(1.0, 3.5)
        sn += rng.uniform(6, 20) * np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                          / (2 * s * s))
    sn[3:6, 3:7] = 9.0
    return sn


def snake_mask(shape=(40, 40)):
    """A one-pixel-wide serpentine component far longer than 128 pixels
    (its root needs more than 128 passes to reach its far end), plus
    blobs."""
    m = np.zeros(shape, dtype=bool)
    for r in range(1, shape[0] - 1, 4):
        m[r, 1:shape[1] - 1] = True
        if r + 2 < shape[0] - 1:
            col = shape[1] - 2 if (r // 4) % 2 == 0 else 1
            m[r:r + 5, col] = True
    m[2:4, 10:14] = False
    return m


@pytest.mark.parametrize("case", ["random", "blobs", "snake"])
def test_label_components_exact(case):
    if case == "random":
        m = np.random.default_rng(1).random((70, 95)) > 0.55
    elif case == "blobs":
        m = blob_map(2) > 4.0
    else:
        m = snake_mask()
    got = td.label_components(torch.as_tensor(m)).numpy()
    ref = np.asarray(jd.label_components(jnp.asarray(m)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    if case == "snake":
        # the 128-pass budget splits the serpentine into several labels,
        # identically in both packages
        assert len(np.unique(got[m])) > 1
        full = td.label_components(torch.as_tensor(m), n_iter=4000).numpy()
        assert len(np.unique(full[m])) < len(np.unique(got[m]))


def test_label_components_batch_matches_single():
    ms = np.stack([blob_map(s) > 4.0 for s in (3, 4, 5)])
    got = td.label_components_batch(torch.as_tensor(ms)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jd.label_components(jnp.asarray(ms[i]))))


def blocked_label_model(mask, n_iter, tile, halo):
    """numpy model of ``csrc/label_components.cu``'s scheme on a (T, ny,
    nx) mask: launches of at most ``halo`` Jacobi passes, each block
    computing a ``tile`` x ``tile`` interior from a haloed region on its
    shrinking exact rectangle; a block whose region holds no label below
    2**30 writes 2**30; a block stops at a pass that changes nothing; a
    launch whose first pass changed nothing anywhere makes every later one
    return at once.  Values outside the exact rectangle are poisoned with
    -1, so reading one would show.  Returns (labels, launches run)."""
    BIG = td._BIG
    T, ny, nx = mask.shape
    R = tile + 2 * halo
    L = td.label_launch_count(n_iter, halo)
    flat = np.arange(ny * nx, dtype=np.int32).reshape(ny, nx)
    bufs = [np.full((T, ny, nx), -7, np.int32) for _ in range(2)]
    changed = np.zeros(L, bool)
    ran = 0
    for j in range(L):
        if j >= 2 and not changed[j - 1]:
            continue
        ran += 1
        passes = n_iter - j * halo if j == L - 1 else halo
        src = np.where(mask, flat, BIG) if j == 0 else bufs[(j + 1) % 2]
        srcp = np.full((T, ny + 2 * R, nx + 2 * R), BIG, np.int32)
        srcp[:, R:R + ny, R:R + nx] = src
        dst = bufs[j % 2]
        for t in range(T):
            for y0 in range(-halo, ny - halo, tile):
                for x0 in range(-halo, nx - halo, tile):
                    a = srcp[t, y0 + R:y0 + 2 * R, x0 + R:x0 + 2 * R].copy()
                    if (a != BIG).any():
                        for q in range(1, passes + 1):
                            inner = a[q:R - q, q:R - q]
                            nb = np.minimum(
                                np.minimum(a[q - 1:R - q - 1, q:R - q],
                                           a[q + 1:R - q + 1, q:R - q]),
                                np.minimum(a[q:R - q, q - 1:R - q - 1],
                                           a[q:R - q, q + 1:R - q + 1]))
                            new = np.where(inner != BIG,
                                           np.minimum(inner, nb), BIG)
                            moved = bool((new != inner).any())
                            a = np.full_like(a, -1)
                            a[q:R - q, q:R - q] = new
                            if not moved:
                                break
                            if q == 1:
                                changed[j] = True
                    yi, xi = y0 + halo, x0 + halo
                    h, w = min(tile, ny - yi), min(tile, nx - xi)
                    dst[t, yi:yi + h, xi:xi + w] = \
                        a[halo:halo + h, halo:halo + w]
    return bufs[(L - 1) % 2], ran


def _label_case(case):
    if case == "random":
        return np.random.default_rng(1).random((70, 95)) > 0.55
    if case == "blobs":
        return blob_map(2) > 4.0
    if case == "snake":
        return snake_mask()
    return np.zeros((33, 50), dtype=bool)


@pytest.mark.parametrize("geometry", [(64, 16), (8, 3)])
@pytest.mark.parametrize("n_iter", [128, 37, 4000])
@pytest.mark.parametrize("case", ["random", "blobs", "snake", "empty"])
def test_blocked_label_scheme_matches_jax(case, n_iter, geometry):
    """The labelling kernel's scheme (at the kernel's 64 x 64 tiles with a
    16-pixel halo, and at 8 x 8 tiles with a 3-pixel halo, so that small
    maps cross many tiles) equals the JAX package's label_components
    bitwise, including the serpentine's split at 128 passes and an n_iter
    that is not a multiple of the passes per launch."""
    m = _label_case(case)
    tile, halo = geometry
    got, ran = blocked_label_model(m[None], n_iter, tile, halo)
    ref = np.asarray(jd.label_components(jnp.asarray(m), n_iter=n_iter))
    np.testing.assert_array_equal(got[0], ref)
    if n_iter == 4000 and case != "snake":
        # converged long before: the unchanged-launch stop fired
        assert ran < td.label_launch_count(n_iter, halo)


@pytest.mark.parametrize("n_iter", [128, 4000])
def test_blocked_label_scheme_batch(n_iter):
    """A batch shares the unchanged-launch flag: the serpentine keeps every
    tile's launches running while a blob tile and an empty tile are
    already final."""
    ms = np.stack([snake_mask((40, 40)), blob_map(7, (40, 40), 3) > 4.0,
                   np.zeros((40, 40), dtype=bool)])
    got, _ = blocked_label_model(ms, n_iter, 8, 3)
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.asarray(
            jd.label_components(jnp.asarray(ms[i]), n_iter=n_iter)))
    np.testing.assert_array_equal(
        got, td.label_components_batch(torch.as_tensor(ms),
                                       n_iter=n_iter).numpy())


def test_label_components_uses_plain_version_on_cpu():
    m = torch.as_tensor(_label_case("blobs"))[None]
    launches = td.label_components_batch.launches
    calls = td._label_components_plain.calls
    out = td.label_components_batch(m, n_iter=37)
    assert td._label_components_plain.calls == calls + 1
    assert td.label_components_batch.launches == launches
    np.testing.assert_array_equal(
        out.numpy(), td._label_components_plain(m, 37).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        td._label_components_cuda(m, 128)
    with pytest.raises(ValueError, match="cpu or cuda"):
        td.label_components_batch(m.to("meta"))
    with pytest.raises(ValueError, match="bool"):
        td.label_components_batch(m.to(torch.uint8))
    with pytest.raises(ValueError, match="n_iter"):
        td.label_components_batch(m, n_iter=-1)


def _check_det(got, ref):
    valid = np.asarray(ref["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["numPix"].numpy(),
                                  np.asarray(ref["numPix"]))
    assert int(got["nObjects"]) == int(ref["nObjects"])
    for k in ("peakY", "peakX"):
        np.testing.assert_array_equal(got[k].numpy()[..., valid],
                                      np.asarray(ref[k])[..., valid])
    for k in ("comY", "comX", "peak"):
        np.testing.assert_allclose(got[k].numpy()[..., valid],
                                   np.asarray(ref[k])[..., valid],
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed,maxObjects,threshold", [
    (10, 64, 4.0), (11, 8, 4.0), (12, 32, 3.0)])
def test_detect_objects_matches_jax(seed, maxObjects, threshold):
    sn = blob_map(seed)
    got = td.detect_objects(torch.as_tensor(sn), threshold,
                            max_objects=maxObjects)
    ref = jd.detect_objects(jnp.asarray(sn), threshold,
                            max_objects=maxObjects)
    _check_det(got, ref)
    assert got["valid"].any()


def test_detect_objects_batch_matches_jax():
    sns = np.stack([blob_map(s) for s in (20, 21, 22, 23)])
    sns[2] = 0.0                                  # a tile with no objects
    got = td.detect_objects_batch(torch.as_tensor(sns), 4.0, max_objects=16)
    ref = jd.detect_objects_batch(jnp.asarray(sns), 4.0, max_objects=16)
    for i in range(4):
        _check_det({k: v[i] for k, v in got.items()},
                   {k: np.asarray(v)[i] for k, v in ref.items()})
    assert int(got["nObjects"][2]) == 0


def test_overflow_count_and_pixel_budget():
    """nObjects reports the true count past the object budget, and a map
    with more significant pixels than ``max_pix`` is forced over the
    budget, as the JAX compact formulation forces it."""
    sn = blob_map(30, nBlobs=14)
    nTrue = int(td.detect_objects(torch.as_tensor(sn), 4.0,
                                  max_objects=256)["nObjects"])
    got = td.detect_objects(torch.as_tensor(sn), 4.0, max_objects=3)
    assert int(got["nObjects"]) == nTrue > 3
    _check_det(got, jd.detect_objects(jnp.asarray(sn), 4.0, max_objects=3))
    nSig = int((sn > 4.0).sum())
    for maxPix in (nSig - 1, nSig):
        got = td.detect_objects(torch.as_tensor(sn), 4.0,
                                max_objects=nTrue + 5, max_pix=maxPix)
        ref = jd.detect_objects(jnp.asarray(sn), 4.0, max_objects=nTrue + 5,
                                impl="compact", max_pix=maxPix)
        assert int(got["nObjects"]) == int(ref["nObjects"])
        overflowed = int(got["nObjects"]) > nTrue + 5
        assert overflowed == (maxPix < nSig)
        if not overflowed:
            _check_det(got, ref)


def _positions(seed, shape, K=30):
    rng = np.random.default_rng(seed)
    ys = rng.uniform(0, shape[0] - 1, K)
    xs = rng.uniform(0, shape[1] - 1, K)
    ys[:2] = [0.2, shape[0] - 1.3]         # windows clamped at the edges
    xs[:2] = [shape[1] - 0.7, 0.4]
    return ys, xs


@pytest.mark.parametrize("window", [16, 5])
def test_cutouts_and_subpixel_reads(window):
    rng = np.random.default_rng(40 + window)
    shape = (70, 90)
    maps3d = rng.normal(size=(2, 70, 90))
    ys, xs = _positions(window, shape)
    tm, ty, tx = (torch.as_tensor(a) for a in (maps3d, ys, xs))
    jm, jy, jx = (jnp.asarray(a) for a in (maps3d, ys, xs))

    cut, y0, x0 = td.gather_cutouts(tm, ty, tx, window=window)
    jcut, jy0, jx0 = jd.gather_cutouts(jm, jy, jx, window=window)
    np.testing.assert_array_equal(y0.numpy(), np.asarray(jy0))
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    np.testing.assert_array_equal(cut.numpy(), np.asarray(jcut))

    sp, nn = td.spline_values(tm, ty, tx, window=window)
    jsp, jnn = jd.spline_values(jm, jy, jx, window=window)
    np.testing.assert_allclose(sp.numpy(), np.asarray(jsp), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_array_equal(nn.numpy(), np.asarray(jnn))
    np.testing.assert_array_equal(
        td.nearest_values(tm, ty, tx).numpy(),
        np.asarray(jd.nearest_values(jm, jy, jx)))

    # against the host windowed spline: interior points, where both
    # anchor formulas pick the same window
    inner = np.nonzero((ys > window + 1) & (ys < shape[0] - window - 2)
                       & (xs > window + 1) & (xs < shape[1] - window - 2))[0]
    assert len(inner) >= 3
    for m in range(2):
        host = tinterp.subpixel_values(maps3d[m], ys[inner], xs[inner],
                                       window=window)
        np.testing.assert_allclose(sp.numpy()[inner, m], host, rtol=1e-10,
                                   atol=1e-12)


def test_bspline_basis_matches_jax():
    t_np, _ = tinterp.notaknot_spline_setup(33)
    u = np.random.default_rng(5).uniform(-1, 34, 40)
    N, span = td._bspline_basis4(torch.as_tensor(t_np), torch.as_tensor(u),
                                 33)
    jN, jspan = jd._bspline_basis4(jnp.asarray(t_np), jnp.asarray(u), 33)
    np.testing.assert_allclose(N.numpy(), np.asarray(jN), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_array_equal(span.numpy(), np.asarray(jspan))
