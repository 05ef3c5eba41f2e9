"""The port's noise estimator (nemo_tpu_torch.ops.noise) against the JAX
package's, float64 on the CPU.

``_rms_cells_plain`` (the plain torch version of the CUDA kernel
``csrc/rms_cells.cu``) is held against the Pallas kernel itself, run in
interpret mode, and the three cases of ``tests/test_pallas_rms.py`` are
re-run against the port.  Tolerances are those of test_pallas_rms.py:
rtol 1e-10 between implementations, 1e-12 for the meta geometry (the same
arithmetic, only reduction order differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nemo_tpu.ops import noise as jn
from nemo_tpu_torch import device as device_mod
from nemo_tpu_torch.ops import noise as tn


def T(a):
    return torch.as_tensor(np.asarray(a))


def tables(*arrays):
    return [torch.as_tensor(np.asarray(a, dtype=np.int32)) for a in arrays]


def cell_map(seed=0, nT=2, shape=(300, 420)):
    """Maps with the special cells the kernel must handle: a masked band
    (empty cells), and a cell whose first clip leaves no pixels."""
    rng = np.random.default_rng(seed)
    m = rng.normal(0, 2.0, (nT,) + shape)
    m[:, :, -140:] = 0                    # empty cells at the right edge
    clip_empty = -np.ones((10, 10))       # |v| >= |mean + 3 sigma| for all
    clip_empty[0, 0] = -1.5
    m[:, 100:110, 100:110] = clip_empty
    return m


def test_plain_matches_pallas_kernel():
    """The port's plain version against nemo_tpu's Pallas kernel (interpret
    mode) on the same padded batch and tables, including an unused slot
    (len 0), an empty cell and a cell whose clip empties at once."""
    m = cell_map()
    nT = m.shape[0]
    Wy, Wx = 96, 128
    sy = np.array([[0, 40, 100, 100, 150, 200, 60, 10],
                   [8, 56, 100, 100, 150, 200, 60, 10]])
    sx = np.array([[0, 128, 100, 100, 290, 200, 20, 250],
                   [16, 130, 100, 100, 290, 200, 20, 250]])
    ly = np.array([[96, 80, 10, 0, 96, 70, 33, 96]] * nT)
    lx = np.array([[128, 100, 10, 64, 100, 128, 17, 128]] * nT)
    zeros = np.zeros_like(sy)
    ref = np.asarray(jn._grid_rms_cells_pallas(
        jnp.asarray(m), sy, sx, zeros, zeros, ly, lx, (Wy, Wx),
        interpret=True))
    got = tn._rms_cells_plain(T(m), *tables(sy, sx, ly, lx), (Wy, Wx))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-14)
    assert np.all(ref[:, 3] == 0)          # unused slot
    assert np.all(ref[:, 4] == 0)          # empty cell
    clip = np.full((10, 10), -1.0)
    clip[0, 0] = -1.5
    np.testing.assert_allclose(ref[:, 2], np.std(clip), rtol=1e-12)
    assert ref[0, 2] > 0                   # the stats were kept, not zeroed


def test_port_matches_pallas_vs_xla_case():
    """test_pallas_rms.test_pallas_rms_matches_xla against the port."""
    rng = np.random.default_rng(42)
    nT, ny, nx = 2, 200, 240
    m = rng.normal(0, 2.0, (nT, ny, nx))
    m[:, :20] = 0
    m[:, :, -20:] = 0
    xla = np.asarray(jn.grid_rms_map_batch(jnp.asarray(m), 64, impl="xla"))
    got = tn.grid_rms_map_batch(T(m), 64).numpy()
    np.testing.assert_allclose(got, xla, rtol=1e-10, atol=1e-12)
    cells = tn.grid_rms_map_batch(T(m), 64, return_cells=True).numpy()
    ref = np.asarray(jn.grid_rms_map_batch(jnp.asarray(m), 64, impl="xla",
                                           return_cells=True))
    np.testing.assert_allclose(cells, ref, rtol=1e-10, atol=1e-12)


def test_meta_geometry_matches_true_shape_exactly():
    """test_pallas_rms.test_meta_geometry_matches_true_shape_exactly: the
    port's batched estimator on padded maps with cell_meta reproduces the
    JAX grid_rms_map on each tile's true shape."""
    rng = np.random.default_rng(3)
    g = 64
    shapes = [(200, 240), (167, 233), (256, 256)]
    padShape = (256, 256)
    padded = np.zeros((len(shapes),) + padShape)
    tiles = []
    for i, (ny, nx) in enumerate(shapes):
        t = rng.normal(0, 2.0, (ny, nx))
        t[: ny // 10] = 0
        tiles.append(t)
        padded[i, :ny, :nx] = t
    meta = tn.cell_meta_batch(shapes, padShape, g)
    jmeta = jn.cell_meta_batch(shapes, padShape, g)
    for k in meta:
        np.testing.assert_array_equal(meta[k], jmeta[k])
    out = tn.grid_rms_map_batch(T(padded), g, meta=meta).numpy()
    for i, (ny, nx) in enumerate(shapes):
        ref = np.asarray(jn.grid_rms_map(jnp.asarray(tiles[i]), g))
        np.testing.assert_allclose(out[i, :ny, :nx], ref, rtol=1e-12,
                                   atol=1e-14, err_msg="tile=%d" % i)
        assert np.all(out[i, ny:] == 0)
        assert np.all(out[i, :, nx:] == 0)


def test_meta_cells_match_true_shape_cells():
    """test_pallas_rms.test_meta_cells_match_true_shape_cells against the
    port, plus its host expansion."""
    rng = np.random.default_rng(5)
    g = 64
    shape, padShape = (150, 170), (192, 256)
    t = rng.normal(0, 1.0, shape)
    padded = np.zeros((1,) + padShape)
    padded[0, : shape[0], : shape[1]] = t
    meta = tn.cell_meta_batch([shape], padShape, g)
    cells = tn.grid_rms_map_batch(T(padded), g, meta=meta,
                                  return_cells=True).numpy()[0]
    refCells = np.asarray(jn.grid_rms_map(jnp.asarray(t), g,
                                          return_cells=True))
    nCy, nCx = refCells.shape
    np.testing.assert_allclose(cells[:nCy, :nCx], refCells, rtol=1e-12,
                               atol=1e-14)
    assert np.all(cells[nCy:] == 0)
    assert np.all(cells[:, nCx:] == 0)
    full = tn.assemble_rms_host(cells[:nCy, :nCx], shape[0], shape[1], g)
    ref = np.asarray(jn.grid_rms_map(jnp.asarray(t), g))
    np.testing.assert_allclose(full, ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(
        full, jn.assemble_rms_host(cells[:nCy, :nCx], shape[0], shape[1], g))


@pytest.mark.parametrize("estimator", ["default", "percentile"])
@pytest.mark.parametrize("grid", [None, 48, 80])
def test_grid_and_whole_map_rms(estimator, grid):
    """grid_rms_map (incl. empty cells at a masked edge, which give 0 and
    expose the next candidate cell) and whole_map_rms, both estimators."""
    m = cell_map(seed=1, nT=1)[0]
    if grid is None:
        got = tn.whole_map_rms(T(m), estimator=estimator).numpy()
        ref = np.asarray(jn.whole_map_rms(jnp.asarray(m),
                                          estimator=estimator))
    else:
        got = tn.grid_rms_map(T(m), grid, estimator=estimator).numpy()
        ref = np.asarray(jn.grid_rms_map(jnp.asarray(m), grid,
                                         estimator=estimator))
        cells = tn.grid_rms_map(T(m), grid, estimator=estimator,
                                return_cells=True).numpy()
        assert np.any(cells == 0)          # the masked band's cells
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-14)


def test_rms_cells_uses_plain_version_on_cpu():
    m = T(cell_map(seed=2, nT=1))
    tabs = tables([[0, 50]], [[0, 60]], [[80, 80]], [[90, 90]])
    launches, calls = tn.rms_cells.launches, tn._rms_cells_plain.calls
    variants = dict(tn.rms_cells.variant_launches)
    out = tn.rms_cells(m, *tabs, (80, 90))
    assert tn._rms_cells_plain.calls == calls + 1
    assert tn.rms_cells.launches == launches
    assert tn.rms_cells.variant_launches == variants
    np.testing.assert_array_equal(
        out.numpy(), tn._rms_cells_plain(m, *tabs, (80, 90)).numpy())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_clip_fixed_point_stop_is_exact(dtype):
    """The staged kernel's shortcut: the clip loop stops at the first
    iteration whose threshold equals the last one's.  Modelled on the plain
    version's arithmetic, it gives bit for bit the result of all 10
    iterations, and it does stop early."""
    m = T(cell_map(seed=8, nT=1)).to(dtype)
    ov, ye, xe, window, geometry = tn._grid_geometry(300, 420, 64, None)
    padded = torch.nn.functional.pad(
        m, (ov, window[1], ov, window[0])).contiguous()
    windows, valid = tn._gather_windows(
        padded, *[tn._int32_table(a, 1, "cpu") for a in geometry], window)
    mean, rms, n0 = tn._masked_mean_std(windows, valid)
    last = None
    stopped = torch.zeros_like(n0, dtype=torch.bool)
    ran = 0
    for _ in range(10):
        thr = torch.abs(mean + 3.0 * rms)
        if last is not None:
            stopped |= thr == last
        if bool(stopped.all()):
            break
        ran += 1
        last = thr
        clip = valid & (torch.abs(windows) < thr[:, None])
        newMean, newRms, nm = tn._masked_mean_std(windows, clip)
        keep = (nm > 0) & ~stopped
        mean = torch.where(keep, newMean, mean)
        rms = torch.where(keep, newRms, rms)
    early = torch.where(n0 > 0, rms, torch.zeros_like(rms))
    assert ran < 10
    assert torch.equal(early, tn._cell_stats(windows, valid))


def test_rms_cells_variant_choice():
    """The staged variant at the batched step's extents (16 DR5-like
    896 x 1536 tiles padded to 900 x 1536, grid 80 px: the window is the
    largest extent in the tables, not meta_window's 240 x 240 bound), in
    float32 and float64; the streaming variant for whole_map_rms's single
    cell and for float64 windows past a block's 232,448 B."""
    meta = tn.cell_meta_batch([(896, 1536)] * 16, (900, 1536), 80)
    tabs, window, pad = tn.meta_cell_tables(meta, 80, (900, 1536), 16,
                                            "cpu")
    assert window == (162, 161)
    assert window == (int(tabs[2].max()), int(tabs[3].max()))
    assert pad == (40, 240, 40, 240)
    assert [t.shape for t in tabs] == [(16, 209)] * 4
    for dtype in (torch.float32, torch.float64):
        assert tn.rms_cells_variant(window, dtype) == "staged"
    assert tn.rms_cells_variant((896, 1536), torch.float32) == "streaming"
    assert tn.rms_cells_variant((240, 240), torch.float64) == "streaming"
    assert tn.rms_cells_variant((240, 240), torch.float32) == "staged"
    assert 162 * 161 * 8 <= tn.STAGED_MAX_WINDOW_BYTES < 240 * 240 * 8
    # the host path's layout (nT = 1) sizes its window the same way
    assert tn._grid_geometry(896, 1536, 80, None)[3] == (162, 161)


def test_cuda_path_without_a_card_raises(monkeypatch):
    m = T(cell_map(seed=2, nT=1))
    tabs = tables([[0]], [[0]], [[80]], [[90]])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tn._rms_cells_cuda(m, *tabs, (80, 90))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tn.rms_cells(m.to("meta"), *[t.to("meta") for t in tabs], (80, 90))
    with pytest.raises(ValueError, match="int32"):
        tn.rms_cells(m, *[t.long() for t in tabs], (80, 90))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        device_mod.policy("cuda")
