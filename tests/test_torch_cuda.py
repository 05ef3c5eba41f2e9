"""Tests of the port's CUDA kernels on the card (marked ``cuda``; they skip
where there is no NVIDIA GPU).  This file imports no JAX, so it also runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nemo_tpu_torch.ops import noise as tn


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def cell_map(seed, nT, shape):
    """Noise with a masked band (empty cells) and a patch whose first clip
    leaves no pixels."""
    rng = np.random.default_rng(seed)
    m = rng.normal(0, 2.0, (nT,) + shape)
    m[:, :, -140:] = 0
    patch = -np.ones((10, 10))
    patch[0, 0] = -1.5
    m[:, 100:110, 100:110] = patch
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
def test_rms_cells_kernel_matches_plain(cuda_card, dtype, rtol):
    """csrc/rms_cells.cu against its plain version on the card, batched
    meta layout with unused slots (float32 may flip one borderline clip:
    rtol 1e-4)."""
    shapes = [(300, 420), (280, 400), (300, 420)]
    m = cell_map(4, len(shapes), (300, 420))
    meta = tn.cell_meta_batch(shapes, (300, 420), 64)
    Wy, Wx, ov = tn.meta_window(64, (300, 420))
    padded = torch.nn.functional.pad(
        torch.as_tensor(m, dtype=dtype, device=cuda_card),
        (ov, Wx, ov, Wy)).contiguous()
    tabs = [tn._int32_table(a, len(shapes), cuda_card) for a in (
        meta["startsY"], meta["startsX"],
        np.where(meta["lensY"] > 0, meta["lensY"] + 2 * ov, 0),
        np.where(meta["lensX"] > 0, meta["lensX"] + 2 * ov, 0))]
    launches = tn.rms_cells.launches
    got = tn.rms_cells(padded, *tabs, (Wy, Wx))
    torch.cuda.synchronize()
    assert tn.rms_cells.launches == launches + 1
    ref = tn._rms_cells_plain(padded, *tabs, (Wy, Wx))
    assert got.shape == tabs[0].shape and got.dtype == dtype
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=0)
    assert np.any(got.cpu().numpy() == 0)          # unused / empty cells


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("variant", ["staged", "streaming"])
def test_rms_cells_variants_match_plain(cuda_card, variant, dtype, rtol):
    """Both variants of csrc/rms_cells.cu against the plain version on the
    batched meta layout with the window sized on the tables' largest
    extent (the staged variant's case), each launch counted under its
    variant."""
    shapes = [(300, 420), (280, 400), (300, 420), (296, 411)]
    m = cell_map(6, len(shapes), (300, 420))
    meta = tn.cell_meta_batch(shapes, (300, 420), 64)
    tabs, window, pad = tn.meta_cell_tables(meta, 64, (300, 420),
                                            len(shapes), cuda_card)
    padded = torch.nn.functional.pad(
        torch.as_tensor(m, dtype=dtype, device=cuda_card), pad).contiguous()
    assert tn.rms_cells_variant(window, dtype) == "staged"
    count = tn.rms_cells.variant_launches[variant]
    got = tn._rms_cells_cuda(padded, *tabs, window, variant=variant)
    torch.cuda.synchronize()
    assert tn.rms_cells.variant_launches[variant] == count + 1
    ref = tn._rms_cells_plain(padded, *tabs, window)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=0)
    assert np.any(got.cpu().numpy() == 0)          # unused / empty cells


def sn_masks(seed=7, T=16, shape=(900, 1536)):
    """(T, ny, nx) bool masks at the batched step's shape on the card: an
    S/N-like map (beam-smoothed white noise at unit rms plus ~20 compact
    sources a tile) above 4, an empty mask, and a one-pixel serpentine
    through every tile (far more than 128 passes long) over the S/N
    mask."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    white = torch.as_tensor(rng.standard_normal((T,) + shape,
                                                dtype=np.float32), device=dev)
    ly = torch.fft.fftfreq(shape[0], device=dev)[:, None]
    lx = torch.fft.rfftfreq(shape[1], device=dev)[None, :]
    beam = torch.exp(-2 * (np.pi * 1.5) ** 2 * (ly ** 2 + lx ** 2))
    sn = torch.fft.irfft2(torch.fft.rfft2(white) * beam, s=shape)
    sn = sn / sn.std()
    yy = torch.arange(shape[0], device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(shape[1], device=dev, dtype=torch.float32)[None, :]
    for t in range(T):
        for y, x, a in zip(rng.uniform(20, shape[0] - 20, 20),
                           rng.uniform(20, shape[1] - 20, 20),
                           rng.uniform(5, 15, 20)):
            sn[t] += float(a) * torch.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                          / (2 * 3.0 ** 2))
    snake = torch.zeros((T,) + shape, dtype=torch.bool, device=dev)
    for k, r in enumerate(range(1, shape[0] - 1, 4)):
        snake[:, r, 1:shape[1] - 1] = True
        col = shape[1] - 2 if k % 2 == 0 else 1
        snake[:, r:min(r + 5, shape[0] - 1), col] = True
    sig = sn > 4.0
    return {"sn": sig, "empty": torch.zeros_like(sig), "snake": snake | sig}


@pytest.mark.cuda
@pytest.mark.parametrize("n_iter", [128, 4000, 37])
def test_label_kernel_matches_plain(cuda_card, n_iter):
    """csrc/label_components.cu equals its plain version bitwise at the
    batched step's 16 x 900 x 1536, on an S/N mask, an empty mask and a
    serpentine that splits at 128 passes; one counted launch per call."""
    from nemo_tpu_torch.ops import detect as td
    masks = sn_masks()
    for name, mask in masks.items():
        launches = td.label_components_batch.launches
        got = td.label_components_batch(mask, n_iter=n_iter)
        torch.cuda.synchronize()
        assert td.label_components_batch.launches == launches + 1
        ref = td._label_components_plain(mask, n_iter)
        assert got.dtype == torch.int32 and got.shape == mask.shape
        assert torch.equal(got, ref), (name, n_iter)
    assert int(masks["sn"].sum()) > 0
    if n_iter == 128:
        got = td.label_components_batch(masks["snake"][:1], n_iter=n_iter)
        snake = masks["snake"][0] & ~masks["sn"][0]
        assert len(torch.unique(got[0][snake])) > 1    # split at 128


@pytest.mark.cuda
def test_grid_rms_map_on_card_matches_cpu(cuda_card):
    """The host path's grid RMS (nT = 1 through the kernel) on the card
    against the CPU's plain version, float64."""
    m = cell_map(5, 1, (300, 420))[0]
    got = tn.grid_rms_map(torch.as_tensor(m, device=cuda_card), 80)
    ref = tn.grid_rms_map(torch.as_tensor(m), 80)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-10,
                               atol=0)


def blob_batch(seed, T=3, shape=(96, 130)):
    """S/N-like maps: noise plus Gaussian blobs, one tile left empty."""
    rng = np.random.default_rng(seed)
    sn = rng.normal(0, 1.3, (T,) + shape)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for t in range(T - 1):
        for _ in range(8):
            y, x = rng.uniform(6, shape[0] - 6), rng.uniform(6, shape[1] - 6)
            amp, s = rng.uniform(6, 20), rng.uniform(1, 3)
            sn[t] += amp * np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                  / (2 * s * s))
    sn[-1] = 0.0
    return sn


@pytest.mark.cuda
def test_detection_on_card_matches_cpu(cuda_card):
    """ops/detect on the card (float64) against the CPU float64 run:
    labels and integer statistics exact, float statistics rtol 1e-12,
    sub-pixel reads rtol 1e-10."""
    from nemo_tpu_torch.ops import detect as td
    sn = blob_batch(11)
    got = td.detect_objects_batch(torch.as_tensor(sn, device=cuda_card),
                                  4.0, max_objects=32)
    ref = td.detect_objects_batch(torch.as_tensor(sn), 4.0, max_objects=32)
    np.testing.assert_array_equal(
        td.label_components_batch(torch.as_tensor(sn > 4, device=cuda_card)
                                  ).cpu().numpy(),
        td.label_components_batch(torch.as_tensor(sn > 4)).numpy())
    valid = ref["valid"].numpy()
    assert valid.sum() >= 8
    for k in ("valid", "numPix", "nObjects"):
        np.testing.assert_array_equal(got[k].cpu().numpy(), ref[k].numpy())
    for k in ("comY", "comX", "peak", "peakY", "peakX"):
        np.testing.assert_allclose(got[k].cpu().numpy()[valid],
                                   ref[k].numpy()[valid], rtol=1e-12)
    maps = torch.as_tensor(np.stack([sn, 2 * sn], axis=1))
    ys, xs = ref["comY"], ref["comX"]
    sp, nn = td.spline_values_batch(maps.to(cuda_card), ys.to(cuda_card),
                                    xs.to(cuda_card), window=8)
    rsp, rnn = td.spline_values_batch(maps, ys, xs, window=8)
    np.testing.assert_allclose(sp.cpu().numpy(), rsp.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_array_equal(nn.cpu().numpy(), rnn.numpy())


STEP_PAD = (64, 90)
STEP_SHAPES = [(60, 84), (61, 85), (59, 84), (60, 83)]
STEP_GRID = 16


def step_inputs(seed=2026):
    """Inputs of the batched step (also the CPU parity test's, which
    imports this): four ragged tiles zero-padded to one bucket, two bands
    of noise plus blobs, centred Gaussian templates at each true shape,
    calibration templates of amplitude (2, -1.5), apodisation, masks (a
    point-source hole in one tile), -inf covariance floors, and the
    true-shape noise-cell tables.  Returns (arrays, meta, grid)."""
    from nemo_tpu_torch.ops import fourier as tf
    pad, shapes = STEP_PAD, STEP_SHAPES
    rng = np.random.default_rng(seed)
    T = len(shapes)
    data = np.zeros((T, 2) + pad)
    tmpl = np.zeros_like(data)
    apod = np.zeros((T,) + pad)
    survey = np.zeros((T,) + pad)
    for i, (ny, nx) in enumerate(shapes):
        yy, xx = np.mgrid[:ny, :nx]
        for f in range(2):
            m = rng.normal(0, 1.0 + 0.3 * f, (ny, nx))
            for _ in range(4):
                amp = rng.uniform(4, 9)
                y, x = rng.uniform(8, ny - 8), rng.uniform(8, nx - 8)
                m += amp * np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                  / (2 * (2.0 + f) ** 2))
            data[i, f, :ny, :nx] = m
            tmpl[i, f, :ny, :nx] = np.exp(
                -((yy - ny / 2) ** 2 + (xx - nx / 2) ** 2)
                / (2 * (2.0 + f) ** 2))
        apod[i, :ny, :nx] = np.outer(tf._apod_profile(ny, 6),
                                     tf._apod_profile(nx, 6))
        survey[i, :ny, :nx] = 1.0
    ps = survey.copy()
    ps[1, 20:24, 30:35] = 0.0
    args = {"data": data, "template": tmpl,
            "calib": tmpl * np.array([2.0, -1.5])[None, :, None, None],
            "w": np.array([1.0, -0.7]), "apodM": apod, "psMask": ps,
            "surveyMask": survey,
            "fg": np.full((T, pad[0], pad[1] // 2 + 1), -np.inf),
            "peakYX": np.array([[s[0] // 2, s[1] // 2] for s in shapes],
                               dtype=np.int32)}
    return args, tn.cell_meta_batch(shapes, pad, STEP_GRID), STEP_GRID


def run_step(device, dtype, args, meta, grid):
    from nemo_tpu_torch.parallel import distribute
    step = distribute.make_matched_filter_step(
        grid, 10, detect_params=(3.0, 24, 128, True, 8))
    t = {k: torch.as_tensor(v, device=device) for k, v in args.items()}
    for k in ("data", "template", "calib", "w", "apodM", "fg"):
        t[k] = t[k].to(dtype)
    return step(t["data"], t["data"], t["template"], t["calib"], t["w"],
                t["apodM"], t["psMask"], t["surveyMask"], t["fg"],
                t["peakYX"], meta)


@pytest.mark.cuda
def test_batched_step_on_card_matches_cpu(cuda_card):
    """The production step's detection tail on the card against the CPU
    float64 run: float64 to rtol 1e-9 (the same detections), float32 to
    the float32 tolerance of chip_smoke (1e-3 of the map's scale); the
    grid RMS went through the kernel, never its plain version."""
    args, meta, grid = step_inputs()
    ref = run_step("cpu", torch.float64, args, meta, grid)
    launches = tn.rms_cells.launches
    plain = tn._rms_cells_plain.calls
    got = run_step(cuda_card, torch.float64, args, meta, grid)
    torch.cuda.synchronize()
    assert tn.rms_cells.launches == launches + 1
    assert tn._rms_cells_plain.calls == plain
    valid = ref["det"]["valid"].numpy()
    assert valid.sum() >= 8
    np.testing.assert_array_equal(got["det"]["valid"].cpu().numpy(), valid)
    for k in ("filtered", "SNMap", "RMSCells", "signalNorm", "calibCrop"):
        r = ref[k].numpy()
        np.testing.assert_allclose(got[k].cpu().numpy(), r, rtol=1e-9,
                                   atol=1e-9 * np.abs(r).max())
    for k in ("comY", "comX"):
        np.testing.assert_allclose(got["det"][k].cpu().numpy()[valid],
                                   ref["det"][k].numpy()[valid], rtol=1e-9)
    got32 = run_step(cuda_card, torch.float32, args, meta, grid)
    r = ref["SNMap"].numpy()
    np.testing.assert_allclose(got32["SNMap"].cpu().numpy(), r, rtol=0,
                               atol=1e-3 * np.abs(r).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-3)])
def test_general_solve_has_no_host_sync(cuda_card, dtype, rtol):
    """The n > 3 route of ``solve_small`` (batched LU) on six-band systems
    laid out as the batched step lays them, under torch's sync debug mode
    "error", so that a host sync fails it: exact zeros at the planted
    singular systems (all zero, all ones), the rest as the CPU's
    float64."""
    from nemo_tpu_torch.ops import solve as ts
    rng = np.random.default_rng(6)
    A = rng.normal(size=(4, 6, 6, 30, 33))
    A = np.einsum("tiryx,tjryx->tijyx", A, A) \
        + 6 * np.eye(6)[None, :, :, None, None]
    A[0, :, :, 0, 0] = 0.0
    A[2, :, :, 5, 7] = 1.0
    b = rng.normal(size=(4, 30, 33, 6))
    good = np.ones((4, 30, 33), bool)
    good[0, 0, 0] = good[2, 5, 7] = False
    Ad = torch.as_tensor(A, dtype=dtype, device=cuda_card)
    bd = torch.as_tensor(b, dtype=dtype, device=cuda_card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = ts.solve_small(Ad.permute(0, 3, 4, 1, 2), bd)
        zero = (x == 0).all(dim=-1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(zero.cpu().numpy(), ~good)
    x = x.cpu().numpy()
    assert np.all(np.isfinite(x))
    ref = ts.solve_small(torch.as_tensor(A).permute(0, 3, 4, 1, 2),
                         torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x[good], ref[good], rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.cuda
def test_boltzmann_kernel_matches_plain(cuda_card):
    """csrc/boltzmann_rk4.cu against its plain version on the card, 24 k
    across the splice grid at nGrid 2,048: the same float64 arithmetic on
    the same per-step table, the batch's operations grouped otherwise
    than the lanes' (~1e-11 relative after 2,047 steps), held at 1e-9."""
    from nemo_tpu_torch.models import boltzmann as tb
    bg = tb._solver_tables(70.0, 0.3, 0.05, 2048)
    k = torch.as_tensor(np.logspace(np.log10(5e-3), np.log10(30.0), 24),
                        device=cuda_card)
    launches = tb.transfer_function.launches
    T, R0 = tb._transfer_cuda(k, bg)
    torch.cuda.synchronize()
    assert tb.transfer_function.launches == launches + 1
    Tp, Rp = tb._transfer_plain(k, bg)
    assert T.dtype == torch.float64 and T.shape == k.shape
    np.testing.assert_allclose(T.cpu().numpy(), Tp.cpu().numpy(),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(R0.cpu().numpy(), Rp.cpu().numpy(),
                               rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_boltzmann_transfer_function_on_card(cuda_card):
    """transfer_function(device="cuda") launches the kernel, never the
    plain version, and returns host float64 arrays."""
    from nemo_tpu_torch.models import boltzmann as tb
    plain, launches = tb._transfer_plain.calls, tb.transfer_function.launches
    T, d = tb.transfer_function([0.01, 0.1, 1.0], nGrid=2048, device="cuda")
    assert tb.transfer_function.launches == launches + 1
    assert tb._transfer_plain.calls == plain
    assert T.dtype == np.float64 and np.all(np.isfinite(T))
    assert d["R0"].shape == (3,)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1e-3, 0.2, 5.0])
def test_boltzmann_trajectory_kernel_matches_plain(cuda_card, k):
    """All 36 components of the kernel's state, every 8th step at nGrid
    2,048 (its snapshot buffer), against the plain version's trajectory
    at 1e-9 of each component's scale: T(k) reads only dc and db, so a
    wrong rate on one lane's multipole could hide there.  k = 1e-3 stays
    superhorizon, 0.2 crosses tight coupling into the full hierarchies,
    5 streams.  One counted launch, no plain call."""
    from nemo_tpu_torch.models import boltzmann as tb
    launches = tb.transfer_function.launches
    plain = tb._transfer_plain.calls
    lk, yk, Rk = tb.debug_trajectory(k, nGrid=2048, every=8)
    torch.cuda.synchronize()
    assert tb.transfer_function.launches == launches + 1
    assert tb._transfer_plain.calls == plain
    lp, yp, Rp = tb.debug_trajectory(k, nGrid=2048, every=8, device="cpu")
    np.testing.assert_array_equal(lk, lp)
    assert yk.shape == yp.shape == (256, tb.NV) and np.all(np.isfinite(yk))
    scale = np.max(np.abs(yp), axis=0)
    scale = np.where(scale > 0, scale, 1.0)
    np.testing.assert_allclose(yk / scale, yp / scale, rtol=0, atol=1e-9)
    np.testing.assert_allclose(Rk, Rp, rtol=1e-9, atol=0)


@pytest.mark.cuda
def test_boltzmann_division_is_ieee(cuda_card):
    """The Boltzmann kernel's branch-free division (FastDiv, and `/` where
    it declines) gives the correctly rounded quotient, bitwise torch's
    `a / b` on the card: 2^22 pairs over the whole float64 range plus
    zeros of both signs, subnormals, the range's ends, inf and nan; and
    every pair whose operands lie within 2^+-400 takes the fast path."""
    from nemo_tpu_torch.models import boltzmann as tb
    rng = np.random.default_rng(7)
    n = 1 << 22

    def draw(lo, hi, size):
        return rng.standard_normal(size) * np.exp2(rng.integers(lo, hi,
                                                                size))

    special = np.array([0.0, -0.0, 5e-324, -5e-324, 2.2250738585072014e-308,
                        1.7976931348623157e308, np.inf, -np.inf, np.nan,
                        1.0, -3.0, 0.7])
    sa, sb = np.meshgrid(special, special)
    a = np.concatenate([draw(-1074, 1023, n // 2), draw(-400, 400, n // 2),
                        sa.ravel()])
    b = np.concatenate([draw(-1074, 1023, n // 2), draw(-400, 400, n // 2),
                        sb.ravel()])
    A = torch.as_tensor(a, device=cuda_card)
    Bt = torch.as_tensor(b, device=cuda_card)
    q = torch.empty_like(A)
    fast = torch.empty(A.shape, dtype=torch.int32, device=cuda_card)
    err = tb.load_kernel().nemo_boltzmann_divide(
        A.data_ptr(), Bt.data_ptr(), q.data_ptr(), fast.data_ptr(),
        int(A.numel()), torch.cuda.current_stream().cuda_stream)
    assert err == 0
    ref = A / Bt
    torch.cuda.synchronize()
    same = (q.view(torch.int64) == ref.view(torch.int64)) \
        | (torch.isnan(q) & torch.isnan(ref))
    assert bool(same.all()), int((~same).sum())
    assert bool(fast[n // 2:n].bool().all())


def paint_inputs(seed=8, n=10000, shape=(3584, 6144)):
    """10,000 point sources of a 1.4' beam at 0.5' over a 3584 x 6144 map
    (the survey of chip_smoke's phases 7 on), 61 x 61 windows."""
    rng = np.random.default_rng(seed)
    ys = rng.uniform(0, shape[0], n)
    xs = rng.uniform(0, shape[1], n)
    amps = 10 ** rng.uniform(1, 3, n)
    r = np.radians(np.linspace(0, 20.0, 2000) / 60.0)
    sigma = np.radians(1.4 / 60.0) / np.sqrt(8 * np.log(2))
    pix = np.radians(0.5 / 60.0)
    return (shape, (pix, pix), ys, xs, amps, r, np.exp(-0.5 * (r / sigma)
                                                       ** 2),
            np.radians(0.25))


@pytest.mark.cuda
def test_paint_objects_on_card(cuda_card):
    """paint_objects on the card against the CPU float64 run (float64
    rtol 1e-12, float32 1e-5 of the peak), and deterministic: two float32
    calls are bitwise equal (no atomics in the sum)."""
    from nemo_tpu_torch.ops import paint
    args = paint_inputs()
    ref = paint.paint_objects(*args).numpy()
    got = paint.paint_objects(*args, device=cuda_card).cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    a = paint.paint_objects(*args, device=cuda_card, dtype=torch.float32)
    b = paint.paint_objects(*args, device=cuda_card, dtype=torch.float32)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.cuda
def test_given_step_on_card_matches_cpu(cuda_card):
    """The given-filter step (cached-filter reruns) on the card against
    the CPU float64 run, lean tail: float64 rtol 1e-9; the grid RMS went
    through the kernel."""
    from nemo_tpu_torch.parallel import distribute
    args, meta, grid = step_inputs()
    build = distribute.make_matched_filter_step(grid, 10, lean_outputs=True,
                                                return_filter=True)
    t = {k: torch.as_tensor(v) for k, v in args.items()}
    filt = build(t["data"], t["data"], t["template"], t["calib"], t["w"],
                 t["apodM"], t["psMask"], t["surveyMask"], t["fg"],
                 t["peakYX"], meta)["filt"]
    given = distribute.make_matched_filter_step(grid, 10, lean_outputs=True,
                                                given_filter=True)
    ref = given(t["data"], filt, t["apodM"], t["psMask"], t["surveyMask"],
                meta)
    launches = tn.rms_cells.launches
    plain = tn._rms_cells_plain.calls
    got = given(*(x.to(cuda_card) for x in (t["data"], filt, t["apodM"],
                                            t["psMask"], t["surveyMask"])),
                meta)
    torch.cuda.synchronize()
    assert tn.rms_cells.launches == launches + 1
    assert tn._rms_cells_plain.calls == plain
    for k in ("filtered", "RMSCells", "signalNorm"):
        r = ref[k].numpy()
        np.testing.assert_allclose(got[k].cpu().numpy(), r, rtol=1e-9,
                                   atol=1e-9 * np.abs(r).max())
    np.testing.assert_array_equal(got["surveyMask"].cpu().numpy(),
                                  ref["surveyMask"].numpy())


@pytest.fixture
def second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (a launch on cuda:1)")
    return torch.device("cuda", 1)


@pytest.mark.cuda
def test_two_shard_mesh_on_one_card(cuda_card):
    """The sharded production step on two virtual shards of cuda:0, float64,
    against the one-device step on the CPU: the detection tail within
    rtol 1e-9; each shard launched rms_cells and label_components once on
    cuda:0, and no plain version ran."""
    from nemo_tpu_torch.ops import detect as td
    from nemo_tpu_torch.parallel import distribute, mesh
    args, meta, grid = step_inputs()
    ref = run_step("cpu", torch.float64, args, meta, grid)
    m = mesh.get_mesh(devices=["cuda:0"] * 2)
    sh = mesh.tile_sharding(m)
    put = {k: torch.as_tensor(v, device=cuda_card) if k == "w"
           else sh.put(v) for k, v in args.items()}
    step = distribute.make_sharded_matched_filter_step(
        m, grid, 10, detect_params=(3.0, 24, 128, True, 8))
    rms0 = tn.rms_cells.device_launches.get("cuda:0", 0)
    lab0 = td.label_components_batch.device_launches.get("cuda:0", 0)
    plain = (tn._rms_cells_plain.calls, td._label_components_plain.calls)
    out = step(put["data"], put["data"], put["template"], put["calib"],
               put["w"], put["apodM"], put["psMask"], put["surveyMask"],
               put["fg"], put["peakYX"], meta)
    torch.cuda.synchronize()
    assert tn.rms_cells.device_launches["cuda:0"] == rms0 + 2
    assert td.label_components_batch.device_launches["cuda:0"] == lab0 + 2
    assert (tn._rms_cells_plain.calls,
            td._label_components_plain.calls) == plain
    assert [p.shape[0] for p in out["SNMap"]] == [2, 2]
    assert all(t.seconds() > 0 for t in out["stepTimer"])
    valid = ref["det"]["valid"].numpy()
    got = {k: torch.cat(out[k]).cpu().numpy() for k in (
        "filtered", "SNMap", "RMSCells", "signalNorm", "calibCrop")}
    np.testing.assert_array_equal(
        torch.cat(out["det"]["valid"]).cpu().numpy(), valid)
    for k, g in got.items():
        r = ref[k].numpy()
        np.testing.assert_allclose(g, r, rtol=1e-9,
                                   atol=1e-9 * np.abs(r).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rms_cells", "label_components",
                                    "boltzmann_rk4", "legendre_contract"])
def test_kernel_launches_on_a_second_card(second_card, kernel):
    """Each kernel's library (nvcc's static runtime, loaded with ctypes)
    launches on cuda:1 when its tensors live there: the result stays on
    cuda:1 and equals its plain version's (rms_cells float64 rtol 1e-10,
    the labels and the Legendre synthesis bitwise, the Boltzmann transfer
    rtol 1e-9), and the launch is counted on cuda:1."""
    dev = second_card
    key = str(dev)
    if kernel == "rms_cells":
        shapes = [(300, 420), (280, 400)]
        meta = tn.cell_meta_batch(shapes, (300, 420), 64)
        tabs, window, pad = tn.meta_cell_tables(meta, 64, (300, 420), 2,
                                                dev)
        padded = torch.nn.functional.pad(torch.as_tensor(
            cell_map(4, 2, (300, 420)), device=dev), pad).contiguous()
        n0 = tn.rms_cells.device_launches.get(key, 0)
        got = tn.rms_cells(padded, *tabs, window)
        torch.cuda.synchronize(dev)
        assert tn.rms_cells.device_launches[key] == n0 + 1
        ref = tn._rms_cells_plain(padded, *tabs, window)
        assert got.device == dev
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-10, atol=0)
    elif kernel == "label_components":
        from nemo_tpu_torch.ops import detect as td
        mask = sn_masks(T=2, shape=(300, 420))["snake"].to(dev)
        n0 = td.label_components_batch.device_launches.get(key, 0)
        got = td.label_components_batch(mask)
        torch.cuda.synchronize(dev)
        assert td.label_components_batch.device_launches[key] == n0 + 1
        assert got.device == dev
        assert torch.equal(got, td._label_components_plain(mask, 128))
    elif kernel == "boltzmann_rk4":
        from nemo_tpu_torch.models import boltzmann as tb
        bg = tb._solver_tables(70.0, 0.3, 0.05, 2048)
        k = torch.as_tensor(np.logspace(-2, 1, 8), device=dev)
        T, _ = tb._transfer_cuda(k, bg)
        torch.cuda.synchronize(dev)
        assert T.device == dev
        np.testing.assert_allclose(T.cpu().numpy(),
                                   tb._transfer_plain(k, bg)[0].cpu().numpy(),
                                   rtol=1e-9, atol=0)
    else:
        from nemo_tpu_torch.ops import sht
        thetas, are, aim, _, _, _ = legendre_inputs(lmax=200, nrings=120)
        got = sht.legendre_contract(thetas, are, aim, 200, 200,
                                    dtype=torch.float64, device=dev)
        torch.cuda.synchronize(dev)
        assert got.device == dev
        ref = sht._legendre_contract_plain(
            torch.as_tensor(thetas, device=dev), torch.as_tensor(are,
                                                                 device=dev),
            torch.as_tensor(aim, device=dev), 200, 200, False, None)
        assert torch.equal(got, ref)


def legendre_inputs(seed=9, lmax=300, nrings=200, decLo=-62.0, decHi=-54.5):
    """Ring colatitudes of a dec -62..-54.5 tile, random alm (lmax+1)^2
    falling as 1/l, and random ring coefficients (lmax+1, nrings)."""
    rng = np.random.default_rng(seed)
    thetas = np.radians(90.0 - np.linspace(decLo, decHi, nrings))
    amp = 1.0 / np.maximum(np.arange(lmax + 1), 1.0)
    tri = np.tril(np.ones((lmax + 1, lmax + 1), dtype=bool))
    are = np.where(tri, rng.normal(size=tri.shape) * amp[:, None], 0.0)
    aim = np.where(tri, rng.normal(size=tri.shape) * amp[:, None], 0.0)
    Gre = rng.normal(size=(lmax + 1, nrings))
    Gim = rng.normal(size=(lmax + 1, nrings))
    w = np.sin(thetas) * 1e-3
    return thetas, are, aim, Gre, Gim, w


@pytest.mark.cuda
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_legendre_kernel_matches_plain(cuda_card, adjoint, dtype):
    """csrc/legendre_contract.cu against its plain version on the card, in
    both directions: synthesis bitwise equal to plain in both types;
    analysis float64 within 1e-10 of max |plain|, float32 within 1e-5 of
    max |alm|; two launches bitwise equal; one launch a call, and an
    analysis call makes no host sync.  Covered: mmax < lmax, ring counts
    that are no multiple of the rings a thread or of 32 (33, 897), and more
    rings than one block takes (4,097: analysis sums its blocks' planes)."""
    from nemo_tpu_torch.ops import sht
    cases = ((300, 300, 200), (200, 150, 1100), (250, 250, 33),
             (220, 180, 897), (120, 120, 4097))
    for lmax, mmax, nrings in cases:
        thetas, are, aim, Gre, Gim, w = legendre_inputs(lmax=lmax,
                                                        nrings=nrings)
        if adjoint:
            args = (Gre[:mmax + 1], Gim[:mmax + 1])
            k, _, (blocks, _) = sht.legendre_geometry(
                nrings, min(lmax, mmax) + 1, dtype)
            assert (blocks > 1) == (nrings > k * sht.MAX_THREADS)
            assert blocks > 1 or nrings != 4097
        else:
            args = (are[:, :mmax + 1], aim[:, :mmax + 1])
        launches = sht.legendre_contract.launches
        plain = sht._legendre_contract_plain.calls
        torch.cuda.synchronize()
        if adjoint:
            torch.cuda.set_sync_debug_mode("error")
        try:
            a = sht.legendre_contract(thetas, *args, lmax, mmax,
                                      adjoint=adjoint, weights=w,
                                      dtype=dtype, device=cuda_card)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        b = sht.legendre_contract(thetas, *args, lmax, mmax, adjoint=adjoint,
                                  weights=w, dtype=dtype, device=cuda_card)
        torch.cuda.synchronize()
        assert sht._legendre_contract_plain.calls == plain
        # one launch a call in either direction, whatever the ring count
        assert sht.legendre_contract.launches == launches + 2
        assert torch.equal(a, b)
        th = torch.as_tensor(thetas, dtype=dtype, device=cuda_card)
        ref = sht._legendre_contract_plain(
            th, *(torch.as_tensor(x, device=cuda_card).to(dtype)
                  for x in args), lmax, mmax, adjoint,
            torch.as_tensor(w, device=cuda_card).to(dtype))
        assert a.shape == ref.shape and a.dtype == dtype
        if not adjoint:
            assert torch.equal(a, ref), (lmax, mmax, nrings)
            continue
        r = ref.double().cpu().numpy()
        g = a.double().cpu().numpy()
        if dtype == torch.float64:
            tol = 1e-10 * np.abs(r).max()
        else:
            tol = 1e-5 * np.abs(r).max()
        assert np.abs(g - r).max() <= tol, (lmax, np.abs(g - r).max(), tol)


@pytest.mark.cuda
def test_legendre_kernel_raises_on_cpu_tensors(cuda_card):
    """The kernel path takes CUDA tensors only; the wrapper sends a CPU
    device to the plain version, never to the kernel."""
    from nemo_tpu_torch.ops import sht
    thetas, are, aim, _, _, _ = legendre_inputs(lmax=20, nrings=8)
    th = torch.as_tensor(thetas, dtype=torch.float32)
    with pytest.raises((ValueError, RuntimeError)):
        sht._legendre_contract_cuda(th, torch.as_tensor(are).float(),
                                    torch.as_tensor(aim).float(), 20, 20)
    launches = sht.legendre_contract.launches
    sht.legendre_contract(thetas, are, aim, 20, 20, device="cpu")
    assert sht.legendre_contract.launches == launches


def realspace_inputs(seed=2027, T=3, shape=(200, 300), k=29):
    """A real-space step's inputs: T tiles of two bands of noise plus
    blobs, each tile with its own odd kernels, calibrations, apodisation
    and masks (a point-source hole in one tile)."""
    from nemo_tpu_torch.ops import fourier as tf
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:k, :k] - k // 2
    data = rng.normal(0, 30.0, (T, 2) + shape)
    kern = np.stack([[np.exp(-(yy ** 2 + xx ** 2) / (2 * s ** 2))
                      - 0.2 * np.exp(-(yy ** 2 + xx ** 2) / (2 * (3 * s) ** 2))
                      + 1e-3 * rng.normal(size=(k, k))
                      for s in (2.0 + t, 3.0 + t)] for t in range(T)])
    apod = np.outer(tf._apod_profile(shape[0], 20),
                    tf._apod_profile(shape[1], 20))
    psMask = np.ones((T,) + shape)
    psMask[1, 90:100, 140:160] = 0
    return {"data": data, "kern": kern,
            "signalNorm": rng.uniform(1e-5, 2e-5, T),
            "apodM": np.broadcast_to(apod, (T,) + shape).copy(),
            "psMask": psMask, "surveyMask": np.ones((T,) + shape)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-5)])
def test_convolve2d_reflect_sum_on_card_matches_cpu(cuda_card, dtype, tol):
    """The convolution on the card (through cuFFT) against the CPU float64
    convolution, within tol of the peak."""
    from nemo_tpu_torch import device as device_mod
    from nemo_tpu_torch.ops import imageops
    device_mod.policy("cuda")
    a = realspace_inputs()
    m, k = torch.as_tensor(a["data"]), torch.as_tensor(a["kern"])
    ref = imageops.convolve2d_reflect_sum_batch(m, k).numpy()
    got = imageops.convolve2d_reflect_sum_batch(
        m.to(cuda_card, dtype), k.to(cuda_card, dtype)).cpu().numpy()
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    one = imageops.convolve2d_reflect_sum(m[1].to(cuda_card, dtype),
                                          k[1].to(cuda_card, dtype))
    assert np.abs(one.cpu().numpy() - ref[1]).max() \
        <= tol * np.abs(ref).max()


@pytest.mark.cuda
def test_realspace_step_on_card_matches_cpu(cuda_card):
    """The real-space batched step on the card in float64 against the CPU
    run: rtol 1e-9 of the peak, the grid RMS through the kernel."""
    from nemo_tpu_torch.ops import noise as noise_ops
    from nemo_tpu_torch.parallel import distribute
    a = realspace_inputs()
    shape = a["data"].shape[-2:]
    meta = noise_ops.cell_meta_batch([shape] * 3, shape, 40)
    step = distribute.make_realspace_step(40, 20, undo_pixel_window=True)
    t = [torch.as_tensor(a[key]) for key in ("data", "kern", "signalNorm",
                                             "apodM", "psMask",
                                             "surveyMask")]
    ref = step(*t, meta)
    launches = tn.rms_cells.launches
    got = step(*(x.to(cuda_card) for x in t), meta)
    torch.cuda.synchronize()
    assert tn.rms_cells.launches == launches + 1
    for key in ("filtered", "SNMap", "RMSMap"):
        r = ref[key].numpy()
        np.testing.assert_allclose(got[key].cpu().numpy(), r, rtol=1e-9,
                                   atol=1e-9 * np.abs(r).max())
    np.testing.assert_array_equal(got["surveyMask"].cpu().numpy(),
                                  ref["surveyMask"].numpy())


def spec_config(work, seed=2028, shape=(300, 420)):
    """A seeded two-band tile with six cluster-like decrements, written as
    FITS, its config dict (one tile) and the targets table."""
    from nemo_tpu_torch import startup
    from nemo_tpu_torch.models import beams
    from nemo_tpu_torch.utils import fits as nfits
    from nemo_tpu_torch.utils import wcs as nwcs
    from nemo_tpu_torch.utils.tables import Table
    rng = np.random.default_rng(seed)
    w = nwcs.makeWCS(shape, 0.5 / 60.0, centreRADeg=30.0, centreDecDeg=0.0)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    ys = rng.uniform(40, shape[0] - 40, 6)
    xs = rng.uniform(40, shape[1] - 40, 6)
    entries = []
    for band, freq, fwhm, noise, amp in (("f150", 149.6, 1.4, 20.0, -400.0),
                                         ("f090", 97.8, 2.1, 30.0, -600.0)):
        data = rng.normal(0, noise, shape)
        for y, x in zip(ys, xs):
            data += amp * np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                 / (2 * 4.0 ** 2))
        path = str(work / ("spec_%s.fits" % band))
        nfits.write_image(path, data, w.header)
        beamPath = str(work / ("beam_%s.txt" % band))
        beams.makeGaussianBeamFile(beamPath, fwhm)
        entries.append({"mapFileName": path, "obsFreqGHz": freq,
                        "units": "uK", "beamFileName": beamPath})
    cfg = {"unfilteredMaps": entries, "thresholdSigma": 4.0, "minObjPix": 1,
           "useInterpolator": True, "removeRings": False,
           "photFilter": None, "outputDir": str(work / "spec"),
           "mapFilters": []}
    ra, dec = np.array([w.pix2wcs(x, y) for x, y in zip(xs, ys)]).T
    tab = Table({"name": np.array(["S%d" % i for i in range(6)]),
                 "RADeg": ra, "decDeg": dec,
                 "template": np.array(["Arnaud_M2e14_z0p4",
                                       "Arnaud_M4e14_z0p2"] * 3)})
    return startup.parseConfigDict(cfg), tab


@pytest.mark.cuda
def test_extract_spec_matched_filter_on_card_matches_cpu(cuda_card, tmp_path,
                                                         monkeypatch):
    """extractSpec -m matchedFilter on the card (float32) against the CPU
    port (float64): y_c and S/N per band within 1e-4 relative; the grid RMS
    launches rms_cells once per (tile, template, band)."""
    import copy
    from nemo_tpu_torch import pipelines, startup
    cfg, tab = spec_config(tmp_path)
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.chdir(tmp_path)
        config = startup.NemoConfig(copy.deepcopy(cfg), device=dev,
                                    writeTileInfo=True)
        launches = tn.rms_cells.launches
        out[dev] = pipelines.extractSpec(config, tab, method="matchedFilter")
        out[dev + "_launches"] = tn.rms_cells.launches - launches
    assert out["cpu_launches"] == 0
    assert out["cuda_launches"] == 2 * 2
    got, ref = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(np.asarray(got["name"]),
                                  np.asarray(ref["name"]))
    cols = [k for k in ref.keys() if k.startswith(("y_c_", "SNR_"))]
    assert len(cols) == 4 and len(got) == 6
    for col in cols:
        np.testing.assert_allclose(np.asarray(got[col]),
                                   np.asarray(ref[col]), rtol=1e-4,
                                   err_msg=col)
