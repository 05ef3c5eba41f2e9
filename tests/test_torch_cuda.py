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
