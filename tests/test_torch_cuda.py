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
