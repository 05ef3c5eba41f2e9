"""The kernels' work counts, pinned at the batched step's 16 x 900 x 1536
shapes to the bounds PERF.md's kernel table was measured against:
rms_cells 0.0430 ms (operations), label_components 0.0330 ms (bytes)."""

import numpy as np
import torch

from portbench.reference import mf
from portbench.rooflines import bound, label_components, rms_cells

SHAPE, PAD, GRID = (896, 1536), (900, 1536), 80


def filtered_like_maps(nT):
    """chip_smoke.py's seeded maps shaped like filtered tiles: noise with
    zeroed borders and a zeroed block."""
    rng = np.random.default_rng(20261016)
    t = rng.normal(0, 1e-5, (nT,) + SHAPE)
    t[:, :20] = 0
    t[:, :, -20:] = 0
    t[:, 300:420, 500:700] = 0
    return t


def test_rms_cells_bound():
    maps = filtered_like_maps(16)
    stages = []
    for m in maps:
        f = torch.as_tensor(m, dtype=torch.float32)
        _, _, st = mf.rms_map(f, GRID, mf.Precision())
        stages.append(st)
    nbytes, ops = rms_cells.launch(16, SHAPE, PAD, GRID,
                                   np.mean(stages, axis=0))
    secs, by = bound(nbytes, ops, "float32")
    assert by == "operations"
    assert round(1e3 * secs, 4) == 0.0430


def test_label_components_bound():
    nbytes, ops = label_components.call(16, PAD, nSig=0.01 * 16 * 900 * 1536)
    secs, by = bound(nbytes, ops, "int32")
    assert (by, round(1e3 * secs, 4)) == ("bytes", 0.0330)
    assert nbytes == 16 * 900 * 1536 * 5
