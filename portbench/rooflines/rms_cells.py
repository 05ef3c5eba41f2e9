"""Work of one launch of ``csrc/rms_cells.cu`` (the clipped grid RMS of
a tile batch, in the batched step's per-tile cell layout).

Frozen from the arithmetic that ``chip_smoke.py`` phase 3 times the
kernel against: each cell's window (the cell plus half a cell on each
side, in the padded batch) is swept once per clip stage the cell needs
(the seed and each clip until its threshold repeats), 7 operations a
pixel and stage (|v|, compare, add; subtract, multiply, add; and the
count); the bytes are the zero-padded map batch read once, the four
int32 cell tables and the cell RMS written once.
"""

import numpy as np

OPS_PER_PIXEL_STAGE = 7
KERNEL_TOKEN = "rms_cells"


def cell_edges(n, grid):
    return np.linspace(0, n, int(n / grid + 1), dtype=int)


def n_cells(n, grid):
    return max(len(cell_edges(int(n), int(grid))) - 1, 1)


def geometry(shape, padShape, grid):
    """(extents of the tile's cells in write order, padded map shape,
    cell slots a tile) of the batched layout."""
    g = int(grid)
    ov = g // 2
    PY, PX = padShape
    Wy = min(PY, 2 * g) + 2 * ov
    Wx = min(PX, 2 * g) + 2 * ov
    ly = np.minimum(np.diff(cell_edges(shape[0], g)) + 2 * ov, Wy)
    lx = np.minimum(np.diff(cell_edges(shape[1], g)) + 2 * ov, Wx)
    extents = (ly[:, None] * lx[None, :]).reshape(-1)
    slots = n_cells(PY, g) * n_cells(PX, g)
    return extents, (PY + ov + Wy, PX + ov + Wx), slots


def launch(nT, shape, padShape, grid, stages, itemsize=4):
    """(bytes, operations) of one launch over ``nT`` tiles of true shape
    ``shape`` at the batch's ``padShape``; ``stages``: clip stages of each
    cell of a tile in write order (or their mean)."""
    extents, padded, slots = geometry(shape, padShape, grid)
    ops = OPS_PER_PIXEL_STAGE * nT * float(np.sum(extents * stages))
    nbytes = nT * padded[0] * padded[1] * itemsize + 4 * nT * slots * 4 \
        + nT * slots * itemsize
    return nbytes, ops


def work(ctx):
    """Per-launch (bytes, operations, type) over the window's chunks
    (``ctx["budgets"]``: one launch a label of a chunk), with the clip
    stages that these inputs need as the reference counts them on the
    judged tiles (``ctx["refs"]``), in the configuration's precision."""
    cfg = ctx["cfg"]
    optype = cfg["precision"]
    item = 8 if optype == "float64" else 4
    shape = tuple(cfg["survey"]["tile_shape"])
    grid = int(round(cfg["nemo"]["allFilters"]["params"]["noiseParams"]
                     ["noiseGridArcmin"] / cfg["survey"]["pixel_arcmin"]))
    labels = [f["label"] for f in cfg["nemo"]["mapFilters"]]
    stages = np.mean([r[lab]["stages"] for r in ctx["refs"].values()
                      for lab in labels], axis=0)
    return [launch(b["nTiles"], shape, tuple(b["padShape"]), grid, stages,
                   item) + (optype,)
            for b in ctx["budgets"] for _ in range(b["nLabels"])]
