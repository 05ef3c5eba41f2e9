"""Work of one call of ``csrc/label_components.cu`` (4-connected labels
of a tile batch's S/N mask by Jacobi passes of label minima).

Frozen from ``chip_smoke.py`` phase 3: the bool mask read once and the
int32 labels written once; 5 operations (four minima and a compare) a
significant pixel and pass.
"""

import numpy as np

OPS_PER_PIXEL_PASS = 5
KERNEL_TOKEN = "label_kernel"


def call(nT, padShape, nSig, nIter=128):
    """(bytes, operations) of one call over ``nT`` masks of ``padShape``
    holding ``nSig`` significant pixels in all."""
    numel = nT * padShape[0] * padShape[1]
    return numel * (1 + 4), OPS_PER_PIXEL_PASS * nIter * nSig


def work(ctx):
    """Per-call (bytes, operations, type) over the window's chunks that
    detect on the card (``ctx["budgets"]``: one call a label of such a
    chunk), with the significant pixels that these inputs give as the
    reference counts them on the judged tiles (``ctx["refs"]``)."""
    cfg = ctx["cfg"]
    labels = [f["label"] for f in cfg["nemo"]["mapFilters"]]
    thr = cfg["nemo"]["thresholdSigma"]
    nSig = np.mean([float(np.sum(r[lab]["SN"] > thr))
                    for r in ctx["refs"].values() for lab in labels])
    return [call(b["nTiles"], tuple(b["padShape"]), nSig * b["nTiles"])
            + ("int32",)
            for b in ctx["budgets"] if b.get("detectLabels")
            for _ in range(b["nLabels"])]
