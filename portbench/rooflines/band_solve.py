"""Work of the batched step's band x band solve: one n x n system a
Fourier pixel of the real-transform half grid, for every tile of a chunk
and every filter of the bank (``nemo_tpu_torch/ops/solve.py``; for n > 3
a batched LU factorisation and solve).

Each system reads its n x n matrix and its n right-hand sides once and
writes its n answers once; (2/3) n^3 + 2 n^2 operations (the LU
factorisation and the two triangular solves).

On the card the n > 3 route runs in cuBLAS's batched kernels, which take
the batch as an array of matrix pointers, ``double* const*`` in their
names: ``getrf_semiwarp`` (the factorisation), ``laswp_kernel`` (the
pivots' row swaps) and ``trsm_batch_left_lower_kernel`` /
``trsm_batch_left_upper_kernel`` (the triangular solves), as an H100's
trace of the six-band cell names them; no other kernel of that cell's
trace carries the token.
"""

KERNEL_TOKEN = "double* const*"


def call(nT, padShape, nf, itemsize=8):
    """(bytes, operations) of one label's solve over ``nT`` tiles of
    ``padShape`` with ``nf`` bands."""
    systems = nT * padShape[0] * (padShape[1] // 2 + 1)
    nbytes = systems * (nf * nf + 2 * nf) * itemsize
    ops = systems * (2.0 / 3.0 * nf ** 3 + 2 * nf ** 2)
    return nbytes, ops


def work(ctx):
    """Per-call (bytes, operations, type) over the window's chunks
    (``ctx["budgets"]``: one solve a label of a chunk), in the
    configuration's precision."""
    cfg = ctx["cfg"]
    optype = cfg["precision"]
    item = 8 if optype == "float64" else 4
    nf = len(cfg["bands"])
    return [call(b["nTiles"], tuple(b["padShape"]), nf, item) + (optype,)
            for b in ctx["budgets"] for _ in range(b["nLabels"])]
