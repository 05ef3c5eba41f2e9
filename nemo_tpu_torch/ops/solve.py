"""Batched small-matrix solves for the per-pixel matched-filter equations.

Port of ``nemo_tpu/ops/solve.py``: closed-form adjugate inverses for
n_freq <= 3 as one elementwise expression over the Fourier grid, with
``torch.linalg.solve`` for larger frequency counts.
"""

import torch


def _zero_singular(det, x):
    return torch.where((det == 0)[..., None], torch.zeros_like(x), x)


def solve_small(A, b):
    """Solve A x = b for batched small matrices.

    Args:
        A: (..., n, n) stacked matrices.
        b: (..., n) stacked right-hand sides.
    Returns:
        x: (..., n).  Where A is singular (det == 0), returns zeros
        (singular Fourier pixels keep filt = 0, as the reference).
    """
    n = A.shape[-1]
    if n == 1:
        det = A[..., 0, 0]
        safe = torch.where(det == 0, torch.ones_like(det), det)
        return _zero_singular(det, (b[..., 0] / safe)[..., None])
    if n == 2:
        a, bb = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - bb * c
        safe = torch.where(det == 0, torch.ones_like(det), det)
        x0 = (d * b[..., 0] - bb * b[..., 1]) / safe
        x1 = (-c * b[..., 0] + a * b[..., 1]) / safe
        return _zero_singular(det, torch.stack([x0, x1], dim=-1))
    if n == 3:
        a11, a12, a13 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
        a21, a22, a23 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
        a31, a32, a33 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
        c11 = a22 * a33 - a23 * a32
        c12 = a13 * a32 - a12 * a33
        c13 = a12 * a23 - a13 * a22
        c21 = a23 * a31 - a21 * a33
        c22 = a11 * a33 - a13 * a31
        c23 = a13 * a21 - a11 * a23
        c31 = a21 * a32 - a22 * a31
        c32 = a12 * a31 - a11 * a32
        c33 = a11 * a22 - a12 * a21
        det = a11 * c11 + a12 * c12 + a13 * c13
        safe = torch.where(det == 0, torch.ones_like(det), det)
        b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
        x0 = (c11 * b0 + c12 * b1 + c13 * b2) / safe
        x1 = (c21 * b0 + c22 * b1 + c23 * b2) / safe
        x2 = (c31 * b0 + c32 * b1 + c33 * b2) / safe
        return _zero_singular(det, torch.stack([x0, x1, x2], dim=-1))
    return torch.linalg.solve(A, b[..., None])[..., 0]
