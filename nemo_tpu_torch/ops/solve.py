"""Batched small-matrix solves for the per-pixel matched-filter equations.

Port of ``nemo_tpu/ops/solve.py``: closed-form adjugate inverses for
n_freq <= 3 as one elementwise expression over the Fourier grid, and for
larger frequency counts a batched LU factorisation and solve
(``torch.linalg.lu_factor_ex`` / ``lu_solve``).  Every route gives zeros
where the system is singular (det == 0), with no exception and no host
sync; the JAX package's ``jnp.linalg.solve`` leaves non-finite values
there for n_freq > 3, a deliberate deviation.
"""

import torch

from ..utils import timing


def _lu_solve(A, b):
    """(x, det) of A x = b by the batched LU with partial pivoting.  The
    determinant is the product of U's diagonal, as ``torch.linalg.det``
    forms it; where it is 0 the solve divides by a zero pivot and ``x``
    holds non-finite values that the caller replaces."""
    n = A.shape[-1]
    timing.count("solve.general_systems", A.numel() // (n * n))
    LU, pivots, _ = torch.linalg.lu_factor_ex(A)
    det = torch.diagonal(LU, dim1=-2, dim2=-1).prod(dim=-1)
    return torch.linalg.lu_solve(LU, pivots, b[..., None])[..., 0], det


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
        x = (b[..., 0] / safe)[..., None]
    elif n == 2:
        a, bb = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - bb * c
        safe = torch.where(det == 0, torch.ones_like(det), det)
        x0 = (d * b[..., 0] - bb * b[..., 1]) / safe
        x1 = (-c * b[..., 0] + a * b[..., 1]) / safe
        x = torch.stack([x0, x1], dim=-1)
    elif n == 3:
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
        x = torch.stack([x0, x1, x2], dim=-1)
    else:
        x, det = _lu_solve(A, b)
    return torch.where((det == 0)[..., None], torch.zeros_like(x), x)
