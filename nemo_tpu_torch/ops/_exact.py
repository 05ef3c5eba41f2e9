"""Correctly rounded square roots on both devices.

torch's CPU ``sqrt`` of a float64 tensor is not correctly rounded: its
vectorised path leaves about 0.8% of values one ulp from the IEEE square
root, whatever the thread count.  numpy's and XLA's CPU square roots are
correctly rounded, and the port's CPU runs are its parity path against the
JAX package, so every square root in the port goes through :func:`sqrt`.
"""

import numpy as np
import torch


def sqrt(x):
    """The IEEE (correctly rounded) square root of a tensor, elementwise:
    numpy's on the CPU, bitwise equal to ``np.sqrt`` and ``jnp.sqrt``;
    torch's on CUDA, whose ``sqrt`` is correctly rounded (torch builds it
    with no fast-math path).  Negative values give NaN, as ``torch.sqrt``
    does."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
