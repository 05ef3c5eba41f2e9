"""Explicit device and dtype policy for the port.

* CPU runs in float64, as the JAX package's tests pin JAX
  (``tests/conftest.py``): the CPU is the parity path.
* CUDA runs in float32 by default (the TPU's production dtype) and in
  float64 when asked (the CLI's ``-x/--x64``).

A :class:`Policy` is made once (by the CLI, :class:`startup.NemoConfig`,
or a caller) and passed down; nothing in the port reads a global device.
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    device: torch.device
    dtype: torch.dtype

    def tensor(self, a, dtype=None):
        """Host array -> tensor on this device, in the policy dtype (or
        ``dtype``)."""
        return torch.as_tensor(a, dtype=dtype or self.dtype,
                               device=self.device)


def policy(device="cuda", x64=False):
    """Resolve a device name into a :class:`Policy`.

    Raises RuntimeError for "cuda" when no card is present: the port never
    falls back to the CPU silently.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return Policy(dev, torch.float64)
    if dev.type != "cuda":
        raise ValueError("device must be 'cpu' or 'cuda', got %r" % device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but no CUDA device is "
                           "available; pass --device cpu (device='cpu') "
                           "to run on the CPU")
    # A float32 convolution goes through cuDNN, which by default runs it
    # in TF32 (~3 decimal digits): the noise-covariance smoothing
    # (imageops.gaussian_filter, a conv1d) would lose the precision the
    # matched-filter solve needs.  Matrix products are pinned to full
    # float32 for the same reason.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return Policy(dev, torch.float64 if x64 else torch.float32)


CPU = Policy(torch.device("cpu"), torch.float64)
