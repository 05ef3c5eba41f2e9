"""Operation and byte counts of the port's hand-written kernels, one
file per kernel, and the card's published peaks."""

# One NVIDIA H100 SXM (NVIDIA's data sheet, 700 W): HBM3 bytes/s and
# operations/s outside the tensor cores by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12, "int32": 67e12}


def bound(nbytes, ops, optype):
    """(least seconds for the work, "bytes" or "operations"): the larger
    of the bytes over the memory bandwidth and the operations over the
    type's peak."""
    tb = nbytes / HBM_BYTES_PER_S
    to = ops / PEAK_OPS_PER_S[optype]
    return max(tb, to), "bytes" if tb >= to else "operations"
