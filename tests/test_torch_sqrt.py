"""The port's square root (``ops/_exact.sqrt``): correctly rounded on the
CPU, bitwise equal to numpy's and XLA's, and the only square root the port
takes."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nemo_tpu_torch
from nemo_tpu_torch.ops import _exact


def _values(lo, hi, n=2_000_000, seed=0):
    """Seeded values spread evenly in log over [lo, hi]."""
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n))


@pytest.mark.parametrize("lo,hi", [(1e-10, 1e-6), (1e-3, 1e3), (1e-10, 1e3)])
def test_sqrt_is_bitwise_numpy_and_jax(lo, hi):
    x = _values(lo, hi)
    got = _exact.sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(x))))


def test_torch_cpu_sqrt_is_not_correctly_rounded():
    """Why the helper exists: torch's own CPU sqrt misses the correctly
    rounded value for some of the same inputs (were it fixed, the helper
    would still be exact, and this test would say so)."""
    x = _values(1e-10, 1e3)
    plain = torch.sqrt(torch.from_numpy(x)).numpy()
    assert np.count_nonzero(plain != np.sqrt(x)) > 0


def test_sqrt_keeps_shape_dtype_and_strides_semantics():
    x = torch.from_numpy(_values(1e-3, 1e3, n=600, seed=1).reshape(20, 30))
    for t in (x, x.T, x[::2, 1:], x[3, 4], x.to(torch.float32)):
        got = _exact.sqrt(t)
        assert got.shape == t.shape and got.dtype == t.dtype
        np.testing.assert_array_equal(got.numpy(), np.sqrt(t.numpy()))
    neg = _exact.sqrt(torch.tensor([-1.0, 0.0, 4.0], dtype=torch.float64))
    assert torch.isnan(neg[0]) and neg[1] == 0 and neg[2] == 2


def test_no_raw_torch_sqrt_in_the_port():
    pkg = os.path.dirname(nemo_tpu_torch.__file__)
    pattern = re.compile(r"torch\.sqrt\(|\.sqrt_?\(\)|torch\.rsqrt\(")
    hits = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            path = os.path.join(dirpath, f)
            if not f.endswith(".py") or path == _exact.__file__:
                continue
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    if pattern.search(line):
                        hits.append("%s:%d: %s" % (path, i, line.strip()))
    assert hits == []
