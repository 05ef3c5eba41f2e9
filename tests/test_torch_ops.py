"""Parity of the port's device operators (nemo_tpu_torch.ops) with the JAX
package's, float64 on the CPU: the same seeded numpy inputs go through
both, compared at rtol 1e-10 (both sides are float64; only the summation
order of FFTs and convolutions differs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nemo_tpu.ops import fourier as jf
from nemo_tpu.ops import imageops as ji
from nemo_tpu.ops import paint as jp
from nemo_tpu.ops import solve as js
from nemo_tpu_torch.ops import fourier as tf
from nemo_tpu_torch.ops import imageops as ti
from nemo_tpu_torch.ops import paint as tp
from nemo_tpu_torch.ops import solve as ts

RTOL = 1e-10


def close(t, j, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def rng_map(seed, shape):
    return np.random.default_rng(seed).normal(0, 1.0, shape)


# -- fourier ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(48, 64), (45, 51), (2, 36, 30)])
def test_fourier_transforms(shape):
    m = rng_map(0, shape)
    fm = tf.rfft2(torch.as_tensor(m))
    close(fm.numpy(), jf.rfft2(jnp.asarray(m)))
    back = tf.irfft2(fm, shape[-2:])
    close(back.numpy(), jf.irfft2(jf.rfft2(jnp.asarray(m)), s=shape[-2:]))
    close(back.numpy(), m)


@pytest.mark.parametrize("pow_", [1.0, -1.0])
@pytest.mark.parametrize("shape", [(40, 52), (37, 41)])
def test_apply_pixel_window(shape, pow_):
    m = rng_map(1, shape)
    close(tf.apply_pixel_window(torch.as_tensor(m), pow=pow_).numpy(),
          jf.apply_pixel_window(jnp.asarray(m), pow=pow_))


@pytest.mark.parametrize("shape,width", [((60, 80), 20), ((31, 45), 7),
                                         ((20, 20), 0)])
def test_apod_mask(shape, width):
    np.testing.assert_array_equal(tf.apod_mask(shape, width).numpy(),
                                  np.asarray(jf.apod_mask(shape, width)))


def test_axes_sizes_pad_crop():
    pix = (2.5e-4, 2.4e-4)
    for shape in ((90, 128), (45, 77)):
        for t, j in zip(tf.rlaxes(shape, pix), jf.rlaxes(shape, pix)):
            np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(tf.rmodlmap(shape, pix),
                                      jf.rmodlmap(shape, pix))
    for n in (1, 7, 97, 896, 1031, 1536, 2049):
        assert tf.good_fft_size(n) == jf.good_fft_size(n)
    m = rng_map(2, (3, 17, 23))
    padded = tf.pad_to(torch.as_tensor(m), (20, 30))
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jf.pad_to(jnp.asarray(m),
                                                       (20, 30))))
    np.testing.assert_array_equal(tf.crop_to(padded, (17, 23)).numpy(), m)


# -- solve_small ----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_solve_small(n):
    """Every route gives exactly 0 where det == 0 (an all-zero system; an
    all-ones one, rank one with det == 0 exactly) and solves the rest; the
    JAX package agrees everywhere for n <= 3 and off the singular pixels
    above (its jnp.linalg.solve leaves non-finite values there)."""
    rng = np.random.default_rng(10 + n)
    A = rng.normal(size=(6, 7, n, n))
    A = A @ np.swapaxes(A, -1, -2) + n * np.eye(n)
    good = np.ones((6, 7), bool)
    A[0, 0] = 0.0                        # singular pixels give x = 0
    good[0, 0] = False
    if n > 1:
        A[2, 3] = 1.0                    # rank one: det == 0 exactly
        good[2, 3] = False
    b = rng.normal(size=(6, 7, n))
    xt = ts.solve_small(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(
        torch.linalg.det(torch.as_tensor(A)).numpy() == 0, ~good)
    assert np.all(np.isfinite(xt))
    assert np.all(xt[~good] == 0)
    xj = np.asarray(js.solve_small(jnp.asarray(A), jnp.asarray(b)))
    if n <= 3:
        close(xt, xj)
    else:
        close(xt[good], xj[good])
    close(np.einsum("...ij,...j->...i", A, xt)[good], b[good], rtol=1e-8,
          atol=1e-10)


# -- imageops ---------------------------------------------------------------------

@pytest.mark.parametrize("n,radius", [(9, 3), (5, 7), (12, 12)])
def test_symmetric_pad(n, radius):
    """scipy 'reflect' == numpy 'symmetric' (the edge pixel repeats), for
    pads narrower and wider than the axis."""
    idx = ti._symmetric_index(n, radius, "cpu").numpy()
    np.testing.assert_array_equal(
        idx, np.pad(np.arange(n), radius, mode="symmetric"))


@pytest.mark.parametrize("sigma", [3, (1.5, 4.0), (0, 2.0)])
@pytest.mark.parametrize("shape", [(40, 56), (3, 33, 29)])
def test_gaussian_filter(shape, sigma):
    from scipy import ndimage
    m = rng_map(3, shape)
    out = ti.gaussian_filter(torch.as_tensor(m), sigma).numpy()
    close(out, ji.gaussian_filter(jnp.asarray(m), sigma))
    if len(shape) == 2:
        s = (sigma, sigma) if np.isscalar(sigma) else sigma
        close(out, ndimage.gaussian_filter(m, s, mode="reflect"))


@pytest.mark.parametrize("ny,nx", [(24, 30), (25, 31)])
def test_hermitian_fullgrid_smoothing(ny, nx):
    """The half-grid covariance smoothed exactly as the full grid is."""
    rng = np.random.default_rng(4)
    a = np.fft.rfft2(rng.normal(size=(ny, nx)))
    b = np.fft.rfft2(rng.normal(size=(ny, nx)))
    half = np.stack([np.real(a * np.conj(b)), np.abs(a) ** 2])
    ext = ti.hermitian_extend(torch.as_tensor(half), nx).numpy()
    close(ext, ji.hermitian_extend(jnp.asarray(half), nx))
    # the extension is the full-grid product itself
    close(ext[0], np.real(np.fft.fft2(np.fft.irfft2(a, s=(ny, nx)))
                          * np.conj(np.fft.fft2(np.fft.irfft2(b, s=(ny, nx))))),
          rtol=1e-9, atol=1e-9)
    sm = ti.gaussian_filter_rfft_fullgrid(torch.as_tensor(half), (3, 3),
                                          nx).numpy()
    close(sm, ji.gaussian_filter_rfft_fullgrid(jnp.asarray(half), (3, 3),
                                               nx))


@pytest.mark.parametrize("size", [1, 4, 7, 40, 41])
def test_min_max_filters(size):
    from scipy import ndimage
    m = rng_map(5, (37, 52))
    mt = torch.as_tensor(m)
    out = ti.minimum_filter(mt, size).numpy()
    np.testing.assert_array_equal(out, np.asarray(
        ji.minimum_filter(jnp.asarray(m), size)))
    np.testing.assert_array_equal(out, ndimage.minimum_filter(m, size))
    np.testing.assert_array_equal(
        ti.maximum_filter(mt, size).numpy(),
        np.asarray(ji.maximum_filter(jnp.asarray(m), size)))


@pytest.mark.parametrize("iterations", [1, 3])
def test_binary_dilate_cross(iterations):
    mask = np.random.default_rng(6).random((30, 41)) > 0.97
    np.testing.assert_array_equal(
        ti.binary_dilate_cross(torch.as_tensor(mask), iterations).numpy(),
        np.asarray(ji.binary_dilate_cross(jnp.asarray(mask), iterations)))


# -- interp and template painting ----------------------------------------------------

def test_interp_matches_jnp_and_numpy():
    rng = np.random.default_rng(7)
    xp = np.cumsum(rng.random(50) + 0.01)
    fp = rng.normal(size=50)
    # points below, inside, above the table, and exactly on every knot
    x = np.concatenate([rng.uniform(xp[0] - 1, xp[-1] + 1, 300), xp,
                        [xp[0] - 1e-3, xp[-1] + 1e-3]])
    out = tp.interp(torch.as_tensor(x), torch.as_tensor(xp),
                    torch.as_tensor(fp), left=fp[0], right=0.0).numpy()
    # the same formula as jnp.interp; XLA may fuse it into multiply-adds,
    # so the two agree to rounding
    close(out, jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp),
                          left=fp[0], right=0.0), rtol=1e-13, atol=1e-15)
    close(out, np.interp(x, xp, fp, left=fp[0], right=0.0), rtol=1e-13,
          atol=1e-15)
    assert np.all(out[-2:] == [fp[0], 0.0])            # left / right
    np.testing.assert_array_equal(out[300:349], fp[:-1])   # interior knots


@pytest.mark.parametrize("shape,center", [((64, 80), None),
                                          ((51, 47), (20.3, 30.7))])
def test_paint_template_centered(shape, center):
    r = np.radians(np.logspace(-4, 0, 300))
    v = np.exp(-(r / np.radians(0.05)) ** 2)
    pix = (np.radians(0.5 / 60), np.radians(0.49 / 60))
    out = tp.paint_template_centered(shape, pix, r, v, center=center)
    close(out.numpy(), jp.paint_template_centered(shape, pix, r, v,
                                                  center=center))
    assert out.dtype == torch.float64 and out.shape == shape
