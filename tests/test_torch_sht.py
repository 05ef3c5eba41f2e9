"""The port's curved-sky transforms (``nemo_tpu_torch/ops/sht.py``) against
the JAX package's (``nemo_tpu/ops/sht.py``) on the same numpy inputs, on
the CPU, where the Legendre contraction runs its plain version:
``legendre_rings`` against scipy, ``alm2map_car`` / ``map2alm_car`` on two
tiles (dec -55, curved; dec 0), the curved sims given JAX's draws, and the
statistics of the port's own draws."""

import jax
import numpy as np
import pytest
import torch

from nemo_tpu.ops import grf as jgrf
from nemo_tpu.ops import sht as jsht
from nemo_tpu_torch.models import beams
from nemo_tpu_torch.ops import grf, sht
from nemo_tpu_torch.utils import wcs as nwcs

SHAPE = (90, 120)
PIX_DEG = 4.0 / 60.0
LMAX = 300
CPU = "cpu"


def _tileWCS(decDeg, shape=SHAPE, pixDeg=PIX_DEG):
    return nwcs.makeWCS(shape, pixDeg, centreRADeg=30.0, centreDecDeg=decDeg)


def _random_alm(rng, lmax, amp=None):
    alm = np.zeros((lmax + 1, lmax + 1), dtype=complex)
    for l in range(lmax + 1):
        a = 1.0 if amp is None else amp[l]
        alm[l, 0] = rng.normal() * a
        alm[l, 1:l + 1] = (rng.normal(size=l)
                           + 1j * rng.normal(size=l)) * a / np.sqrt(2)
    return alm


def _np(t):
    return t.cpu().numpy()


def test_legendre_matches_scipy():
    from scipy.special import sph_harm_y

    thetas = np.array([0.3, 0.9, np.pi / 2, 2.2, 2.8])
    lmax = 12
    calls = sht._legendre_contract_plain.calls
    lam = sht.legendre_rings(thetas, lmax, dtype=torch.float64, device=CPU)
    assert sht._legendre_contract_plain.calls == calls + lmax + 1
    for l in range(lmax + 1):
        for m in range(l + 1):
            ref = np.real(sph_harm_y(l, m, thetas, 0.0))
            assert np.allclose(lam[l, m], ref, atol=1e-13), (l, m)
    # m > l lanes are exactly zero
    assert np.all(lam[np.triu_indices(lmax + 1, 1)] == 0)


@pytest.mark.parametrize("decDeg", [-55.0, 0.0])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_alm2map_car_matches_jax(decDeg, dtype):
    """Same alm: float64 within 1e-10 of max |ref|, float32 within 1e-5 of
    the map's std (both packages run the recurrence in float32 there)."""
    w = _tileWCS(decDeg)
    rng = np.random.default_rng(1 + int(abs(decDeg)))
    alm = _random_alm(rng, LMAX)
    jdt = np.float64 if dtype == torch.float64 else np.float32
    ref = np.asarray(jsht.alm2map_car(alm, SHAPE, w, dtype=jdt))
    got = _np(sht.alm2map_car(alm, SHAPE, w, dtype=dtype, device=CPU))
    assert got.shape == SHAPE and got.dtype == np.float64
    if dtype == torch.float64:
        assert np.abs(got - ref).max() < 1e-10 * np.abs(ref).max()
    else:
        assert np.std(got - ref) < 1e-5 * np.std(ref)


@pytest.mark.parametrize("decDeg", [-55.0, 0.0])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_map2alm_car_matches_jax(decDeg, dtype):
    w = _tileWCS(decDeg)
    rng = np.random.default_rng(11 + int(abs(decDeg)))
    m = rng.normal(size=SHAPE)
    jdt = np.float64 if dtype == torch.float64 else np.float32
    ref = np.asarray(jsht.map2alm_car(m, SHAPE, w, LMAX, dtype=jdt))
    got = _np(sht.map2alm_car(m, SHAPE, w, LMAX, dtype=dtype, device=CPU))
    assert got.shape == (LMAX + 1, LMAX + 1)
    assert np.all(got[np.triu_indices(LMAX + 1, 1)] == 0)
    tri = np.tril(np.ones((LMAX + 1, LMAX + 1), dtype=bool))
    if dtype == torch.float64:
        assert np.abs(got - ref).max() < 1e-10 * np.abs(ref).max()
    else:
        assert np.std((got - ref)[tri]) < 1e-5 * np.std(ref[tri])


def test_alm2map_matches_brute_force():
    from scipy.special import sph_harm_y

    shape = (10, 14)
    w = nwcs.makeWCS(shape, 0.5, centreRADeg=30.0, centreDecDeg=-50.0)
    lmax = 16
    rng = np.random.default_rng(3)
    alm = _random_alm(rng, lmax)
    m = _np(sht.alm2map_car(alm, shape, w, dtype=torch.float64, device=CPU))

    xx, yy = np.meshgrid(np.arange(shape[1], dtype=float),
                         np.arange(shape[0], dtype=float))
    out = np.asarray(w.pix2wcs(xx.ravel(), yy.ravel()))
    thetas = np.radians(90.0 - out[:, 1])
    phis = np.radians(out[:, 0] % 360.0)
    ref = np.zeros(len(thetas))
    for l in range(lmax + 1):
        for mm in range(l + 1):
            Y = sph_harm_y(l, mm, thetas, phis)
            fac = 1.0 if mm == 0 else 2.0
            ref += fac * np.real(alm[l, mm] * Y)
    ref = ref.reshape(shape)
    assert np.max(np.abs(m - ref)) < 1e-10 * max(1.0, np.abs(ref).max())


def test_round_trip_full_sphere():
    ny, nx = 181, 360
    w = nwcs.makeWCS((ny, nx), 1.0, centreRADeg=180.0, centreDecDeg=0.0)
    lmax = 40
    rng = np.random.default_rng(7)
    alm = _random_alm(rng, lmax)
    m = sht.alm2map_car(alm, (ny, nx), w, dtype=torch.float64, device=CPU)
    alm2 = _np(sht.map2alm_car(m, (ny, nx), w, lmax, dtype=torch.float64,
                               device=CPU))
    # midpoint ring quadrature: exact to its order away from the band edge
    sel = np.arange(lmax + 1) <= 2 * lmax // 3
    err = np.abs(alm2 - alm)[sel].max() / np.abs(alm).max()
    assert err < 5e-3


def test_float32_matches_float64():
    """The scaled recurrence stays accurate in float32 (the card's default
    for the contraction): the float64 run is the reference."""
    shape = (64, 128)
    w = nwcs.makeWCS(shape, 0.5 / 60.0, centreRADeg=30.0,
                     centreDecDeg=-55.0)
    lmax = 400
    rng = np.random.default_rng(11)
    amp = 1.0 / np.maximum(np.arange(lmax + 1), 1.0)
    alm = _random_alm(rng, lmax, amp)
    m64 = _np(sht.alm2map_car(alm, shape, w, dtype=torch.float64,
                              device=CPU))
    m32 = _np(sht.alm2map_car(alm, shape, w, dtype=torch.float32,
                              device=CPU))
    assert np.std(m32 - m64) / np.std(m64) < 1e-4


def _kernel_rings(k, threads, blocks):
    """The ring each (ring block, thread, slot) runs, as
    csrc/legendre_contract.cu's synthesis_kernel and analysis_kernel assign
    them: warp w of block x takes the k x 32 contiguous rings from
    (x threads + 32 w) k, its lane i ring 32 s + i of them in slot s."""
    x = np.arange(blocks)[:, None, None]
    t = np.arange(threads)[None, :, None]
    s = np.arange(k)[None, None, :]
    return (x * threads + (t & ~31)) * k + 32 * s + (t & 31)


@pytest.mark.parametrize("R", [1, 31, 32, 224, 895, 896, 897, 1100, 3584,
                               4097])
@pytest.mark.parametrize("dtype,k", [(torch.float32, 4), (torch.float64, 2)])
def test_synthesis_geometry_covers_every_ring_once(R, dtype, k):
    """The Legendre kernel's launch geometry, which synthesis and analysis
    share, at the rings a thread of each type: every ring run by exactly
    one (ring block, thread, slot), whole warps of at most 1,024 (and the
    kernel's cap) threads, one block per m up to the cap's reach (k x the
    cap) with idle lanes only in its last warp, more blocks (the analysis's
    planes) beyond it, and the grid's m dimension within CUDA's 65,535."""
    for nm in (1, 2001, 6001, 12001, 65535):
        kk, threads, (blocks, gm) = sht.legendre_geometry(R, nm, dtype)
        assert kk == k and gm == nm <= 65535
        assert threads % 32 == 0
        assert threads <= min(1024, sht.MAX_THREADS)
        rings = _kernel_rings(k, threads, blocks)
        live = np.sort(rings[rings < R])
        assert np.array_equal(live, np.arange(R))
        lanes = -(-R // k)
        assert blocks == -(-lanes // sht.MAX_THREADS)
        assert (blocks == 1) == (R <= k * sht.MAX_THREADS)
        if blocks == 1:
            # idle lanes (rings >= R) lie in the last warp
            idle = np.nonzero((rings[0] >= R).any(axis=1))[0]
            assert idle.size == 0 or idle.min() >= threads - 32
    if dtype == torch.float32:
        assert sht.legendre_geometry(896, 6001, dtype)[1:] == (224, (1, 6001))
        assert sht.legendre_geometry(3584, 2001, dtype)[2] == (2, 2001)
    with pytest.raises(ValueError):
        sht.legendre_geometry(R, 65536, dtype)


def _beam(tmp_path):
    path = str(tmp_path / "beam.txt")
    beams.makeGaussianBeamFile(path, 1.4)
    return beams.BeamProfile(beamFileName=path)


def test_sim_cmb_map_curved_matches_jax_given_draws(tmp_path):
    """Given JAX's alm (``sht.rand_alm``) and white noise map, the port's
    curved CMB sim is JAX's within 1e-10 (float64 contraction)."""
    w = _tileWCS(-55.0)
    beam = _beam(tmp_path)
    key = jax.random.PRNGKey(17)
    ref = np.asarray(jsht.sim_cmb_map_curved(
        key, SHAPE, w, beamBell=beam.Bell, beamEll=beam.ell,
        noiseLevel=20.0, lmax=LMAX, dtype=np.float64))
    k1, k2 = jax.random.split(key)
    Cl = jgrf.lensedClTT() * np.interp(np.arange(12001.0), beam.ell,
                                        beam.Bell)
    alm = jsht.rand_alm(k1, Cl, lmax=LMAX)
    white = np.asarray(jax.random.normal(k2, SHAPE, dtype=np.float64))
    got = _np(sht.sim_cmb_map_curved(
        SHAPE, w, beamBell=beam.Bell, beamEll=beam.ell, noiseLevel=20.0,
        lmax=LMAX, dtype=torch.float64, device=CPU, alm=alm,
        noise_white=white))
    assert np.abs(got - ref).max() < 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("level", ["scalar", "map"])
def test_sim_noise_map_curved_matches_jax_given_draws(level):
    w = _tileWCS(-55.0)
    key = jax.random.PRNGKey(23)
    noiseLevel = 10.0
    if level == "map":
        noiseLevel = np.full(SHAPE, 10.0)
        noiseLevel[:, :20] = 0.0
        noiseLevel[40:] = 15.0
    ref = np.asarray(jsht.sim_noise_map_curved(
        key, SHAPE, w, noiseLevel, lKnee=400.0, lmax=LMAX,
        dtype=np.float64))
    white = np.asarray(jax.random.normal(key, SHAPE), dtype=np.float64)
    got = _np(sht.sim_noise_map_curved(
        SHAPE, w, noiseLevel, lKnee=400.0, lmax=LMAX, dtype=torch.float64,
        device=CPU, white=white))
    assert np.abs(got - ref).max() < 1e-10 * np.abs(ref).max()


def test_rand_alm_spectrum():
    lmax = 300
    Cl = 1.0 / np.maximum(np.arange(lmax + 1.0), 1.0) ** 2
    g = torch.Generator().manual_seed(0)
    alm = _np(sht.rand_alm(Cl, lmax=lmax, generator=g, device=CPU))
    ls = np.arange(lmax + 1)
    tri = ls[None, :] <= ls[:, None]
    assert np.all(alm[~tri] == 0)
    power = (np.abs(alm) ** 2 * np.where(tri, 2.0, 0.0))
    power[:, 0] *= 0.5
    hatCl = power.sum(axis=1) / (2 * ls + 1)
    band = slice(50, 301)
    ratio = hatCl[band].mean() / Cl[band].mean()
    assert abs(ratio - 1) < 0.1
    # the generator is the only source of randomness
    again = _np(sht.rand_alm(Cl, lmax=lmax, device=CPU,
                             generator=torch.Generator().manual_seed(0)))
    np.testing.assert_array_equal(alm, again)


def test_rand_alm_given_draw_matches_jax():
    key = jax.random.PRNGKey(2)
    Cl = np.asarray(jgrf.lensedClTT())[:201]
    ref = jsht.rand_alm(key, Cl, lmax=200)
    k1, k2 = jax.random.split(key)
    re = np.asarray(jax.random.normal(k1, (201, 201), dtype=np.float32))
    im = np.asarray(jax.random.normal(k2, (201, 201), dtype=np.float32))
    got = _np(sht.rand_alm(Cl, lmax=200, device=CPU, white=(re, im)))
    np.testing.assert_array_equal(got, ref)


def test_sim_cmb_map_curved_variance():
    """Realised map variance matches sum (2l+1)/(4pi) C_l within sample
    scatter on a band-limited low-l sim drawn by the port."""
    shape = (40, 720)
    w = nwcs.makeWCS(shape, 0.5, centreRADeg=0.0, centreDecDeg=-40.0)
    lmax = 180
    Cl = np.asarray(grf.lensedClTT())[:lmax + 1]
    m = _np(sht.sim_cmb_map_curved(shape, w, ClTT=Cl, lmax=lmax, device=CPU,
                                   generator=torch.Generator()
                                   .manual_seed(4)))
    expected = np.sum((2 * np.arange(lmax + 1) + 1) * Cl) / (4 * np.pi)
    assert 0.5 < m.var() / expected < 2.0


def test_curved_noise_preserves_white_above_band_limit():
    """The 1/f alm round trip adds back the above-lmax residual of the
    white map, so white power above the band limit survives."""
    shape = (128, 128)
    w = nwcs.makeWCS(shape, 0.5 / 60.0, centreRADeg=30.0,
                     centreDecDeg=-10.0)     # 0.5': Nyquist l ~ 21600
    noiseLevel = 10.0
    out = _np(sht.sim_noise_map_curved(
        shape, w, noiseLevel, lKnee=300.0, lmax=200, device=CPU,
        generator=torch.Generator().manual_seed(3)))
    ratio = np.std(out) / noiseLevel
    assert 0.9 < ratio < 1.5, ratio


def test_drawing_needs_a_generator_or_the_draw():
    w = _tileWCS(-55.0)
    with pytest.raises(ValueError):
        sht.rand_alm(np.ones(11), device=CPU)
    with pytest.raises(ValueError):
        sht.sim_noise_map_curved(SHAPE, w, 1.0, 300.0, lmax=50, device=CPU)
