"""The port's flat-sky sims (``nemo_tpu_torch/ops/grf.py``) against the JAX
package's (``nemo_tpu/ops/grf.py``) on the CPU: given the same white field
(drawn with ``jax.random.normal`` here), every function's result within
1e-10; the lensed spectrum read from the port's own table; the statistics
of the port's own draws."""

import jax
import numpy as np
import pytest
import torch

from nemo_tpu import maps as jmaps
from nemo_tpu.ops import fourier as jfourier
from nemo_tpu.ops import grf as jgrf
from nemo_tpu_torch.models import beams
from nemo_tpu_torch.ops import fourier, grf
from nemo_tpu_torch.utils import wcs as nwcs

SHAPE = (90, 120)
PIX_DEG = 4.0 / 60.0
CPU = "cpu"


def _tile(decDeg):
    w = nwcs.makeWCS(SHAPE, PIX_DEG, centreRADeg=30.0, centreDecDeg=decDeg)
    return w, jmaps.pixScalesRad(w, SHAPE), jmaps.pixScaleXRadPerRow(w, SHAPE)


def _close(got, ref, rtol=1e-10):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def _white(key, shape=SHAPE):
    return np.asarray(jax.random.normal(key, shape, dtype=np.float64))


def test_lensed_cl_reads_the_ports_table():
    ref = jgrf.lensedClTT()
    got = grf.lensedClTT()
    np.testing.assert_array_equal(got, ref)
    assert not np.allclose(got, grf.approxLensedClTT())
    np.testing.assert_array_equal(grf.lensedClTT(3000), jgrf.lensedClTT(3000))
    np.testing.assert_array_equal(grf.approxLensedClTT(500),
                                  jgrf.approxLensedClTT(500))


def test_missing_lensed_table_raises(monkeypatch, tmp_path):
    """The JAX package falls back to the analytic curve; the port raises."""
    monkeypatch.setattr(grf, "LENSED_CL_TABLE", str(tmp_path / "none.txt"))
    monkeypatch.setattr(grf, "_lensedDlCache", {})
    with pytest.raises(FileNotFoundError):
        grf.lensedClTT()


def test_rmodlmap_graph_matches_jax():
    pix = (1e-3, 1.2e-3)
    got = fourier.rmodlmap_graph(SHAPE, pix)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jfourier.rmodlmap_graph(SHAPE, pix)), rtol=1e-15, atol=0)


def test_gaussian_field_matches_jax_given_white():
    _, pix, _ = _tile(0.0)
    Cl = jgrf.lensedClTT()
    ell = np.arange(len(Cl), dtype=float)
    key = jax.random.PRNGKey(5)
    ref = jgrf.gaussian_field(key, SHAPE, pix, ell, Cl)
    got = grf.gaussian_field(SHAPE, pix, ell, Cl, device=CPU,
                             white=_white(key))
    _close(got, ref)


def test_gaussian_field_decaware_matches_jax_given_white():
    _, pix, dxRows = _tile(-55.0)
    nBands = grf.dec_band_count(dxRows)
    assert nBands == jgrf.dec_band_count(dxRows) and nBands > 1
    Cl = jgrf.lensedClTT()
    ell = np.arange(len(Cl), dtype=float)
    key = jax.random.PRNGKey(6)
    ref = jgrf.gaussian_field_decaware(key, SHAPE, pix[0], dxRows, ell, Cl,
                                       n_bands=nBands)
    got = grf.gaussian_field_decaware(SHAPE, pix[0], dxRows, ell, Cl,
                                      n_bands=nBands, device=CPU,
                                      white=_white(key))
    _close(got, ref)


@pytest.mark.parametrize("lKnee", [None, 2000.0])
@pytest.mark.parametrize("level", ["scalar", "map"])
def test_sim_noise_map_matches_jax_given_white(lKnee, level):
    _, pix, _ = _tile(-20.0)
    noiseLevel = 12.0
    if level == "map":
        noiseLevel = np.full(SHAPE, 12.0)
        noiseLevel[:10] = 0.0
        noiseLevel[:, 60:] = 30.0
    key = jax.random.PRNGKey(7)
    ref = jgrf.sim_noise_map(key, SHAPE, noiseLevel, pix_scales_rad=pix,
                             lKnee=lKnee)
    got = grf.sim_noise_map(SHAPE, noiseLevel, pix_scales_rad=pix,
                            lKnee=lKnee, device=CPU, white=_white(key))
    _close(got, ref)


@pytest.mark.parametrize("decDeg", [-55.0, 0.0])
def test_sim_cmb_map_matches_jax_given_white(decDeg, tmp_path):
    """The beam-weighted spectrum, the banded (dec -55) or single-scale
    synthesis and the white noise, each given JAX's draw."""
    _, pix, dxRows = _tile(decDeg)
    path = str(tmp_path / "beam.txt")
    beams.makeGaussianBeamFile(path, 2.1)
    beam = beams.BeamProfile(beamFileName=path)
    key = jax.random.PRNGKey(8)
    ref = jgrf.sim_cmb_map(key, SHAPE, pix, beamBell=beam.Bell,
                           beamEll=beam.ell, noiseLevel=25.0,
                           dx_rows=dxRows)
    k1, k2 = jax.random.split(key)
    got = grf.sim_cmb_map(SHAPE, pix, beamBell=beam.Bell, beamEll=beam.ell,
                          noiseLevel=25.0, dx_rows=dxRows, device=CPU,
                          white=_white(k1), noise_white=_white(k2))
    _close(got, ref)


def test_port_draws_statistics():
    """The port's own draws: white noise at its level, the same seed the
    same map, another seed another map; a flat C_l field's variance
    matches sum over modes C/Omega_pix."""
    shape = (256, 256)
    gen = lambda s: torch.Generator().manual_seed(s)     # noqa: E731
    a = grf.sim_noise_map(shape, 10.0, device=CPU, generator=gen(1))
    b = grf.sim_noise_map(shape, 10.0, device=CPU, generator=gen(1))
    c = grf.sim_noise_map(shape, 10.0, device=CPU, generator=gen(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.std()) / 10.0 - 1) < 0.02
    pix = (np.radians(1 / 60.0),) * 2
    lmax = 5000
    Cl = np.full(lmax + 1, 1e-6)
    f = grf.gaussian_field(shape, pix, np.arange(lmax + 1.0), Cl,
                           device=CPU, generator=gen(3))
    lmap = fourier.rmodlmap(shape, pix)
    # each mode carries C / Omega_pix of power; the variance is their mean
    inside = np.fft.irfft2(np.where(lmap <= lmax, 1.0, 0.0), s=shape)[0, 0]
    expected = 1e-6 / (pix[0] * pix[1]) * inside
    assert abs(float(f.var()) / expected - 1) < 0.05
    with pytest.raises(ValueError):
        grf.sim_noise_map(shape, 1.0, device=CPU)
