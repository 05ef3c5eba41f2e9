"""The port's batched step (nemo_tpu_torch.parallel.distribute) against the
JAX package's on a one-device CPU mesh, float64, on the same numpy-seeded
inputs: four ragged tiles (true shapes differing by a pixel or two inside
one padded-shape bucket), two bands, edge trim 0 and nonzero; the
production step's full, lean and detection tails and the benchmark step.
Tolerance rtol 1e-10 (float64, summation order only), integers exact.
Also ``fourier.windowed_irfft2``, the calibration read of the step.  The
step's inputs are built by ``tests/test_torch_cuda.step_inputs``, which
the card's own test of the step shares."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nemo_tpu.ops import fourier as jfourier
from nemo_tpu.parallel import distribute as jdist
from nemo_tpu.parallel.mesh import get_mesh
from nemo_tpu_torch.ops import fourier as tfourier
from nemo_tpu_torch.parallel import distribute as tdist
from tests.test_torch_cuda import STEP_GRID, STEP_PAD, step_inputs

PAD, GRID = STEP_PAD, STEP_GRID


def close(t, j, rtol=1e-10):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-300))


def _gauss(shape, cy, cx, sigma):
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    return np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))


@pytest.fixture(scope="module")
def inputs():
    args, meta, _ = step_inputs()
    return dict(args, meta=meta)


def run_both(inp, trimPix, **kw):
    jstep = jdist.make_sharded_matched_filter_step(get_mesh(n_devices=1),
                                                   GRID, trimPix, **kw)
    tstep = tdist.make_matched_filter_step(GRID, trimPix, **kw)
    args = [inp[k] for k in ("data", "data", "template", "calib", "w",
                             "apodM", "psMask", "surveyMask", "fg",
                             "peakYX")]
    jout = jstep(*[jnp.asarray(a) for a in args],
                 {k: jnp.asarray(v) for k, v in inp["meta"].items()})
    targs = [torch.as_tensor(a) for a in args]
    targs[1] = targs[0]          # dataMap noise: the same tensor
    tout = tstep(*targs, inp["meta"])
    return tout, jout


@pytest.mark.parametrize("trimPix", [0, 10])
def test_full_tail_matches_jax(inputs, trimPix):
    tout, jout = run_both(inputs, trimPix, undo_pixel_window=True,
                          return_filter=True)
    assert set(tout) == set(jout) | {"singularSystems"}
    assert tout["singularSystems"].tolist() == [0] * len(tout["signalNorm"])
    for k in ("filtered", "SNMap", "RMSMap", "signalNorm", "calibCrop",
              "filt"):
        close(tout[k], jout[k])
    np.testing.assert_array_equal(tout["surveyMask"].numpy(),
                                  np.asarray(jout["surveyMask"]))
    assert tout["surveyMask"].dtype == torch.uint8
    assert float(tout["SNMap"].abs().max()) > 4


@pytest.mark.parametrize("trimPix", [0, 10])
def test_lean_tail_matches_jax(inputs, trimPix):
    tout, jout = run_both(inputs, trimPix, lean_outputs=True)
    assert set(tout) == set(jout) | {"singularSystems"}
    assert tout["singularSystems"].tolist() == [0] * len(tout["signalNorm"])
    for k in ("filtered", "RMSCells", "signalNorm", "calibCrop"):
        close(tout[k], jout[k])
    np.testing.assert_array_equal(tout["surveyMask"].numpy(),
                                  np.asarray(jout["surveyMask"]))


@pytest.mark.parametrize("trimPix,useCom", [(0, True), (10, True),
                                            (10, False)])
def test_detect_tail_matches_jax(inputs, trimPix, useCom):
    params = (3.0, 24, 128, useCom, 8)
    tout, jout = run_both(inputs, trimPix, detect_params=params)
    assert set(tout) == set(jout) | {"singularSystems"}
    assert tout["singularSystems"].tolist() == [0] * len(tout["signalNorm"])
    for k in ("filtered", "SNMap", "RMSCells", "signalNorm", "calibCrop"):
        close(tout[k], jout[k])
    det, jdet = tout["det"], jout["det"]
    valid = np.asarray(jdet["valid"])
    assert valid.sum() >= 8
    for k in ("valid", "numPix", "nObjects"):
        np.testing.assert_array_equal(det[k].numpy(), np.asarray(jdet[k]))
    for k in ("peakY", "peakX"):
        np.testing.assert_array_equal(det[k].numpy()[valid],
                                      np.asarray(jdet[k])[valid])
    for k in ("comY", "comX", "peak"):
        close(det[k].numpy()[valid], np.asarray(jdet[k])[valid], 1e-12)
    for k in ("subSpline", "subNearest"):
        close(tout[k].numpy()[valid], np.asarray(jout[k])[valid])


def test_benchmark_step_matches_jax(inputs):
    """The benchmark step (the one bench.py times) on same-shape tiles:
    maps, the candidate lists above threshold (ties among the zero
    entries past each tile's peak count are ordered differently by
    jax.lax.top_k and torch.topk) and the survey statistics."""
    T, thr, topK = 4, 3.0, 32
    ny, nx = PAD
    rng = np.random.default_rng(7)
    data = rng.normal(size=(T, 2, ny, nx))
    data[:, :, 20:26, 40:46] += 6.0
    template = np.broadcast_to(_gauss(PAD, ny / 2, nx / 2, 2.5),
                               (T, 2, ny, nx)).copy()
    w = np.array([1.0, 0.8])
    apod = np.outer(tfourier._apod_profile(ny, 6),
                    tfourier._apod_profile(nx, 6))
    ps = np.ones((T, ny, nx))
    ps[0, 5:9, 5:9] = 0
    survey = np.ones((T, ny, nx))
    args = (data, data, template, w, apod, ps, survey)
    jout = jdist.make_sharded_tile_step(get_mesh(n_devices=1), GRID, 10,
                                        topK=topK, threshold=thr)(
        *[jnp.asarray(a) for a in args])
    tout = tdist.make_tile_step(GRID, 10, topK=topK, threshold=thr)(
        *[torch.as_tensor(a) for a in args])
    for k in ("filtered", "SNMap", "RMSMap", "peakVals"):
        close(tout[k], jout[k])
    above = np.asarray(jout["peakVals"]) > thr
    assert above.sum() >= T
    for k in ("peakYs", "peakXs"):
        np.testing.assert_array_equal(tout[k].numpy()[above],
                                      np.asarray(jout[k])[above])
    assert int(tout["surveyCandidateCount"]) == \
        int(jout["surveyCandidateCount"])
    np.testing.assert_array_equal(tout["surveyRMSHist"].numpy(),
                                  np.asarray(jout["surveyRMSHist"]))
    # the one-tile step agrees with the batch's first tile
    one = tdist._single_tile_step(*[torch.as_tensor(a[0]) if i not in (3, 4)
                                    else torch.as_tensor(a)
                                    for i, a in enumerate(args)],
                                  GRID, 10, topK, thr)
    close(one["SNMap"], tout["SNMap"][0])


def test_resident_map_reads_match_jax(inputs):
    """The cross-filter reads of a resident (S/N, signal) map pair:
    cutouts and sub-pixel reads at per-tile positions."""
    rng = np.random.default_rng(8)
    sn, fm = inputs["data"][:, 0], inputs["data"][:, 1]
    ys = rng.uniform(0, PAD[0] - 1, (4, 10))
    xs = rng.uniform(0, PAD[1] - 1, (4, 10))
    targs = [torch.as_tensor(a) for a in (sn, fm, ys, xs)]
    jargs = [jnp.asarray(a) for a in (sn, fm, ys, xs)]
    cut, y0, x0 = tdist.gather_cutouts_batch(*targs, window=6)
    jcut, jy0, jx0 = jdist.gather_cutouts_batch(*jargs, window=6)
    np.testing.assert_array_equal(cut.numpy(), np.asarray(jcut))
    np.testing.assert_array_equal(y0.numpy(), np.asarray(jy0))
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    for got, ref in zip(tdist.subpixel_read_batch(*targs, window=6),
                        jdist.subpixel_read_batch(*jargs, window=6)):
        close(got, ref)


def test_windowed_irfft2_matches_jax_and_full_inverse():
    rng = np.random.default_rng(3)
    for ny, nx in ((48, 70), (45, 63)):
        G = np.fft.rfft2(rng.normal(size=(2, ny, nx)))
        full = torch.fft.irfft2(torch.as_tensor(G), s=(ny, nx)).numpy()
        for y0, x0 in ((0, 0), (7, 20), (ny - 33, nx - 33)):
            got = tfourier.windowed_irfft2(torch.as_tensor(G), y0, x0, ny,
                                           nx, 33)
            ref = jfourier.windowed_irfft2(jnp.asarray(G), jnp.int32(y0),
                                           jnp.int32(x0), ny, nx, 33)
            close(got, ref)
            close(got, full[:, y0:y0 + 33, x0:x0 + 33])
    # one origin per batch entry, broadcast over the band axis
    Gb = np.fft.rfft2(rng.normal(size=(3, 2, 48, 70)))
    y0 = torch.tensor([0, 9, 15])
    x0 = torch.tensor([37, 2, 20])
    got = tfourier.windowed_irfft2(torch.as_tensor(Gb), y0, x0, 48, 70, 33)
    full = np.fft.irfft2(Gb, s=(48, 70))
    for i in range(3):
        close(got[i], full[i, :, int(y0[i]):int(y0[i]) + 33,
                           int(x0[i]):int(x0[i]) + 33])


def test_windowed_irfft2_float32_phases():
    """At the DR5 tile's padded width the phase k*x/n reaches ~2 pi * 700;
    reducing k*x mod n in integers keeps a float32 window within float32
    rounding of the float64 one."""
    ny, nx = 96, 1536
    G = np.fft.rfft2(np.random.default_rng(4).normal(size=(ny, nx)))
    ref = tfourier.windowed_irfft2(torch.as_tensor(G), 30, 1480, ny, nx, 33)
    got = tfourier.windowed_irfft2(torch.as_tensor(G).to(torch.complex64),
                                   30, 1480, ny, nx, 33)
    assert got.dtype == torch.float32
    err = (got.double() - ref).abs().max() / ref.abs().max()
    assert float(err) < 2e-5, float(err)
