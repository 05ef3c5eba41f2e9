"""The port's real-space matched filter (the DR3 / E-D56-style kernel
variant) against the JAX package's, float64 on the CPU, on inputs made from
a seed:

* the reflect-boundary convolutions (``imageops.convolve2d_reflect`` and
  its band-summed forms, through the FFT) against JAX and two direct sums,
  ``scipy.ndimage.convolve`` and torch's grouped ``conv2d``, within 1e-12
  of the peak; ``fourier.radial_distance_map`` bitwise;
* ``MatchedFilter.reshapeFilter`` and ``applyFilter`` on a map of another
  shape, within 1e-12 of the peak;
* ``filters.filterMaps`` with a real-space filter on
  ``tests/test_realspace_filter.py``'s fixture (one band and two, plain
  and symmetrised): the kernel, signal norm, background scale and fRel
  weights, and the signal, S/N and RMS maps and the survey mask, within
  1e-9 of the peak; the kernel FITS read back by both packages;
  ``_resolveRADecSection`` in its three modes; the batched engine's
  eligibility rules;
* on a small tiled survey: the port's batched engine against JAX's row for
  row (rtol 1e-6) and against the port's per-tile engine (the JAX
  package's own rtol 1e-3 for its two engines), and ``fitQ`` with the
  real-space reference filter against JAX's Q (rtol 1e-9).
"""

import copy
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml
from scipy import ndimage

import jax.numpy as jnp

from nemo_tpu import filters as jflt
from nemo_tpu import pipelines as jpipelines
from nemo_tpu import startup as jstartup
from nemo_tpu.models import qfit as jqfit
from nemo_tpu.ops import fourier as jfourier
from nemo_tpu.ops import imageops as jimageops
from nemo_tpu.parallel import engine as jengine
from nemo_tpu.utils import fits as jfits
from nemo_tpu.utils.wcs import WCS as JWCS
from nemo_tpu_torch import catalogs, filters as tflt, startup
from nemo_tpu_torch.models import qfit
from nemo_tpu_torch.ops import fourier, imageops
from nemo_tpu_torch.parallel import engine
from nemo_tpu_torch.utils import fits as nfits
from nemo_tpu_torch.utils import wcs as twcs
from tests.test_filters import _make_sim_tile
from tests.test_realspace_filter import REALSPACE_PARAMS
from tests.test_tile_noise_regions import _config as tnr_config
from tests.test_torch_engine import PHOT, make_survey, run_torch
from tests.test_torch_filters import (close, jax_filter, tile,  # noqa: F401
                                      torch_filter)
from tests.test_torch_selfn import qtabs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread while this module runs: the suite's
    workers share the machine's cores, and oversubscribed spinning
    threads slow every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def peak_close(t, j, tol):
    """|t - j| within tol of max |j| everywhere."""
    t, j = np.asarray(t, dtype=float), np.asarray(j, dtype=float)
    assert t.shape == j.shape
    err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-300)
    assert err <= tol, err


# -- the convolutions ---------------------------------------------------------

CONV_CASES = [((40, 50), (7, 9)),
              ((12, 15), (29, 31)),      # a kernel wider than the map
              ((33, 20), (1, 3)),
              ((24, 30), (15, 17))]      # wider than half the map


@pytest.mark.parametrize("shape,kshape", CONV_CASES)
def test_convolve2d_reflect_matches_jax_and_scipy(shape, kshape):
    rng = np.random.default_rng(sum(shape + kshape))
    m = rng.normal(size=(2,) + shape)
    k = rng.normal(size=(2,) + kshape)
    ref = [ndimage.convolve(m[i], k[i], mode="reflect") for i in range(2)]
    one = imageops.convolve2d_reflect(torch.as_tensor(m), k[0]).numpy()
    peak_close(one[0], ref[0], 1e-12)
    peak_close(one, jimageops.convolve2d_reflect(jnp.asarray(m), k[0]),
               1e-12)
    summed = imageops.convolve2d_reflect_sum(torch.as_tensor(m),
                                             torch.as_tensor(k)).numpy()
    peak_close(summed, ref[0] + ref[1], 1e-12)
    peak_close(summed, jimageops.convolve2d_reflect_sum(jnp.asarray(m),
                                                        jnp.asarray(k)),
               1e-12)


@pytest.mark.parametrize("shape,kshape", CONV_CASES)
def test_convolve2d_reflect_sum_batch_both_routes(shape, kshape):
    """The tile-batched form, each tile with its own kernels, through the
    wrapper and through ``_conv_sum`` on the padded maps, against two
    direct sums: scipy per tile and one grouped conv2d (the library call
    the transform replaced, a cross-correlation: kernels flipped)."""
    rng = np.random.default_rng(7 + sum(shape))
    m = torch.as_tensor(rng.normal(size=(3, 2) + shape))
    k = torch.as_tensor(rng.normal(size=(3, 2) + kshape))
    ref = np.stack([sum(ndimage.convolve(m[t, i].numpy(), k[t, i].numpy(),
                                         mode="reflect") for i in range(2))
                    for t in range(3)])
    calls = imageops.convolve2d_reflect_sum_batch.calls
    peak_close(imageops.convolve2d_reflect_sum_batch(m, k).numpy(), ref,
               1e-12)
    assert imageops.convolve2d_reflect_sum_batch.calls == calls + 1
    padded = imageops._reflect_pad(m, *kshape)
    direct = torch.nn.functional.conv2d(
        padded.reshape((1, 6) + padded.shape[-2:]),
        torch.flip(k, dims=(-2, -1)), groups=3)[0].numpy()
    peak_close(direct, ref, 1e-12)
    peak_close(imageops._conv_sum(padded, k).numpy(), direct, 1e-12)


@pytest.mark.parametrize("fn", ["convolve2d_reflect",
                                "convolve2d_reflect_sum",
                                "convolve2d_reflect_sum_batch"])
def test_convolve2d_reflect_even_kernel_raises(fn):
    m = torch.zeros((1, 1, 10, 10), dtype=torch.float64)
    k = torch.zeros((1, 1, 4, 5), dtype=torch.float64)
    args = {"convolve2d_reflect": (m[0, 0], k[0, 0]),
            "convolve2d_reflect_sum": (m[0], k[0]),
            "convolve2d_reflect_sum_batch": (m, k)}[fn]
    with pytest.raises(ValueError, match="odd"):
        getattr(imageops, fn)(*args)


@pytest.mark.parametrize("shape,sigma", [((164, 276), (60.0, 60.0)),
                                         ((50, 40), (20.0, 7.0))])
def test_background_smoothing_matches_jax_and_scipy(shape, sigma):
    """The background subtraction's wide Gaussian (hundreds of taps: the
    CPU correlates through the FFT above imageops._CPU_FFT_TAPS) against
    scipy and JAX, within 1e-12 of the peak."""
    m = np.random.default_rng(3).normal(0, 100, shape)
    got = imageops.gaussian_filter(torch.as_tensor(m), sigma).numpy()
    peak_close(got, ndimage.gaussian_filter(m, sigma, mode="reflect"), 1e-12)
    peak_close(got, jimageops.gaussian_filter(jnp.asarray(m), sigma), 1e-12)
    assert 2 * int(4 * max(sigma) + 0.5) + 1 > imageops._CPU_FFT_TAPS


@pytest.mark.parametrize("shape,center", [((40, 51), None),
                                          ((17, 8), (3, 5))])
def test_radial_distance_map_bitwise(shape, center):
    pix = (np.radians(0.5 / 60), np.radians(0.47 / 60))
    np.testing.assert_array_equal(
        fourier.radial_distance_map(shape, pix, center=center),
        jfourier.radial_distance_map(shape, pix, center=center))


# -- reshapeFilter ------------------------------------------------------------

def built_pair(tile):
    d, jdicts, tdicts = tile
    jf = jax_filter(jdicts, None)
    jf.buildAndApply()
    tf = torch_filter(tdicts, None)
    tf.loadFilterState(np.asarray(jf.filt), jf.signalNorm, jf.fRelWeights)
    return jf, tf, np.stack([m["data"] for m in tdicts])


@pytest.mark.parametrize("shape", [(100, 130), (150, 168)])
def test_reshape_filter_matches_jax(tile, shape):
    jf, tf, _ = built_pair(tile)
    peak_close(tf.reshapeFilter(shape), jf.reshapeFilter(shape), 1e-12)
    nf = len(jf.unfilteredMapsDictList)
    peak_close(tf.reshapeFilter((nf,) + shape),
               jf.reshapeFilter((nf,) + shape), 1e-12)


def test_apply_filter_other_shape_matches_jax(tile):
    """A map of another shape is filtered with the filter interpolated onto
    its grid, at that grid's own transform size (the JAX package's
    padShape for it), not at the filter's."""
    jf, tf, stack = built_pair(tile)
    sub = stack[:, 7:107, 11:141]
    got = tf.applyFilter(sub)
    peak_close(got, jf.applyFilter(jnp.asarray(sub)), 1e-12)
    assert got.shape == sub.shape[-2:]


# -- the real-space filter on one tile ----------------------------------------

def band_dicts(nBands, shape):
    """tests/test_realspace_filter.py's tile (one band), with an f090 band
    of the same sky geometry as the second; the JAX map dicts and the
    port's."""
    jdicts = [_make_sim_tile(shape=shape, y0=2e-3, noise_uK=20.0)[0]]
    if nBands == 2:
        jdicts.append(_make_sim_tile(
            shape=shape, y0=2e-3, noise_uK=30.0, seed=1, freqGHz=97.8,
            fwhm=2.1, beam_name="beam_f090.txt")[0])
    tdicts = [dict(d, wcs=twcs.WCS(d["wcs"].header)) for d in jdicts]
    return jdicts, tdicts


def capture_rms(mp, mod):
    """Record the RMS maps a package's filters write, before RICE
    compression quantises them."""
    written = {}
    orig = mod.nfits.write_image

    def rec(path, data, *a, **k):
        if os.path.basename(path).startswith("RMSMap_"):
            written[os.path.basename(path)] = np.array(data)
        return orig(path, data, *a, **k)
    mp.setattr(mod.nfits, "write_image", rec)
    return written


def filter_both(tmp, nBands, symmetrize=False, shape=(512, 512)):
    """filterMaps with the real-space filter through both packages; returns
    {package: (output dict, filter object, work dir, RMS maps written)}."""
    params = copy.deepcopy(REALSPACE_PARAMS)
    params["noiseParams"]["symmetrize"] = symmetrize
    params["saveRMSMap"] = True
    f = {"label": "RS_Arnaud_M2e14_z0p4",
         "class": "ArnaudModelRealSpaceMatchedFilter", "params": params}
    jdicts, tdicts = band_dicts(nBands, shape)
    out = {}
    for name, mod, dicts, kw in (
            ("jax", jflt, jdicts, {}),
            ("torch", tflt, tdicts, {"policy": tflt.device_mod.CPU})):
        d = str(tmp / name)
        with pytest.MonkeyPatch.context() as mp:
            rms = capture_rms(mp, mod)
            res, obj = mod.filterMaps(dicts, f, "PRIMARY",
                                      diagnosticsDir=d + "/diagnostics",
                                      selFnDir=d + "/selFn",
                                      returnFilter=True, **kw)
        out[name] = (res, obj, d, rms)
    return out


@pytest.fixture(scope="module")
def filtered_pairs(tmp_path_factory):
    runs = {}
    for nBands, sym, shape in ((1, False, (512, 512)), (2, False, (512, 512)),
                               (1, True, (400, 400))):
        tmp = tmp_path_factory.mktemp("rs_%d_%s" % (nBands, sym))
        runs[nBands, sym] = filter_both(tmp, nBands, sym, shape)
    return runs


PAIRS = [(1, False), (2, False), (1, True)]


@pytest.mark.parametrize("nBands,sym", PAIRS)
def test_realspace_kernel_state_matches_jax(filtered_pairs, nBands, sym):
    run = filtered_pairs[nBands, sym]
    jobj, tobj = run["jax"][1], run["torch"][1]
    assert tobj.kern2d.shape == jobj.kern2d.shape
    assert tobj.kern2d.shape[0] == nBands and tobj.kern2d.shape[1] % 2 == 1
    peak_close(tobj.kern2d, jobj.kern2d, 1e-9)
    close(tobj.signalNorm, jobj.signalNorm, rtol=1e-9)
    assert tobj.bckSubScaleArcmin == jobj.bckSubScaleArcmin
    assert list(tobj.fRelWeights) == list(jobj.fRelWeights)
    close(list(tobj.fRelWeights.values()), list(jobj.fRelWeights.values()),
          rtol=1e-9)


@pytest.mark.parametrize("nBands,sym", PAIRS)
def test_realspace_maps_match_jax(filtered_pairs, nBands, sym):
    run = filtered_pairs[nBands, sym]
    jres, tres = run["jax"][0], run["torch"][0]
    for key in ("data", "SNMap", "surveyMask"):
        peak_close(tres[key], jres[key], 1e-9)
    # the tile's RMS map and the kernel's sub-region filter's
    jrms, trms = run["jax"][3], run["torch"][3]
    assert sorted(trms) == sorted(jrms) == [
        "RMSMap_RS_Arnaud_M2e14_z0p4#PRIMARY.fits",
        "RMSMap_realSpaceKernel_RS_Arnaud_M2e14_z0p4#PRIMARY.fits"]
    for name in jrms:
        peak_close(trms[name], jrms[name], 1e-9)
    assert np.max(tres["SNMap"]) > 10       # the cluster is detected


@pytest.mark.parametrize("made_by", ["jax", "torch"])
def test_kernel_fits_read_by_both(filtered_pairs, made_by):
    """The kernel FITS (float32 kernel, SIGNORM, BCKSCALE, RW*) written by
    either package loads into both with the same state."""
    built = filtered_pairs[2, False][made_by][1]
    assert os.path.exists(built.filterFileName)
    for mod in (jflt, tflt):
        obj = object.__new__(mod.ArnaudModelRealSpaceMatchedFilter)
        obj.filterFileName = built.filterFileName
        obj.loadFilter()
        np.testing.assert_array_equal(
            obj.kern2d, np.asarray(built.kern2d, dtype=np.float32))
        assert obj.signalNorm == pytest.approx(built.signalNorm, rel=1e-15)
        assert obj.bckSubScaleArcmin == built.bckSubScaleArcmin
        assert obj.fRelWeights == pytest.approx(built.fRelWeights,
                                                rel=1e-15)


def test_kernel_profile_diagnostics_written(filtered_pairs):
    """The .npz of the kernel profile is written with every build, as the
    JAX package writes it, and holds the same profile; the PDF beside it
    is written where matplotlib is installed."""
    run = filtered_pairs[1, False]
    files = {}
    for name in ("jax", "torch"):
        d = os.path.join(run[name][2], "diagnostics")
        files[name] = np.load(os.path.join(
            d, "filterProf1D_RS_Arnaud_M2e14_z0p4#PRIMARY.npz"))
        assert os.path.exists(os.path.join(
            d, "filterPlot1D_RS_Arnaud_M2e14_z0p4#PRIMARY.pdf"))
    for key in ("arcminRange", "prof", "mask", "bckSubScaleArcmin"):
        peak_close(files["torch"][key], files["jax"][key], 1e-9)


def test_kernel_profile_pdf_skipped_without_matplotlib(filtered_pairs,
                                                       tmp_path, monkeypatch,
                                                       capsys):
    """Without matplotlib (the machine with the card has none) the build
    writes the .npz, warns and goes on."""
    tobj = filtered_pairs[1, False]["torch"][1]
    monkeypatch.setattr(tobj, "diagnosticsDir", str(tmp_path))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    prof = np.array([[1.0, 0.5, 0.0, -0.1, -0.05, 0.0]])
    arcmin = np.arange(6) * 2.0
    tobj._saveKernelProfilePlot(prof, arcmin, arcmin < 9)
    assert "WARNING" in capsys.readouterr().out
    names = os.listdir(tmp_path)
    assert any(n.endswith(".npz") for n in names)
    assert not any(n.endswith(".pdf") for n in names)


# -- the kernel sub-region ----------------------------------------------------

@pytest.mark.parametrize("mode", ["tileNoiseRegions", "auto", "explicit"])
def test_resolve_radec_section(tmp_path, mode):
    jconfig = tnr_config(tmp_path)
    tconfig = startup.NemoConfig(str(tmp_path / "tnr.yml"), device="cpu")
    section = {"tileNoiseRegions": "tileNoiseRegions", "auto": "auto",
               "explicit": [31.0, 29.0, -3.0, -2.0]}[mode]
    for tileName in ("T0", "T1"):
        got = []
        for mod, config, WCS in ((jflt, jconfig, JWCS),
                                 (tflt, tconfig, twcs.WCS)):
            fObj = object.__new__(mod.RealSpaceMatchedFilter)
            fObj.params = {"noiseParams": {"RADecSection": section}}
            fObj.tileName = tileName
            fObj.wcs = WCS(config.tileCoordsDict[tileName]["header"])
            got.append(fObj._resolveRADecSection())
        assert got[1] == got[0]
        if mode == "tileNoiseRegions":
            want = {"T0": [32.0, 28.0, -4.0, -1.0],
                    "T1": [32.5, 27.5, 0.5, 4.5]}[tileName]
            assert got[1] == want
        if mode == "explicit":
            assert got[1] == section


def test_resolve_radec_section_without_headers_raises(tmp_path):
    tnr_config(tmp_path)
    tconfig = startup.NemoConfig(str(tmp_path / "tnr.yml"), device="cpu")
    fObj = object.__new__(tflt.RealSpaceMatchedFilter)
    fObj.params = {"noiseParams": {"RADecSection": "tileNoiseRegions"}}
    fObj.tileName = "T0"
    fObj.wcs = twcs.WCS({k: v for k, v in
                         dict(tconfig.tileCoordsDict["T0"]["header"]).items()
                         if not k.startswith(("NRA", "NDE"))})
    with pytest.raises(ValueError, match="tileNoiseRegions"):
        fObj._resolveRADecSection()


# -- the batched engine -------------------------------------------------------

def _spec(cls, units="uK", **noise):
    noiseParams = dict({"method": "dataMap", "noiseGridArcmin": 40.0},
                       **noise)
    return {"class": cls, "params": {"noiseParams": noiseParams,
                                     "outputUnits": units}}


ELIGIBILITY = [
    (_spec("BeamRealSpaceMatchedFilter"), True),
    (_spec("BeamRealSpaceMatchedFilter", noiseGridArcmin="smart"), False),
    (dict(_spec("ArnaudModelRealSpaceMatchedFilter", "yc"),
          params={"noiseParams": {"method": "dataMap",
                                  "noiseGridArcmin": 40.0},
                  "bckSub": True, "outputUnits": "yc"}), True),
    (_spec("ArnaudModelRealSpaceMatchedFilter", "yc",
           noiseGridArcmin="smart"), False),
    (_spec("BattagliaModelRealSpaceMatchedFilter", RMSEstimator="biweight"),
     False),
    (_spec("BeamRealSpaceMatchedFilter", units="Jy"), False),
    (_spec("BeamRealSpaceMatchedFilter", method="model"), True),
    (_spec("BeamRealSpaceMatchedFilter", noiseGridArcmin=None), False),
    (dict(_spec("BeamMatchedFilter"),
          params={"noiseParams": {"method": "dataMap",
                                  "noiseGridArcmin": 40.0},
                  "bckSub": True, "outputUnits": "uK"}), False),
]


@pytest.mark.parametrize("spec,want", ELIGIBILITY)
def test_eligibility_matches_jax(spec, want):
    assert engine.eligibleForBatch(spec, {}) is want
    assert jengine.eligibleForBatch(spec, {}) is want


RS_PARAMS = {"noiseParams": {"method": "dataMap", "noiseGridArcmin": 10.0,
                             "RADecSection": "auto", "kernelMaxArcmin": 7.0,
                             "symmetrize": False,
                             "matchedFilterClass": "ArnaudModelMatchedFilter"},
             "bckSub": True, "bckSubScaleArcmin": 30.0, "outputUnits": "yc",
             "edgeTrimArcmin": 4.0}


# The Q fit's reference: a scale whose Q[0] passes the fit's 1% check.
# With a real-space reference the kernel's calibration template carries no
# pixel window and the Q models do, so at 0.5' pixels both packages stop
# on Q[0]/y0 = 0.975 for the M2e14 z0.4 scale (0.984 for M4e14 z0.2);
# this scale gives 0.992.
QREF = "Arnaud_M1e15_z0p1"


def realspace_survey(work):
    """test_torch_engine's two-band survey cut into four tiles without
    overlap, in two even shapes (two chunks of two tiles in the batched
    engine: an odd tile's Q model centre falls between pixels), filtered
    by two real-space scales."""
    cfg = make_survey(work)
    cfg["tileOverlapDeg"] = 0.0
    cfg["tileDefinitions"] = [
        {"tileName": "A", "RADecSection": [27.70, 30.0, -1.375, 0.0]},
        {"tileName": "B", "RADecSection": [30.0, 32.28, -1.375, 0.0]},
        {"tileName": "C", "RADecSection": [27.70, 30.0, 0.0, 1.365]},
        {"tileName": "D", "RADecSection": [30.0, 32.28, 0.0, 1.365]}]
    cfg["allFilters"] = {"class": "ArnaudModelRealSpaceMatchedFilter",
                         "params": copy.deepcopy(RS_PARAMS)}
    cfg["mapFilters"] = [{"label": QREF,
                          "params": {"M500MSun": 1e15, "z": 0.1}},
                         {"label": PHOT,
                          "params": {"M500MSun": 2e14, "z": 0.4}}]
    cfg["photFilter"] = QREF
    return cfg


@pytest.fixture(scope="module")
def rs_survey(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("torch_realspace"))
    cfg = realspace_survey(work)
    host, hostConfig = run_torch(cfg, os.path.join(work, "host"))
    bat, batConfig = run_torch(cfg, os.path.join(work, "batched"),
                               useDeviceBatching=True, deviceBatchSize=4)
    jcfg = copy.deepcopy(cfg)
    jcfg.update(useDeviceBatching=True, outputDir=os.path.join(work, "jax"))
    path = os.path.join(work, "jax.yml")
    with open(path, "w") as f:
        yaml.safe_dump(jcfg, f)
    jconfig = jstartup.NemoConfig(path, writeTileInfo=True)
    jcat = jpipelines.filterMapsAndMakeCatalogs(jconfig, writeAreaMask=True,
                                                writeFlagMask=True,
                                                verbose=False)
    jqfit.fitQ(jconfig)
    return {"work": work, "cfg": cfg, "host": host, "batched": bat,
            "batConfig": batConfig, "jax": jcat, "jaxConfig": jconfig}


def matched(ref, cat, radiusArcmin=0.05):
    refM, catM, _ = catalogs.crossMatch(ref, cat, radiusArcmin=radiusArcmin)
    assert len(refM) == len(ref) == len(cat)
    return refM, catM


def test_batched_engine_matches_jax_batched(rs_survey):
    """Row for row: every JAX row at the same position, with the same
    amplitudes and S/N."""
    ref, cat = rs_survey["jax"], rs_survey["batched"]
    assert len(ref) >= 10
    refM, catM = matched(ref, cat)
    for key in ("y_c", "err_y_c", "SNR", "fixed_y_c", "fixed_err_y_c",
                "fixed_SNR", "RADeg", "decDeg"):
        np.testing.assert_allclose(np.asarray(catM[key], dtype=float),
                                   np.asarray(refM[key], dtype=float),
                                   rtol=1e-6, err_msg=key)


def test_batched_engine_matches_host_engine(rs_survey):
    """The JAX package's own tolerance between its engines
    (tests/test_tiled_e2e.py:test_realspace_batched_matches_host)."""
    host, bat = rs_survey["host"], rs_survey["batched"]
    m1, m2 = matched(host, bat, radiusArcmin=0.5)
    for key in ("fixed_y_c", "SNR"):
        np.testing.assert_allclose(
            np.asarray(m2[key]) / np.asarray(m1[key]), 1.0, rtol=1e-3,
            err_msg=key)


def test_batched_engine_chunks(rs_survey):
    """Two chunks of two tiles a label (the tiles come in two true shapes),
    each with its staging and kernel-build seconds."""
    with open(os.path.join(rs_survey["batConfig"].diagnosticsDir,
                           "chunk_budgets.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["nTiles"] for r in recs] == [2, 2, 2, 2]
    assert len({tuple(r["padShape"]) for r in recs}) == 2
    for r in recs:
        assert 0 < r["kernelBuild"] < r["staging"]
        assert r["detectTiles"] == 0 and r["device"] == "cpu"


def test_fitq_realspace_reference_matches_jax(rs_survey, tmp_path):
    """The serial Q fit with a real-space reference filter, on a copy of
    the JAX run's outputs (its kernel FITS): models painted and filtered at
    the tile's true shape, one at a time, the peak read from the host
    map's crop."""
    jconfig = rs_survey["jaxConfig"]
    dst = str(tmp_path / "q")
    shutil.copytree(os.path.dirname(jconfig.selFnDir), dst)
    os.remove(os.path.join(dst, "selFn", "QFit.fits"))
    cfg = dict(rs_survey["cfg"], outputDir=dst)
    cfgPath = str(tmp_path / "q.yml")
    with open(cfgPath, "w") as f:
        yaml.safe_dump(cfg, f)
    config = startup.NemoConfig(cfgPath, device="cpu", writeTileInfo=True)
    qfit.fitQ(config)
    got = qtabs(os.path.join(config.selFnDir, "QFit.fits"))
    ref = qtabs(os.path.join(jconfig.selFnDir, "QFit.fits"))
    assert sorted(got) == sorted(ref) == ["A", "B", "C", "D"]
    for tileName in ref:
        (tg, _), (tr, _) = got[tileName], ref[tileName]
        np.testing.assert_allclose(np.asarray(tg["theta500Arcmin"]),
                                   np.asarray(tr["theta500Arcmin"]),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(tg["Q"]), np.asarray(tr["Q"]),
                                   rtol=1e-9, atol=0, err_msg=tileName)


def test_kernel_fits_written_by_batched_run(rs_survey):
    """The batched run's staging wrote each (tile, label) kernel FITS, and
    they hold the JAX batched run's kernels."""
    bat, jax = rs_survey["batConfig"], rs_survey["jaxConfig"]
    for tileName in bat.tileNames:
        name = "filter_%s#%s.fits" % (QREF, tileName)
        got, gh = nfits.read_image(os.path.join(bat.diagnosticsDir, tileName,
                                                name))
        ref, rh = jfits.read_image(os.path.join(jax.diagnosticsDir,
                                                tileName, name))
        peak_close(got, ref, 1e-6)
        assert gh["SIGNORM"] == pytest.approx(rh["SIGNORM"], rel=1e-9)
