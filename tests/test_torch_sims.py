"""The port's simulated skies in use, against the JAX package, float64 on
the CPU: the declination policy and its config override, ``simCMBMap`` /
``simNoiseMap``, the ``model`` and ``max(dataMap,CMB)`` noise methods of
the matched filter (alone, and through both engines' pipelines), the
``CMBSimSeed`` sky-sim preprocess and the contamination estimates, and the
``nemoModel`` CLI.

torch cannot reproduce ``jax.random``, so the port is given JAX's draws:
:class:`JaxDraws` replaces the port's one draw function
(``ops/grf.draw_normal``) and returns, for each torch generator (seeded as
the port seeds it), the field JAX draws from the same seed in the same
order.  Everything after the draw is then held to JAX's result.  Where the
curved-sky path runs, JAX's Legendre contraction is pinned to float64 (the
port's CPU dtype) and both packages' band limits are cut to keep the plain
contraction quick.
"""

import copy
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from nemo_tpu import filters as jfilters
from nemo_tpu import maps as jmaps
from nemo_tpu import pipelines as jpipelines
from nemo_tpu import startup as jstartup
from nemo_tpu.cli import nemoModel_main as jnemoModel
from nemo_tpu.ops import sht as jsht
from nemo_tpu_torch import catalogs, device as device_mod, filters, maps
from nemo_tpu_torch import pipelines, startup
from nemo_tpu_torch.cli import nemoModel_main
from nemo_tpu_torch.models import beams
from nemo_tpu_torch.ops import grf, sht
from nemo_tpu_torch.utils import fits as nfits
from nemo_tpu_torch.utils import wcs as nwcs
from nemo_tpu_torch.utils.tables import Table
from tests.test_torch_engine import make_survey

SHAPE = (90, 120)
PIX_DEG = 4.0 / 60.0
CPU = device_mod.CPU


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread while this module runs (the suite's
    workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """Stands in for ``grf.draw_normal``: the n-th draw from a generator
    seeded s is what the JAX package draws from ``PRNGKey(s)`` there - a
    CMB field from ``split(key)[0]`` (a flat field directly, an alm as the
    two halves of ``split(split(key)[0])``), the noise after it from
    ``split(key)[1]``, and a generator's first draw of noise from ``key``
    itself."""

    def __init__(self):
        self.count = {}
        self.keep = []

    def __call__(self, shape, dtype, device, generator, what):
        n = self.count.get(id(generator), 0)
        self.count[id(generator)] = n + 1
        self.keep.append(generator)
        key = jax.random.PRNGKey(generator.initial_seed())
        if what == "rand_alm":
            sub = jax.random.split(jax.random.split(key)[0])[n]
            arr = jax.random.normal(sub, shape, dtype=np.float32)
        elif n == 0 and what.startswith("gaussian_field"):
            arr = jax.random.normal(jax.random.split(key)[0], shape,
                                    dtype=np.float64)
        elif n == 0:
            arr = jax.random.normal(key, shape, dtype=np.float64)
        else:
            arr = jax.random.normal(jax.random.split(key)[1], shape,
                                    dtype=np.float64)
        return torch.as_tensor(np.array(arr), device=device).to(dtype)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(grf, "draw_normal", JaxDraws())


@pytest.fixture
def curved_f64(monkeypatch):
    """JAX's Legendre contraction in float64, and both packages' curved
    band limits cut to 200."""
    orig = jsht._contract

    def contract64(*args, **kw):
        kw["dtype"] = np.float64
        return orig(*args, **kw)

    monkeypatch.setattr(jsht, "_contract", contract64)
    for mod in (maps, jmaps):
        monkeypatch.setattr(mod, "CURVED_AUTO_LMAX", 200)
    for mod in (sht, jsht):
        monkeypatch.setattr(mod, "sim_noise_map_curved", functools.partial(
            mod.sim_noise_map_curved, lmax=200))


def _tileWCS(decDeg, shape=SHAPE):
    return nwcs.makeWCS(shape, PIX_DEG, centreRADeg=30.0,
                        centreDecDeg=decDeg)


def _close(got, ref, rtol=1e-10):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


# -- the declination policy ---------------------------------------------------

def test_resolve_sim_method_policy():
    import warnings
    wLow, wHigh = _tileWCS(0.0), _tileWCS(-55.0)
    assert maps.maxAbsDecDeg(wHigh, SHAPE) == jmaps.maxAbsDecDeg(wHigh, SHAPE)
    assert maps.resolveSimMethod(wLow, SHAPE, "auto") == "flat"
    assert maps.resolveSimMethod(wHigh, SHAPE, "auto") == "curved"
    assert maps.resolveSimMethod(wLow, SHAPE, "curved") == "curved"
    with pytest.warns(UserWarning, match="flat-sky"):
        assert maps.resolveSimMethod(wHigh, SHAPE, "flat",
                                     context="port-test") == "flat"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert maps.resolveSimMethod(wLow, SHAPE, "flat",
                                     context="port-test-low") == "flat"


@pytest.mark.parametrize("value,expected", [
    ("flat", "flat"), ("curved", "curved"), ("auto", None)])
def test_simCMBMethod_sets_the_override(monkeypatch, value, expected):
    """The config key sets maps.SIM_METHOD_OVERRIDE, as the JAX package's
    does, and the override steers every auto call."""
    monkeypatch.setattr(maps, "SIM_METHOD_OVERRIDE", "flat")
    startup.parseConfigDict({"unfilteredMaps": [], "mapFilters": [],
                             "simCMBMethod": value})
    assert maps.SIM_METHOD_OVERRIDE == expected
    w = _tileWCS(0.0 if value == "curved" else -55.0)
    want = {"flat": "flat", "curved": "curved", "auto": "curved"}[value]
    assert maps.resolveSimMethod(w, SHAPE, "auto") == want
    with pytest.raises(ValueError):
        startup.parseConfigDict({"unfilteredMaps": [], "mapFilters": [],
                                 "simCMBMethod": "spherical"})


def test_simCMBMap_auto_dispatch(monkeypatch):
    monkeypatch.setattr(maps, "CURVED_AUTO_LMAX", 150)
    wHigh, wLow = _tileWCS(-55.0), _tileWCS(0.0)
    calls = sht._legendre_contract_plain.calls
    auto = maps.simCMBMap(SHAPE, wHigh, seed=3, policy=CPU)
    assert sht._legendre_contract_plain.calls == calls + 1
    explicit = maps.simCMBMap(SHAPE, wHigh, seed=3, method="curved",
                              lmax=150, policy=CPU)
    np.testing.assert_array_equal(auto, explicit)
    auto = maps.simCMBMap(SHAPE, wLow, seed=3, policy=CPU)
    flat = maps.simCMBMap(SHAPE, wLow, seed=3, method="flat", policy=CPU)
    np.testing.assert_array_equal(auto, flat)
    assert np.isfinite(auto).all() and auto.std() > 0
    with pytest.raises(ValueError):
        maps.simCMBMap(SHAPE, wLow, seed=1, method="nope", policy=CPU)
    with pytest.raises(ValueError):
        maps.simNoiseMap(SHAPE, 10.0, wcs=wLow, seed=5, method="curved",
                         policy=CPU)


@pytest.mark.parametrize("decDeg", [-55.0, 0.0])
def test_sim_maps_match_jax_given_draws(decDeg, tmp_path, jax_draws,
                                        curved_f64):
    """simCMBMap (auto: curved at dec -55, flat at 0) with a beam and white
    noise, and simNoiseMap (1/f, auto), given JAX's draws: within 1e-10."""
    w = _tileWCS(decDeg)
    beamFile = str(tmp_path / "beam.txt")
    beams.makeGaussianBeamFile(beamFile, 1.4)
    ref = jmaps.simCMBMap(SHAPE, w, noiseLevel=15.0, beam=beamFile, seed=41)
    got = maps.simCMBMap(SHAPE, w, noiseLevel=15.0, beam=beamFile, seed=41,
                         policy=CPU)
    _close(got, ref)
    ref = jmaps.simNoiseMap(SHAPE, 12.0, wcs=w, lKnee=1500.0, seed=42)
    got = maps.simNoiseMap(SHAPE, 12.0, wcs=w, lKnee=1500.0, seed=42,
                           policy=CPU)
    _close(got, ref)


# -- the model and max(dataMap,CMB) filters alone -----------------------------

def _filterDicts(decDeg, beamFile, wcsmod):
    w = wcsmod.makeWCS(SHAPE, PIX_DEG, centreRADeg=30.0, centreDecDeg=decDeg)
    rng = np.random.default_rng(5)
    return [{"data": rng.normal(0, 30.0, SHAPE), "wcs": w,
             "weights": np.full(SHAPE, 1.0 / 30.0 ** 2),
             "beamFileName": beamFile, "obsFreqGHz": 149.6, "units": "uK",
             "flagMask": np.zeros(SHAPE, dtype=int),
             "surveyMask": np.ones(SHAPE),
             "pointSourceMask": np.ones(SHAPE)}]


@pytest.mark.parametrize("decDeg", [-55.0, 0.0])
@pytest.mark.parametrize("method", ["model", "max(dataMap,CMB)"])
def test_filter_matches_jax_given_stack(decDeg, method, tmp_path,
                                        monkeypatch):
    """The port's filter and SIGNORM within 1e-9 of JAX's, the port given
    JAX's noise stack (``givenNoiseStack``; for max(dataMap,CMB) the stack
    is the data and the CMB floor is the port's own)."""
    from nemo_tpu.utils import wcs as jwcs
    monkeypatch.setattr(jmaps, "CURVED_AUTO_LMAX", 300)
    beamFile = str(tmp_path / "beam.txt")
    beams.makeGaussianBeamFile(beamFile, 1.4)
    params = {"noiseParams": {"method": method, "noiseGridArcmin": 40.0},
              "outputUnits": "uK"}
    jf = jfilters.BeamMatchedFilter("t", _filterDicts(decDeg, beamFile, jwcs),
                                    params)
    jf.buildAndApply()
    tf = filters.BeamMatchedFilter("t", _filterDicts(decDeg, beamFile, nwcs),
                                   params, policy=CPU)
    if method == "model":
        tf.givenNoiseStack = np.asarray(jf._noiseStack(None))
    tf.buildAndApply()
    _close(tf.filt.numpy(), np.asarray(jf.filt), 1e-9)
    assert abs(tf.signalNorm / jf.signalNorm - 1) < 1e-9
    if method == "max(dataMap,CMB)":
        _close(tf._foregroundsPower(), jf._foregroundsPower(), 1e-12)


def test_model_stack_matches_jax_given_draws(tmp_path, jax_draws,
                                             curved_f64):
    """The port's own model-noise stacks, given JAX's draws: the flat
    (dec 0) and curved (dec -55) paths within 1e-10."""
    from nemo_tpu.utils import wcs as jwcs
    beamFile = str(tmp_path / "beam.txt")
    beams.makeGaussianBeamFile(beamFile, 1.4)
    params = {"noiseParams": {"method": "model", "noiseGridArcmin": 40.0},
              "outputUnits": "uK"}
    for decDeg in (0.0, -55.0):
        jf = jfilters.BeamMatchedFilter(
            "t", _filterDicts(decDeg, beamFile, jwcs), params)
        tf = filters.BeamMatchedFilter(
            "t", _filterDicts(decDeg, beamFile, nwcs), params, policy=CPU)
        _close(tf._noiseStack(None).numpy(), np.asarray(jf._noiseStack(None)))


# -- pipelines on the seeded four-tile survey ---------------------------------

NUMERIC = ("y_c", "err_y_c", "SNR", "fixed_y_c", "fixed_SNR",
           "fixed_err_y_c")


def _write(cfg, work, name, **over):
    d = dict(copy.deepcopy(cfg), **over)
    d["outputDir"] = os.path.join(work, name)
    path = os.path.join(work, name + ".yml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def _run_jax(cfg, work, name, **over):
    config = jstartup.NemoConfig(_write(cfg, work, name, **over),
                                 writeTileInfo=True)
    cat = jpipelines.filterMapsAndMakeCatalogs(
        config, writeAreaMask=True, writeFlagMask=True, verbose=False)
    return cat, config


def _run_port(cfg, work, name, **over):
    config = startup.NemoConfig(_write(cfg, work, name, **over),
                                device="cpu", writeTileInfo=True)
    cat = pipelines.filterMapsAndMakeCatalogs(
        config, writeAreaMask=True, writeFlagMask=True, verbose=False)
    return cat, config


def _same_catalog(got, ref, tol=1e-6):
    """The same rows (sorted by name), positions within 1e-6 arcsec,
    numeric columns within ``tol``."""
    assert len(ref) > 5 and len(got) == len(ref)
    g = np.argsort(np.asarray(got["name"]))
    r = np.argsort(np.asarray(ref["name"]))
    assert list(np.asarray(got["name"])[g]) == list(np.asarray(ref["name"])[r])
    sep = catalogs.calcAngSepDeg(
        np.asarray(got["RADeg"])[g], np.asarray(got["decDeg"])[g],
        np.asarray(ref["RADeg"])[r], np.asarray(ref["decDeg"])[r]) * 3600
    assert np.max(sep) < 1e-6
    for col in NUMERIC:
        np.testing.assert_allclose(np.asarray(got[col], float)[g],
                                   np.asarray(ref[col], float)[r],
                                   rtol=tol, atol=0, err_msg=col)


def _same_filters(config, jconfig, tol=1e-9):
    n = 0
    for tile in jconfig.tileNames:
        for f in jconfig.parDict["mapFilters"]:
            name = "filter_%s#%s.fits" % (f["label"], tile)
            ref, rh = nfits.read_image(os.path.join(
                jconfig.diagnosticsDir, tile, name))
            got, gh = nfits.read_image(os.path.join(
                config.diagnosticsDir, tile, name))
            _close(got, ref, tol)
            assert abs(gh["SIGNORM"] / rh["SIGNORM"] - 1) < tol
            n += 1
    assert n == len(jconfig.tileNames) * len(jconfig.parDict["mapFilters"])


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("torch_sims"))
    cfg = make_survey(work)
    cfg["mapFilters"] = cfg["mapFilters"][:1]
    cfg["allFilters"]["params"]["saveFilter"] = True
    return work, cfg


def _with_method(cfg, method):
    cfg = copy.deepcopy(cfg)
    cfg["allFilters"]["params"]["noiseParams"]["method"] = method
    return cfg


@pytest.mark.parametrize("method", ["max(dataMap,CMB)", "model"])
def test_pipelines_match_jax(survey, method, monkeypatch):
    """Each noise method through the port's per-tile and batched engines
    against JAX's per-tile pipeline (the model stacks from JAX's draws):
    the saved filters within 1e-9, the catalogs row for row."""
    monkeypatch.setattr(grf, "draw_normal", JaxDraws())
    work, cfg = survey
    cfg = _with_method(cfg, method)
    tag = "max" if method.startswith("max") else "model"
    ref, jconfig = _run_jax(cfg, work, "jax_" + tag)
    host, hconfig = _run_port(cfg, work, "host_" + tag)
    _same_filters(hconfig, jconfig)
    _same_catalog(host, ref)
    launches = sht.legendre_contract.launches
    batched, bconfig = _run_port(cfg, work, "batched_" + tag,
                                 useDeviceBatching=True)
    assert sht.legendre_contract.launches == launches
    _same_filters(bconfig, jconfig)
    _same_catalog(batched, ref)


def test_cmb_sim_seed_preprocess_matches_jax(survey, jax_draws):
    """The CMBSimSeed branch of MapDict.preprocess: the source-free sky of
    every band of a tile within 1e-10 of JAX's."""
    work, cfg = survey
    jconfig = jstartup.NemoConfig(_write(cfg, work, "seed_jax"),
                                  writeTileInfo=True)
    config = startup.NemoConfig(_write(cfg, work, "seed_port"),
                                device="cpu", writeTileInfo=True)
    tile = config.tileNames[0]
    for jm, tm in zip(jconfig.unfilteredMapsDictList,
                      config.unfilteredMapsDictList):
        jd, td = jm.copy(), tm.copy()
        for d in (jd, td):
            d["CMBSimSeed"] = 8000
            d.preprocess(tileName=tile)
        _close(td["data"], jd["data"])
        assert np.any(td["data"] != 0)


def test_contamination_estimates_match_jax(survey, jax_draws):
    """estimateContaminationFromSkySim (one sim, given JAX's draws) and
    estimateContaminationFromInvertedMaps after a dataMap run, then
    estimateContamination: the same tables."""
    work, cfg = survey
    jcat, jconfig = _run_jax(cfg, work, "contam_jax")
    cat, config = _run_port(cfg, work, "contam_port")
    _same_catalog(cat, jcat)
    jsims = jmaps.estimateContaminationFromSkySim(jconfig, numSkySims=1)
    sims = maps.estimateContaminationFromSkySim(config, numSkySims=1)
    assert len(sims) == len(jsims) == 1
    assert len(sims[0]) == len(jsims[0])
    jinv = jmaps.estimateContaminationFromInvertedMaps(jconfig)
    inv = maps.estimateContaminationFromInvertedMaps(config)
    assert len(inv) == len(jinv)
    diag = os.path.join(work, "contam_port")
    for sim, jsim, label in ((sims[0], jsims[0], "skySim"),
                             (inv, jinv, "invertedMap")):
        got = maps.estimateContamination(sim, cat, ["SNR", "fixed_SNR"],
                                         label, diagnosticsDir=diag)
        ref = jmaps.estimateContamination(jsim, jcat, ["SNR", "fixed_SNR"],
                                          label)
        assert sorted(got) == sorted(ref)
        for k in ref:
            for col in ref[k].keys():
                np.testing.assert_array_equal(np.asarray(got[k][col]),
                                              np.asarray(ref[k][col]))
        maps.plotContamination(got, diag)
    assert os.path.exists(os.path.join(
        diag, "skySim_SNR_contaminationEstimate_usefulFractions.txt"))


# -- nemoModel ----------------------------------------------------------------

@pytest.fixture(scope="module")
def model_inputs(tmp_path_factory):
    """A dec -55 template at 4', a Gaussian beam and a catalog of three
    clusters (y_c, template) and two point sources (deltaT_c)."""
    d = tmp_path_factory.mktemp("nemoModel")
    w = _tileWCS(-55.0)
    template = str(d / "template.fits")
    nfits.write_image(template, np.ones(SHAPE), w.header)
    beamFile = str(d / "beam.txt")
    beams.makeGaussianBeamFile(beamFile, 2.1)
    coords = w.pix2wcs(np.array([30.0, 60.0, 90.0]),
                       np.array([25.0, 45.0, 65.0]))
    cat = Table({"name": np.array(["c0", "c1", "c2"]),
                 "RADeg": coords[:, 0], "decDeg": coords[:, 1],
                 "y_c": np.array([3.0, 5.0, 4.0]),
                 "template": np.array(["Arnaud_M2e14_z0p4"] * 3)})
    catPath = str(d / "clusters.fits")
    cat.write(catPath)
    return d, template, beamFile, catPath


def _jax_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["nemoModel"] + argv)
    jnemoModel.main()


@pytest.mark.parametrize("extra", [[], ["-C", "--curved-cmb", "--cmb-lmax",
                                        "200", "-N", "20", "--lknee",
                                        "2000", "-S", "42"]])
def test_nemoModel_matches_jax(model_inputs, extra, monkeypatch, jax_draws,
                               curved_f64):
    """nemoModel's main(): the model image alone, and with a curved CMB at
    lmax 200 and 1/f noise on the curved path (given JAX's draws), within
    1e-10 of JAX's output FITS."""
    d, template, beamFile, catPath = model_inputs
    tag = "sims" if extra else "model"
    outJ = str(d / ("jax_%s.fits" % tag))
    outT = str(d / ("port_%s.fits" % tag))
    _jax_main([catPath, template, beamFile, outJ, "-f", "97.8"] + extra,
              monkeypatch)
    calls = sht._legendre_contract_plain.calls
    nemoModel_main.main([catPath, template, beamFile, outT, "-f", "97.8",
                         "--device", "cpu"] + extra)
    ref, _ = nfits.read_image(outJ)
    got, _ = nfits.read_image(outT)
    _close(got, ref)
    # the CMB's synthesis; the 1/f noise's analysis and two syntheses
    assert sht._legendre_contract_plain.calls == calls + (4 if extra else 0)
    if extra:
        for suffix in ("_signalOnly.fits", "_signalAndCMB.fits"):
            ref, _ = nfits.read_image(outJ.replace(".fits", suffix))
            got, _ = nfits.read_image(outT.replace(".fits", suffix))
            _close(got, ref)
