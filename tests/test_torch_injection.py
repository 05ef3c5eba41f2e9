"""The source-injection test (``nemo -I``) and the batched cached-filter
rerun it is made of: the port against the JAX package, float64 on the
CPU, on the seeded four-tile survey of ``test_torch_engine.make_survey``.

The JAX package runs the first pass, the Q fit and the tables once per
file; each port run starts from a copy of that output (filter caches,
RMS maps, area masks, the optimal catalog), so both packages rerun the
same saved filters.  The mock catalogs come from numpy's
``default_rng(config seed)`` in both, so the whole test compares row by
row:

* ``sourceInjectionTest`` on the per-tile engine and on the batched
  engine against JAX's (per-tile engine): the same rows, positions within
  1e-6 arcsec, fluxes and S/N at rtol 1e-6; the same input catalog;
* a rerun builds no filter: no build step on the batched engine, no
  ``_buildFilter`` on the per-tile engine, and the caches are untouched;
  the batched rerun writes no RMS map (the per-tile engine's rule);
* one batched rerun against JAX's batched rerun (the filtered and S/N
  maps of the given-filter step at 1e-9, then the catalog with the
  per-tile engine's rule of no RMS map saved in a rerun) and against
  the port's per-tile rerun (catalogs: fluxes 1e-9, positions 1e-3
  arcsec);
* ``positionRecoveryAnalysis`` and ``noiseBiasAnalysis``, equal;
* ``QFit(QSource="injection"|"hybrid")`` and ``SelFn(method="injection")``
  from the same ``sourceInjectionData.fits``, 1e-10;
* the CLI with ``-I --device cpu``, and its warning on an empty table.

JAX's own batched engine is not the reference for the whole test: its
cached-filter rerun writes each rerun's RMS map over the selection
function's (``nemo_tpu/parallel/engine.py:1802``, ``_emit_result``)
before its S/N reads them, so its S/N differs from its per-tile engine's;
the port keeps the per-tile engine's rule (ROADMAP.md, section 3), and
the one-rerun catalog test gives JAX's batched engine that rule too.
"""

import copy
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

from nemo_tpu import completeness as jcompleteness
from nemo_tpu import maps as jmaps
from nemo_tpu import pipelines as jpipelines
from nemo_tpu import startup as jstartup
from nemo_tpu.models import qfit as jqfit
from nemo_tpu.parallel import engine as jengine
from nemo_tpu.parallel.mesh import get_mesh
from nemo_tpu_torch import catalogs, completeness, filters, maps, pipelines
from nemo_tpu_torch import startup
from nemo_tpu_torch.cli import nemo_main
from nemo_tpu_torch.models import qfit
from nemo_tpu_torch.parallel import distribute, engine
from nemo_tpu_torch.utils.tables import Table
from tests.test_torch_engine import PHOT
from tests.test_torch_selfn import selfn_config

# four models, so the injection Q spline has a theta500 range
MODELS = [{"redshift": 0.4, "M500": 0.8e14}, {"redshift": 0.4, "M500": 2e14},
          {"redshift": 0.4, "M500": 5e14}, {"redshift": 0.2, "M500": 8e14}]
INJECTION = {"sourceInjectionModels": MODELS, "sourceInjectionIterations": 1,
             "sourcesPerTile": 15, "seed": 334}
COLUMNS = ("RADeg", "decDeg", "SNR", "rArcmin", "inFlux", "outFlux",
           "noiseLevel", "theta500Arcmin")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread while this module runs (the suite's
    workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def injection_config(work):
    cfg = selfn_config(work)
    cfg["mapFilters"][0]["params"]["saveFilteredMaps"] = False
    cfg.update(copy.deepcopy(INJECTION))
    return cfg


def write_config(cfg, work, name, **over):
    d = dict(copy.deepcopy(cfg), **over)
    d["outputDir"] = os.path.join(work, name)
    path = os.path.join(work, name + ".yml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def port_copy(work, cfg, name, **over):
    """A copy of the JAX first pass's output and the port's config on it."""
    shutil.copytree(os.path.join(work, "first"), os.path.join(work, name))
    os.rename(os.path.join(work, name, "first_optimalCatalog.fits"),
              os.path.join(work, name, "%s_optimalCatalog.fits" % name))
    return startup.NemoConfig(write_config(cfg, work, name, **over),
                              device="cpu", writeTileInfo=True)


def mtimes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.startswith(("filter_", "RMSMap_")):
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, root)] = os.stat(p).st_mtime_ns
    return out


@pytest.fixture(scope="module")
def injected(tmp_path_factory, one_torch_thread):
    """The JAX first pass and epilogue, then the injection test by JAX
    (per-tile engine) and by the port on both engines, with the port's
    filter builds counted."""
    work = str(tmp_path_factory.mktemp("torch_injection"))
    cfg = injection_config(work)
    first = jstartup.NemoConfig(write_config(cfg, work, "first"),
                                writeTileInfo=True)
    cat = jpipelines.filterMapsAndMakeCatalogs(
        first, writeAreaMask=True, writeFlagMask=True, verbose=False)
    catalogs.writeCatalog(cat, os.path.join(first.rootOutDir,
                                            "first_optimalCatalog.fits"))
    jqfit.fitQ(first)
    jpipelines.makeRMSTables(first)
    jcompleteness.getFRelWeights(first)
    shutil.copy(first.configFileName,
                os.path.join(first.selFnDir, "config.yml"))

    out = {"work": work, "cfg": cfg}
    ports = {"host": port_copy(work, cfg, "host"),
             "batched": port_copy(work, cfg, "batched",
                                  useDeviceBatching=True)}
    jconfig = jstartup.NemoConfig(write_config(cfg, work, "first"),
                                  writeTileInfo=True)
    out["jax"] = jmaps.sourceInjectionTest(jconfig)
    out["jaxConfig"] = jconfig
    for tag, config in ports.items():
        before = mtimes(config.rootOutDir)
        steps = dict(distribute.make_matched_filter_step.calls)
        with mock.patch.object(filters.MatchedFilter, "_buildFilter",
                               autospec=True,
                               side_effect=filters.MatchedFilter._buildFilter
                               ) as hostBuilds:
            out[tag] = maps.sourceInjectionTest(config)
        calls = distribute.make_matched_filter_step.calls
        out[tag + "Counts"] = {
            "hostBuilds": hostBuilds.call_count,
            "buildSteps": calls["build"] - steps["build"],
            "givenSteps": calls["given"] - steps["given"],
            "changedFiles": sorted(k for k, v in mtimes(
                config.rootOutDir).items() if before.get(k) != v)}
        out[tag + "Config"] = config
    return out


def assert_tables_equal(got, ref):
    assert len(ref) > 20 and len(got) == len(ref)
    assert list(np.asarray(got["tileName"])) == \
        list(np.asarray(ref["tileName"]))
    assert list(np.asarray(got["sourceInjectionModel"])) == \
        list(np.asarray(ref["sourceInjectionModel"]))
    sep = catalogs.calcAngSepDeg(
        np.asarray(got["RADeg"]), np.asarray(got["decDeg"]),
        np.asarray(ref["RADeg"]), np.asarray(ref["decDeg"])) * 3600
    assert np.max(sep) < 1e-6
    for col in COLUMNS[2:]:
        np.testing.assert_allclose(np.asarray(got[col], dtype=float),
                                   np.asarray(ref[col], dtype=float),
                                   rtol=1e-6, atol=1e-12, err_msg=col)


@pytest.mark.parametrize("engineName", ["host", "batched"])
def test_injection_test_matches_jax(injected, engineName):
    assert_tables_equal(injected[engineName], injected["jax"])
    name = "sourceInjectionInputCatalog.fits"
    got = Table.read(os.path.join(injected[engineName + "Config"].selFnDir,
                                  name))
    ref = Table.read(os.path.join(injected["jaxConfig"].selFnDir, name))
    assert len(got) == len(ref) > len(injected["jax"])
    for col in ("RADeg", "decDeg", "inFlux", "theta500Arcmin"):
        np.testing.assert_array_equal(np.asarray(got[col]),
                                      np.asarray(ref[col]))


@pytest.mark.parametrize("engineName", ["host", "batched"])
def test_reruns_build_no_filter(injected, engineName):
    """Every rerun applies the saved filters: nothing builds one, the
    caches keep their files, and no rerun writes an RMS map."""
    counts = injected[engineName + "Counts"]
    assert counts["hostBuilds"] == 0
    assert counts["buildSteps"] == 0
    assert counts["changedFiles"] == []
    if engineName == "batched":
        # one given step a chunk (two chunks of two tiles) a model
        assert counts["givenSteps"] == 2 * len(MODELS)
    else:
        assert counts["givenSteps"] == 0


def rerun_setup(injected, name, **over):
    """A port config on a copy of the first pass with the maps carrying
    one mock catalog of each model's clusters (the first model's)."""
    config = port_copy(injected["work"], injected["cfg"], name, **over)
    mock_ = catalogs.generateTestCatalog(config, 12, amplitudeColumnName="y_c",
                                         amplitudeRange=[2.0, 8.0],
                                         maskDilationPix=20, seed=99)
    inj = {"catalog": mock_, "GNFWParams": config.parDict["GNFWParams"],
           "override": dict(MODELS[1]), "profile": "A10"}
    for mapDict in config.unfilteredMapsDictList:
        mapDict["injectSources"] = inj
    return config, inj


def test_batched_rerun_matches_jax_and_the_per_tile_rerun(injected):
    config, inj = rerun_setup(injected, "rerun_batched",
                              useDeviceBatching=True)
    photF = [f for f in config.parDict["mapFilters"]
             if f["label"] == PHOT]
    got = engine.batchFilterTilesMulti(config, photF, undoPixelWindow=False,
                                       verbose=False, useCachedFilters=True)
    jconfig = jstartup.NemoConfig(write_config(
        injected["cfg"], injected["work"], "rerun_batched",
        useDeviceBatching=True), writeTileInfo=True)
    for mapDict in jconfig.unfilteredMapsDictList:
        mapDict["injectSources"] = inj
    ref = jengine.batchFilterTilesMulti(
        jconfig, photF, mesh=get_mesh(n_devices=1), undoPixelWindow=False,
        verbose=False, useCachedFilters=True)
    for tile in config.tileNames:
        g, r = got[PHOT][tile], ref[PHOT][tile]
        for key in ("data", "SNMap"):
            np.testing.assert_allclose(
                g[key], r[key], rtol=1e-9,
                atol=1e-9 * np.abs(r[key]).max(), err_msg=key)
        np.testing.assert_array_equal(g["surveyMask"], r["surveyMask"])

    # the catalog of the batched rerun against the per-tile engine's and
    # against JAX's batched rerun, given the per-tile engine's rule that a
    # cached-filter rerun saves no RMS map (nemo_tpu/filters.py:621): the
    # batched engine lacks it and would overwrite the cached RMS maps
    # before its own S/N reads them
    cats = {}
    for tag, over in (("batched", {"useDeviceBatching": True}),
                      ("host", {})):
        c, _ = rerun_setup(injected, "rerun_cat_" + tag, **over)
        cats[tag] = pipelines.filterMapsAndMakeCatalogs(
            c, useCachedFilters=True, useCachedRMSMap=True, verbose=False)
    port_copy(injected["work"], injected["cfg"], "rerun_cat_jax")
    jconfig = jstartup.NemoConfig(write_config(
        injected["cfg"], injected["work"], "rerun_cat_jax",
        useDeviceBatching=True), writeTileInfo=True)
    for mapDict in jconfig.unfilteredMapsDictList:
        mapDict["injectSources"] = inj
    for f in jconfig.parDict["mapFilters"]:
        f["params"]["saveRMSMap"] = False
    with mock.patch.object(jengine, "get_mesh",
                           lambda: get_mesh(n_devices=1)):
        cats["jax"] = jpipelines.filterMapsAndMakeCatalogs(
            jconfig, useCachedFilters=True, useCachedRMSMap=True,
            verbose=False)
    b = cats["batched"]
    for tag in ("host", "jax"):
        h = cats[tag]
        assert len(h) > 10 and len(b) == len(h), tag
        sep = catalogs.calcAngSepDeg(np.asarray(b["RADeg"]),
                                     np.asarray(b["decDeg"]),
                                     np.asarray(h["RADeg"]),
                                     np.asarray(h["decDeg"])) * 3600
        assert np.max(sep) < 1e-3, tag
        for col in ("y_c", "err_y_c", "fixed_y_c", "SNR"):
            np.testing.assert_allclose(np.asarray(b[col]), np.asarray(h[col]),
                                       rtol=1e-9, err_msg=tag + " " + col)


def test_analyses_match_jax(injected, tmp_path):
    tab = injected["jax"]
    got = maps.positionRecoveryAnalysis(
        tab, str(tmp_path / "p.pdf"), pickleFileName=str(tmp_path / "p.pkl"))
    ref = jmaps.positionRecoveryAnalysis(
        tab, str(tmp_path / "q.pdf"), pickleFileName=str(tmp_path / "q.pkl"))
    assert sorted(got) == sorted(ref) == [50, 95, 99.7]
    for p in ref:
        for key in ("centres", "values"):
            np.testing.assert_array_equal(got[p][key], ref[p][key])
        if ref[p]["params"] is None:
            assert got[p]["params"] is None
        else:
            np.testing.assert_array_equal(got[p]["params"],
                                          ref[p]["params"])
    got = maps.noiseBiasAnalysis(tab)
    ref = jmaps.noiseBiasAnalysis(tab)
    for key in ("binCentres", "medianRatio"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert (got["params"] is None) == (ref["params"] is None)
    if ref["params"] is not None:
        np.testing.assert_array_equal(got["params"], ref["params"])


@pytest.fixture(scope="module")
def injection_selfn(injected):
    """The JAX selFn/ with the injection data written, as the CLI does."""
    selFnDir = injected["jaxConfig"].selFnDir
    path = os.path.join(selFnDir, "sourceInjectionData.fits")
    if not os.path.exists(path):
        injected["jax"].write(path)
    return selFnDir


@pytest.mark.parametrize("QSource", ["injection", "hybrid"])
def test_injection_q_matches_jax(injection_selfn, QSource):
    thetas = np.linspace(0.5, 8.0, 16)
    got = qfit.QFit(QSource=QSource, selFnDir=injection_selfn)
    ref = jqfit.QFit(QSource=QSource, selFnDir=injection_selfn)
    for tile in (None, "A", "D") if QSource == "hybrid" else (None,):
        q = got.getQ(thetas, z=0.4, tileName=tile)
        np.testing.assert_allclose(q, ref.getQ(thetas, z=0.4, tileName=tile),
                                   rtol=1e-10, atol=1e-14)
        assert np.all(np.isfinite(q)) and np.max(q) > 0.5


def test_injection_selfn_matches_jax(injection_selfn):
    got = completeness.SelFn(injection_selfn, 5.0, zMax=2.0, zStep=0.1,
                             method="injection", QSource="injection",
                             device="cpu")
    ref = jcompleteness.SelFn(injection_selfn, 5.0, zMax=2.0, zStep=0.1,
                              method="injection", QSource="injection")
    np.testing.assert_allclose(got.compMz, ref.compMz, rtol=1e-10,
                               atol=1e-14)
    assert 0.5 < np.max(got.compMz) <= 1.0


def test_cli_injection_on_cpu(injected, capsys):
    """``nemo cfg.yml -I --device cpu`` from scratch on the batched engine:
    its injection data are JAX's rows; rerun on the same output without
    sourceInjectionModels, the empty table only warns."""
    work, cfg = injected["work"], injected["cfg"]
    path = write_config(cfg, work, "cli", useDeviceBatching=True,
                        fitQ=False, calcSelFn=False)
    nemo_main.main([path, "-I", "--device", "cpu"])
    selFnDir = os.path.join(work, "cli", "selFn")
    tab = Table.read(os.path.join(selFnDir, "sourceInjectionData.fits"))
    assert len(tab) == len(injected["jax"])
    for col in ("inFlux", "outFlux", "SNR"):
        np.testing.assert_allclose(np.asarray(tab[col]),
                                   np.asarray(injected["jax"][col]),
                                   rtol=1e-6, err_msg=col)
    assert os.path.exists(os.path.join(work, "cli", "diagnostics",
                                       "positionRecovery.pkl"))

    os.remove(os.path.join(selFnDir, "sourceInjectionData.fits"))
    d = dict(copy.deepcopy(cfg), useDeviceBatching=True, fitQ=False,
             calcSelFn=False)
    d.pop("sourceInjectionModels")
    d["outputDir"] = os.path.join(work, "cli")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    capsys.readouterr()
    nemo_main.main([path, "-I", "--device", "cpu"])
    assert "source injection test recovered no objects" \
        in capsys.readouterr().out
    assert len(Table.read(os.path.join(selFnDir,
                                       "sourceInjectionData.fits"))) == 0
