"""The port's selection-function stage against the JAX package's, float64
on the CPU: the Q fit (all three routes), read from the JAX run's filter
caches.  The RMS tables, fRel weights and fused products
(``test_torch_selfn_tables.py``) and the masses
(``test_torch_selfn_mass.py``) share this file's JAX run.

The JAX pipeline runs once per test file on a small seeded two-band tiled
survey (four tiles of ~170 x 290 pixels, written with numpy): filters and
catalog, ``fitQ`` (tile-batched, kept as ``QFit_tileBatched.fits``, then
serial), ``makeRMSTables``, ``getFRelWeights``,
``tidyUp``, with the config copied to ``selFn/config.yml`` as the CLI does.
The port then runs each stage on a copy of that output directory with the
JAX products of the stage removed.

Tolerances: Q is a ratio of filtered peaks that both packages compute
with the same float64 arithmetic (FFTs, spline reads) in a different
order: 1e-10 relative.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from nemo_tpu import completeness as jcompleteness
from nemo_tpu import pipelines as jpipelines
from nemo_tpu import startup as jstartup
from nemo_tpu.models import qfit as jqfit
from nemo_tpu_torch import catalogs, startup
from nemo_tpu_torch.models import qfit
from nemo_tpu_torch.utils.tables import Table
from tests.test_torch_engine import PHOT, make_survey

QTOL = 1e-10
# the JAX products of each stage, removed from the port's copy
SELFN_PRODUCTS = ("QFit.fits", "QFit_tileBatched.fits", "RMSTab.fits",
                  "fRelWeights.fits", "tileAreas.fits",
                  "RMSMap_%s.fits" % PHOT)
TILE_BATCHED = {"qfitTileBatch": True, "qfitBatchSize": 8,
                "qfitTileBatchSize": 3}
MASS_OPTIONS = {"tenToA0": 4.95e-5, "B0": 0.08, "Mpivot": 3.0e+14,
                "sigma_int": 0.2, "relativisticCorrection": True,
                "rescaleFactor": 0.71, "rescaleFactorErr": 0.07,
                "transferFunction": "eisenstein_hu"}


def selfn_config(work):
    """The survey's config with DR5's selection-function keys (the
    transfer function pinned to Eisenstein & Hu for CPU speed)."""
    cfg = make_survey(work)
    cfg["mapFilters"] = [f for f in cfg["mapFilters"] if f["label"] == PHOT]
    # the filtered maps are kept for the cached-map reruns (nemoMass -c)
    cfg["mapFilters"][0]["params"]["saveFilteredMaps"] = True
    cfg["stitchTiles"] = False
    cfg["fitQ"] = True
    cfg["calcSelFn"] = True
    cfg["massOptions"] = dict(MASS_OPTIONS,
                              redshiftCatalog=os.path.join(work,
                                                           "redshifts.fits"))
    cfg["selFnOptions"] = {"fixedSNRCut": 5.0, "method": "fast",
                           "massLimitMaps": [{"z": 0.5}]}
    return cfg


def write_config(cfg, path, outDir):
    d = copy.deepcopy(cfg)
    d["outputDir"] = outDir
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def run_jax(work):
    """The JAX pipeline and its selection-function epilogue; returns
    (config file, JAX config, optimal catalog)."""
    cfg = selfn_config(work)
    outDir = os.path.join(work, "jax")
    cfgPath = write_config(cfg, os.path.join(work, "jax.yml"), outDir)
    config = jstartup.NemoConfig(cfgPath, writeTileInfo=True)
    cat = jpipelines.filterMapsAndMakeCatalogs(config, writeAreaMask=True,
                                               writeFlagMask=True,
                                               verbose=False)
    catalogs.writeCatalog(cat, os.path.join(outDir, "jax_optimalCatalog.fits"))
    config.parDict.update(TILE_BATCHED)
    jqfit.fitQ(config)
    os.rename(os.path.join(config.selFnDir, "QFit.fits"),
              os.path.join(config.selFnDir, "QFit_tileBatched.fits"))
    for key in TILE_BATCHED:
        config.parDict.pop(key)
    jqfit.fitQ(config)
    jpipelines.makeRMSTables(config)
    jcompleteness.getFRelWeights(config)
    jcompleteness.tidyUp(config)
    shutil.copy(cfgPath, os.path.join(config.selFnDir, "config.yml"))
    return cfgPath, config, cat


def port_copy(work, name, **over):
    """A copy of the JAX run's output directory without its
    selection-function products, and the port's config (CPU) on it."""
    src = os.path.join(work, "jax")
    dst = os.path.join(work, name)
    shutil.copytree(src, dst)
    for f in SELFN_PRODUCTS:
        path = os.path.join(dst, "selFn", f)
        if os.path.exists(path):
            os.remove(path)
    budgets = os.path.join(dst, "diagnostics", "chunk_budgets.jsonl")
    if os.path.exists(budgets):
        os.remove(budgets)
    os.rename(os.path.join(dst, "jax_optimalCatalog.fits"),
              os.path.join(dst, "%s_optimalCatalog.fits" % name))
    cfg = dict(selfn_config(work), **over)
    cfgPath = write_config(cfg, os.path.join(work, name + ".yml"), dst)
    return cfgPath, startup.NemoConfig(cfgPath, device="cpu",
                                       writeTileInfo=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread while this module runs: the suite's
    workers share the machine's cores, and torch's spinning worker
    threads slow every small op when the cores are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, one_torch_thread):
    work = str(tmp_path_factory.mktemp("torch_selfn"))
    cfgPath, config, cat = run_jax(work)
    return work, config, cat


def qtabs(path):
    from nemo_tpu_torch.utils import fits as nfits
    out = {}
    for h in nfits.read(path):
        if h.is_table:
            cols, header = nfits.read_table(path, ext=h.name)
            out[h.name] = (Table(cols), header.get("ZDEPQ"))
    return out


def assert_qfit_equal(got, ref, rtol=QTOL):
    g, r = qtabs(got), qtabs(ref)
    assert sorted(g) == sorted(r) and len(g) == 4
    for tile in r:
        (tg, zg), (tr, zr) = g[tile], r[tile]
        assert zg == zr
        for col in ("theta500Arcmin", "z"):
            np.testing.assert_allclose(np.asarray(tg[col]),
                                       np.asarray(tr[col]), rtol=1e-12,
                                       err_msg=tile)
        np.testing.assert_allclose(np.asarray(tg["Q"]), np.asarray(tr["Q"]),
                                   rtol=rtol, atol=0, err_msg=tile)


@pytest.mark.parametrize("route,over", [
    ("serial", {"qfitTileBatch": False, "qfitBatchSize": 1}),
    ("modelBatched", {"qfitTileBatch": False, "qfitBatchSize": 16}),
    ("tileBatched", TILE_BATCHED)])
def test_fitq_routes_match_jax(jax_run, route, over):
    """Each of the port's routes reads the JAX run's filter caches and
    writes JAX's Q tables: the serial and model-batched routes the JAX
    serial route's, the tile-batched route the JAX tile-batched route's
    (1e-10) and the serial route's within the JAX package's own
    tile-batched tolerance (1e-7: the routes sum their transforms in
    other orders).  The tile-batched route records its chunks."""
    work, jconfig, _ = jax_run
    _, config = port_copy(work, "q_" + route, **over)
    qfit.fitQ(config)
    got = os.path.join(config.selFnDir, "QFit.fits")
    serial = os.path.join(jconfig.selFnDir, "QFit.fits")
    if route == "tileBatched":
        assert_qfit_equal(got, os.path.join(jconfig.selFnDir,
                                            "QFit_tileBatched.fits"))
        assert_qfit_equal(got, serial, rtol=1e-7)
    else:
        assert_qfit_equal(got, serial)
    if route == "tileBatched":
        budgets = os.path.join(config.diagnosticsDir, "chunk_budgets.jsonl")
        with open(budgets) as f:
            recs = [json.loads(line) for line in f]
        recs = [r for r in recs if r.get("stage") == "fitQ"]
        assert [r["nTiles"] for r in recs] == [3, 1]


def test_qfit_auto_route_is_serial_on_cpu(jax_run, monkeypatch):
    work, _, _ = jax_run
    _, config = port_copy(work, "q_auto")
    called = []
    monkeypatch.setattr(qfit, "_fitQTileBatched",
                        lambda *a, **k: called.append(1))
    qfit.fitQ(config)
    assert called == []
    assert os.path.exists(os.path.join(config.selFnDir, "QFit.fits"))


def test_qfit_files_read_across_packages(jax_run):
    """The port's QFit reads the JAX run's QFit.fits, and JAX's QFit the
    port's: the same Q at every tile and scale."""
    work, jconfig, _ = jax_run
    _, config = port_copy(work, "q_cross", qfitTileBatch=False)
    qfit.fitQ(config)
    theta = np.logspace(np.log10(0.3), np.log10(20.0), 12)
    portOnJax = qfit.QFit(selFnDir=jconfig.selFnDir)
    jaxOnPort = jqfit.QFit(selFnDir=config.selFnDir)
    jaxOnJax = jqfit.QFit(selFnDir=jconfig.selFnDir)
    for tile in jconfig.tileNames + [None]:
        ref = jaxOnJax.getQ(theta, z=0.4, tileName=tile)
        np.testing.assert_allclose(portOnJax.getQ(theta, z=0.4,
                                                  tileName=tile),
                                   ref, rtol=1e-12)
        np.testing.assert_allclose(jaxOnPort.getQ(theta, z=0.4,
                                                  tileName=tile),
                                   ref, rtol=QTOL)
    # Q = 1 at the reference filter's theta500 (the JAX package's check)
    from nemo_tpu_torch.models import cosmology
    thetaRef = cosmology.calcTheta500Arcmin(
        0.4, 2e14, cosmology.fiducialCosmoModel())
    for tile in jconfig.tileNames:
        q = portOnJax.getQ(np.array([thetaRef]), z=0.4, tileName=tile)
        assert abs(q[0] - 1.0) < 0.05
