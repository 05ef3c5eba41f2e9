"""The port's RMS tables, fRel weights, fused products, selection function,
mass-limit maps and cached-RMS rerun against the JAX package's, float64 on
the CPU, on the JAX run of ``test_torch_selfn.py``'s survey.

Tolerances: the tables, weights and fused maps are host numpy on the same
files in both packages (copied code): equal.  The completeness grids are
host numpy too, on a mock survey whose cosmology is the copied module
(Eisenstein & Hu transfer): 1e-10 relative.  The cached-RMS rerun filters
the maps again with float64 torch ops against XLA's: catalog values within
1e-9 relative (the packages' FFTs sum in other orders).
"""

import os
import shutil

import numpy as np
import pytest

from nemo_tpu import completeness as jcompleteness
from nemo_tpu import pipelines as jpipelines
from nemo_tpu_torch import completeness, pipelines
from nemo_tpu_torch.models import qfit
from nemo_tpu_torch.utils import fits as nfits
from nemo_tpu_torch.utils.tables import Table
from tests.test_torch_selfn import (  # noqa: F401
    PHOT, jax_run, one_torch_thread, port_copy)

CTOL = 1e-10


@pytest.fixture(scope="module")
def port_tables(jax_run):  # noqa: F811
    """The port's epilogue (Q fit, RMS tables, fRel weights, tidy-up) on
    a copy of the JAX run without its selection-function products."""
    work, jconfig, _ = jax_run
    cfgPath, config = port_copy(work, "tables", qfitTileBatch=False)
    qfit.fitQ(config)
    pipelines.makeRMSTables(config)
    completeness.getFRelWeights(config)
    completeness.tidyUp(config)
    return work, jconfig, config, cfgPath


def _table(path):
    return Table.read(path)


def test_rms_tables_equal(port_tables):
    _, jconfig, config, _ = port_tables
    got = _table(os.path.join(config.selFnDir, "RMSTab.fits"))
    ref = _table(os.path.join(jconfig.selFnDir, "RMSTab.fits"))
    assert sorted(got.keys()) == sorted(ref.keys())
    assert len(got) == len(ref) > 0
    for key in ref.keys():
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)
    assert sorted(set(np.asarray(got["tileName"]))) == \
        sorted(jconfig.tileNames)


def test_frel_weights_and_tile_areas_equal(port_tables):
    _, jconfig, config, _ = port_tables
    got = completeness.loadFRelWeights(
        os.path.join(config.selFnDir, "fRelWeights.fits"))
    ref = jcompleteness.loadFRelWeights(
        os.path.join(jconfig.selFnDir, "fRelWeights.fits"))
    assert got == ref and len(got) == 4
    ga = _table(os.path.join(config.selFnDir, "tileAreas.fits"))
    ra = _table(os.path.join(jconfig.selFnDir, "tileAreas.fits"))
    np.testing.assert_array_equal(np.asarray(ga["tileName"]),
                                  np.asarray(ra["tileName"]))
    np.testing.assert_array_equal(np.asarray(ga["areaDeg2"]),
                                  np.asarray(ra["areaDeg2"]))


def test_fused_rms_maps_equal(port_tables):
    _, jconfig, config, _ = port_tables
    name = "RMSMap_%s.fits" % PHOT
    for tile in jconfig.tileNames:
        got, _ = nfits.read_image(os.path.join(config.selFnDir, name),
                                  ext=tile)
        ref, _ = nfits.read_image(os.path.join(jconfig.selFnDir, name),
                                  ext=tile)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _selfns(jconfig, selFnDir):
    port = completeness.SelFn(selFnDir, 5.0, device="cpu")
    jax = jcompleteness.SelFn(jconfig.selFnDir, 5.0)
    return port, jax


@pytest.mark.parametrize("source", ["jax", "port"])
def test_selfn_completeness_matches(port_tables, source):
    """compMz with Eisenstein & Hu, before and after update(), and the 90%
    mass limit: the port's SelFn on the JAX run's selFn/ and on its own."""
    _, jconfig, config, _ = port_tables
    selFnDir = jconfig.selFnDir if source == "jax" else config.selFnDir
    if source == "port":
        shutil.copy(os.path.join(jconfig.selFnDir, "config.yml"),
                    os.path.join(config.selFnDir, "config.yml"))
    port, jax = _selfns(jconfig, selFnDir)
    assert port.mockSurvey.cosmoModel.device == "cpu"
    assert port.tileNames == jax.tileNames
    np.testing.assert_allclose(port.compMz, jax.compMz, rtol=CTOL,
                               atol=1e-14)
    assert 0.3 < np.max(port.compMz) <= 1.0
    for s in (port, jax):
        s.update(72.0, 0.28, 0.047, 0.78, 0.96)
    np.testing.assert_allclose(port.compMz, jax.compMz, rtol=CTOL,
                               atol=1e-14)
    np.testing.assert_allclose(port.getMassLimit(0.9), jax.getMassLimit(0.9),
                               rtol=CTOL, equal_nan=True)


def test_completeness_and_mass_limit_maps_match(port_tables):
    """completenessByFootprint and the z = 0.5 mass-limit maps, as the
    CLI's -S epilogue runs them."""
    _, jconfig, config, _ = port_tables
    shutil.copy(os.path.join(jconfig.selFnDir, "config.yml"),
                os.path.join(config.selFnDir, "config.yml"))
    config.configFileName = None
    got = completeness.completenessByFootprint(config)
    ref = jcompleteness.completenessByFootprint(jconfig)
    np.testing.assert_allclose(np.asarray(got["full"]["MLim_90pc_1e14MSun"]),
                               np.asarray(ref["full"]["MLim_90pc_1e14MSun"]),
                               rtol=CTOL, equal_nan=True)
    completeness.makeMassLimitMapsAndPlots(config)
    jcompleteness.makeMassLimitMapsAndPlots(jconfig)
    for tile in jconfig.tileNames:
        g, _ = completeness.loadMassLimitMap(tile, config.diagnosticsDir, 0.5)
        r, _ = jcompleteness.loadMassLimitMap(tile, jconfig.diagnosticsDir,
                                              0.5)
        assert np.any(g > 0)
        np.testing.assert_allclose(g, r, rtol=CTOL, equal_nan=True)


def test_cached_rms_map_rerun_matches(port_tables):
    """filterMapsAndMakeCatalogs(useCachedRMSMap=True): S/N against the
    selection function's RMS maps, in both packages."""
    work, jconfig, _, _ = port_tables
    _, config = port_copy(work, "cachedRMS")    # keeps the tiles' RMS maps
    got = pipelines.filterMapsAndMakeCatalogs(config, useCachedRMSMap=True,
                                              verbose=False)
    ref = jpipelines.filterMapsAndMakeCatalogs(jconfig, useCachedRMSMap=True,
                                               verbose=False)
    assert len(got) == len(ref) > 0
    got.sort("name")
    ref.sort("name")
    np.testing.assert_array_equal(np.asarray(got["name"]),
                                  np.asarray(ref["name"]))
    for key in ("SNR", "fixed_SNR", "fixed_y_c", "fixed_err_y_c"):
        np.testing.assert_allclose(np.asarray(got[key], dtype=float),
                                   np.asarray(ref[key], dtype=float),
                                   rtol=1e-9, err_msg=key)
