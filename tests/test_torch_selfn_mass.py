"""The port's mass inference against the JAX package's, float64 on the
CPU, on the JAX run of ``test_torch_selfn.py``'s survey: the per-row
``calcMass``, the batched ``calcMassBatch`` (torch ops on the CPU against
JAX's jitted pass), and the ``nemoMass`` CLI (redshift-catalog cross-match
and forced photometry on the cached filtered maps).

Tolerances: ``calcMass`` is host numpy in both (copied code): 1e-12.  The
batched posterior and fine-grid search do the same float64 arithmetic
(the row sums in another order): masses and errors within 1e-9 relative.
"""

import os
import sys

import numpy as np
import pytest
import torch

from nemo_tpu import completeness as jcompleteness
from nemo_tpu.cli import nemoMass_main as jmass_main
from nemo_tpu.mock import MockSurvey as JMockSurvey
from nemo_tpu.models import qfit as jqfit
from nemo_tpu.models import scaling as jscaling
from nemo_tpu_torch import catalogs
from nemo_tpu_torch.cli import nemoMass_main
from nemo_tpu_torch.mock import MockSurvey
from nemo_tpu_torch.models import qfit, scaling
from nemo_tpu_torch.utils.tables import Table
from tests.test_torch_selfn import (  # noqa: F401
    MASS_OPTIONS, jax_run, one_torch_thread)

MTOL = 1e-9
MASS_KW = {k: MASS_OPTIONS[k] for k in ("tenToA0", "B0", "Mpivot",
                                        "sigma_int")}


@pytest.fixture(scope="module")
def mass_setup(jax_run):  # noqa: F811
    """Both packages' QFit (on the JAX run's selFn/) and mock surveys."""
    work, jconfig, cat = jax_run
    args = (1e13, 700.0, 0.0, 3.0, 70.0, 0.3, 0.05, 0.8, 0.95)
    kw = dict(delta=500, rhoType="critical",
              transferFunction="eisenstein_hu")
    return (work, jconfig, cat,
            qfit.QFit(selFnDir=jconfig.selFnDir),
            MockSurvey(*args, device="cpu", **kw),
            jqfit.QFit(selFnDir=jconfig.selFnDir),
            JMockSurvey(*args, **kw))


def seeded_rows(n, tiles, seed=5):
    """n rows of y0~, errors and redshifts, half photometric."""
    rng = np.random.default_rng(seed)
    y0 = rng.uniform(2e-5, 3e-4, n)
    return {"y0s": y0, "y0Errs": y0 / rng.uniform(4.0, 15.0, n),
            "zs": rng.uniform(0.1, 1.4, n),
            "zErrs": np.where(np.arange(n) % 2 == 0, 0.0,
                              rng.uniform(0.01, 0.05, n)),
            "tileNames": list(rng.choice(tiles, n))}


def test_calc_mass_rows_match(mass_setup):
    _, jconfig, _, Q, ms, jQ, jms = mass_setup
    rows = seeded_rows(4, jconfig.tileNames)
    for i in range(4):
        args = (rows["y0s"][i], rows["y0Errs"][i], rows["zs"][i],
                rows["zErrs"][i])
        got = scaling.calcMass(*args, Q, ms, tileName=rows["tileNames"][i],
                               **MASS_KW)
        ref = jscaling.calcMass(*args, jQ, jms,
                                tileName=rows["tileNames"][i], **MASS_KW)
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-12,
                                       err_msg=key)


def test_calc_mass_batch_matches_jax(mass_setup):
    _, jconfig, _, Q, ms, jQ, jms = mass_setup
    rows = seeded_rows(200, jconfig.tileNames)
    got = scaling.calcMassBatch(rows["y0s"], rows["y0Errs"], rows["zs"],
                                rows["zErrs"], Q, ms,
                                tileNames=rows["tileNames"], **MASS_KW)
    ref = jscaling.calcMassBatch(rows["y0s"], rows["y0Errs"], rows["zs"],
                                 rows["zErrs"], jQ, jms,
                                 tileNames=rows["tileNames"], **MASS_KW)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == np.float64
        np.testing.assert_allclose(got[key], ref[key], rtol=MTOL, atol=0,
                                   err_msg=key)
    assert np.all(got["M500c"] > 0) and np.all(got["M500c_errPlus"] > 0)
    # the batched rows agree with the per-row path
    one = scaling.calcMass(rows["y0s"][1], rows["y0Errs"][1], rows["zs"][1],
                           rows["zErrs"][1], Q, ms,
                           tileName=rows["tileNames"][1], **MASS_KW)
    np.testing.assert_allclose(got["M500c"][1], one["M500c"], rtol=1e-6)


def test_calc_mass_batch_without_errors(mass_setup):
    _, jconfig, _, Q, ms, jQ, jms = mass_setup
    rows = seeded_rows(20, jconfig.tileNames, seed=9)
    got = scaling.calcMassBatch(rows["y0s"], rows["y0Errs"], rows["zs"],
                                rows["zErrs"], Q, ms, calcErrors=False,
                                tileNames=rows["tileNames"], **MASS_KW)
    ref = jscaling.calcMassBatch(rows["y0s"], rows["y0Errs"], rows["zs"],
                                 rows["zErrs"], jQ, jms, calcErrors=False,
                                 tileNames=rows["tileNames"], **MASS_KW)
    np.testing.assert_allclose(got["M500c"], ref["M500c"], rtol=MTOL)
    np.testing.assert_array_equal(got["M500c_errPlus"], 0.0)


def test_m500_from_p_batch_matches_jax():
    """The batched ML search on seeded posteriors: the port on the CPU
    (asked for by name; the card is its default) against JAX's, 1e-9."""
    rng = np.random.default_rng(7)
    log10M = np.linspace(13.0, 16.0, 300)
    centres = rng.uniform(13.8, 15.2, 12)
    widths = rng.uniform(0.05, 0.3, 12)
    P = np.exp(-0.5 * ((log10M[None, :] - centres[:, None])
                       / widths[:, None]) ** 2)
    got = scaling.getM500FromPBatch(P, log10M, device="cpu")
    ref = jscaling.getM500FromPBatch(P, log10M)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=MTOL, atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            scaling.getM500FromPBatch(P, log10M)


def _redshift_catalog(cat, path, seed=11):
    """Redshifts at the catalog's positions: seeded z, half spectroscopic
    (zErr 0), half photometric."""
    rng = np.random.default_rng(seed)
    n = len(cat)
    tab = Table({"name": np.array(["z%03d" % i for i in range(n)]),
                 "RADeg": np.asarray(cat["RADeg"], dtype=float),
                 "decDeg": np.asarray(cat["decDeg"], dtype=float),
                 "z": rng.uniform(0.1, 1.0, n),
                 "zErr": np.where(np.arange(n) % 2 == 0, 0.0, 0.03)})
    catalogs.writeCatalog(tab, path)
    return tab


MASS_COLUMNS = ("M500c", "M500c_errPlus", "M500c_errMinus", "M500cUncorr",
                "M500cCal", "M500cCal_errPlus", "M200m", "M200mUncorr",
                "M200mCal", "M200m_errMinus", "Q")


def _run_jax_cli(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["nemoMass"] + argv)
    jmass_main.main()


def test_nemomass_cli_matches(mass_setup, monkeypatch):
    """The nemoMass CLI on the optimal catalog cross-matched with a
    redshift catalog: the port (--device cpu) and the JAX CLI write the
    same M500c, Uncorr, Cal and M200m columns."""
    work, jconfig, cat, *_ = mass_setup
    jcompleteness.getFRelWeights(jconfig)
    zTab = _redshift_catalog(cat, os.path.join(work, "redshifts.fits"))
    cfgPath = os.path.join(work, "jax.yml")
    portOut = os.path.join(work, "port_mass.fits")
    nemoMass_main.main([cfgPath, "--device", "cpu", "-o", portOut])
    jaxOut = os.path.join(work, "jax_mass.fits")
    _run_jax_cli([cfgPath, "-o", jaxOut], monkeypatch)
    got, ref = Table.read(portOut), Table.read(jaxOut)
    assert len(got) == len(ref) == len(zTab) > 0
    np.testing.assert_array_equal(np.asarray(got["name"]),
                                  np.asarray(ref["name"]))
    for key in MASS_COLUMNS:
        np.testing.assert_allclose(np.asarray(got[key], dtype=float),
                                   np.asarray(ref[key], dtype=float),
                                   rtol=MTOL, atol=0, err_msg=key)
    assert np.all(np.asarray(got["M500cCal"]) > np.asarray(got["M500c"]))


def test_nemomass_forced_photometry_matches(mass_setup, monkeypatch):
    """nemoMass -c on a catalog without fixed_y_c: forced photometry on
    the cached filtered maps, then masses, in both packages."""
    work, jconfig, cat, *_ = mass_setup
    inPath = os.path.join(work, "positions.fits")
    _redshift_catalog(cat[:6], inPath, seed=3)
    cfgPath = os.path.join(work, "jax.yml")
    portOut = os.path.join(work, "port_forced_mass.fits")
    jaxOut = os.path.join(work, "jax_forced_mass.fits")
    nemoMass_main.main([cfgPath, "-c", inPath, "--device", "cpu", "-o",
                        portOut])
    _run_jax_cli([cfgPath, "-c", inPath, "-o", jaxOut], monkeypatch)
    got, ref = Table.read(portOut), Table.read(jaxOut)
    assert len(got) == len(ref) > 0
    for key in ("fixed_y_c", "fixed_err_y_c") + MASS_COLUMNS:
        np.testing.assert_allclose(np.asarray(got[key], dtype=float),
                                   np.asarray(ref[key], dtype=float),
                                   rtol=MTOL, atol=0, err_msg=key)
