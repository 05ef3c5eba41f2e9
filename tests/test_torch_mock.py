"""The port's mock catalogs (``pipelines.makeMockClusterCatalog`` and the
``nemoMock`` CLI) and its ``nemoCatalogCheck`` CLI against the JAX
package's, float64 on the CPU, on the JAX run of
``tests/test_torch_selfn.py`` (four tiles, its ``selFn/`` with the Q fit,
RMS tables and ``config.yml``; the Eisenstein & Hu transfer).

Tolerances: mocks row for row with the same seed: the same row count and
names, every numeric column within rtol 1e-8 (the mass function's grid
and the draws' inputs are the same float64 host arithmetic);
nemoCatalogCheck's printed counts, in-mask and missed tables equal.
"""

import contextlib
import io
import os
import sys

import numpy as np

from nemo_tpu import pipelines as jpipelines
from nemo_tpu import startup as jstartup
from nemo_tpu.cli import nemoCatalogCheck_main as jcheck_main
from nemo_tpu.cli import nemoMock_main as jmock_main
from nemo_tpu_torch import pipelines, startup
from nemo_tpu_torch.cli import nemoCatalogCheck_main, nemoMock_main
from nemo_tpu_torch.utils.tables import Table
from tests.test_torch_selfn import jax_run, one_torch_thread  # noqa: F401

RTOL = 1e-8


def assert_tables_equal(got, ref, rtol=RTOL):
    assert len(got) == len(ref) > 0
    assert sorted(got.keys()) == sorted(ref.keys())
    for col in ref.keys():
        a, b = np.asarray(got[col]), np.asarray(ref[col])
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=col)
        else:
            np.testing.assert_array_equal(a, b, err_msg=col)


def mock_configs(jconfig, work, seed):
    """Both packages' configs on the JAX run's selFn/, as nemoMock makes
    them, with their own mocks directories."""
    selFnDir = jconfig.selFnDir
    path = os.path.join(selFnDir, "config.yml")
    kw = dict(makeOutputDirs=False, setUpMaps=False, verbose=False,
              selFnDir=selFnDir)
    out = (jstartup.NemoConfig(path, **kw),
           startup.NemoConfig(path, device="cpu", **kw))
    for c, name in zip(out, ("jax", "torch")):
        c.mocksDir = os.path.join(work, "mocks_" + name)
        c.parDict["seed"] = seed
    return out


def test_make_mock_catalog_matches_jax(jax_run):  # noqa: F811
    """Two mocks from one seeded generator, combined: the same catalogs
    row for row, and the same files."""
    work, jconfig, _ = jax_run
    jc, tc = mock_configs(jconfig, work, seed=31)
    ref = jpipelines.makeMockClusterCatalog(jc, numMocksToMake=2,
                                            combineMocks=True)
    got = pipelines.makeMockClusterCatalog(tc, numMocksToMake=2,
                                           combineMocks=True)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert_tables_equal(g, r)
        assert "true_M500c" in g.keys()
    assert len(got[0]) != len(got[1]) or \
        not np.array_equal(np.asarray(got[0]["RADeg"]),
                           np.asarray(got[1]["RADeg"]))
    files = sorted(os.listdir(tc.mocksDir))
    assert files == sorted(os.listdir(jc.mocksDir)) == [
        "mockCatalog_1.csv", "mockCatalog_1.fits", "mockCatalog_2.csv",
        "mockCatalog_2.fits", "mockCatalog_combined.fits",
        "mockParameters.txt"]
    assert_tables_equal(
        Table.read(os.path.join(tc.mocksDir, "mockCatalog_combined.fits")),
        Table.read(os.path.join(jc.mocksDir, "mockCatalog_combined.fits")))
    with open(os.path.join(tc.mocksDir, "mockParameters.txt")) as f, \
            open(os.path.join(jc.mocksDir, "mockParameters.txt")) as g:
        assert f.read() == g.read()


def test_nemomock_cli_matches_jax(jax_run, monkeypatch):  # noqa: F811
    """nemoMock selFn/ mocks/ -N 2 -s 5 -S 5 --device cpu against the JAX
    CLI."""
    work, jconfig, _ = jax_run
    dirs = {n: os.path.join(work, "cli_mocks_" + n) for n in ("jax", "torch")}
    args = ["-N", "2", "-s", "5", "-S", "5"]
    monkeypatch.setattr(sys, "argv", ["nemoMock", jconfig.selFnDir,
                                      dirs["jax"]] + args)
    jmock_main.main()
    nemoMock_main.main([jconfig.selFnDir, dirs["torch"]] + args
                       + ["--device", "cpu"])
    for i in (1, 2):
        name = "mockCatalog_%d.fits" % i
        got = Table.read(os.path.join(dirs["torch"], name))
        ref = Table.read(os.path.join(dirs["jax"], name))
        assert_tables_equal(got, ref)
        assert np.all(np.asarray(got["fixed_SNR"]) >= 5)


def _run_printing(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue()


def test_nemocatalogcheck_cli_matches_jax(jax_run, monkeypatch):  # noqa: F811
    """An external catalog of detected clusters, undetected positions in
    the survey (one with a negative RA) and positions outside it: the same
    printed counts and the same in-mask, missed and DS9 region files."""
    work, jconfig, cat = jax_run
    rng = np.random.default_rng(3)
    det = cat[np.argsort(-np.asarray(cat["SNR"]))[:6]]
    ra = np.concatenate([np.asarray(det["RADeg"]),
                         rng.uniform(28.5, 31.5, 5), [-330.5, 45.0, 10.0]])
    dec = np.concatenate([np.asarray(det["decDeg"]),
                          rng.uniform(-1.0, 1.0, 5), [0.2, 0.0, -5.0]])
    ext = Table({"name": np.array(["E%02d" % i for i in range(len(ra))]),
                 "RADeg": ra, "decDeg": dec})
    extPath = os.path.join(work, "extCatalog.fits")
    ext.write(extPath)
    cfgPath = os.path.join(work, "jax.yml")
    printed = {}
    for name in ("jax", "torch"):
        cwd = os.path.join(work, "check_" + name)
        os.makedirs(cwd, exist_ok=True)
        monkeypatch.chdir(cwd)
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["nemoCatalogCheck", cfgPath,
                                              extPath])
            printed[name] = _run_printing(jcheck_main.main)
        else:
            printed[name] = _run_printing(lambda: nemoCatalogCheck_main.main(
                [cfgPath, extPath, "--device", "cpu"]))
    lines = [ln for ln in printed["torch"].splitlines()
             if ln.startswith("...")]
    assert lines == [ln for ln in printed["jax"].splitlines()
                     if ln.startswith("...")]
    assert "are NOT found within" in printed["torch"]
    files = sorted(os.listdir(os.path.join(work, "check_torch")))
    assert files == sorted(os.listdir(os.path.join(work, "check_jax")))
    assert files == ["extCatalog_inMask_jax.fits",
                     "extCatalog_missed_in_jax_optimalCatalog.fits",
                     "extCatalog_missed_in_jax_optimalCatalog.reg"]
    for f in files:
        a, b = (os.path.join(work, "check_" + n, f) for n in ("torch", "jax"))
        if f.endswith(".fits"):
            assert_tables_equal(Table.read(a), Table.read(b))
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read()
    inMask = set(np.asarray(Table.read(os.path.join(
        work, "check_torch", "extCatalog_inMask_jax.fits"))["name"]))
    # the detections and the negative-RA one in the mask, the two off the
    # survey not
    assert inMask >= {"E%02d" % i for i in range(6)} | {"E11"}
    assert not inMask & {"E12", "E13"}
    missed = Table.read(os.path.join(
        work, "check_torch", "extCatalog_missed_in_jax_optimalCatalog.fits"))
    assert not set(np.asarray(missed["name"])) & set(
        "E%02d" % i for i in range(6))
