"""The port's SED extraction (``pipelines.extractSpec``, both methods) and
its ``nemoSpec`` CLI against the JAX package's, float64 on the CPU.

The survey is ``tests/test_torch_engine.py``'s seeded two-band tiled map
(four tiles, 16 Arnaud clusters); the targets are its clusters, half given
each of two templates.  Both packages run in a working directory of their
own (the matched-filter method writes ``nemoSpecCache/`` there).

Tolerances: CAP disk fluxes, their errors and S/N within 1e-10 of each
column's largest absolute value (host numpy on the same PSF-matched maps,
whose transforms agree to ~1e-15); matched-filter ``y_c``, ``deltaT_c``
and ``SNR`` per band within 1e-8 relative (the filters agree to ~1e-12).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from nemo_tpu import pipelines as jpipelines
from nemo_tpu import startup as jstartup
from nemo_tpu.cli import nemoSpec_main as jnemoSpec_main
from nemo_tpu_torch import pipelines, startup
from nemo_tpu_torch.cli import nemoSpec_main
from nemo_tpu_torch.utils import wcs as nwcs
from nemo_tpu_torch.utils.tables import Table
from tests.test_torch_engine import PIX_ARCMIN, SHAPE, make_survey

TEMPLATES = ("Arnaud_M2e14_z0p4", "Arnaud_M4e14_z0p2")
N_CLUSTERS = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread: the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cluster_targets(seed=7):
    """make_survey's cluster positions (its generator's first two draws),
    half with each template."""
    rng = np.random.default_rng(seed)
    ys = rng.uniform(30, SHAPE[0] - 30, N_CLUSTERS)
    xs = rng.uniform(30, SHAPE[1] - 30, N_CLUSTERS)
    w = nwcs.makeWCS(SHAPE, PIX_ARCMIN / 60.0, centreRADeg=30.0,
                     centreDecDeg=0.0)
    ra, dec = np.array([w.pix2wcs(x, y) for x, y in zip(xs, ys)]).T
    return Table({"name": np.array(["T%02d" % i for i in range(N_CLUSTERS)]),
                  "RADeg": ra, "decDeg": dec,
                  "template": np.array([TEMPLATES[i % 2]
                                        for i in range(N_CLUSTERS)])})


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_spec")
    cfg = make_survey(str(work))
    cfg["mapFilters"] = cfg["mapFilters"][:1]
    paths = {}
    for name in ("jax", "torch"):
        d = copy.deepcopy(cfg)
        d["outputDir"] = str(work / name)
        paths[name] = str(work / (name + ".yml"))
        with open(paths[name], "w") as f:
            yaml.safe_dump(d, f)
        os.makedirs(work / ("cwd_" + name), exist_ok=True)
    return work, paths, cluster_targets()


def configs(survey):
    work, paths, _ = survey
    return (jstartup.NemoConfig(paths["jax"], writeTileInfo=True),
            startup.NemoConfig(paths["torch"], device="cpu",
                               writeTileInfo=True))


def assert_spec_equal(got, ref, cols, rtol=None, of_max=None):
    """Row for row (both packages walk the tiles and templates in the same
    order; an object in two overlapping tiles has a row from each)."""
    np.testing.assert_array_equal(np.asarray(got["name"]),
                                  np.asarray(ref["name"]))
    for col in cols:
        a = np.asarray(got[col], dtype=float)
        b = np.asarray(ref[col], dtype=float)
        if of_max is not None:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=of_max * np.abs(b).max(),
                                       err_msg=col)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0,
                                       err_msg=col)


def test_extract_spec_cap_matches_jax(survey, monkeypatch):
    work, _, tab = survey
    jconfig, config = configs(survey)
    monkeypatch.chdir(work / "cwd_jax")
    ref = jpipelines.extractSpec(jconfig, tab, method="CAP")
    monkeypatch.chdir(work / "cwd_torch")
    got = pipelines.extractSpec(config, tab, method="CAP")
    cols = [k for k in ref.keys() if k.startswith(("diskT", "err_diskT",
                                                   "diskSNR"))]
    assert len(cols) == 6 and sorted(got.keys()) == sorted(ref.keys())
    assert len(got) >= N_CLUSTERS
    assert_spec_equal(got, ref, cols, of_max=1e-10)
    # clusters are decrements at 98 and 150 GHz
    assert np.median(np.asarray(got["diskSNR_150"])) > 0


def test_extract_spec_matched_filter_matches_jax(survey, monkeypatch):
    work, _, tab = survey
    jconfig, config = configs(survey)
    monkeypatch.chdir(work / "cwd_jax")
    ref = jpipelines.extractSpec(jconfig, tab, method="matchedFilter")
    monkeypatch.chdir(work / "cwd_torch")
    got = pipelines.extractSpec(config, tab, method="matchedFilter")
    assert os.path.isdir(os.path.join("nemoSpecCache", "torch"))
    cols = [k for k in ref.keys()
            if k.startswith(("y_c_", "err_y_c_", "deltaT_c_", "SNR_"))]
    assert len([c for c in cols if c.startswith("y_c_")]) == 2
    assert sorted(got.keys()) == sorted(ref.keys())
    assert len(got) >= N_CLUSTERS // 2
    assert_spec_equal(got, ref, cols, rtol=1e-8)
    for col in ("y_c_149", "y_c_97"):
        assert np.median(np.asarray(got[col])) > 0


def test_nemospec_cli_matches_jax(survey, monkeypatch):
    """nemoSpec -m matchedFilter -z on the CPU: the same rows, SED
    columns and cross-matched redshifts as the JAX CLI's."""
    work, paths, tab = survey
    targets = tab[np.arange(N_CLUSTERS) % 2 == 0]
    catPath = str(work / "targets.fits")
    targets.write(catPath)
    zPath = str(work / "redshifts.fits")
    z = np.linspace(0.2, 0.9, len(targets))
    Table({"name": np.asarray(targets["name"]),
           "RADeg": np.asarray(targets["RADeg"]),
           "decDeg": np.asarray(targets["decDeg"]),
           "redshift": z}).write(zPath)
    out = {}
    for name in ("jax", "torch"):
        monkeypatch.chdir(work / ("cwd_" + name))
        outPath = str(work / ("spec_%s.fits" % name))
        argv = [paths[name], catPath, "-m", "matchedFilter", "-o", outPath,
                "-z", zPath]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["nemoSpec"] + argv)
            jnemoSpec_main.main()
        else:
            nemoSpec_main.main(argv + ["--device", "cpu"])
        out[name] = Table.read(outPath)
    got, ref = out["torch"], out["jax"]
    assert sorted(got.keys()) == sorted(ref.keys())
    assert "redshift" in got.keys()
    cols = [k for k in ref.keys() if k.startswith(("y_c_", "SNR_"))]
    assert_spec_equal(got, ref, cols, rtol=1e-8)
    assert_spec_equal(got, ref, ["redshift"], rtol=0)
    zByName = dict(zip(np.asarray(targets["name"]), z))
    np.testing.assert_array_equal(
        np.asarray(got["redshift"]),
        [zByName[n] for n in np.asarray(got["name"])])
