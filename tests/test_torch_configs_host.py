"""Configurations of the per-tile host path that no other port test
covers, through both packages' pipelines, float64 on the CPU, on a seeded
600 x 600 two-band sim (white noise, Arnaud clusters, bright point
sources): the Beam filter in uK (the ``quickstart-sources.yml`` shape),
ring removal with shape measurement, a point-source mask from a catalog
with background subtraction, the Battaglia filter, an edge trim with a
two-scale bank, and forced photometry.

Tolerances: the same catalog length and columns, positions within 1e-6
arcsec, numeric columns at rtol 1e-6.
"""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

from nemo_tpu import pipelines as jpipelines
from nemo_tpu import startup as jstartup
from nemo_tpu_torch import catalogs, maps, pipelines, startup
from nemo_tpu_torch.device import CPU
from nemo_tpu_torch.models import beams
from nemo_tpu_torch.utils import fits as nfits
from nemo_tpu_torch.utils import wcs as nwcs
from nemo_tpu_torch.utils.tables import Table

SHAPE = (600, 600)
PIX_ARCMIN = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("configs_host"))
    rng = np.random.default_rng(600)
    w = nwcs.makeWCS(SHAPE, PIX_ARCMIN / 60.0, centreRADeg=50.0,
                     centreDecDeg=-5.0)

    def table(n, **cols):
        xs = rng.uniform(50, SHAPE[1] - 50, n)
        ys = rng.uniform(50, SHAPE[0] - 50, n)
        c = w.pix2wcs(xs, ys)
        return Table(dict({"name": np.array(["o%d" % i for i in range(n)]),
                           "RADeg": c[:, 0], "decDeg": c[:, 1]}, **cols))

    clusters = table(8, y_c=rng.uniform(3, 8, 8),
                     template=np.array(["Arnaud_M2e14_z0p4"] * 8))
    sources = table(6, deltaT_c=rng.uniform(1500, 6000, 6),
                    rArcmin=np.full(6, 3.0))
    entries = []
    for band, freq, fwhm, noise in (("f150", 149.6, 1.4, 25.0),
                                    ("f090", 97.8, 2.1, 35.0)):
        beamPath = os.path.join(work, "beam_%s.txt" % band)
        beams.makeGaussianBeamFile(beamPath, fwhm)
        sky = maps.makeModelImage(SHAPE, w, clusters, beamPath,
                                  obsFreqGHz=freq, policy=CPU) \
            + maps.makeModelImage(SHAPE, w, sources, beamPath, policy=CPU) \
            + rng.normal(0, noise, SHAPE)
        path = os.path.join(work, "sim_%s.fits" % band)
        nfits.write_image(path, sky, w.header)
        entries.append({"mapFileName": path, "obsFreqGHz": freq,
                        "units": "uK", "beamFileName": beamPath})
    sourcesPath = os.path.join(work, "sources.fits")
    sources.write(sourcesPath)
    clustersPath = os.path.join(work, "clusters.fits")
    clusters.write(clustersPath)
    base = {"unfilteredMaps": entries, "thresholdSigma": 4.0,
            "minObjPix": 1, "findCenterOfMass": True, "useInterpolator": True,
            "rejectBorder": 0, "removeRings": False,
            "photFilter": "Arnaud_M2e14_z0p4",
            "allFilters": {"class": "ArnaudModelMatchedFilter",
                           "params": {"noiseParams": {
                               "method": "dataMap", "noiseGridArcmin": 20.0},
                               "outputUnits": "yc"}},
            "mapFilters": [{"label": "Arnaud_M2e14_z0p4",
                            "params": {"M500MSun": 2e14, "z": 0.4}}]}
    return {"work": work, "base": base, "sources": sourcesPath,
            "clusters": clustersPath}


def case_config(sim, case):
    cfg = copy.deepcopy(sim["base"])
    if case == "beam_uK":
        cfg.update(photFilter=None, thresholdSigma=5.0, objIdent="ACT-S")
        cfg.pop("allFilters")
        cfg["unfilteredMaps"] = cfg["unfilteredMaps"][1:]
        cfg["mapFilters"] = [{
            "label": "Beam_f090", "class": "BeamMatchedFilter",
            "params": {"noiseParams": {"method": "dataMap",
                                       "noiseGridArcmin": 40.0},
                       "saveFilteredMaps": True, "outputUnits": "uK",
                       "edgeTrimArcmin": 10.0}}]
    elif case == "rings_shapes":
        cfg.update(removeRings=True, measureShapes=True)
    elif case == "ps_mask_bcksub":
        cfg["maskPointSourcesFromCatalog"] = [sim["sources"]]
        cfg["allFilters"]["params"].update(bckSub=True,
                                           bckSubScaleArcmin=30.0)
    elif case == "battaglia":
        cfg["allFilters"]["class"] = "BattagliaModelMatchedFilter"
        cfg["mapFilters"] = [{"label": "Battaglia_M2e14_z0p4",
                              "params": {"M500MSun": 2e14, "z": 0.4}}]
        cfg["photFilter"] = "Battaglia_M2e14_z0p4"
    elif case == "trim_two_scales":
        cfg["allFilters"]["params"]["edgeTrimArcmin"] = 8.0
        cfg["mapFilters"].append({"label": "Arnaud_M4e14_z0p2",
                                  "params": {"M500MSun": 4e14, "z": 0.2}})
    elif case == "forced_photometry":
        cfg["forcedPhotometryCatalog"] = sim["clusters"]
    else:
        raise KeyError(case)
    return cfg


def run_both(sim, case):
    out = {}
    for tag in ("jax", "torch"):
        d = case_config(sim, case)
        d["outputDir"] = os.path.join(sim["work"], "%s_%s" % (case, tag))
        path = d["outputDir"] + ".yml"
        with open(path, "w") as f:
            yaml.safe_dump(d, f)
        if tag == "jax":
            config = jstartup.NemoConfig(path, writeTileInfo=True)
            run = jpipelines.filterMapsAndMakeCatalogs
        else:
            config = startup.NemoConfig(path, device="cpu",
                                        writeTileInfo=True)
            run = pipelines.filterMapsAndMakeCatalogs
        forced = d.get("forcedPhotometryCatalog")
        if forced:
            config.parDict["forcedPhotometryCatalog"] = forced
        out[tag] = run(config, writeAreaMask=True, writeFlagMask=True,
                       verbose=False)
    return out["torch"], out["jax"]


def assert_catalogs_equal(got, ref):
    assert len(ref) >= 4 and len(got) == len(ref)
    assert sorted(got.keys()) == sorted(ref.keys())
    sep = catalogs.calcAngSepDeg(
        np.asarray(got["RADeg"], dtype=float),
        np.asarray(got["decDeg"], dtype=float),
        np.asarray(ref["RADeg"], dtype=float),
        np.asarray(ref["decDeg"], dtype=float)) * 3600
    assert np.max(sep) < 1e-6
    for key in ref.keys():
        col = np.asarray(ref[key])
        if col.dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(got[key], dtype=float),
                                       col, rtol=1e-6, atol=1e-12,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(np.asarray(got[key]), col,
                                          err_msg=key)


CASES = ["beam_uK", "rings_shapes", "ps_mask_bcksub", "battaglia",
         "trim_two_scales", "forced_photometry"]


@pytest.mark.parametrize("case", CASES)
def test_host_path_config_matches_jax(sim, case):
    got, ref = run_both(sim, case)
    assert_catalogs_equal(got, ref)
    if case == "rings_shapes":
        assert "ellipse_A" in ref.keys()
