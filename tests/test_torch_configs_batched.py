"""Configurations of the batched engine that no other port test covers,
through both packages' batched pipelines, float64 on the CPU, on the
seeded four-tile survey of ``test_torch_engine.make_survey``: device
detection with the Beam filter in uK, with a point-source mask from a
catalog, and with the Battaglia filter; host detection in the batched
engine (lean outputs); and shape measurement (which keeps detection on
the host).

Tolerances: the same catalog length and columns, positions within 1e-6
arcsec, numeric columns at rtol 1e-6.

The JAX package's engine runs on a one-device mesh here, as the port runs
on one device: its step on the suite's eight virtual CPU devices waits on
cross-device rendezvous that a loaded machine can starve.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from nemo_tpu import pipelines as jpipelines
from nemo_tpu import startup as jstartup
from nemo_tpu.parallel import engine as jengine
from nemo_tpu.parallel.mesh import get_mesh
from nemo_tpu_torch import pipelines, startup
from nemo_tpu_torch.utils import wcs as nwcs
from nemo_tpu_torch.utils.tables import Table
from tests.test_torch_configs_host import assert_catalogs_equal
from tests.test_torch_engine import SHAPE, PIX_ARCMIN, make_survey


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_device_mesh():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "get_mesh", lambda: get_mesh(n_devices=1))
        yield


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("configs_batched"))
    cfg = make_survey(work)
    cfg["mapFilters"] = cfg["mapFilters"][:1]
    # bright point sources to mask, at random survey positions
    rng = np.random.default_rng(77)
    w = nwcs.makeWCS(SHAPE, PIX_ARCMIN / 60.0, centreRADeg=30.0,
                     centreDecDeg=0.0)
    c = w.pix2wcs(rng.uniform(40, SHAPE[1] - 40, 6),
                  rng.uniform(40, SHAPE[0] - 40, 6))
    path = os.path.join(work, "psCatalog.fits")
    Table({"name": np.array(["p%d" % i for i in range(6)]),
           "RADeg": c[:, 0], "decDeg": c[:, 1],
           "rArcmin": np.full(6, 2.5)}).write(path)
    return work, cfg, path


def case_config(cfg, psPath, case):
    d = dict(copy.deepcopy(cfg), useDeviceBatching=True,
             useDeviceDetection=True, deviceBatchSize=2)
    params = d["allFilters"]["params"]
    if case == "beam_uK":
        d["allFilters"]["class"] = "BeamMatchedFilter"
        params["outputUnits"] = "uK"
        d["mapFilters"] = [{"label": "Beam", "params": {}}]
        d.update(photFilter="Beam", thresholdSigma=5.0)
    elif case == "ps_mask":
        d["maskPointSourcesFromCatalog"] = [psPath]
    elif case == "battaglia":
        d["allFilters"]["class"] = "BattagliaModelMatchedFilter"
        d["mapFilters"] = [{"label": "Battaglia_M2e14_z0p4",
                            "params": {"M500MSun": 2e14, "z": 0.4}}]
        d["photFilter"] = "Battaglia_M2e14_z0p4"
    elif case == "lean":
        d["useDeviceDetection"] = False
    elif case == "measure_shapes":
        d["measureShapes"] = True
    else:
        raise KeyError(case)
    return d


CASES = ["beam_uK", "ps_mask", "battaglia", "lean", "measure_shapes"]


@pytest.mark.parametrize("case", CASES)
def test_batched_config_matches_jax(survey, case):
    work, cfg, psPath = survey
    out = {}
    for tag in ("jax", "torch"):
        d = case_config(cfg, psPath, case)
        d["outputDir"] = os.path.join(work, "%s_%s" % (case, tag))
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
        out[tag] = (run(config, writeAreaMask=True, writeFlagMask=True,
                        verbose=False), config)
    (got, config), (ref, _) = out["torch"], out["jax"]
    assert_catalogs_equal(got, ref)
    # detection ran where the case puts it
    with open(os.path.join(config.diagnosticsDir,
                           "chunk_budgets.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    onDevice = sum(r["detectTiles"] for r in recs)
    assert onDevice == (4 if case in ("beam_uK", "ps_mask", "battaglia")
                        else 0)
