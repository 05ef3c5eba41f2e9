"""The port's ``nemo`` CLI with the selection-function epilogue (``-S``,
``fitQ: true``, ``--device cpu``) against the JAX run of
``test_torch_selfn.py``'s survey: the slice as a whole, from the maps to
the Q tables, RMS tables, fRel weights, tile areas, 90% completeness and
mass-limit maps.

Tolerances: the port filters the maps itself here, float64 torch ops
against XLA's, so its RMS maps and filters differ from the JAX run's in
the last digits: Q, noise levels and weights within 1e-8 relative; areas
(pixel counts) and the mass limits (grid values) equal.
"""

import json
import os

import numpy as np

from nemo_tpu import completeness as jcompleteness
from nemo_tpu_torch import completeness
from nemo_tpu_torch.cli import nemo_main
from nemo_tpu_torch.utils.tables import Table
from tests.test_torch_selfn import (  # noqa: F401
    jax_run, one_torch_thread, qtabs, selfn_config, write_config)

TOL = 1e-8


def test_nemo_cli_epilogue_matches_jax(jax_run):  # noqa: F811
    work, jconfig, _ = jax_run
    outDir = os.path.join(work, "cli")
    cfgPath = write_config(selfn_config(work), os.path.join(work, "cli.yml"),
                           outDir)
    nemo_main.main([cfgPath, "-S", "--device", "cpu"])
    selFn = os.path.join(outDir, "selFn")

    got, ref = qtabs(os.path.join(selFn, "QFit.fits")), \
        qtabs(os.path.join(jconfig.selFnDir, "QFit.fits"))
    assert sorted(got) == sorted(ref) == sorted(jconfig.tileNames)
    for tile in ref:
        np.testing.assert_allclose(np.asarray(got[tile][0]["Q"]),
                                   np.asarray(ref[tile][0]["Q"]), rtol=TOL)

    g = Table.read(os.path.join(selFn, "RMSTab.fits"))
    r = Table.read(os.path.join(jconfig.selFnDir, "RMSTab.fits"))
    assert len(g) == len(r) > 0
    np.testing.assert_allclose(np.asarray(g["y0RMS"]),
                               np.asarray(r["y0RMS"]), rtol=TOL)
    np.testing.assert_array_equal(np.asarray(g["areaDeg2"]),
                                  np.asarray(r["areaDeg2"]))

    gw = completeness.loadFRelWeights(os.path.join(selFn,
                                                   "fRelWeights.fits"))
    rw = jcompleteness.loadFRelWeights(os.path.join(jconfig.selFnDir,
                                                    "fRelWeights.fits"))
    assert sorted(gw) == sorted(rw)
    for tile in rw:
        for freq in rw[tile]:
            np.testing.assert_allclose(gw[tile][freq], rw[tile][freq],
                                       rtol=TOL)
    ga = Table.read(os.path.join(selFn, "tileAreas.fits"))
    ra = Table.read(os.path.join(jconfig.selFnDir, "tileAreas.fits"))
    np.testing.assert_array_equal(np.asarray(ga["areaDeg2"]),
                                  np.asarray(ra["areaDeg2"]))

    # the completeness epilogue, against the JAX package's on its own run
    diag = os.path.join(outDir, "diagnostics")
    ref90 = jcompleteness.completenessByFootprint(jconfig)["full"]
    got90 = Table.read(os.path.join(diag, "completeness90pc_full.fits"))
    np.testing.assert_array_equal(np.asarray(got90["MLim_90pc_1e14MSun"]),
                                  np.asarray(ref90["MLim_90pc_1e14MSun"]))
    jcompleteness.makeMassLimitMapsAndPlots(jconfig)
    for tile in jconfig.tileNames:
        gm, _ = completeness.loadMassLimitMap(tile, diag, 0.5)
        rm, _ = jcompleteness.loadMassLimitMap(tile, jconfig.diagnosticsDir,
                                               0.5)
        np.testing.assert_array_equal(gm, rm)
    with open(os.path.join(diag, "timings.json")) as f:
        stages = json.load(f)
    text = json.dumps(stages)
    for stage in ("fitQ", "makeRMSTables", "tidyUp", "completeness"):
        assert stage in text, stage
