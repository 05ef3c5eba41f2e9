"""The port's one-tile cluster search end to end, float64 on the CPU,
against the JAX package's on the same files.

``tests.golden.run_pipeline`` makes the seeded two-band sims and the JAX
catalog; the port then runs the same ``golden.yml`` (fresh outputDir,
device cpu).  Its catalog must match the committed golden catalog within
test_golden_regression.py's tolerances (positions < 1', fixed_y_c rtol
5e-3), and the JAX catalog at rtol 1e-6 (both float64: only summation
order differs).
"""

import os

import numpy as np
import pytest
import torch

from nemo_tpu import catalogs as jcatalogs
from nemo_tpu_torch import pipelines, startup
from tests import golden


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    workDir = str(tmp_path_factory.mktemp("torch_slice"))
    inputTab, jaxCat = golden.run_pipeline(workDir)
    parDict = startup.parseConfigFile(os.path.join(workDir, "golden.yml"))
    parDict["outputDir"] = os.path.join(workDir, "out_torch")
    config = startup.NemoConfig(parDict, device="cpu")
    assert str(config.policy.device) == "cpu"
    torchCat = pipelines.filterMapsAndMakeCatalogs(config)
    return inputTab, jaxCat, torchCat, golden.load_golden(), workDir


def matched(ref, cat):
    idx, sep = jcatalogs.nearestNeighbours(
        np.asarray(ref["RADeg"], dtype=float),
        np.asarray(ref["decDeg"], dtype=float),
        np.asarray(cat["RADeg"]), np.asarray(cat["decDeg"]))
    return idx, sep


def test_port_matches_golden_catalog(both_runs):
    inputTab, jaxCat, torchCat, gold, _ = both_runs
    idx, sep = matched(gold, torchCat)
    assert np.all(sep * 60 < 1.0), "position drift vs golden catalog"
    ratio = np.asarray(torchCat["fixed_y_c"])[idx] \
        / np.asarray(gold["fixed_y_c"], dtype=float)
    np.testing.assert_allclose(ratio, 1.0, rtol=5e-3)
    refM, outM, _ = jcatalogs.crossMatch(inputTab, torchCat,
                                         radiusArcmin=1.5)
    assert len(refM) == len(gold)


def test_port_matches_jax_catalog(both_runs):
    inputTab, jaxCat, torchCat, gold, _ = both_runs
    assert len(torchCat) == len(jaxCat)
    idx, sep = matched(jaxCat, torchCat)
    assert np.all(sep * 3600 < 1e-3)
    for key in ("fixed_y_c", "SNR", "fixed_SNR", "y_c"):
        np.testing.assert_allclose(np.asarray(torchCat[key])[idx],
                                   np.asarray(jaxCat[key]), rtol=1e-6,
                                   err_msg=key)


def test_cli_runs_the_slice(both_runs, tmp_path, capsys):
    """The port's CLI on the golden config (fresh outputDir, --device cpu)
    writes the same catalog; asked for the injection test on this cluster
    config, which has no sourceInjectionModels, it reuses the catalog,
    runs the test and only warns on its empty table, as nemo_tpu's CLI
    does; --device cuda without a card fails."""
    import yaml

    from nemo_tpu_torch.cli import nemo_main
    from nemo_tpu_torch.utils.tables import Table
    inputTab, jaxCat, torchCat, gold, workDir = both_runs
    with open(os.path.join(workDir, "golden.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["outputDir"] = str(tmp_path / "cli")
    path = str(tmp_path / "cli.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    nemo_main.main([path, "--device", "cpu"])
    cat = Table.read(str(tmp_path / "cli" / "cli_optimalCatalog.fits"))
    assert len(cat) == len(torchCat)
    np.testing.assert_allclose(np.sort(np.asarray(cat["fixed_y_c"])),
                               np.sort(np.asarray(torchCat["fixed_y_c"])),
                               rtol=1e-12)
    assert os.path.exists(str(tmp_path / "cli" / "diagnostics"
                              / "timings.json"))
    cfg["sourceInjectionTest"] = True
    cfg["sourcesPerTile"] = 20
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    capsys.readouterr()
    nemo_main.main([path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "already made catalog" in out
    assert "source injection test recovered no objects" in out
    inj = Table.read(str(tmp_path / "cli" / "selFn"
                         / "sourceInjectionData.fits"))
    assert len(inj) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            nemo_main.main([path, "--device", "cuda"])
