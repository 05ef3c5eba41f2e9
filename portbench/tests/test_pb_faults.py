"""A run with the timed path broken underneath comes out not correct,
once for each fault a search cell can have: the second half of each
chunk's batch left out, an answer altered where it is produced, and a
filter step that returns its input unchanged (the noise weighting
skipped).  The run is the harness's own, on the CPU and the tiny
configuration, judged by the cell's own limits.  (One card: no exchange
between chips to leave out.)  At the cells' own sizes, the judged tiles
reach both halves of every chunk on every seed, so the first fault
cannot pass unseen there."""

import json
import os

import pytest

from portbench import harness, sky
from portbench.tests import tiny
from portbench.windows import search

CELLS = [w["name"] for w in harness.load_bench()["workloads"]]


def _wrap(monkeypatch, module, name, after):
    orig = getattr(module, name)

    def patched(*a, **k):
        return after(orig(*a, **k), *a)
    monkeypatch.setattr(module, name, patched)


def second_halves(cfg):
    """Names of the tiles in the second half of each engine chunk."""
    tiles = sky.Survey(cfg, "").tiles
    batch = int(cfg["nemo"]["deviceBatchSize"])
    return {name for i, (name, _, _) in enumerate(tiles)
            if i % batch >= batch // 2}


def _drop_half(monkeypatch):
    """The answers of the second half of each chunk never reach the
    catalog."""
    from nemo_tpu_torch import photometry
    dropped = second_halves(tiny.tiny_config())

    def drop(cat, d, *a):
        return [] if d["tileName"] in dropped else cat
    _wrap(monkeypatch, photometry, "catalogFromDeviceDetections", drop)
    _wrap(monkeypatch, photometry, "findObjects", drop)


def _alter_answer(monkeypatch):
    """One row's fixed_y_c is 2% off where it is produced."""
    from nemo_tpu_torch import photometry

    def alter(cat, *a):
        if len(cat) and "fixed_y_c" in cat.keys():
            cat["fixed_y_c"][0] *= 1.02
        return cat

    def alterFluxes(_, catalog, *a, **k):
        if len(catalog):
            catalog["fixed_y_c"][0] *= 1.02
    _wrap(monkeypatch, photometry, "catalogFromDeviceDetections", alter)
    _wrap(monkeypatch, photometry, "measureFluxes", alterFluxes)


def _unweighted_filter(monkeypatch):
    """The filter build hands the template back unweighted by N^-1."""
    from nemo_tpu_torch import filters
    from nemo_tpu_torch.parallel import distribute

    def batched(fNoise, fSignalAbs, w, fg, nx):
        return fSignalAbs * w[None, :, None, None]

    def host(noiseStack, fSignalsAbs, w, apodM, padShape=None, fg=None):
        return fSignalsAbs * w[:, None, None]
    monkeypatch.setattr(distribute, "_covariance_filter", batched)
    monkeypatch.setattr(filters, "_build_filter_core", host)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_drop_half, _alter_answer,
                                   _unweighted_filter])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault, cell):
    root = tiny.tiny_root(tmp_path)
    bench = harness.load_bench(root)
    wl = next(w for w in bench["workloads"] if w["name"] == cell)
    with open(os.path.join(tiny.PKG, "configs",
                           wl["config"] + ".json")) as f:
        limits = json.load(f)["limits"]
    cfgPath = os.path.join(root, "portbench", "configs",
                           wl["config"] + ".json")
    with open(cfgPath) as f:
        cfg = json.load(f)
    cfg["limits"] = limits
    with open(cfgPath, "w") as f:
        json.dump(cfg, f)
    sound = harness.run(cell, 2 ** 31 + 17, 0.0, 0, device="cpu", root=root)
    assert sound["correct"], sound["checks"]
    fault(monkeypatch)
    res = harness.run(cell, 2 ** 31 + 17, 0.0, 0, device="cpu", root=root)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_judged_tiles_meet_both_halves_of_every_chunk(cell):
    bench = harness.load_bench()
    cfg = harness.Cell(bench, cell).cfg
    survey = sky.Survey(cfg, "")
    batch = int(cfg["nemo"]["deviceBatchSize"])
    halves = -(-len(survey.tiles) // batch) * 2
    assert halves <= int(cfg["judge"]["tiles"])
    second = second_halves(cfg)
    for seed in range(2 ** 31, 2 ** 31 + 200):
        judged = search.judged_tiles(survey, cfg, seed)
        index = {name: i for i, (name, _, _) in enumerate(survey.tiles)}
        got = {(index[t] // batch, t in second) for t in judged}
        assert len(got) == halves, (seed, judged)
