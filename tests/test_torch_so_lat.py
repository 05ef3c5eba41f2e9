"""The six-band Simons Observatory LAT search, ``so_lat_mmf`` and its cell
``so_lat_mmf_search`` in BENCHMARK.json: the configuration held to its
source, the cell rehearsed on the CPU at a tiny size (the benchmark's
four 200 x 288 tiles and three filters, ``portbench/tests/tiny.py``)
against the benchmark's plain reference, and the counters of the
band x band solve on a six-band batch."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nemo_tpu_torch import completeness
from nemo_tpu_torch.ops import fourier
from nemo_tpu_torch.ops import solve as ts
from nemo_tpu_torch.parallel import distribute, engine
from nemo_tpu_torch.utils import fits as nfits
from nemo_tpu_torch.utils import timing
from portbench import harness
from portbench.tests import tiny
from portbench.windows import search
from tests.test_torch_cuda import STEP_GRID, step_inputs

CELL = "so_lat_mmf_search"
SEED = 2 ** 31 + 19
# Ade et al. 2019, JCAP 02, 056, Table 1, baseline: band centre (GHz),
# beam FWHM (arcmin), white noise (uK-arcmin)
SO_LAT = [(27, 7.4, 71), (39, 5.1, 36), (93, 2.2, 8.0), (145, 1.4, 10),
          (225, 1.0, 22), (280, 0.9, 54)]


def counters():
    return dict(timing.RECORDER.counters)


def delta(before, name):
    return timing.RECORDER.counters.get(name, 0) - before.get(name, 0)


def test_config_holds_its_source():
    """Six bands at the paper's centres and beams, white noise per 0.5'
    pixel from its uK-arcmin, DR5's bank, and every cut named and
    explained."""
    bench = harness.load_bench()
    cell = harness.Cell(bench, CELL)
    cfg, entry = cell.cfg, cell.entry
    pix = cfg["survey"]["pixel_arcmin"]
    assert pix == 0.5
    got = [(b["freq_ghz"], b["beam_fwhm_arcmin"], b["white_noise_uK"] * pix)
           for b in cfg["bands"]]
    assert got == pytest.approx(SO_LAT)
    pub = cfg["published"]
    assert list(zip(pub["bands_ghz"], pub["beam_fwhm_arcmin"],
                    pub["white_noise_uK_arcmin"])) == pytest.approx(SO_LAT)
    assert pub["f_sky"] == 0.4
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert set(cfg["reduced_why"]) == set(cfg["reduced"])
    assert all(cfg["reduced_why"][k] and k in pub for k in cfg["reduced"])
    dr5 = harness.Cell(bench, "dr5_mmf_search").cfg
    assert cfg["nemo"]["mapFilters"] == dr5["nemo"]["mapFilters"]
    for key in ("photFilter", "thresholdSigma", "allFilters",
                "deviceBatchSize", "useDeviceDetection"):
        assert cfg["nemo"][key] == dr5["nemo"][key]
    assert cfg["survey"] == dr5["survey"]
    assert cfg["precision"] == "float64"
    assert (cell.chips, cell.workload["traffic"]) == (1, "search")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("so_lat"))


def test_cell_on_the_cpu_is_correct(tiny_root):
    """The cell's whole run (set-up, window, the reference's judgement)
    on the CPU: correct under the tiny limits."""
    res = harness.run(CELL, SEED, 0.0, 0, device="cpu", root=tiny_root)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 4
    assert set(res["metrics"]) == {"search_tiles_per_s", "setup_s"}
    assert res["checks"]["missed"]["value"] == 0


def test_pass_counts_solves_and_writes_six_band_weights(tiny_root, tmp_path,
                                                        monkeypatch):
    """One pass of the tiny cell: every Fourier pixel of every tile and
    filter went through the general (n > 3) solve, none singular, each
    ``chunk.step`` span names its six bands, and the photometry filters'
    RW* weights (read back by ``getFRelWeights``) cover the six bands and
    sum to 1."""
    bench = harness.load_bench(tiny_root)
    cell = harness.Cell(bench, CELL, tiny_root, "cpu",
                        workdir=str(tmp_path / "work"))
    state = search.State(cell, SEED)
    before = counters()
    monkeypatch.setattr(timing, "_recording", lambda: True)
    session = timing.RECORDER.begin_session()
    out = str(tmp_path / "pass")
    p = state.one_pass(out, judged=state.judged)
    session.close()
    monkeypatch.undo()
    systems = sum(b["nTiles"] * b["nLabels"] * b["padShape"][0]
                  * (b["padShape"][1] // 2 + 1) for b in p.budgets)
    assert systems > 0
    assert delta(before, "solve.general_systems") == systems
    assert delta(before, "solve.singular_systems") == 0
    steps = [r for r in session.records() if r["name"] == "chunk.step"]
    assert len(steps) == sum(b["nLabels"] for b in p.budgets)
    assert {r["attrs"]["bands"] for r in steps} == {6}

    cfg = cell.cfg
    phot = cfg["nemo"]["photFilter"]
    freqs = [b["freq_ghz"] for b in cfg["bands"]]
    tiles = [t for t, _, _ in state.survey.tiles]
    diag = os.path.join(out, "diagnostics")
    header = nfits.read_image_header(os.path.join(
        diag, tiles[0], "filter_%s#%s.fits" % (phot, tiles[0])))
    assert [header["RW%d_GHZ" % i] for i in range(1, 7)] == freqs
    selFn = tmp_path / "selFn"
    selFn.mkdir()
    config = SimpleNamespace(parDict={"photFilter": phot},
                             selFnDir=str(selFn), allTileNames=tiles,
                             diagnosticsDir=diag)
    weights = completeness.getFRelWeights(config)
    assert sorted(weights) == sorted(tiles)
    for t in tiles:
        assert sorted(weights[t]) == freqs
        assert sum(weights[t].values()) == pytest.approx(1.0, abs=1e-6)


def six_band_inputs():
    """The batched step's test inputs (``test_torch_cuda.step_inputs``)
    widened to six bands: each band its two-band source plus noise of its
    own, its template and calibration, weights of both signs."""
    args, meta, _ = step_inputs()
    rng = np.random.default_rng(6)
    inside = args["surveyMask"][:, None]
    src = [k % 2 for k in range(6)]
    data = args["data"][:, src] \
        + rng.normal(0, 0.5, (4, 6) + inside.shape[-2:]) * inside
    tmpl = args["template"][:, src]
    amp = np.array([2.0, -1.5, 1.2, -0.8, 0.3, 0.9])[None, :, None, None]
    six = dict(args, data=data, template=tmpl, calib=tmpl * amp,
               w=np.array([-1.9, -1.8, -1.0, -0.4, 0.1, 0.8]))
    return six, meta


def test_singular_systems_counted_with_the_step_norms():
    """A six-band batch whose second tile has no noise (each of its
    pixels' systems is all zero): the step gives that tile a zero filter
    and reports its pixels singular, the engine's norm download adds them
    to ``solve.singular_systems``, and ``solve.general_systems`` counts
    every system; a planted singular pixel of a six-band ``solve_small``
    batch gives 0 and is counted."""
    args, meta = six_band_inputs()
    noise = args["data"].copy()
    noise[1] = 0.0
    t = {k: torch.as_tensor(v) for k, v in args.items()}
    step = distribute.make_matched_filter_step(STEP_GRID, 0,
                                               lean_outputs=True,
                                               return_filter=True)
    before = counters()
    out = step(t["data"], torch.as_tensor(noise), t["template"], t["calib"],
               t["w"], t["apodM"], t["psMask"], t["surveyMask"], t["fg"],
               t["peakYX"], meta)
    PY, PX = args["data"].shape[-2:]
    half = PY * (PX // 2 + 1)
    assert delta(before, "solve.general_systems") == 4 * half
    # counted where the right-hand side w |s| is not 0 (elsewhere the
    # answer is 0 whatever the system)
    rhs = torch.abs(fourier.rfft2(t["template"][1])) * t["w"][:, None, None]
    counted = int((rhs != 0).any(dim=0).sum())
    assert counted > 0.9 * half
    assert out["singularSystems"].tolist() == [0, counted, 0, 0]
    assert torch.all(out["filt"][1] == 0)
    assert torch.all(out["filt"][0].abs().sum(dim=0) != 0)
    budget = {"download": 0.0, "downBytes": 0}
    norms = engine._step_norms({k: [out[k]] for k in (
        "signalNorm", "singularSystems")}, budget)
    np.testing.assert_array_equal(norms, out["signalNorm"].numpy())
    assert delta(before, "solve.singular_systems") == counted
    assert budget["downBytes"] == norms.nbytes * 2

    rng = np.random.default_rng(7)
    A = rng.normal(size=(3, 5, 6, 6))
    A = A @ np.swapaxes(A, -1, -2) + 6 * np.eye(6)
    A[1, 2] = 0.0
    before = counters()
    x = ts.solve_small(torch.as_tensor(A), torch.as_tensor(rng.normal(
        size=(3, 5, 6))))
    assert delta(before, "solve.general_systems") == 15
    assert torch.all(x[1, 2] == 0) and torch.all(torch.isfinite(x))


def test_band_solve_roofline_of_a_recorded_window():
    """``band_solve_roofline.search`` over a recorded window: the least
    time of a chunk's 16 solves of 16 x 900 x 769 six-band systems (bytes
    over the card's bandwidth) against the device time of the route's
    kernels, found by the names the card's trace gives them; other
    kernels are not counted."""
    from portbench.rooflines import band_solve, bound
    cfg = harness.Cell(harness.load_bench(), CELL).cfg
    budgets = [{"nTiles": 16, "nLabels": 16, "padShape": [900, 1536]}]
    kernels = [
        "void getrf_semiwarp<double, double, 3, 1, true>(int, double* "
        "const*, int, int*, int*, int)",
        "void laswp_kernel<double, false>(int, double* const*, int, int, "
        "int, int const*, int, int, int)",
        "void trsm_batch_left_lower_kernel<double>(cublasTrsmBatchParams"
        "<double>, double const* const*, double* const*, double const*, "
        "double)",
        "void trsm_batch_left_upper_kernel<double>(cublasTrsmBatchParams"
        "<double>, double const* const*, double* const*, double const*, "
        "double)"]
    events = [(k, 1.0 + i, 1.0 + i + 0.005) for i, k in enumerate(kernels)]
    events.append(("void cudnn::cnn::conv2d_grouped_direct_kernel<false, "
                   "true, false, false, false, false, 1, 0, int, double, "
                   "double, double>(cudnnTensorStruct, double const*)",
                   9.0, 10.0))
    ctx = {"cfg": cfg, "budgets": budgets, "events": events,
           "window": (0.0, 10.0), "refs": {"T00": {}}}
    work = band_solve.work(ctx)
    systems = 16 * 900 * 769
    assert work == [(systems * 48 * 8, systems * (144 + 72), "float64")] \
        * 16
    least = 16 * bound(*work[0])[0]
    assert bound(*work[0])[1] == "bytes"
    got = harness.reader("band_solve_roofline.search")(ctx)
    assert got == pytest.approx(100 * least / 0.02, rel=1e-9)
