"""The plain reference agrees with the port's outputs on the CPU in
float64 at a tiny size: the photometry filter and its calibration, the
RMS map (as written, within its quantisation) and the optimal
catalog."""

import os

import numpy as np
import pytest

from portbench import judge
from portbench.tests import tiny
from portbench.windows import search


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ref"))
    cell = tiny.tiny_cell(tmp_path_factory.mktemp("bench"), work)
    state = search.State(cell, 2 ** 31 + 3)
    out = search.run(state, 0.0)
    refs = {t: judge.reference_tile(cell.cfg, state.survey, t, "cpu")
            for t in state.judged}
    return cell.cfg, state.survey, work, out.passes, refs


@pytest.mark.parametrize("name", judge.NAMES)
def test_number_within_the_float64_limit(run, name):
    cfg, survey, _, passes, refs = run
    nums = judge.judge(cfg, survey, refs, passes)
    assert nums[name] <= tiny.LIMITS[name]


def test_catalog_rows_are_judged(run):
    _, _, _, passes, refs = run
    for t, ref in refs.items():
        assert ref["rows"], t
        assert judge._rows_of(passes[0].catalog, t), t


def test_rms_map_file_within_its_quantisation(run):
    from nemo_tpu_torch.utils import fits as nfits
    cfg, survey, work, _, refs = run
    phot = cfg["nemo"]["photFilter"]
    for t, ref in refs.items():
        path = os.path.join(work, "pass000", "selFn", t,
                            "RMSMap_%s#%s.fits" % (phot, t))
        got, _ = nfits.read_image(path)
        ny, nx = ref["shape"]
        want = ref[phot]["RMS"][:ny, :nx] * ref[phot]["scale"]
        # RICE keeps each row to std(row) / 16
        step = want.std(axis=1, keepdims=True) / 16
        assert np.all(np.abs(got - want) <= 0.51 * step + 1e-300)
