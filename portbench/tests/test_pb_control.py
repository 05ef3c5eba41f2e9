"""The control (the reference in the precision below the configuration's,
in the program's place) comes out not correct under each cell's limits,
at a size a test run holds."""

import json
import os

import numpy as np
import pytest

from portbench import control, harness, judge, sky
from portbench.tests import tiny
from portbench.windows import search

CONFIGS = [c["name"] for c in harness.load_bench()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_control_is_not_correct(tmp_path, name):
    cfg, traffic = tiny.tiny_config(name), tiny.tiny_traffic()
    with open(os.path.join(tiny.PKG, "configs", name + ".json")) as f:
        limits = json.load(f)["limits"]
    survey = sky.make_survey(cfg, traffic, 2 ** 31 + 5,
                             str(tmp_path / "inputs"), "cpu")
    judged = search.judged_tiles(survey, cfg, 2 ** 31 + 5)
    refs = {t: judge.reference_tile(cfg, survey, t, "cpu") for t in judged}
    ctl = control.control_pass(cfg, survey, judged, "cpu")
    nums = judge.judge(cfg, survey, refs, [ctl])
    ok, rows = judge.verdict(nums, limits)
    assert not ok, rows
    assert all(np.isfinite(v) for k, v in nums.items()
               if k != "signorm_rel_err")
