"""The port's Boltzmann solver (``nemo_tpu_torch/models/boltzmann.py``)
against the JAX package's, float64 on the CPU, where the port runs the
plain torch version of its CUDA kernel.

Tolerances: the two packages do the same float64 arithmetic in the same
order, but their exp and the rounding of the background interpolation may
differ in the last bit, and 4,095 RK4 steps carry that along: T(k) and the
trajectories agree to ~1e-11 relative (measured), held at 1e-9.  The
background tables are host numpy in both, copied code: equal exactly.

Regenerate the committed nGrid 24,576 reference table (the JAX solve,
~30 s on one CPU core) from the repository root with
``JAX_PLATFORMS=cpu python -m tests.test_torch_boltzmann``.
"""

import functools
import json
import os

import numpy as np
import pytest

from nemo_tpu.models import boltzmann as JB
from nemo_tpu.models import cosmology as JC
from nemo_tpu_torch.models import boltzmann as TB
from nemo_tpu_torch.models import cosmology as TC
from tests.test_torch_selfn import one_torch_thread  # noqa: F401

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "boltzmann_transfer_reference.json")
H0, OM0 = 67.36, 0.3153
OB0 = 0.02237 / 0.6736 ** 2
RTOL = 1e-9


def test_background_equals_jax():
    tb = TB.Background(H0=H0, Om0=OM0, Ob0=OB0, nGrid=4096)
    jb = JB.Background(H0=H0, Om0=OM0, Ob0=OB0, nGrid=4096)
    for name in ("lna", "a", "Hc", "tau", "xe", "kappa_dot", "kD", "cs2_b"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      err_msg=name)


def test_transfer_function_plain_matches_jax():
    k = np.logspace(np.log10(5e-3), np.log10(30.0), 8)
    calls = TB._transfer_plain.calls
    T, d = TB.transfer_function(k, H0=H0, Om0=OM0, Ob0=OB0, nGrid=4096,
                                device="cpu")
    Tj, dj = JB.transfer_function(k, H0=H0, Om0=OM0, Ob0=OB0, nGrid=4096)
    assert TB._transfer_plain.calls == calls + 1
    assert T.shape == k.shape and np.all(np.isfinite(T))
    np.testing.assert_allclose(T, Tj, rtol=RTOL, atol=0)
    np.testing.assert_allclose(d["R0"], dj["R0"], rtol=RTOL, atol=0)


def test_debug_trajectory_matches_jax():
    lt, yt, Rt = TB.debug_trajectory(1e-3, H0=H0, Om0=OM0, Ob0=OB0,
                                     nGrid=2048, every=16)
    lj, yj, Rj = JB.debug_trajectory(1e-3, H0=H0, Om0=OM0, Ob0=OB0,
                                     nGrid=2048, every=16)
    np.testing.assert_array_equal(lt, np.asarray(lj))
    assert yt.shape == yj.shape == (len(lt), TB.NV)
    scale = np.max(np.abs(yj), axis=0)
    np.testing.assert_allclose(yt / scale, yj / scale, rtol=0, atol=RTOL)
    np.testing.assert_allclose(Rt, Rj, rtol=RTOL, atol=0)


def test_transfer_function_rejects_other_dtypes_and_devices():
    with pytest.raises(ValueError):
        TB.transfer_function([0.1], nGrid=64, dtype=np.float32, device="cpu")
    with pytest.raises(ValueError):
        TB.transfer_function([0.1], nGrid=64, device="meta")


def test_reference_table_metadata():
    with open(REF) as f:
        ref = json.load(f)
    assert (ref["H0"], ref["Om0"], ref["Ob0"]) == (70.0, 0.3, 0.05)
    assert ref["nGrid"] == 24576
    np.testing.assert_array_equal(np.array(ref["kMpc"]), TC._BOLTZ_KGRID)
    np.testing.assert_array_equal(TC._BOLTZ_KGRID, JC._BOLTZ_KGRID)
    assert len(ref["T"]) == len(ref["R0"]) == len(TC._BOLTZ_KGRID)
    assert np.all(np.isfinite(ref["T"])) and np.all(np.array(ref["R0"]) > 0)


@pytest.fixture
def reduced_boltzmann(monkeypatch):
    """Both packages' solvers at nGrid 4,096 (production 24,576 takes
    minutes on one CPU core), with their transfer caches emptied before
    and after."""
    for mod, cos in ((TB, TC), (JB, JC)):
        monkeypatch.setattr(mod, "transfer_function", functools.partial(
            mod.transfer_function, nGrid=4096))
        cos._boltzmann_Tk_cached.cache_clear()
    yield
    TC._boltzmann_Tk_cached.cache_clear()
    JC._boltzmann_Tk_cached.cache_clear()


def test_flatlcdm_boltzmann_on_the_given_device(reduced_boltzmann):
    """The port's FlatLCDM(transferFunction="boltzmann") reaches the
    port's own solver (the module was missing: ``from . import
    boltzmann`` raised ImportError) on the device it is given, and gives
    the JAX package's sigma(M)."""
    calls = TB._transfer_plain.calls
    cos = TC.FlatLCDM(H0=H0, Om0=OM0, Ob0=OB0, sigma8=0.8, ns=0.96,
                      transferFunction="boltzmann", device="cpu")
    jcos = JC.FlatLCDM(H0=H0, Om0=OM0, Ob0=OB0, sigma8=0.8, ns=0.96,
                       transferFunction="boltzmann")
    M = np.array([1e13, 1e14, 1e15])
    s = cos.sigmaM(M)
    assert TB._transfer_plain.calls == calls + 1
    np.testing.assert_allclose(s, jcos.sigmaM(M), rtol=RTOL, atol=0)
    # cached per (H0, Om0, Ob0, device): a second model solves nothing
    TC.FlatLCDM(H0=H0, Om0=OM0, Ob0=OB0, sigma8=0.7, ns=0.96,
                transferFunction="boltzmann", device="cpu").sigmaM(M)
    assert TB._transfer_plain.calls == calls + 1


def test_mock_survey_passes_its_device(monkeypatch):
    from nemo_tpu_torch.mock import MockSurvey
    seen = []
    real = TC.FlatLCDM

    def spy(*args, **kw):
        seen.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(TC, "FlatLCDM", spy)
    ms = MockSurvey(1e14, 100.0, 0.1, 0.3, 70.0, 0.3, 0.05, 0.8, 0.95,
                    zStep=0.1, transferFunction="eisenstein_hu",
                    device="cpu")
    assert seen == ["cpu"] and ms.cosmoModel.device == "cpu"


if __name__ == "__main__":
    k = TC._BOLTZ_KGRID
    T, d = JB.transfer_function(k, H0=70.0, Om0=0.3, Ob0=0.05, nGrid=24576)
    with open(REF, "w") as f:
        json.dump({
            "description": "Boltzmann transfer function T(k) = delta_m / R0 "
                           "and the initial comoving curvature R0 from "
                           "nemo_tpu.models.boltzmann.transfer_function (JAX,"
                           " CPU, float64) on cosmology._BOLTZ_KGRID; "
                           "regenerate with JAX_PLATFORMS=cpu "
                           "python -m tests.test_torch_boltzmann",
            "H0": 70.0, "Om0": 0.3, "Ob0": 0.05, "nGrid": 24576,
            "kMpc": k.tolist(), "T": np.asarray(T).tolist(),
            "R0": np.asarray(d["R0"]).tolist()}, f, indent=1)
