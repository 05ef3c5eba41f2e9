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
import re

import numpy as np
import pytest
import torch

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
                                     nGrid=2048, every=16, device="cpu")
    lj, yj, Rj = JB.debug_trajectory(1e-3, H0=H0, Om0=OM0, Ob0=OB0,
                                     nGrid=2048, every=16)
    np.testing.assert_array_equal(lt, np.asarray(lj))
    assert yt.shape == yj.shape == (len(lt), TB.NV)
    scale = np.max(np.abs(yj), axis=0)
    np.testing.assert_allclose(yt / scale, yj / scale, rtol=0, atol=RTOL)
    np.testing.assert_allclose(Rt, Rj, rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def step_tables():
    """The port's per-step table and the JAX package's Background at nGrid
    2,048."""
    bg = TB.Background(H0=H0, Om0=OM0, Ob0=OB0, nGrid=2048)
    return TB._step_tables(bg), JB.Background(H0=H0, Om0=OM0, Ob0=OB0,
                                              nGrid=2048)


def block(tab, j):
    """Block ``j`` of every record, as {column name: (nSteps,) array}."""
    n = len(TB._AB)
    return dict(zip(TB._AB, tab[:, j * n:(j + 1) * n].T))


def np_interp_like_jnp(x, lna, tab):
    """jnp.interp's formula in numpy, each operation rounded on its own:
    index from searchsorted(side="right") clamped to [1, n-1], then f0 +
    (delta / dx) * df, end values outside the table."""
    i = np.clip(np.searchsorted(lna, x, side="right"), 1, len(lna) - 1)
    dx = lna[i] - lna[i - 1]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    f = np.where(dx0, tab[i - 1], tab[i - 1] + ((x - lna[i - 1])
                                                / np.where(dx0, 1, dx))
                 * (tab[i] - tab[i - 1]))
    f = np.where(x < lna[0], tab[0], f)
    return np.where(x > lna[-1], tab[-1], f)


@pytest.mark.parametrize("j", [0, 1, 2])
def test_step_tables_interpolate_like_jnp_interp(step_tables, j):
    """Abscissa j of each step (x, x + h/2, x + h): the five interpolated
    columns equal jnp.interp's formula with each operation rounded on its
    own bitwise, and jnp.interp of the JAX Background's tables to 1e-15
    (XLA's CPU code may fuse the lerp's multiply-add: one ulp at a few
    points); a = exp(x) agrees with jnp.exp to 1e-15 (the two exp may
    differ in the last bit)."""
    import jax
    import jax.numpy as jnp
    tab, jb = step_tables
    assert tab.shape == (2047, TB.STEP_REC) and tab.dtype == np.float64
    h = float(jb.lna[1] - jb.lna[0])
    b = block(tab, j)
    xs = jb.lna[:-1] + (0.0, h / 2, h)[j]
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        x = jnp.asarray(jb.lna[:-1]) + (0.0, h / 2, h)[j]
        np.testing.assert_array_equal(np.asarray(x), xs)
        lna = jnp.asarray(jb.lna)
        for col, name in (("Hc", "Hc"), ("tau", "tau"), ("kap", "kappa_dot"),
                          ("cs2", "cs2_b"), ("kD", "kD")):
            np.testing.assert_array_equal(
                b[col], np_interp_like_jnp(xs, jb.lna, getattr(jb, name)),
                err_msg=col)
            ref = np.asarray(jnp.interp(x, lna, jnp.asarray(getattr(jb,
                                                                    name))))
            np.testing.assert_allclose(b[col], ref, rtol=1e-15, atol=0,
                                       err_msg=col)
        np.testing.assert_allclose(b["a"], np.asarray(jnp.exp(x)),
                                   rtol=1e-15, atol=0)


def test_step_tables_derived_columns(step_tables):
    """The derived columns are the reference's expressions of the
    interpolated ones, operand for operand (so bitwise)."""
    tab, jb = step_tables
    h = float(jb.lna[1] - jb.lna[0])
    h_tau = h / block(tab, 0)["Hc"]
    relax = 0.5 / h_tau
    for j in range(3):
        b = block(tab, j)
        a = b["a"]
        want = {"w_c": jb.Oc0 / a, "w_b": jb.Ob0 / a,
                "w_g": jb.Og0 / (a * a), "w_n": jb.On0 / (a * a)}
        want["Rb"] = 0.75 * (want["w_b"] / want["w_g"])
        want.update(relRate=np.minimum(b["kap"], relax),
                    tauMax=np.maximum(b["tau"], 1e-30),
                    Rb1=1.0 + want["Rb"],
                    slipDen=b["kap"] * (1.0 + 1.0 / np.maximum(want["Rb"],
                                                               1e-30)),
                    kapMax=np.maximum(b["kap"], 1e-30))
        want.update(cLG=9 / want["tauMax"], cLN=13 / want["tauMax"])
        for name, ref in want.items():
            np.testing.assert_array_equal(b[name], ref,
                                          err_msg="%s at %d" % (name, j))
    end = block(tab, 2)
    a = end["a"]
    RbR = 0.75 * (jb.Ob0 / a) / (jb.Og0 / (a * a))
    kh = end["kap"] * h_tau
    E1, E03 = np.exp(-kh), np.exp(-0.3 * kh)
    want = {"h_tau": h_tau, "relax": relax, "RbR": RbR, "Rb1R": 1.0 + RbR,
            "E1": E1, "Ed": np.exp(-kh * (1.0 + 1.0 / np.maximum(RbR,
                                                                1e-30))),
            "E03": E03, "E03mE1": E03 - E1, "RbFrac": RbR / (1.0 + RbR),
            "invRb1": 1.0 / (1.0 + RbR)}
    assert set(want) == set(TB._PER_STEP)
    for name, ref in want.items():
        np.testing.assert_array_equal(tab[:, TB._COL[name]], ref,
                                      err_msg=name)


def test_kernel_source_names_the_table_columns():
    """csrc/boltzmann_rk4.cu's enums Ab and Step list the table's columns
    in the order _step_tables writes them, and its record is STEP_REC."""
    src = os.path.join(os.path.dirname(TB.__file__), os.pardir, "csrc",
                       "boltzmann_rk4.cu")
    with open(src) as f:
        text = f.read()

    def enum(name):
        body = re.search(r"enum %s \{([^}]*)\}" % name, text).group(1)
        return [e.split("=")[0].strip() for e in body.split(",")]

    def c_name(prefix, col):
        return prefix + col.upper().replace("_", "")

    assert enum("Ab") == [c_name("A_", c) for c in TB._AB] + ["NAB"]
    assert enum("Step") == [c_name("S_", c) for c in TB._PER_STEP] + ["REC"]
    assert "static_assert(REC == %d" % TB.STEP_REC in text


def test_plain_version_reads_the_step_tables(monkeypatch):
    """_transfer_plain builds the per-step table once and reads it: a
    table with a perturbed opacity moves T."""
    bg = TB._solver_tables(70.0, 0.3, 0.05, 256)
    k = torch.as_tensor([0.05, 0.5])
    T, _ = TB._transfer_plain(k, bg)
    real, seen = TB._step_tables, []

    def spy(b):
        seen.append(b)
        tab = real(b)
        for j in range(3):
            tab[:, j * len(TB._AB) + TB._AB.index("kap")] *= 1.5
        return tab

    monkeypatch.setattr(TB, "_step_tables", spy)
    T2, _ = TB._transfer_plain(k, bg)
    assert seen == [bg]
    assert not np.allclose(T2.numpy(), T.numpy(), rtol=1e-6, atol=0)


def test_kernel_wrappers_reject_what_the_kernel_does_not_take():
    """The kernel's wrappers raise before any build on inputs the kernel
    does not take: CPU wavenumbers, a table of another record size, a
    snapshot buffer of another shape."""
    bg = TB._solver_tables(70.0, 0.3, 0.05, 256)
    k = torch.as_tensor([0.1])
    with pytest.raises(ValueError):
        TB._transfer_cuda(k, bg)
    tab = torch.as_tensor(TB._step_tables(bg))
    with pytest.raises(ValueError):
        TB._launch(k, tab[:, :32].contiguous(), bg)
    with pytest.raises(ValueError):
        TB._launch(k, tab, bg, torch.zeros((1, 3, TB.NV),
                                           dtype=torch.float64), 8)


def test_kernel_builds_are_named_by_source_and_defines():
    """The kernel and its build with nvcc's division are one source under
    two library names (the -D flag enters the name's hash)."""
    from nemo_tpu_torch import cuda_build
    src, lib = cuda_build._lib_path("boltzmann_rk4.cu")
    src2, lib2 = cuda_build._lib_path(TB.IEEE_DIV_BUILD)
    assert src == src2 and src.endswith("boltzmann_rk4.cu")
    assert lib != lib2 and lib.endswith(".so") and lib2.endswith(".so")
    assert cuda_build._split(TB.IEEE_DIV_BUILD) == (
        "boltzmann_rk4.cu", ["-DNEMO_BOLTZ_IEEE_DIV"])


def test_debug_trajectory_on_cuda_needs_the_card():
    """debug_trajectory's default device is the card's kernel; without a
    card it raises rather than running the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    calls = TB._transfer_plain.calls
    with pytest.raises((RuntimeError, AssertionError)):
        TB.debug_trajectory(0.1, nGrid=256)
    assert TB._transfer_plain.calls == calls


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
