"""Linear Boltzmann solver: matter transfer functions on torch tensors.

Port of ``nemo_tpu/models/boltzmann.py``.  The background and the
recombination history (:class:`Background`, host numpy) are copied as they
are; the perturbation solve - conformal-Newtonian MB95 hierarchies (CDM,
baryons, photon intensity and polarization to l = 8, massless neutrinos to
l = 12) with the tight-coupling and radiation-streaming regimes and the
exact per-step Thomson relaxation, integrated by fixed-step RK4 in ln a
from ln a = -19.5 to 0 - is the JAX package's, step for step.

Two versions of the solve, both reading one per-step table
(:func:`_step_tables`: every value that depends on the step and not on
k - the background at the three RK4 abscissae by ``jnp.interp``'s rule,
what the reference derives from it alone, and the relaxation's
exponentials - built once per cosmology on the host, each value the
reference's expression):

* :func:`_transfer_plain`, plain torch: every k at once as a batch
  dimension, the scan written as a Python loop over the ``nGrid - 1``
  steps.
* ``csrc/boltzmann_rk4.cu``, the hand-written CUDA kernel: one warp a k,
  in one launch, the 31 photon and neutrino multipoles one a lane and the
  five matter and metric components replicated on every lane; the table
  is uploaded step-major and each warp reads the same record at the same
  step.  The time is one warp's dependent instruction stream (160 k fill
  160 of the card's 528 schedulers), so each evaluation is straight-line
  code for its regime and divides with nvcc's own fast sequence, without
  the branch that kept the divisions from overlapping (see the source).

:func:`transfer_function` launches the kernel for ``device="cuda"`` (and
raises if the build or launch fails) and runs the plain version for
``device="cpu"``.  Either way the solve is float64: the pre-recombination
system is stiff, and the JAX package pins it to float64 too.
"""

import ctypes
import functools
import math

import numpy as np
import torch

from .. import cuda_build

# -- constants (SI where dimensional) ----------------------------------------
C_M_S = 2.99792458e8
MPC_M = 3.0856775814913673e22
SIGMA_T = 6.6524587321e-29          # m^2
M_H = 1.6735575e-27                 # kg (hydrogen atom)
K_B = 1.380649e-23
HBAR = 1.054571817e-34
M_E = 9.1093837015e-31
EPS0_EV = 13.605693122994           # H ionisation energy, eV
EV = 1.602176634e-19
XI_HE1_EV = 24.587387936
XI_HE2_EV = 54.417760440
G_SI = 6.67430e-11
TCMB0 = 2.7255
YP = 0.245                          # helium mass fraction
NEFF = 3.046

LG = 8      # photon intensity / polarization hierarchy extent
LN = 12     # massless neutrino hierarchy extent
NV = 5 + (LG + 1) * 2 + (LN + 1)

# regime thresholds
TCA_FAC = 40.0       # tight coupling while kappa' > TCA_FAC * max(k, aH)
RSA_KTAU = 240.0     # radiation streaming beyond k*tau > RSA_KTAU
RSA_KAPPA = 0.2      # ... and kappa' < RSA_KAPPA * k


class Background:
    """Flat LCDM + radiation background and recombination tables."""

    def __init__(self, H0=70.0, Om0=0.3, Ob0=0.05, lnaMin=-19.5,
                 nGrid=24576):
        self.H0 = float(H0)
        self.h = self.H0 / 100.0
        self.Om0 = float(Om0)
        self.Ob0 = float(Ob0)
        self.Oc0 = self.Om0 - self.Ob0
        og_h2 = 2.47282e-5 * (TCMB0 / 2.7255) ** 4
        self.Og0 = og_h2 / self.h ** 2
        self.On0 = self.Og0 * (7.0 / 8.0) * (4.0 / 11.0) ** (4. / 3.) * NEFF
        self.Or0 = self.Og0 + self.On0
        self.Ol0 = 1.0 - self.Om0 - self.Or0
        # H0 in Mpc^-1 (units c = 1): H0[km/s/Mpc] / c[km/s]
        self.H0_mpc = self.H0 / 2.99792458e5

        self.lna = np.linspace(lnaMin, 0.0, nGrid)
        a = np.exp(self.lna)
        self.a = a
        # conformal Hubble aH in Mpc^-1
        self.Hc = self.H0_mpc * np.sqrt(self.Om0 / a + self.Or0 / a ** 2
                                        + self.Ol0 * a ** 2)
        # conformal time tau(a) in Mpc: dtau = da / (a^2 H) = dlna / (aH);
        # seed with the RD closed form tau = a / (H0 sqrt(Or)) at lnaMin
        dlna = self.lna[1] - self.lna[0]
        integrand = 1.0 / self.Hc
        tau0 = a[0] / (self.H0_mpc * np.sqrt(self.Or0))
        self.tau = tau0 + np.concatenate(
            [[0.0], np.cumsum((integrand[1:] + integrand[:-1]) / 2 * dlna)])
        self._recombination()

    # -- recombination --------------------------------------------------------
    def _recombination(self):
        """x_e(a) via Saha (He III/II/I + H) -> Peebles for the H tail;
        opacity kappa'(a) = n_e sigma_T a in Mpc^-1."""
        a = self.a
        Tg = TCMB0 / a                                   # K
        rho_crit0 = 3 * (self.H0 * 1e3 / MPC_M) ** 2 / (8 * np.pi * G_SI)
        nH0 = (1 - YP) * self.Ob0 * rho_crit0 / M_H      # m^-3 today
        fHe = YP / (4 * (1 - YP))
        nH = nH0 / a ** 3

        def saha_rhs(T, chi_eV):
            # (me kB T / 2 pi hbar^2)^(3/2) e^(-chi/kT) / nH  [dimensionless]
            return ((M_E * K_B * T / (2 * np.pi * HBAR ** 2)) ** 1.5
                    * np.exp(-chi_eV * EV / (K_B * T)))

        xe = np.zeros_like(a)
        # Saha chain per grid point (vectorised where possible)
        for i, (T, nHi) in enumerate(zip(Tg, nH)):
            # HeIII <-> HeII
            S3 = saha_rhs(T, XI_HE2_EV) / nHi
            # HeII <-> HeI
            S2 = 4 * saha_rhs(T, XI_HE1_EV) / nHi
            # H
            S1 = saha_rhs(T, EPS0_EV) / nHi
            # iterate x_e = xHII + fHe*(xHeII + 2 xHeIII) self-consistently
            # (Saha: xHII * x_e / (1 - xHII) = S1/nH, etc.)
            x = 1.0 + 2 * fHe
            for _ in range(80):
                xH = S1 / (x + S1)                           # linear in xHII
                r2 = S2 / x
                r3 = S3 / x
                D = 1 + r2 + r2 * r3
                xHeII_frac = r2 / D                          # of total He
                xHeIII_frac = r2 * r3 / D
                xNew = xH + fHe * (xHeII_frac + 2 * xHeIII_frac)
                if abs(xNew - x) < 1e-12:
                    x = xNew
                    break
                x = 0.5 * (x + xNew)
            xe[i] = x

        # Peebles takeover for the H tail once total x_e < 0.985 (He is
        # fully recombined well before hydrogen becomes relevant, so xe
        # below the switch is purely hydrogen)
        switch = np.argmax(xe < 0.985)
        if switch == 0:
            switch = len(a) - 1
        lam_2s1s = 8.227                                 # s^-1

        def peebles_dxdlna(lna_i, xH, Ti, nHi, Hi_s):
            # case-B recombination coefficient: Pequignot et al. fit as
            # used by RECFAST, with its fudge factor F = 1.14
            T4 = Ti / 1e4
            alpha2 = 1.14 * 1e-19 * 4.309 * T4 ** -0.6166 \
                / (1 + 0.6703 * T4 ** 0.5300)              # m^3/s
            beta = alpha2 * (M_E * K_B * Ti
                             / (2 * np.pi * HBAR ** 2)) ** 1.5 \
                * np.exp(-EPS0_EV * EV / (K_B * Ti))
            # 2s->1s + Lyman-alpha escape vs reionisation from n=2
            beta2 = alpha2 * (M_E * K_B * Ti
                              / (2 * np.pi * HBAR ** 2)) ** 1.5 \
                * np.exp(-EPS0_EV * EV / (4 * K_B * Ti))
            n1s = (1 - xH) * nHi
            lam_alpha = Hi_s * (3 * EPS0_EV * EV
                                / (HBAR * C_M_S)) ** 3 \
                / (8 * np.pi) ** 2 / np.maximum(n1s, 1e-30)
            C = (lam_2s1s + lam_alpha) \
                / (lam_2s1s + lam_alpha + beta2)
            dxdt = C * (beta * (1 - xH) - nHi * alpha2 * xH * xH)
            return dxdt / Hi_s

        # proper H(a) in s^-1
        H_s = self.Hc / self.a * (C_M_S / MPC_M)
        dlna = self.lna[1] - self.lna[0]
        xH = min(xe[switch], 1.0)
        for i in range(switch, len(a)):
            if i > switch:
                # RK2 midpoint in lna (the tail is smooth at this grid)
                k1 = peebles_dxdlna(self.lna[i - 1], xH, Tg[i - 1],
                                    nH[i - 1], H_s[i - 1])
                xm = xH + 0.5 * dlna * k1
                Tm = TCMB0 / np.exp(self.lna[i - 1] + 0.5 * dlna)
                nHm = nH0 / np.exp(3 * (self.lna[i - 1] + 0.5 * dlna))
                Hm = np.interp(self.lna[i - 1] + 0.5 * dlna, self.lna, H_s)
                k2 = peebles_dxdlna(0.0, xm, Tm, nHm, Hm)
                xH = xH + dlna * k2
                xH = float(np.clip(xH, 1e-6, 1.0))
            xe[i] = xH          # He fully recombined by now
        self.xe = xe

        # kappa' = n_e sigma_T a  in Mpc^-1   (dkappa/dtau, comoving)
        ne = xe * nH                                   # m^-3 proper
        self.kappa_dot = ne * SIGMA_T * a * MPC_M

        # Silk damping scale k_D(a): 1/k_D^2 = int dtau/(6 kappa') x
        # [R^2 + 16(1+R)/15] / (1+R)^2  (photon diffusion; R = 3rho_b/
        # 4rho_g).  Modes with k >> k_D are physically erased while
        # still semi-optically-thick - the streaming regime must engage
        # for them (their k*tau oscillations are unresolvable by a
        # fixed-step integrator AND carry no surviving amplitude).
        R = 0.75 * self.Ob0 * a / self.Og0
        damp_int = (R ** 2 + 16.0 * (1 + R) / 15.0)             / (6.0 * self.kappa_dot * (1 + R) ** 2)
        dtau = np.gradient(self.tau)
        inv_kD2 = np.cumsum(damp_int * dtau)
        self.kD = 1.0 / np.sqrt(np.maximum(inv_kD2, 1e-30))

        # baryon temperature: tight to T_gamma until Compton decoupling
        # (z ~ 150), then Tb ~ a^-2; sound speed cs^2 = kB Tb/(mu mH c^2)
        # x (1 - dlnTb/dlna / 3)
        a_dec = 1.0 / 151.0
        Tb = np.where(a < a_dec, Tg, TCMB0 / a_dec * (a_dec / a) ** 2)
        mu = 1.0 / (1 - YP * (1 - 1.0 / 4.0))   # mean molecular weight-ish
        dlnTb = np.where(a < a_dec, -1.0, -2.0)
        self.cs2_b = K_B * Tb / (mu * M_H * C_M_S ** 2) * (1 - dlnTb / 3.0)


@functools.lru_cache(maxsize=4)
def _solver_tables(H0, Om0, Ob0, nGrid):
    return Background(H0=H0, Om0=Om0, Ob0=Ob0, nGrid=nGrid)


# -- the perturbation solve ---------------------------------------------------

# state indices
I_PHI, I_DC, I_TC, I_DB, I_TB = 0, 1, 2, 3, 4
I_F = 5                   # F_0..F_LG
I_G = I_F + LG + 1        # G_0..G_LG
I_N = I_G + LG + 1        # N_0..N_LN

# background tables, in this order, interpolated in ln a
_TABLES = ("Hc", "tau", "kappa_dot", "cs2_b", "kD")

# The per-step table (:func:`_step_tables`): one record of STEP_REC doubles
# a step, three blocks of _AB values (at the RK4 abscissae x, x + h/2 and
# x + h), then the step's own values _PER_STEP.  csrc/boltzmann_rk4.cu
# names the same columns in the same order (enums Ab and Step).
_AB = ("a", "Hc", "tau", "kap", "cs2", "kD", "w_c", "w_b", "w_g", "w_n",
       "Rb", "relRate", "tauMax", "cLG", "cLN", "Rb1", "slipDen", "kapMax")
_PER_STEP = ("h_tau", "relax", "RbR", "Rb1R", "E1", "Ed", "E03", "E03mE1",
             "RbFrac", "invRb1")
STEP_REC = 3 * len(_AB) + len(_PER_STEP)
_COL = {name: j for j, name in enumerate(_PER_STEP, start=3 * len(_AB))}


def _interp_tables(x, lna, tabs):
    """``jnp.interp`` of each row of ``tabs`` (m, n) at the points ``x``
    (float64 numpy), formula for formula: index from
    ``searchsorted(side="right")`` clamped to [1, n-1], then
    ``f0 + (delta / dx) * df``, with the end values outside the table.
    Returns (m, len(x))."""
    n = lna.shape[0]
    i = np.clip(np.searchsorted(lna, x, side="right"), 1, n - 1)
    x0 = lna[i - 1]
    dx = lna[i] - x0
    dx0 = np.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    ratio = (x - x0) / np.where(dx0, 1.0, dx)
    f0 = np.take(tabs, i - 1, axis=1)
    f = np.where(dx0, f0, f0 + ratio * (np.take(tabs, i, axis=1) - f0))
    f = np.where(x < lna[0], tabs[:, :1], f)
    return np.where(x > lna[-1], tabs[:, -1:], f)


def _step_tables(bg):
    """Every value of the solve that depends on the step and not on k, as
    a (nGrid - 1, STEP_REC) float64 numpy array, one record a step (a view
    of a column-major buffer: ``.T`` is contiguous).

    At each RK4 abscissa (x, x + h/2, x + h) the background (a = exp(x),
    then Hc, tau, kap, cs2, kD by ``jnp.interp``'s rule) and what the
    reference derives from it alone; per step the relaxation's h_tau and
    rate cap and, at the step's end, its Rb and exponentials.  Each value
    is the reference's expression, with the same operands in the same
    order, so the plain version and the kernel, which both read this
    table, compute the same products.  At x, a knot, the rule gives the
    knot's values: f0 + (0 / dx) * df is f0."""
    c = _constants(bg)
    h = c["h"]
    tabs = np.stack([getattr(bg, t) for t in _TABLES])
    x = bg.lna[:-1]
    nSteps = x.shape[0]
    cols = np.empty((STEP_REC, nSteps))
    mid = _interp_tables(np.concatenate([x + h / 2, x + h]), bg.lna, tabs)
    blocks = []
    for j, xx in enumerate((x, x + h / 2, x + h)):
        Hc, tau, kap, cs2, kD = (tabs[:, :-1] if j == 0 else
                                 mid[:, (j - 1) * nSteps:j * nSteps])
        a = np.exp(xx)
        w_b, w_g = c["Ob0"] / a, c["Og0"] / (a * a)
        Rb = 0.75 * (w_b / w_g)
        tauMax = np.maximum(tau, 1e-30)
        blocks.append({"a": a, "Hc": Hc, "tau": tau, "kap": kap, "cs2": cs2,
                       "kD": kD, "w_c": c["Oc0"] / a, "w_b": w_b, "w_g": w_g,
                       "w_n": c["On0"] / (a * a), "Rb": Rb,
                       "tauMax": tauMax, "cLG": (LG + 1) / tauMax,
                       "cLN": (LN + 1) / tauMax, "Rb1": 1.0 + Rb,
                       "slipDen": kap * (1.0 + 1.0 / np.maximum(Rb, 1e-30)),
                       "kapMax": np.maximum(kap, 1e-30)})
    h_tau = h / blocks[0]["Hc"]
    relax = 0.5 / h_tau
    for j, b in enumerate(blocks):
        b["relRate"] = np.minimum(b["kap"], relax)
        for i, name in enumerate(_AB):
            cols[j * len(_AB) + i] = b[name]
    # the relaxation at the step's end (its Rb is written as the
    # reference's relax_step writes it, which rounds otherwise than the
    # derivatives' 0.75 * (w_b / w_g))
    end = blocks[2]
    a = end["a"]
    RbR = 0.75 * (c["Ob0"] / a) / (c["Og0"] / (a * a))
    kh = end["kap"] * h_tau
    E1 = np.exp(-kh)
    E03 = np.exp(-0.3 * kh)
    per = {"h_tau": h_tau, "relax": relax, "RbR": RbR, "Rb1R": 1.0 + RbR,
           "E1": E1, "Ed": np.exp(-kh * (1.0 + 1.0 / np.maximum(RbR, 1e-30))),
           "E03": E03, "E03mE1": E03 - E1, "RbFrac": RbR / (1.0 + RbR),
           "invRb1": 1.0 / (1.0 + RbR)}
    for name, j in _COL.items():
        cols[j] = per[name]
    return cols.T


def _abscissa(rec, j):
    """Block ``j`` (0: x, 1: x + h/2, 2: x + h) of one step's record, as a
    dict of Python floats."""
    return dict(zip(_AB, rec[j * len(_AB):(j + 1) * len(_AB)]))


def _constants(bg):
    """Host-side constants of the solve, each computed as the JAX package
    computes it in Python (so both versions and the kernel use the same
    doubles)."""
    H0m = bg.H0_mpc
    Rnu = bg.On0 / (bg.Og0 + bg.On0)
    return {"h": float(bg.lna[1] - bg.lna[0]), "Oc0": bg.Oc0, "Ob0": bg.Ob0,
            "Og0": bg.Og0, "On0": bg.On0, "Ol0": bg.Ol0,
            "c6H2": 6.0 * H0m ** 2, "c15H2": 1.5 * H0m ** 2,
            "phi0": (1.0 + 2.0 * Rnu / 5.0) * 1.0,
            "tau0": float(bg.tau[0]),
            "OgOn": bg.Og0 + bg.On0, "OcOb": bg.Oc0 + bg.Ob0}


class _System:
    """The plain torch system over one Background, vectorised over k
    (``kk`` (nk,), states (nk, NV)); the arithmetic of the JAX package's
    ``_make_system`` closures, in the same order."""

    def __init__(self, bg, kk):
        self.bg = bg
        self.c = _constants(bg)
        self.kk = kk
        self.kk2 = kk * kk
        dev = kk.device
        lF = torch.arange(3, LG, dtype=torch.float64, device=dev)
        lN = torch.arange(2, LN, dtype=torch.float64, device=dev)
        self.kkF = kk[:, None] / (2 * lF + 1.0)
        self.lF, self.lF1 = lF, lF + 1
        self.kkN = kk[:, None] / (2 * lN + 1.0)
        self.lN, self.lN1 = lN, lN + 1

    def derivs(self, b, y, relax):
        """dy/dlna for every k; ``b`` the per-step table's block at this
        abscissa (a dict of floats, see :func:`_step_tables`), ``relax``
        the step's rate cap."""
        c, kk, kk2 = self.c, self.kk, self.kk2
        Hc, tau, kap, cs2, kD = b["Hc"], b["tau"], b["kap"], b["cs2"], b["kD"]
        w_c, w_b, w_g, w_n = b["w_c"], b["w_b"], b["w_g"], b["w_n"]
        phi = y[:, I_PHI]
        dc, tc, db, tb = y[:, I_DC], y[:, I_TC], y[:, I_DB], y[:, I_TB]
        F = y[:, I_F:I_F + LG + 1]
        G = y[:, I_G:I_G + LG + 1]
        N = y[:, I_N:I_N + LN + 1]

        th_g = 0.75 * kk * F[:, 1]
        th_n = 0.75 * kk * N[:, 1]
        sig_g = F[:, 2] / 2.0
        sig_n = N[:, 2] / 2.0
        psi = phi - (c["c6H2"] / kk2) * (w_g * sig_g + w_n * sig_n)
        mom = (w_c * tc + w_b * tb
               + (4. / 3.) * (w_g * th_g + w_n * th_n))
        phi_dot = (-Hc * psi + (c["c15H2"] * mom) / kk2)
        dphi = phi_dot / Hc

        tca = kap > TCA_FAC * torch.clamp(kk, min=Hc)
        rsa = ((kk * tau > RSA_KTAU) & (kap < RSA_KAPPA * kk)) \
            | ((kk * tau > 100.0) & (kk > 3.0 * kD))
        tca = tca & ~rsa
        rsa_n = kk * tau > RSA_KTAU

        dens = (w_c * dc + w_b * db + w_g * F[:, 0] + w_n * N[:, 0])
        phi_alg = -(c["c15H2"] / kk2) * (dens + 3.0 * Hc * mom / kk2)

        d_dc = (-tc) / Hc + 3 * dphi
        d_tc = (-Hc * tc + kk2 * psi) / Hc
        slipNum = kk2 * (F[:, 0] / 4.0 - sig_g) - cs2 * kk2 * db + Hc * tb
        slip = slipNum / b["slipDen"]
        tb_full = (-Hc * tb + cs2 * kk2 * db + kk2 * psi)
        tb_tca = tb_full + slipNum / b["Rb1"]
        d_tb = torch.where(tca, tb_tca, tb_full) / Hc
        d_db = (-tb) / Hc + 3 * dphi

        # photons: the full hierarchies (the JAX package's kapEff terms are
        # products with 0.0 and are left out)
        dF0 = -kk * F[:, 1] + 4 * phi_dot
        dF_full = torch.cat([
            dF0[:, None],
            ((kk / 3.0) * (F[:, 0] - 2 * F[:, 2])
             + (4 * kk / 3.0) * psi)[:, None],
            ((kk / 5.0) * (2 * F[:, 1] - 3 * F[:, 3]))[:, None],
            self.kkF * (self.lF * F[:, 2:LG - 1] - self.lF1 * F[:, 4:LG + 1]),
            (kk * F[:, LG - 1] - b["cLG"] * F[:, LG])[:, None]],
            dim=1)
        dG_full = torch.cat([
            (-kk * G[:, 1])[:, None],
            ((kk / 3.0) * (G[:, 0] - 2 * G[:, 2]))[:, None],
            ((kk / 5.0) * (2 * G[:, 1] - 3 * G[:, 3]))[:, None],
            self.kkF * (self.lF * G[:, 2:LG - 1] - self.lF1 * G[:, 4:LG + 1]),
            (kk * G[:, LG - 1] - b["cLG"] * G[:, LG])[:, None]],
            dim=1)

        # tight coupling
        relRate = b["relRate"]
        F2_tca = (8.0 / 15.0) * (kk / b["kapMax"]) * F[:, 1]
        tcaTgtF = torch.zeros_like(F)
        tcaTgtF[:, 1] = (4.0 / (3 * kk)) * (tb + slip)
        tcaTgtF[:, 2] = F2_tca
        dF_tca = relRate * (tcaTgtF - F)
        dF_tca[:, 0] = dF0
        dF_tca[:, 1] += (4.0 / (3 * kk)) * tb_tca
        tcaTgtG = torch.zeros_like(G)
        tcaTgtG[:, 0] = 1.25 * F2_tca
        tcaTgtG[:, 2] = 0.25 * F2_tca
        dG_tca = relRate * (tcaTgtG - G)

        # radiation streaming
        rsaRate = torch.clamp(kk, max=relax)
        rsaTgt = torch.zeros_like(F)
        rsaTgt[:, 0] = -4.0 * psi
        rsaTgt[:, 1] = (4.0 / kk) * phi_dot
        dF_rsa = rsaRate[:, None] * (rsaTgt - F)
        dG_rsa = -rsaRate[:, None] * G

        rsaC, tcaC = rsa[:, None], tca[:, None]
        dF = torch.where(rsaC, dF_rsa, torch.where(tcaC, dF_tca, dF_full)) / Hc
        dG = torch.where(rsaC, dG_rsa, torch.where(tcaC, dG_tca, dG_full)) / Hc

        # neutrinos
        dN_full = torch.cat([
            (-kk * N[:, 1] + 4 * phi_dot)[:, None],
            ((kk / 3.0) * (N[:, 0] - 2 * N[:, 2])
             + (4 * kk / 3.0) * psi)[:, None],
            self.kkN * (self.lN * N[:, 1:LN - 1] - self.lN1 * N[:, 3:LN + 1]),
            (kk * N[:, LN - 1] - b["cLN"] * N[:, LN])[:, None]],
            dim=1)
        rsaTgtN = torch.zeros_like(N)
        rsaTgtN[:, 0] = -4.0 * psi
        rsaTgtN[:, 1] = (4.0 / kk) * phi_dot
        dN = torch.where(rsa_n[:, None], rsaRate[:, None] * (rsaTgtN - N),
                         dN_full) / Hc

        dphi = torch.where(rsa, rsaRate * (phi_alg - phi) / Hc, dphi)
        return torch.cat([torch.stack([dphi, d_dc, d_tc, d_db, d_tb], dim=1),
                          dF, dG, dN], dim=1)

    def initial_state(self):
        """Adiabatic superhorizon RD initial conditions, unit psi scale."""
        c, kk, kk2 = self.c, self.kk, self.kk2
        tau0 = c["tau0"]
        dg = -2.0 * 1.0
        th = (kk2 * tau0 / 2.0) * 1.0
        y = torch.zeros((kk.shape[0], NV), dtype=torch.float64,
                        device=kk.device)
        y[:, I_PHI] = c["phi0"]
        y[:, I_DC] = 0.75 * dg
        y[:, I_DB] = 0.75 * dg
        y[:, I_TC] = th
        y[:, I_TB] = th
        y[:, I_F + 0] = dg
        y[:, I_F + 1] = 4.0 * th / (3.0 * kk)
        y[:, I_N + 0] = dg
        y[:, I_N + 1] = 4.0 * th / (3.0 * kk)
        kt = kk * tau0
        y[:, I_N + 2] = (2.0 / 15.0) * (kt * kt) * 1.0
        return y

    def comoving_curvature(self, y, a):
        """R = phi + 2/(3(1+w)) psi with the total w at scale factor a."""
        c = self.c
        a2 = a * a
        w_tot = (c["OgOn"] / a2 / 3.0) \
            / (c["OcOb"] / a + c["OgOn"] / a2 + c["Ol0"] * a2)
        phi = y[:, I_PHI]
        psi = phi - (c["c6H2"] / self.kk2) * (
            (c["Og0"] / a2) * (y[:, I_F + 2] / 2.0)
            + (c["On0"] / a2) * (y[:, I_N + 2] / 2.0))
        return phi + (2.0 / (3.0 * (1.0 + w_tot))) * psi

    def relax_step(self, y, s, be):
        """Exact Thomson relaxation over one step, outside tight coupling;
        ``s`` the step's own values and ``be`` the table's block at the
        step's end (see :func:`_step_tables`)."""
        kk = self.kk
        tca = be["kap"] > TCA_FAC * torch.clamp(kk, min=be["Hc"])
        F = y[:, I_F:I_F + LG + 1]
        G = y[:, I_G:I_G + LG + 1]
        tb = y[:, I_TB]
        th_g = 0.75 * kk * F[:, 1]
        E1 = s["E1"]
        thBar = (th_g + s["RbR"] * tb) / s["Rb1R"]
        S = (th_g - tb) * s["Ed"]
        th_gN = thBar + s["RbFrac"] * S
        tbN = thBar - s["invRb1"] * S
        fac = (F[:, 2] + G[:, 0] + G[:, 2]) * s["E03mE1"] / 0.7
        yN = y * E1
        yN[:, :I_TB] = y[:, :I_TB]
        yN[:, I_TB] = tbN
        yN[:, I_F] = F[:, 0]
        yN[:, I_F + 1] = 4.0 * th_gN / (3.0 * kk)
        yN[:, I_F + 2] = F[:, 2] * E1 + 0.1 * fac
        yN[:, I_G] = G[:, 0] * E1 + 0.5 * fac
        yN[:, I_G + 2] = G[:, 2] * E1 + 0.1 * fac
        yN[:, I_N:] = y[:, I_N:]
        return torch.where(tca[:, None], y, yN)

    def steps(self, y, tab, every=0):
        """The ``nGrid - 1`` RK4 steps of the per-step table ``tab`` from
        ``y``, each followed by the relaxation; returns the final state and
        (step index, state) after every ``every``-th step when ``every`` >
        0."""
        h = self.c["h"]
        snaps = []
        for i, rec in enumerate(tab.tolist()):
            b0, bm, be = (_abscissa(rec, j) for j in range(3))
            s = {name: rec[j] for name, j in _COL.items()}
            relax = s["relax"]
            k1 = self.derivs(b0, y, relax)
            k2 = self.derivs(bm, y + h / 2 * k1, relax)
            k3 = self.derivs(bm, y + h / 2 * k2, relax)
            k4 = self.derivs(be, y + h * k3, relax)
            yN = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            y = self.relax_step(yN, s, be)
            if every and i % every == 0:
                snaps.append((i, y))
        return y, snaps


def _transfer_plain(kk, bg):
    """Plain torch solve for float64 ``kk`` (nk,) on its device: (T, R0)
    tensors."""
    _transfer_plain.calls += 1
    tab = _step_tables(bg)
    sysd = _System(bg, kk)
    y0 = sysd.initial_state()
    R0 = sysd.comoving_curvature(y0, _abscissa(tab[0], 0)["a"])
    yF, _ = sysd.steps(y0, tab)
    c = sysd.c
    dm = (c["Oc0"] * yF[:, I_DC] + c["Ob0"] * yF[:, I_DB]) / c["OcOb"]
    return dm / R0, R0


_transfer_plain.calls = 0


# -- the CUDA kernel --------------------------------------------------------

# kernel parameters, in the order of struct BoltzParams in the source
_PARAM_KEYS = ("h", "Oc0", "Ob0", "Og0", "On0", "Ol0", "c6H2", "c15H2",
               "phi0", "tau0", "OgOn", "OcOb")


def _declare(lib):
    fn = lib.nemo_boltzmann_rk4
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    div = lib.nemo_boltzmann_divide
    div.restype = ctypes.c_int
    div.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    probe = lib.nemo_boltzmann_chain_probe
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p]


# the kernel built with nvcc's `/` in place of its branch-free division
# (the same results; chip_smoke.py times the two builds)
IEEE_DIV_BUILD = "boltzmann_rk4.cu -DNEMO_BOLTZ_IEEE_DIV"


def load_kernel(source="boltzmann_rk4.cu"):
    """Build (first call) and load the Boltzmann kernel's library."""
    return cuda_build.load_library(source, _declare)


def _snapshots(nSteps, every):
    """Count of the states kept every ``every`` steps (after steps 0,
    every, 2 every, ...)."""
    return (nSteps + every - 1) // every


def _launch(kk, tab, bg, snap=None, every=0, lib=None):
    """One launch of the kernel: float64 CUDA tensors ``kk`` (nk,) and the
    per-step table ``tab`` (nGrid - 1, STEP_REC) on its card; returns (T,
    R0).  With ``snap`` (nk, nSnap, NV), the state after every ``every``-th
    step is written there too.  ``lib``: another build of the kernel."""
    nSteps = tab.shape[0]
    if (tab.dtype != torch.float64 or tab.device != kk.device
            or tuple(tab.shape) != (nSteps, STEP_REC)
            or not tab.is_contiguous()):
        raise ValueError("the per-step table must be a contiguous (nSteps, "
                         "%d) float64 tensor on the wavenumbers' device"
                         % STEP_REC)
    if snap is not None and (
            every < 1 or snap.dtype != torch.float64
            or snap.device != kk.device or not snap.is_contiguous()
            or tuple(snap.shape) != (kk.shape[0], _snapshots(nSteps, every),
                                     NV)):
        raise ValueError("snapshot buffer: want (nk, nSnap, NV) float64 on "
                         "the wavenumbers' device, every >= 1")
    lib = lib or load_kernel()
    c = _constants(bg)
    params = np.array([c[k] for k in _PARAM_KEYS], dtype=np.float64)
    T = torch.empty_like(kk)
    R0 = torch.empty_like(kk)
    with torch.cuda.device(kk.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nemo_boltzmann_rk4(
            kk.data_ptr(), tab.data_ptr(), int(nSteps), STEP_REC,
            params.ctypes.data, T.data_ptr(), R0.data_ptr(),
            int(kk.shape[0]), None if snap is None else snap.data_ptr(),
            int(every) if snap is not None else 0, stream)
    if err != 0:
        raise RuntimeError("boltzmann_rk4 kernel launch failed: CUDA error "
                           "%d" % err)
    transfer_function.launches += 1
    return T, R0


def _transfer_cuda(kk, bg):
    """The kernel: (T, R0) tensors on ``kk``'s card, one warp a k.  The
    per-step table is built on the host and uploaded here, so its time is
    part of the call."""
    if not kk.is_cuda:
        raise ValueError("the CUDA Boltzmann kernel needs CUDA tensors")
    kk = kk.to(torch.float64).contiguous()
    return _launch(kk, _device_step_tables(bg, kk.device), bg)


def _device_step_tables(bg, device):
    """The per-step table on ``device``, step-major: uploaded as the
    host's column-major buffer and transposed there."""
    cols = torch.as_tensor(_step_tables(bg).T, device=device)
    return cols.T.contiguous()


def transfer_function(kMpc, H0=70.0, Om0=0.3, Ob0=0.05, nGrid=24576,
                      dtype=np.float64, device="cuda"):
    """Linear matter transfer function delta_m(k, z=0) / R_init.

    Args:
        kMpc: 1-d array of comoving wavenumbers in Mpc^-1 (<= ~60; the
            integrator's step budget is tuned for the sigma(M) range).
        device: "cuda" launches ``csrc/boltzmann_rk4.cu`` (and raises if
            it cannot); "cpu" runs :func:`_transfer_plain`.
    Returns:
        (T, diag): T same shape as kMpc (arbitrary overall scale -
        callers normalise to sigma8); diag dict with the initial comoving
        curvature ``R0``.  Float64 numpy arrays.
    """
    if np.dtype(dtype) != np.float64:
        raise ValueError("the Boltzmann solve runs in float64 only (the "
                         "pre-recombination system is stiff)")
    dev = torch.device(device)
    bg = _solver_tables(float(H0), float(Om0), float(Ob0), int(nGrid))
    kk = torch.as_tensor(np.asarray(kMpc, dtype=np.float64), device=dev)
    if dev.type == "cpu":
        T, R0 = _transfer_plain(kk, bg)
    elif dev.type == "cuda":
        T, R0 = _transfer_cuda(kk, bg)
    else:
        raise ValueError("device must be 'cpu' or 'cuda', got %r" % device)
    return T.cpu().numpy(), {"R0": R0.cpu().numpy()}


transfer_function.launches = 0


def debug_trajectory(kk, H0=70.0, Om0=0.3, Ob0=0.05, nGrid=8192,
                     dtype=np.float64, every=8, device="cuda"):
    """Per-step state snapshots for one k (diagnostics / tests): the
    kernel's for ``device="cuda"`` (its snapshot buffer), the plain
    version's for ``device="cpu"``.

    Returns (lna_snap, ys (nSnap, NV), R (nSnap,)) with R the comoving
    curvature at each snapshot - superhorizon R must stay constant.
    """
    if np.dtype(dtype) != np.float64:
        raise ValueError("the Boltzmann solve runs in float64 only")
    dev = torch.device(device)
    bg = _solver_tables(float(H0), float(Om0), float(Ob0), int(nGrid))
    k = torch.tensor([float(kk)], dtype=torch.float64, device=dev)
    if dev.type == "cpu":
        sysd = _System(bg, k)
        _, snaps = sysd.steps(sysd.initial_state(), _step_tables(bg),
                              every=every)
        ys = torch.cat([s for _, s in snaps]).numpy()
    elif dev.type == "cuda":
        snap = torch.empty((1, _snapshots(bg.lna.size - 1, every), NV),
                           dtype=torch.float64, device=dev)
        _launch(k, _device_step_tables(bg, dev), bg, snap, every)
        ys = snap[0].cpu().numpy()
    else:
        raise ValueError("device must be 'cpu' or 'cuda', got %r" % device)
    lnas = bg.lna[1:][::every]
    sysd = _System(bg, k.cpu())
    R = np.array([float(sysd.comoving_curvature(
        torch.as_tensor(y)[None], math.exp(x))[0])
        for y, x in zip(ys, lnas)])
    return lnas, ys, R
