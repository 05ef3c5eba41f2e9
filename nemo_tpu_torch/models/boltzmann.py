"""Linear Boltzmann solver: matter transfer functions on torch tensors.

Port of ``nemo_tpu/models/boltzmann.py``.  The background and the
recombination history (:class:`Background`, host numpy) are copied as they
are; the perturbation solve - conformal-Newtonian MB95 hierarchies (CDM,
baryons, photon intensity and polarization to l = 8, massless neutrinos to
l = 12) with the tight-coupling and radiation-streaming regimes and the
exact per-step Thomson relaxation, integrated by fixed-step RK4 in ln a
from ln a = -19.5 to 0 - is the JAX package's, step for step.

Two versions of the solve:

* :func:`_transfer_plain`, plain torch: every k at once as a batch
  dimension, the scan written as a Python loop over the ``nGrid - 1``
  steps.  The background values at each step's three RK4 abscissae are
  interpolated once, before the loop, with ``jnp.interp``'s formula.
* ``csrc/boltzmann_rk4.cu``, the hand-written CUDA kernel: one thread
  integrates one k through every step in one launch (the scan on the hot
  path is a kernel; eager torch would launch ~10^7 small kernels per
  cosmology).  It interpolates the background tables itself with the
  same formula and index rule.

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


def _interp_tables(x, lna, tabs):
    """``jnp.interp`` of each row of ``tabs`` (m, n) at the points ``x``
    (float64 tensors), formula for formula: index from
    ``searchsorted(side="right")`` clamped to [1, n-1], then
    ``f0 + (delta / dx) * df``, with the end values outside the table.
    Returns (m, len(x))."""
    n = lna.shape[0]
    i = torch.clamp(torch.searchsorted(lna, x, right=True), 1, n - 1)
    x0 = lna[i - 1]
    dx = lna[i] - x0
    delta = x - x0
    eps = np.spacing(np.finfo(np.float64).eps)
    dx0 = torch.abs(dx) <= eps
    ratio = delta / torch.where(dx0, torch.ones_like(dx), dx)
    f0 = tabs[:, i - 1]
    f = torch.where(dx0, f0, f0 + ratio * (tabs[:, i] - f0))
    f = torch.where(x < lna[0], tabs[:, :1], f)
    return torch.where(x > lna[-1], tabs[:, -1:], f)


def _background_at(bg, x):
    """Per-point background scalars at the float64 CPU tensor ``x``:
    numpy arrays a, Hc, tau, kap, cs2, kD."""
    lna = torch.as_tensor(bg.lna, dtype=torch.float64)
    tabs = torch.as_tensor(np.stack([getattr(bg, t) for t in _TABLES]),
                           dtype=torch.float64)
    vals = _interp_tables(x, lna, tabs).numpy()
    return (torch.exp(x).numpy(),) + tuple(vals)


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
        """dy/dlna for every k; ``b`` = (a, Hc, tau, kap, cs2, kD) at this
        abscissa (Python floats), ``relax`` the step's rate cap."""
        c, kk, kk2 = self.c, self.kk, self.kk2
        a, Hc, tau, kap, cs2, kD = b
        phi = y[:, I_PHI]
        dc, tc, db, tb = y[:, I_DC], y[:, I_TC], y[:, I_DB], y[:, I_TB]
        F = y[:, I_F:I_F + LG + 1]
        G = y[:, I_G:I_G + LG + 1]
        N = y[:, I_N:I_N + LN + 1]

        w_c = c["Oc0"] / a
        w_b = c["Ob0"] / a
        w_g = c["Og0"] / (a * a)
        w_n = c["On0"] / (a * a)

        th_g = 0.75 * kk * F[:, 1]
        th_n = 0.75 * kk * N[:, 1]
        sig_g = F[:, 2] / 2.0
        sig_n = N[:, 2] / 2.0
        psi = phi - (c["c6H2"] / kk2) * (w_g * sig_g + w_n * sig_n)
        mom = (w_c * tc + w_b * tb
               + (4. / 3.) * (w_g * th_g + w_n * th_n))
        phi_dot = (-Hc * psi + (c["c15H2"] * mom) / kk2)
        dphi = phi_dot / Hc

        Rb = 0.75 * (w_b / w_g)
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
        slip = slipNum / (kap * (1.0 + 1.0 / max(Rb, 1e-30)))
        tb_full = (-Hc * tb + cs2 * kk2 * db + kk2 * psi)
        tb_tca = tb_full + slipNum / (1.0 + Rb)
        d_tb = torch.where(tca, tb_tca, tb_full) / Hc
        d_db = (-tb) / Hc + 3 * dphi

        # photons: the full hierarchies (the JAX package's kapEff terms are
        # products with 0.0 and are left out)
        tauMax = max(tau, 1e-30)
        dF0 = -kk * F[:, 1] + 4 * phi_dot
        dF_full = torch.cat([
            dF0[:, None],
            ((kk / 3.0) * (F[:, 0] - 2 * F[:, 2])
             + (4 * kk / 3.0) * psi)[:, None],
            ((kk / 5.0) * (2 * F[:, 1] - 3 * F[:, 3]))[:, None],
            self.kkF * (self.lF * F[:, 2:LG - 1] - self.lF1 * F[:, 4:LG + 1]),
            (kk * F[:, LG - 1] - ((LG + 1) / tauMax) * F[:, LG])[:, None]],
            dim=1)
        dG_full = torch.cat([
            (-kk * G[:, 1])[:, None],
            ((kk / 3.0) * (G[:, 0] - 2 * G[:, 2]))[:, None],
            ((kk / 5.0) * (2 * G[:, 1] - 3 * G[:, 3]))[:, None],
            self.kkF * (self.lF * G[:, 2:LG - 1] - self.lF1 * G[:, 4:LG + 1]),
            (kk * G[:, LG - 1] - ((LG + 1) / tauMax) * G[:, LG])[:, None]],
            dim=1)

        # tight coupling
        relRate = min(kap, relax)
        F2_tca = (8.0 / 15.0) * (kk / max(kap, 1e-30)) * F[:, 1]
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
            (kk * N[:, LN - 1] - ((LN + 1) / tauMax) * N[:, LN])[:, None]],
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

    def relax_step(self, y, b, h_tau):
        """Exact Thomson relaxation over one step, outside tight coupling;
        ``b`` is the background at the step's end."""
        c, kk = self.c, self.kk
        a, Hc, _, kap, _, _ = b
        Rb = 0.75 * (c["Ob0"] / a) / (c["Og0"] / (a * a))
        tca = kap > TCA_FAC * torch.clamp(kk, min=Hc)
        F = y[:, I_F:I_F + LG + 1]
        G = y[:, I_G:I_G + LG + 1]
        tb = y[:, I_TB]
        th_g = 0.75 * kk * F[:, 1]
        kh = kap * h_tau
        E1 = math.exp(-kh)
        Ed = math.exp(-kh * (1.0 + 1.0 / max(Rb, 1e-30)))
        thBar = (th_g + Rb * tb) / (1.0 + Rb)
        S = (th_g - tb) * Ed
        th_gN = thBar + (Rb / (1.0 + Rb)) * S
        tbN = thBar - (1.0 / (1.0 + Rb)) * S
        E03 = math.exp(-0.3 * kh)
        fac = (F[:, 2] + G[:, 0] + G[:, 2]) * (E03 - E1) / 0.7
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

    def steps(self, y, every=0):
        """``nGrid - 1`` RK4 steps from ``y``, each followed by the
        relaxation; yields (step index, state) after every ``every``-th
        step when ``every`` > 0, and returns the final state."""
        bg, h = self.bg, self.c["h"]
        lna = torch.as_tensor(bg.lna, dtype=torch.float64)
        x = lna[:-1]
        b0, bm, be = (_background_at(bg, xx) for xx in
                      (x, x + h / 2, x + h))
        snaps = []
        for i in range(x.shape[0]):
            s0 = tuple(float(v[i]) for v in b0)
            sm = tuple(float(v[i]) for v in bm)
            se = tuple(float(v[i]) for v in be)
            h_tau = h / s0[1]
            relax = 0.5 / h_tau
            k1 = self.derivs(s0, y, relax)
            k2 = self.derivs(sm, y + h / 2 * k1, relax)
            k3 = self.derivs(sm, y + h / 2 * k2, relax)
            k4 = self.derivs(se, y + h * k3, relax)
            yN = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            y = self.relax_step(yN, se, h_tau)
            if every and i % every == 0:
                snaps.append((i, y))
        return y, snaps


def _transfer_plain(kk, bg):
    """Plain torch solve for float64 ``kk`` (nk,) on its device: (T, R0)
    tensors."""
    _transfer_plain.calls += 1
    sysd = _System(bg, kk)
    y0 = sysd.initial_state()
    R0 = sysd.comoving_curvature(y0, math.exp(float(bg.lna[0])))
    yF, _ = sysd.steps(y0)
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
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]


def load_kernel():
    """Build (first call) and load the Boltzmann kernel's library."""
    return cuda_build.load_library("boltzmann_rk4.cu", _declare)


def _device_tables(bg, device):
    """(6, nGrid) float64 tensor on ``device``: ln a, then the
    background tables in :data:`_TABLES` order."""
    return torch.as_tensor(
        np.stack([bg.lna] + [getattr(bg, t) for t in _TABLES]),
        dtype=torch.float64, device=device).contiguous()


def _transfer_cuda(kk, bg):
    """The kernel: (T, R0) tensors on ``kk``'s card, every k on a warp of
    its own."""
    if not kk.is_cuda:
        raise ValueError("the CUDA Boltzmann kernel needs CUDA tensors")
    lib = load_kernel()
    kk = kk.to(torch.float64).contiguous()
    tabs = _device_tables(bg, kk.device)
    c = _constants(bg)
    params = np.array([c[k] for k in _PARAM_KEYS], dtype=np.float64)
    T = torch.empty_like(kk)
    R0 = torch.empty_like(kk)
    with torch.cuda.device(kk.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nemo_boltzmann_rk4(
            kk.data_ptr(), tabs.data_ptr(), int(tabs.shape[1]),
            params.ctypes.data, T.data_ptr(), R0.data_ptr(),
            int(kk.shape[0]), stream)
    if err != 0:
        raise RuntimeError("boltzmann_rk4 kernel launch failed: CUDA error "
                           "%d" % err)
    transfer_function.launches += 1
    return T, R0


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
                     dtype=np.float64, every=8, device="cpu"):
    """Per-step state snapshots for one k (diagnostics / tests), by the
    plain version.

    Returns (lna_snap, ys (nSnap, NV), R (nSnap,)) with R the comoving
    curvature at each snapshot - superhorizon R must stay constant.
    """
    if np.dtype(dtype) != np.float64:
        raise ValueError("the Boltzmann solve runs in float64 only")
    bg = _solver_tables(float(H0), float(Om0), float(Ob0), int(nGrid))
    k = torch.tensor([float(kk)], dtype=torch.float64,
                     device=torch.device(device))
    sysd = _System(bg, k)
    _, snaps = sysd.steps(sysd.initial_state(), every=every)
    lnas = bg.lna[1:][::every]
    ys = torch.cat([s for _, s in snaps]).cpu().numpy()
    R = np.array([float(sysd.comoving_curvature(s, math.exp(x))[0])
                  for (_, s), x in zip(snaps, lnas)])
    return lnas, ys, R
