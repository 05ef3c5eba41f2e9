"""Native cosmology module (replaces the reference's pyccl dependency).

The reference calls CCL for: background quantities E(z), angular diameter
distance, critical density (``nemo/signals.py:378-445``), the Tinker08/10
halo mass functions on a (z, log10M) grid (``nemo/MockSurvey.py:159-307``),
comoving volumes (``MockSurvey.py:265-269``), and NFW mass-definition
translation with a Bhattacharya13 concentration-mass relation
(``signals.py:1510-1551``).

Everything here is pure numpy/JAX-compatible math:

* Flat LCDM background with photon + massless-neutrino radiation
  (T_CMB = 2.7255 K, N_eff = 3.044), matching CCL's defaults to ~1e-4.
* Linear power spectrum from the Eisenstein & Hu (1998) transfer function
  (with baryon acoustic features), sigma8-normalised.  The reference's
  default is CAMB via CCL; EH98 agrees at the 1-2% level in sigma(M), which
  propagates to a few % in the HMF - within the reference's own mass
  round-trip tolerances (tests/clusters.robot: 2-3%).
* Tinker et al. (2008) multiplicity function with the Delta-interpolated
  parameters and redshift evolution, evaluated for arbitrary overdensity
  w.r.t. mean or critical density.
* NFW mass-definition conversions using the Bhattacharya et al. (2013)
  c(M) relation and the Hu & Kravtsov (2003) x(f) inversion.

Grids are precomputed with numpy at construction; hot-path evaluations
(HMF on the (z, M) grid for SelFn.update) are plain array math that can be
jitted on TPU.
"""

import functools

import numpy as np

# -- constants (CODATA / IAU) ------------------------------------------------
C_KM_S = 299792.458                 # km/s
G_MSUN = 4.301e-9                   # G in MSun^-1 km^2 s^-2 Mpc (as signals.py:1493)
TCMB0 = 2.7255                      # CCL default CMB temperature [K]
NEFF = 3.044
DELTA_COLLAPSE = 1.686


def rho_crit0(h):
    """Critical density today in MSun / Mpc^3 (comoving = physical at z=0)."""
    H0 = 100.0 * h  # km/s/Mpc
    return 3 * H0 ** 2 / (8 * np.pi * G_MSUN)


# Boltzmann splice grid: the solver's conventional T(k) comes from
# delta_m / (k^2 R0), exact only well inside the horizon - at
# k = 1e-4 Mpc^-1 the neglected (aH/k)^2 gauge terms inflate it ~5x.
# kmin = 5e-3 keeps that contamination < 0.3% while still covering the
# equality turnover; EH98 (shape-accurate where T ~ 1) is spliced in
# below, scaled for continuity.  kmax = 30: k > 30 contributes nothing
# to sigma(M >= 1e13) through the W^2 filter.
_BOLTZ_KGRID = np.logspace(np.log10(5e-3), np.log10(30.0), 160)


@functools.lru_cache(maxsize=8)
def _boltzmann_Tk_cached(H0, Om0, Ob0):
    """Raw Boltzmann transfer on ``_BOLTZ_KGRID``, cached per background
    cosmology: sigma8 and ns only normalise/tilt the spectrum OUTSIDE
    the transfer, so SelFn.update / mass-inference loops that vary them
    re-solve nothing.  The ~15-50 s (1-core CPU, float64) solve runs at
    most once per (H0, Om0, Ob0) per process."""
    from . import boltzmann

    Traw, _ = boltzmann.transfer_function(_BOLTZ_KGRID, H0=H0, Om0=Om0,
                                          Ob0=Ob0)
    return Traw


class FlatLCDM:
    """Flat LCDM background + linear power + Tinker08 HMF.

    ``transferFunction``: "eh98" (Eisenstein & Hu 1998 with wiggles,
    instantaneous - the default) or "boltzmann" (the native linear
    Boltzmann solver, ``models/boltzmann.py`` - the first-principles
    counterpart of the reference's CCL ``boltzmann_camb`` transfer,
    ``nemo/MockSurvey.py:159-307``; sigma(M) SHAPE differs from EH98 by
    the documented -1%..+2% over M 1e13..1e16).  The Boltzmann table
    costs ~seconds on TPU / a few minutes on one CPU core per distinct
    (H0, Om0, Ob0); results are cached per parameter set.
    """

    def __init__(self, H0=70.0, Om0=0.3, Ob0=0.05, sigma8=0.8, ns=0.95,
                 zmax=12.0, ngrid=4096, transferFunction="eh98"):
        if transferFunction not in ("eh98", "boltzmann"):
            raise ValueError("transferFunction must be 'eh98' or "
                             "'boltzmann'")
        self.transferFunction = transferFunction
        self.H0 = float(H0)
        self.h = self.H0 / 100.0
        self.Om0 = float(Om0)
        self.Ob0 = float(Ob0)
        self.sigma8 = float(sigma8)
        self.ns = float(ns)
        # Radiation: photons + massless neutrinos
        # Omega_gamma h^2 = 2.47282e-5 * (T/2.7255)^4
        og_h2 = 2.47282e-5 * (TCMB0 / 2.7255) ** 4
        self.Og0 = og_h2 / self.h ** 2
        self.Onu0 = self.Og0 * (7.0 / 8.0) * (4.0 / 11.0) ** (4.0 / 3.0) * NEFF
        self.Or0 = self.Og0 + self.Onu0
        self.Ol0 = 1.0 - self.Om0 - self.Or0
        self.rho_crit0 = rho_crit0(self.h)          # MSun / Mpc^3
        self.rho_m0 = self.Om0 * self.rho_crit0     # comoving matter density

        # chi(z) lookup
        zg = np.linspace(0.0, zmax, ngrid)
        Einv = 1.0 / self.Ez(zg)
        chi = np.concatenate([[0.0], np.cumsum(
            (Einv[1:] + Einv[:-1]) / 2 * np.diff(zg))])
        self._z_grid = zg
        self._chi_grid = (C_KM_S / self.H0) * chi   # Mpc

        # growth factor lookup (matter + Lambda, like the reference's
        # astCalc-based gz at signals.py:1464-1478)
        self._growth_grid = self._growth_unnorm(zg)
        self._growth_grid /= self._growth_unnorm(np.array([0.0]))[0]

        # Linear power is built LAZILY (first sigma/HMF access): the
        # fiducial model's consumers (theta500/R500 geometry, Q fitting,
        # filter construction) touch only the background, and with the
        # reference-default Boltzmann transfer an eager build would
        # spend the ~50 s solve on runs that never use sigma(M).
        self._kGrid = None
        self._pkGrid = None
        self._sigma0Cache = {}

    @property
    def _k(self):
        if self._kGrid is None:
            self._init_power()
        return self._kGrid

    @property
    def _pk(self):
        if self._pkGrid is None:
            self._init_power()
        return self._pkGrid

    # -- background ----------------------------------------------------------
    def Ez(self, z):
        z = np.asarray(z, dtype=float)
        return np.sqrt(self.Om0 * (1 + z) ** 3 + self.Or0 * (1 + z) ** 4
                       + self.Ol0)

    def Ez2(self, z):
        return self.Ez(z) ** 2

    def Omz(self, z):
        z = np.asarray(z, dtype=float)
        return self.Om0 * (1 + z) ** 3 / self.Ez2(z)

    def criticalDensity(self, z):
        """Physical critical density at z in MSun / Mpc^3
        (== CCL RHO_CRITICAL * (E(z) h)^2 as used at signals.py:399)."""
        return self.rho_crit0 * self.Ez2(z)

    def meanDensity(self, z):
        return self.Omz(z) * self.criticalDensity(z)

    def comovingDistance(self, z):
        return np.interp(np.asarray(z, dtype=float), self._z_grid,
                         self._chi_grid)

    def angularDiameterDistance(self, z):
        z = np.asarray(z, dtype=float)
        return self.comovingDistance(z) / (1 + z)

    def comovingVolume(self, z):
        """All-sky comoving volume to z in Mpc^3 (MockSurvey.py:265-269)."""
        return (4.0 / 3.0) * np.pi * self.comovingDistance(z) ** 3

    def _growth_unnorm(self, z):
        # D(z) proportional to E(z) * int_z^inf (1+z')/E^3 dz' (matter+Lambda)
        out = np.zeros_like(np.atleast_1d(z), dtype=float)
        zupper = np.linspace(0.0, 1000.0, 20000)
        E3 = (self.Om0 * (1 + zupper) ** 3 + self.Ol0) ** 1.5
        integrand = (1 + zupper) / E3
        cum = np.concatenate([[0.0], np.cumsum(
            (integrand[1:] + integrand[:-1]) / 2 * np.diff(zupper))])
        total = cum[-1]
        partial = total - np.interp(np.atleast_1d(z), zupper, cum)
        Ez_ml = np.sqrt(self.Om0 * (1 + np.atleast_1d(z)) ** 3 + self.Ol0)
        out = Ez_ml * partial
        return out

    def growthFactor(self, z):
        """Linear growth factor normalised to D(0) = 1."""
        return np.interp(np.asarray(z, dtype=float), self._z_grid,
                         self._growth_grid)

    # -- linear power (EH98 with wiggles) -------------------------------------
    def _eh98_transfer(self, k):
        """Eisenstein & Hu (1998) transfer function; k in Mpc^-1."""
        h = self.h
        om = self.Om0 * h ** 2
        ob = self.Ob0 * h ** 2
        fb = self.Ob0 / self.Om0
        theta = TCMB0 / 2.7

        zeq = 2.50e4 * om * theta ** -4
        keq = 7.46e-2 * om * theta ** -2  # Mpc^-1
        b1 = 0.313 * om ** -0.419 * (1 + 0.607 * om ** 0.674)
        b2 = 0.238 * om ** 0.223
        zd = 1291 * (om ** 0.251 / (1 + 0.659 * om ** 0.828)) \
            * (1 + b1 * ob ** b2)

        def Rfunc(z):
            return 31.5 * ob * theta ** -4 * (1000.0 / z)

        Req = Rfunc(zeq)
        Rd = Rfunc(zd)
        s = (2.0 / (3.0 * keq)) * np.sqrt(6.0 / Req) * np.log(
            (np.sqrt(1 + Rd) + np.sqrt(Rd + Req)) / (1 + np.sqrt(Req)))
        ksilk = 1.6 * ob ** 0.52 * om ** 0.73 * (1 + (10.4 * om) ** -0.95)

        q = k / (13.41 * keq)

        a1 = (46.9 * om) ** 0.670 * (1 + (32.1 * om) ** -0.532)
        a2 = (12.0 * om) ** 0.424 * (1 + (45.0 * om) ** -0.582)
        alpha_c = a1 ** (-fb) * a2 ** (-fb ** 3)
        bb1 = 0.944 / (1 + (458 * om) ** -0.708)
        bb2 = (0.395 * om) ** -0.0266
        beta_c = 1.0 / (1 + bb1 * ((1 - fb) ** bb2 - 1))

        def T0(q, ac, bc):
            C = 14.2 / ac + 386.0 / (1 + 69.9 * q ** 1.08)
            ln_arg = np.log(np.e + 1.8 * bc * q)
            return ln_arg / (ln_arg + C * q * q)

        f = 1.0 / (1 + (k * s / 5.4) ** 4)
        Tc = f * T0(q, 1.0, beta_c) + (1 - f) * T0(q, alpha_c, beta_c)

        y = (1 + zeq) / (1 + zd)
        Gy = y * (-6 * np.sqrt(1 + y)
                  + (2 + 3 * y) * np.log((np.sqrt(1 + y) + 1)
                                         / (np.sqrt(1 + y) - 1)))
        alpha_b = 2.07 * keq * s * (1 + Rd) ** -0.75 * Gy
        beta_node = 8.41 * om ** 0.435
        beta_b = 0.5 + fb + (3 - 2 * fb) * np.sqrt((17.2 * om) ** 2 + 1)

        stilde = s / (1 + (beta_node / (k * s)) ** 3) ** (1.0 / 3.0)
        ks = k * stilde
        j0 = np.sinc(ks / np.pi)  # spherical Bessel j0(x) = sinc(x/pi) in numpy
        Tb = (T0(q, 1.0, 1.0) / (1 + (k * s / 5.2) ** 2)
              + alpha_b / (1 + (beta_b / (k * s)) ** 3)
              * np.exp(-(k / ksilk) ** 1.4)) * j0

        return fb * Tb + (1 - fb) * Tc

    def _boltzmann_transfer(self, k):
        """Conventional T(k) from the native Boltzmann solver, spliced
        onto EH98 outside the solved range (see ``_BOLTZ_KGRID`` for the
        boundary rationale - both splices are continuous by scaling EH98
        to match at the boundary)."""
        kb = _BOLTZ_KGRID
        Traw = _boltzmann_Tk_cached(round(self.H0, 10),
                                    round(self.Om0, 10),
                                    round(self.Ob0, 10))
        Tb = np.abs(Traw) / kb ** 2     # strip the sub-horizon k^2
        Teh = self._eh98_transfer(k)
        TehB = self._eh98_transfer(kb)
        T = np.empty_like(k)
        inner = (k >= kb[0]) & (k <= kb[-1])
        T[inner] = np.exp(np.interp(np.log(k[inner]), np.log(kb),
                                    np.log(Tb)))
        lo = k < kb[0]
        T[lo] = Teh[lo] * (Tb[0] / TehB[0])
        hi = k > kb[-1]
        T[hi] = Teh[hi] * (Tb[-1] / TehB[-1])
        return T

    def _init_power(self):
        k = np.logspace(-5, 3, 4096)  # Mpc^-1
        if self.transferFunction == "boltzmann":
            T = self._boltzmann_transfer(k)
        else:
            T = self._eh98_transfer(k)
        pk_un = k ** self.ns * T ** 2
        R8 = 8.0 / self.h
        s8_un = np.sqrt(self._sigma2_of_R(R8, k, pk_un))
        self._kGrid = k
        self._pkGrid = pk_un * (self.sigma8 / s8_un) ** 2
        # sigma(M, z=0) is z-independent (growth factorises out), so cache
        # it per mass grid: dndlnM is called once per (row, z) in mass
        # inference and once per z bin in cluster counts / SelFn.update,
        # always on the same M grid.
        self._sigma0Cache = {}

    @staticmethod
    def _sigma2_of_R(R, k, pk):
        R = np.atleast_1d(R)[:, None]
        x = k[None, :] * R
        w = 3 * (np.sin(x) - x * np.cos(x)) / x ** 3
        integrand = pk[None, :] * w ** 2 * k[None, :] ** 3
        # integrate in ln k
        lnk = np.log(k)
        out = np.trapezoid(integrand, lnk, axis=1) / (2 * np.pi ** 2)
        return out if out.shape[0] > 1 else out[0]

    def sigmaR(self, R, z=0.0):
        s = np.sqrt(self._sigma2_of_R(R, self._k, self._pk))
        return s * self.growthFactor(z)

    def lagrangianR(self, M):
        """Lagrangian radius in Mpc for mass in MSun (comoving)."""
        return (3 * np.asarray(M) / (4 * np.pi * self.rho_m0)) ** (1.0 / 3.0)

    def sigmaM(self, M, z=0.0):
        return self.sigmaR(self.lagrangianR(M), z)

    def nu(self, M, z):
        return DELTA_COLLAPSE / self.sigmaM(M, z)

    # -- Tinker08 ------------------------------------------------------------
    _T08_DELTAS = np.array([200, 300, 400, 600, 800, 1200, 1600, 2400, 3200])
    _T08_A = np.array([0.186, 0.200, 0.212, 0.218, 0.248,
                       0.255, 0.260, 0.260, 0.260])
    _T08_a = np.array([1.47, 1.52, 1.56, 1.61, 1.87, 2.13, 2.30, 2.53, 2.66])
    _T08_b = np.array([2.57, 2.25, 2.05, 1.87, 1.59, 1.51, 1.46, 1.44, 1.41])
    _T08_c = np.array([1.19, 1.27, 1.34, 1.45, 1.58, 1.80, 1.97, 2.24, 2.44])

    def _tinker08_params(self, delta_m):
        ld = np.log10(delta_m)
        x = np.log10(self._T08_DELTAS)
        A0 = np.interp(ld, x, self._T08_A)
        a0 = np.interp(ld, x, self._T08_a)
        b0 = np.interp(ld, x, self._T08_b)
        c0 = np.interp(ld, x, self._T08_c)
        return A0, a0, b0, c0

    def tinker08_f(self, sigma, z, delta_m):
        A0, a0, b0, c0 = self._tinker08_params(delta_m)
        zc = min(float(z), 2.5)  # parameters frozen above z = 2.5 (T08 S4)
        A = A0 * (1 + zc) ** -0.14
        a = a0 * (1 + zc) ** -0.06
        alpha = 10 ** (-((0.75 / np.log10(delta_m / 75.0)) ** 1.2))
        b = b0 * (1 + zc) ** -alpha
        c = c0
        return A * ((sigma / b) ** -a + 1) * np.exp(-c / sigma ** 2)

    # -- Tinker10 --------------------------------------------------------------
    # Table 4 of Tinker et al. (2010); delta is w.r.t. mean density.
    _T10_DELTAS = _T08_DELTAS
    _T10_alpha = np.array([0.368, 0.363, 0.385, 0.389, 0.393,
                           0.365, 0.379, 0.355, 0.327])
    _T10_beta = np.array([0.589, 0.585, 0.544, 0.543, 0.564,
                          0.623, 0.637, 0.673, 0.702])
    _T10_gamma = np.array([0.864, 0.922, 0.987, 1.09, 1.20,
                           1.34, 1.50, 1.68, 1.81])
    _T10_phi = np.array([-0.729, -0.789, -0.910, -1.05, -1.20,
                         -1.26, -1.45, -1.50, -1.49])
    _T10_eta = np.array([-0.243, -0.261, -0.261, -0.273, -0.278,
                         -0.301, -0.301, -0.319, -0.336])

    def tinker10_g(self, sigma, z, delta_m):
        """nu f(nu) multiplicity of Tinker et al. (2010), with their
        redshift evolution (frozen at z = 3)."""
        ld = np.log10(delta_m)
        x = np.log10(self._T10_DELTAS)
        alpha = np.interp(ld, x, self._T10_alpha)
        beta0 = np.interp(ld, x, self._T10_beta)
        gamma0 = np.interp(ld, x, self._T10_gamma)
        phi0 = np.interp(ld, x, self._T10_phi)
        eta0 = np.interp(ld, x, self._T10_eta)
        zc = min(float(z), 3.0)
        beta = beta0 * (1 + zc) ** 0.20
        phi = phi0 * (1 + zc) ** -0.08
        eta = eta0 * (1 + zc) ** 0.27
        gamma = gamma0 * (1 + zc) ** -0.01
        nu = DELTA_COLLAPSE / sigma
        fnu = alpha * (1 + (beta * nu) ** (-2 * phi)) * nu ** (2 * eta) \
            * np.exp(-gamma * nu ** 2 / 2.0)
        return nu * fnu

    def dndlnM(self, M, z, delta=500, rhoType="critical",
               massFunction="Tinker08"):
        """Halo mass function dn/dlnM [comoving Mpc^-3] at overdensity
        ``delta`` w.r.t. ``rhoType`` density (CCL MassFuncTinker08/10
        parity)."""
        M = np.asarray(M, dtype=float)
        if rhoType == "critical":
            delta_m = float(delta) / self.Omz(z)
        else:
            delta_m = float(delta)
        key = (M[0] if M.ndim else float(M), M.size,
               hash(M.tobytes()))
        sig0 = self._sigma0Cache.get(key)
        if sig0 is None:
            R = self.lagrangianR(M)
            sig0 = np.sqrt(self._sigma2_of_R(R, self._k, self._pk))
            if len(self._sigma0Cache) > 32:
                self._sigma0Cache.clear()
            self._sigma0Cache[key] = sig0
        D = self.growthFactor(z)
        sigma = sig0 * D
        if massFunction == "Tinker10":
            f = self.tinker10_g(sigma, z, delta_m)
        else:
            f = self.tinker08_f(sigma, z, delta_m)
        # dln sigma^-1 / dlnM via finite differences on the M grid
        lnM = np.log(M)
        lnsinv = -np.log(sigma)
        dlns_dlnM = np.gradient(lnsinv, lnM)
        return f * (self.rho_m0 / M) * dlns_dlnM

    # -- NFW mass conversions --------------------------------------------------
    @staticmethod
    def _nfw_mu(x):
        return np.log(1 + x) - x / (1 + x)

    def concentrationB13(self, M200c, z):
        """Bhattacharya et al. (2013) c200c(M, z), full-sample fit."""
        D = self.growthFactor(z)
        # nu defined with their fitting form (B13 eq. 9 family)
        nu = (1.0 / D) * (1.12 * (np.asarray(M200c)
                                  / (5e13 / self.h)) ** 0.3 + 0.53)
        return D ** 0.54 * 5.9 * nu ** -0.35

    def _delta_ratio(self, z, delta, rhoType):
        """delta * rho_type(z) expressed in units of rho_crit(z)."""
        if rhoType == "critical":
            return float(delta)
        return float(delta) * self.Omz(z)

    def convertMassDef(self, M, z, delta_in, rhoType_in, delta_out,
                       rhoType_out):
        """NFW-based M_{delta_in} -> M_{delta_out}.

        Uses c200c from Bhattacharya13; masses in MSun.  Vectorised over
        BOTH M and z (broadcast together), so a whole catalog's
        mass-definition conversions run as one numpy computation instead
        of the reference's per-row loop (``bin/nemoMass:203-213``).
        """
        scalarIn = np.isscalar(M) or np.ndim(M) == 0
        M, z = np.broadcast_arrays(np.atleast_1d(np.asarray(M, dtype=float)),
                                   np.asarray(z, dtype=float))
        d_in = np.asarray(self._delta_ratio(z, delta_in, rhoType_in))
        d_out = np.asarray(self._delta_ratio(z, delta_out, rhoType_out))
        if np.all(d_in == d_out):
            return float(M[0]) if scalarIn else M.copy()

        # Get c_in: concentration defined for 200c; convert via iteration.
        # Approximate M200c from M_in first (iterate twice - converges fast).
        M200c = M.copy()
        for _ in range(3):
            c200c = self.concentrationB13(M200c, z)
            # radius ratio R_in/R200c from mass defs:
            # M_in/M200c = (d_in/200) * (R_in/R200c)^3 and NFW mu ratio
            # solve x_in = R_in/rs given R200c/rs = c200c
            x_in = self._solve_x(c200c, d_in / 200.0, M / M200c)
            M200c = M * self._nfw_mu(c200c) / self._nfw_mu(x_in)
        c_in = self.concentrationB13(M200c, z) * 0 + c200c  # final c200c
        rs_ratio_in = x_in  # R_in / rs

        # Now convert to out definition: find x_out with
        # mean density within x_out = d_out * rho_c
        # mean density within x: 3 mu(x) Ms / (4 pi rs^3 x^3) ... relative:
        # d(x) / d(x_in) = [mu(x)/x^3] / [mu(x_in)/x_in^3]
        x_out = self._solve_x_target(rs_ratio_in, d_in, d_out)
        M_out = M * self._nfw_mu(x_out) / self._nfw_mu(rs_ratio_in)
        return float(M_out[0]) if scalarIn else M_out

    def _solve_x(self, c200c, dens_ratio, mass_ratio_guess):
        """Solve mu(x)/x^3 = dens_ratio * mu(c)/c^3 for x (bisection)."""
        target = dens_ratio * self._nfw_mu(c200c) / c200c ** 3
        return self._invert_mu_over_x3(target)

    def _solve_x_target(self, x_in, d_in, d_out):
        target = (d_out / d_in) * self._nfw_mu(x_in) / x_in ** 3
        return self._invert_mu_over_x3(target)

    @staticmethod
    def _invert_mu_over_x3(target):
        """Invert g(x) = mu(x)/x^3 (monotonically decreasing)."""
        target = np.atleast_1d(target)
        lo = np.full_like(target, 1e-4)
        hi = np.full_like(target, 1e4)
        for _ in range(80):
            mid = np.sqrt(lo * hi)
            g = (np.log(1 + mid) - mid / (1 + mid)) / mid ** 3
            too_big = g > target  # g decreasing: need larger x
            lo = np.where(too_big, mid, lo)
            hi = np.where(too_big, hi, mid)
        return np.sqrt(lo * hi)


# Fiducial cosmology used for filter construction and Q fitting, matching the
# reference's module-level default (``nemo/signals.py:59-69``).
_FIDUCIAL = None


def fiducialCosmoModel():
    global _FIDUCIAL
    if _FIDUCIAL is None:
        _FIDUCIAL = FlatLCDM(H0=70.0, Om0=0.3, Ob0=0.05, sigma8=0.8, ns=0.95)
    return _FIDUCIAL


# -- halo geometry helpers (signals.py:378-445 equivalents) -------------------
def calcRDeltaMpc(z, MDelta, cosmo, delta=500, wrt="critical"):
    """R_Delta in Mpc for a halo of mass MDelta (MSun) at z."""
    if wrt == "critical":
        dens = delta * cosmo.criticalDensity(z)
    else:
        dens = delta * cosmo.meanDensity(z)
    return (3 * np.asarray(MDelta) / (4 * np.pi * dens)) ** (1.0 / 3.0)


def calcR500Mpc(z, M500c, cosmo):
    return calcRDeltaMpc(z, M500c, cosmo, delta=500, wrt="critical")


def calcTheta500Arcmin(z, M500c, cosmo):
    """Angular scale of R500c in arcmin (signals.py:427-445)."""
    R = calcR500Mpc(z, M500c, cosmo)
    DA = cosmo.angularDiameterDistance(z)
    return np.degrees(np.arctan(R / DA)) * 60.0


def M500cFromTheta500(theta500Arcmin, z, cosmo):
    """Invert calcTheta500Arcmin (used to build the Q-fit M range,
    signals.py:913-918)."""
    DA = cosmo.angularDiameterDistance(z)
    R500 = np.tan(np.radians(np.asarray(theta500Arcmin) / 60.0)) * DA
    return (4.0 / 3.0) * np.pi * R500 ** 3 * 500 * cosmo.criticalDensity(z)
