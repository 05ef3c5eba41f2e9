"""Halo mass function grids and mock catalog generation.

Rebuild of ``nemo/MockSurvey.py`` on the native cosmology module (no CCL):
Tinker08 (or Tinker10-style) cluster counts on a (z, log10M) grid, comoving
volumes, inverse-CDF samplers, and end-to-end mock observable generation
through the y0~ scaling relation.
"""

import numpy as np
from scipy import interpolate

from . import catalogs
from .models import cosmology as cosmo_mod
from .models import sz
from .utils.tables import Table


class MockSurvey:
    """Cluster counts and mock catalogs for a survey area
    (``MockSurvey.py:30-627``)."""

    def __init__(self, minMass, areaDeg2, zMin, zMax, H0, Om0, Ob0, sigma8,
                 ns, zStep=0.01, enableDrawSample=False, delta=500,
                 rhoType="critical", transferFunction="boltzmann_camb",
                 massFunction="Tinker08", c_m_relation="Bhattacharya13",
                 device="cuda"):
        if areaDeg2 == 0:
            raise ValueError("Cannot create a MockSurvey with zero area")
        self.areaDeg2 = areaDeg2
        # NOTE: matches the reference's (slightly odd) areaSr convention
        # (``MockSurvey.py:101``): radians(sqrt(area))^2
        self.areaSr = np.radians(np.sqrt(areaDeg2)) ** 2

        zRange = np.arange(zMin, zMax + zStep, zStep)
        self.zBinEdges = zRange
        self.z = (zRange[:-1] + zRange[1:]) / 2.0
        self.a = 1.0 / (1 + self.z)

        self.delta = delta
        self.rhoType = rhoType
        self.massFuncName = massFunction
        # reference naming (CCL): 'eisenstein_hu' or 'boltzmann_camb'
        # (nemo/MockSurvey.py:66, whose DEFAULT is boltzmann_camb -
        # matched here since round 5; the native Boltzmann solve costs
        # ~50 s once per (H0, Om0, Ob0) per process, cached, and the
        # power grid is built lazily).  Maps onto the native options
        self.transferFunction = {
            "eisenstein_hu": "eh98", "eh98": "eh98",
            "boltzmann_camb": "boltzmann",
            "boltzmann": "boltzmann"}[transferFunction]
        self.mdefLabel = "M%d%s" % (delta, rhoType[0])
        self.device = device    # where the Boltzmann transfer is solved

        self.H0 = -1
        self.Om0 = -1
        self.Ob0 = -1
        self.sigma8 = -1
        self.ns = -1

        self.log10M = np.arange(np.log10(minMass), 16, 0.01)
        self.M = 10 ** self.log10M
        step = self.log10M[1] - self.log10M[0]
        self.log10MBinEdges = np.linspace(self.log10M.min() - step / 2,
                                          self.log10M.max() + step / 2,
                                          len(self.log10M) + 1)

        self.enableDrawSample = enableDrawSample
        self.update(H0, Om0, Ob0, sigma8, ns)

    # ------------------------------------------------------------------
    def setSurveyArea(self, areaDeg2):
        if areaDeg2 == 0:
            raise ValueError("Cannot set zero area")
        if areaDeg2 != self.areaDeg2:
            self.areaDeg2 = areaDeg2
            self.areaSr = np.radians(np.sqrt(areaDeg2)) ** 2
            self._doClusterCount()

    def update(self, H0, Om0, Ob0, sigma8, ns):
        """Recompute everything for new cosmological parameters
        (``MockSurvey.py:179-243``)."""
        if (self.H0, self.Om0, self.Ob0, self.sigma8, self.ns) != \
                (H0, Om0, Ob0, sigma8, ns):
            self.H0, self.Om0, self.Ob0 = H0, Om0, Ob0
            self.sigma8, self.ns = sigma8, ns
            self.cosmoModel = cosmo_mod.FlatLCDM(
                H0=H0, Om0=Om0, Ob0=Ob0, sigma8=sigma8, ns=ns,
                transferFunction=self.transferFunction,
                device=self.device)
        self._doClusterCount()

        cm = self.cosmoModel
        self.Ez = cm.Ez(self.z)
        self.Ez2 = self.Ez ** 2
        self.DAz = cm.angularDiameterDistance(self.z)
        self.criticalDensity = cm.criticalDensity(self.z)

        # theta500(M) and fRel(M) interpolators per z slice
        # (``MockSurvey.py:196-225``)
        self.theta500Splines = []
        self.fRelSplines = []
        interpPoints = 100
        for k in range(len(self.z)):
            zk = self.z[k]
            if self.delta == 500 and self.rhoType == "critical":
                lo, hi = self.log10M.min(), self.log10M.max()
            else:
                lo = np.log10(self._toM500c(self.M.min(), zk))
                hi = np.log10(self._toM500c(self.M.max(), zk))
            fitM500s = 10 ** np.linspace(lo, hi, interpPoints)
            R500 = (3 * fitM500s
                    / (4 * np.pi * 500 * self.criticalDensity[k])) ** (1 / 3)
            fitTheta500s = np.degrees(np.arctan(R500 / self.DAz[k])) * 60.0
            fitFRels = sz.calcFRel(zk, fitM500s, self.Ez[k])
            self.theta500Splines.append(interpolate.splrep(
                np.log10(fitM500s), fitTheta500s))
            self.fRelSplines.append(interpolate.splrep(
                np.log10(fitM500s), fitFRels))

        if self.enableDrawSample:
            zSum = self.clusterCount.sum(axis=1)
            pz = np.cumsum(zSum) / self.numClusters
            self.zRoller = interpolate.InterpolatedUnivariateSpline(
                pz, self.z, k=3)
            self.log10MRollers = []
            for i in range(len(self.z)):
                ngtm = self._cumulativeNumberDensity(self.z[i])
                mask = ngtm > 0
                self.log10MRollers.append(
                    interpolate.InterpolatedUnivariateSpline(
                        (ngtm[mask] / ngtm[0])[::-1],
                        np.log10(self.M[mask][::-1]), k=3))

    def _toM500c(self, M, z):
        return self.cosmoModel.convertMassDef(M, z, self.delta, self.rhoType,
                                              500, "critical")

    # ------------------------------------------------------------------
    def _cumulativeNumberDensity(self, z):
        """n(>M) per comoving Mpc^3 (``MockSurvey.py:246-262``)."""
        dndlnM = self.cosmoModel.dndlnM(self.M, z, delta=self.delta,
                                        rhoType=self.rhoType,
                                        massFunction=self.massFuncName)
        lnM = np.log(self.M)
        # integrate from high mass down
        rev = dndlnM[::-1]
        ngtm = np.concatenate([[0.0], np.cumsum(
            (rev[1:] + rev[:-1]) / 2 * np.diff(lnM)[::-1])])[::-1][:-1]
        # extend the integral above the top of the grid with a power-law tail
        if dndlnM[-1] > 0 and dndlnM[-2] > 0:
            slope = (np.log(dndlnM[-1]) - np.log(dndlnM[-2])) \
                / (lnM[-1] - lnM[-2])
            if slope < -1e-9:
                ngtm = ngtm + dndlnM[-1] / (-slope)
        return np.concatenate([ngtm, [ngtm[-1] * 1e-9]])[:len(self.M)]

    def _comovingVolume(self, z):
        return self.cosmoModel.comovingVolume(z)

    def _doClusterCount(self):
        """Counts on the (z, log10M) grid (``MockSurvey.py:272-307``)."""
        zRange = self.zBinEdges
        numberDensity = []
        clusterCount = []
        totalVolumeMpc3 = 0.0
        for i in range(len(zRange) - 1):
            zShellMid = (zRange[i] + zRange[i + 1]) / 2.0
            dndlnM = self.cosmoModel.dndlnM(self.M, zShellMid,
                                            delta=self.delta,
                                            rhoType=self.rhoType,
                                            massFunction=self.massFuncName)
            n = (dndlnM / self.M) * np.gradient(self.M)
            numberDensity.append(n)
            shellVolumeMpc3 = (self._comovingVolume(zRange[i + 1])
                               - self._comovingVolume(zRange[i]))
            shellVolumeMpc3 *= self.areaSr / (4 * np.pi)
            totalVolumeMpc3 += shellVolumeMpc3
            clusterCount.append(n * shellVolumeMpc3)
        self.volumeMpc3 = totalVolumeMpc3
        self.numberDensity = np.array(numberDensity)
        self.clusterCount = np.array(clusterCount)
        self.numClusters = self.clusterCount.sum()
        self.numClustersByRedshift = self.clusterCount.sum(axis=1)

    def calcNumClustersExpected(self, MLimit=1e13, zMin=0.0, zMax=2.0,
                                compMz=None):
        """Expected counts with optional completeness weighting
        (``MockSurvey.py:310-337``)."""
        numClusters = self.clusterCount if compMz is None \
            else compMz * self.clusterCount
        zMask = (self.z > zMin) & (self.z < zMax)
        mMask = self.M > MLimit
        return numClusters[:, mMask][zMask].sum()

    def getPLog10M(self, z):
        """P(log10M) at z from n(>M) (``MockSurvey.py:340-354``)."""
        numberDensity = self._cumulativeNumberDensity(z)
        return numberDensity / np.trapezoid(numberDensity, self.M)

    # ------------------------------------------------------------------
    def drawSample(self, y0Noise, scalingRelationDict, QFit=None, wcs=None,
                   photFilterLabel=None, tileName=None, SNRLimit=None,
                   makeNames=False, z=None, numDraws=None, areaDeg2=None,
                   applySNRCut=False, applyPoissonScatter=True,
                   applyIntrinsicScatter=True, applyNoiseScatter=True,
                   applyRelativisticCorrection=True, verbose=False,
                   biasModel=None, rng=None):
        """Draw a mock cluster sample (``MockSurvey.py:357-627``)."""
        rng = rng or np.random.default_rng()
        if z is None:
            zRange = self.z
        else:
            zRange = [self.z[np.argmin(np.abs(z - self.z))]]

        numClustersByRedshift = np.zeros(len(zRange), dtype=int)
        for k, zk in enumerate(zRange):
            zIndex = np.argmin(np.abs(zk - self.z))
            base = int(round(self.numClustersByRedshift[zIndex]))
            numClustersByRedshift[k] = rng.poisson(base) \
                if applyPoissonScatter else base
        if areaDeg2 is not None:
            numClustersByRedshift = (numClustersByRedshift
                                     * (areaDeg2 / self.areaDeg2)).astype(int)
        numClusters = int(numClustersByRedshift.sum())
        if numDraws is not None:
            numClusters = numDraws
        if numClusters == 0:
            return None

        tenToA0 = scalingRelationDict["tenToA0"]
        B0 = scalingRelationDict["B0"]
        Mpivot = scalingRelationDict["Mpivot"]
        sigma_int = scalingRelationDict["sigma_int"]

        # Positions / noise levels
        if isinstance(y0Noise, np.ndarray) and y0Noise.ndim == 2:
            assert wcs is not None
            RMSMap = y0Noise
            ys, xs = np.nonzero(RMSMap > 0)
            # Uniform sky density: pixels in CAR over-represent high |dec| by
            # 1/cos(dec), so accept-reject with probability cos(dec). The
            # reference achieves the same by drawing uniform-on-sphere points
            # and keeping those landing on valid pixels (MockSurvey.py:454-485).
            got_y, got_x = [], []
            nGot = 0
            for _ in range(10000):
                n_draw = max(2 * (numClusters - nGot), 16)
                pick = rng.integers(0, len(ys), n_draw)
                decs_try = wcs.pix2wcs(xs[pick].astype(float),
                                       ys[pick].astype(float))[:, 1]
                acc = rng.uniform(0, 1, n_draw) < np.cos(np.radians(decs_try))
                got_y.append(ys[pick[acc]])
                got_x.append(xs[pick[acc]])
                nGot += int(acc.sum())
                if nGot >= numClusters:
                    break
            ysel = np.concatenate(got_y)[:numClusters]
            xsel = np.concatenate(got_x)[:numClusters]
            coords = wcs.pix2wcs(xsel.astype(float), ysel.astype(float))
            RAs = coords[:, 0]
            decs = coords[:, 1]
            y0Noise = RMSMap[ysel, xsel]
        elif isinstance(y0Noise, Table):
            areaCum = np.cumsum(np.asarray(y0Noise["areaDeg2"])
                                / np.sum(y0Noise["areaDeg2"]))
            vals = np.interp(rng.uniform(0, 1, numClusters), areaCum,
                             np.asarray(y0Noise["y0RMS"]))
            y0Noise = vals
            RAs = np.zeros(numClusters)
            decs = np.zeros(numClusters)
        else:
            y0Noise = np.ones(numClusters) * y0Noise
            RAs = np.zeros(numClusters)
            decs = np.zeros(numClusters)

        if makeNames:
            names = [catalogs.makeName(ra, dec, prefix="MOCK-CL")
                     for ra, dec in zip(RAs, decs)]
        else:
            names = np.arange(numClusters) + 1

        # Masses by inverse-CDF per z slice (``MockSurvey.py:508-562``)
        log10Ms = rng.random(len(y0Noise))
        log10M500cs = np.zeros(len(y0Noise))
        zs = np.zeros(len(y0Noise))
        zErrs = np.zeros(len(y0Noise))
        Ez2s = np.zeros(len(y0Noise))
        Qs = np.zeros(len(y0Noise))
        fRels = np.zeros(len(y0Noise))
        currentIndex = 0
        for k, zk in enumerate(zRange):
            zIndex = np.argmin(np.abs(zk - self.z))
            if numDraws is not None:
                n_zk = int(round(numDraws / len(zRange)))
            else:
                n_zk = numClustersByRedshift[k]
            if n_zk == 0:
                continue
            nextIndex = min(currentIndex + n_zk, len(y0Noise))
            sel = np.arange(currentIndex, nextIndex)
            if len(sel) == 0:
                continue
            currentIndex = nextIndex
            log10Ms[sel] = self.log10MRollers[zIndex](log10Ms[sel])
            if self.delta == 500 and self.rhoType == "critical":
                log10M500cs[sel] = log10Ms[sel]
            else:
                log10M500cs[sel] = np.log10(self._toM500c(
                    10 ** log10Ms[sel], zk))
            theta500s = interpolate.splev(log10M500cs[sel],
                                          self.theta500Splines[zIndex],
                                          ext=3)
            if QFit is not None:
                Qs[sel] = QFit.getQ(theta500s, z=zk, tileName=tileName)
            else:
                Qs[sel] = 1.0
            fRels[sel] = interpolate.splev(log10M500cs[sel],
                                           self.fRelSplines[zIndex], ext=3)
            Ez2s[sel] = self.Ez2[zIndex]
            zs[sel] = zk

        log10Ms = np.clip(log10Ms, self.log10M.min(), self.log10M.max())
        # Reference semantics (MockSurvey.py:568-571): only NON-POSITIVE
        # fRel values (crazy masses at odd cosmologies) are floored to 0.1
        # to keep logs finite; legitimate values in (0, 0.1) survive.
        fRels[fRels <= 0] = 0.1
        fRels[fRels > 1] = 1.0
        true_y0s = tenToA0 * Ez2s * (10 ** log10Ms / Mpivot) ** (1 + B0) * Qs
        if applyRelativisticCorrection:
            true_y0s = true_y0s * fRels
        if applyIntrinsicScatter:
            scattered_y0s = np.exp(rng.normal(np.log(true_y0s), sigma_int))
        else:
            scattered_y0s = true_y0s
        if applyNoiseScatter:
            measured_y0s = rng.normal(scattered_y0s, y0Noise)
        else:
            measured_y0s = scattered_y0s

        massColLabel = "true_M%d%s" % (self.delta, self.rhoType[0])
        tab = Table()
        tab["name"] = np.array(names)
        tab["RADeg"] = RAs
        tab["decDeg"] = decs
        tab[massColLabel] = 10 ** log10Ms / 1e14
        if "true_M500c" not in tab.keys():
            tab["true_M500c"] = 10 ** log10M500cs / 1e14
        if QFit is None:
            tab["true_y_c"] = true_y0s / 1e-4
        else:
            tab["true_Q"] = Qs
            tab["true_fixed_y_c"] = true_y0s / 1e-4
            tab["fixed_y_c"] = measured_y0s / 1e-4
            tab["fixed_err_y_c"] = y0Noise / 1e-4
            tab["true_fixed_SNR"] = np.asarray(tab["true_fixed_y_c"]) / \
                np.asarray(tab["fixed_err_y_c"])
            if biasModel is not None:
                corr = biasModel["func"](np.asarray(tab["true_fixed_SNR"]),
                                         *biasModel["params"])
                tab["fixed_y_c"] = np.asarray(tab["fixed_y_c"]) * corr
            tab["fixed_SNR"] = np.asarray(tab["fixed_y_c"]) / \
                np.asarray(tab["fixed_err_y_c"])
        tab["redshift"] = zs
        tab["redshiftErr"] = zErrs
        if photFilterLabel is not None and tileName is not None:
            tab["template"] = np.array([photFilterLabel] * len(tab))
            tab["tileName"] = np.array([tileName] * len(tab))
        if applySNRCut and SNRLimit is not None:
            tab = tab[np.asarray(tab["fixed_SNR"]) > SNRLimit]
        return tab
