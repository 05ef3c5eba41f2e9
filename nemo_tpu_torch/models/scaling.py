"""Mass-observable scaling relation and mass inference.

Port of ``nemo_tpu/models/scaling.py`` (a rebuild of the mass part of
``nemo/signals.py``): the UPP-style y0~ - M relation of Hasselfield et al.
(2013), with Eddington (mass-function) de-biasing and relativistic
corrections.  The per-cluster functions are host numpy, as in the JAX
package; the batched catalog path (:func:`calcMassBatch`) evaluates every
row's posterior and its ML mass and 68.3% interval with torch ops on an
explicit device and dtype (the mock survey's device by default; float32 on
CUDA, float64 on the CPU, as the device policy sets them).
"""

import numpy as np
import torch
from scipy import interpolate

from .. import device as device_mod
from . import sz


def getM500FromP(P, log10M, calcErrors=True):
    """Maximum-likelihood mass + 68.3% interval from P(log10M)
    (``signals.py:1207-1245``).  Masses in 1e14 MSun."""
    tck = interpolate.splrep(log10M, P)
    fineLog10M = np.linspace(log10M.min(), log10M.max(), 10000)
    fineP = interpolate.splev(fineLog10M, tck)
    fineP = fineP / np.trapezoid(fineP, fineLog10M)
    index = int(np.argmax(fineP))
    clusterLogM500 = fineLog10M[index]
    clusterM500 = 10 ** clusterLogM500 / 1e14
    errMinus = errPlus = 0.0
    if calcErrors:
        for n in range(fineP.shape[0]):
            lo = index - n
            hi = index + n
            if lo < 0 or hi > fineP.shape[0]:
                break
            p = np.trapezoid(fineP[lo:hi], fineLog10M[lo:hi])
            if p >= 0.6827:
                errMinus = (10 ** clusterLogM500
                            - 10 ** fineLog10M[lo]) / 1e14
                errPlus = (10 ** fineLog10M[hi]
                           - 10 ** clusterLogM500) / 1e14
                break
    return clusterM500, errMinus, errPlus


def calcPMass(y0, y0Err, z, zErr, QFit, mockSurvey, tenToA0=4.95e-5, B0=0.08,
              Mpivot=3e14, sigma_int=0.2, Ez_gamma=2,
              onePlusRedshift_power=0.0, applyMFDebiasCorrection=True,
              applyRelativisticCorrection=True,
              fRelWeightsDict={148.0: 1.0}, return2D=False, returnQ=False,
              tileName=None):
    """P(log10 M500) for one cluster (``signals.py:1339-1452``)."""
    if zErr > 0:
        zMin = z - zErr * 5
        zMax = z + zErr * 5
        zMask = (mockSurvey.z >= zMin) & (mockSurvey.z < zMax)
        zRange = mockSurvey.z[zMask]
        Pz = np.exp(-((z - zRange) ** 2) / (2 * zErr ** 2))
        Pz = Pz / np.trapezoid(Pz, zRange)
    else:
        zRange = [z]
        Pz = np.ones(1)

    log_y0 = np.log(y0)
    log_y0Err = y0Err / y0
    log10Ms = mockSurvey.log10M

    PArr = []
    Qs = None
    for k, zk in enumerate(zRange):
        if mockSurvey.delta != 500 or mockSurvey.rhoType != "critical":
            log10M500c_zk = np.log10(mockSurvey._toM500c(10 ** log10Ms, zk))
        else:
            log10M500c_zk = log10Ms
        zIndex = int(np.argmin(np.abs(mockSurvey.z - zk)))
        theta500s = interpolate.splev(log10M500c_zk,
                                      mockSurvey.theta500Splines[zIndex],
                                      ext=3)
        Qs = QFit.getQ(theta500s, zk, tileName=tileName)
        fRels = interpolate.splev(log10M500c_zk,
                                  mockSurvey.fRelSplines[zIndex], ext=3)
        fRels = np.where(fRels <= 0, 1e-4, fRels)
        y0pred = tenToA0 * mockSurvey.Ez[zIndex] ** Ez_gamma \
            * (10 ** log10Ms / Mpivot) ** (1 + B0) * Qs
        y0pred = y0pred * (1 + zk) ** onePlusRedshift_power
        if applyRelativisticCorrection:
            y0pred = y0pred * fRels
        if np.any(y0pred < 0):
            raise ValueError("Some predicted y0 values are negative")
        with np.errstate(divide="ignore"):
            log_y0pred = np.log(y0pred)
        Py0GivenM = np.exp(-((log_y0 - log_y0pred) ** 2)
                           / (2 * (log_y0Err ** 2 + sigma_int ** 2)))
        norm = np.trapezoid(Py0GivenM, log10Ms)
        if norm > 0:
            Py0GivenM = Py0GivenM / norm
        if applyMFDebiasCorrection:
            PLog10M = mockSurvey.getPLog10M(zk)
            PLog10M = PLog10M / np.trapezoid(PLog10M, log10Ms)
        else:
            PLog10M = 1.0
        PArr.append(Py0GivenM * PLog10M * Pz[k])

    PArr = np.array(PArr)
    P = PArr.sum(axis=0)
    P = P / np.trapezoid(P, log10Ms)

    PQ = P / np.trapezoid(P, Qs)
    fittedQ = Qs[np.argmax(PQ)]

    if return2D:
        P2D = np.zeros(mockSurvey.clusterCount.shape)
        if zErr == 0:
            P2D[np.argmin(np.abs(mockSurvey.z - z))] = PArr[0]
        else:
            P2D[(mockSurvey.z >= z - zErr * 5)
                & (mockSurvey.z < z + zErr * 5)] = PArr
        P = P2D / P2D.sum()
    if returnQ:
        return P, fittedQ
    return P


def calcMass(y0, y0Err, z, zErr, QFit, mockSurvey, tenToA0=4.95e-5, B0=0.08,
             Mpivot=3e14, sigma_int=0.2, Ez_gamma=2,
             onePlusRedshift_power=0.0, applyMFDebiasCorrection=True,
             applyRelativisticCorrection=True, calcErrors=True,
             fRelWeightsDict={148.0: 1.0}, tileName=None):
    """M500 with errors for one cluster (``signals.py:1293-1336``).

    Returns dict keyed by the mockSurvey's mass definition label."""
    if y0 < 0:
        raise ValueError("y0 cannot be negative")
    if y0 > 1e-2:
        raise ValueError("y0 suspiciously large - multiply by 1e-4?")
    P, bestQ = calcPMass(
        y0, y0Err, z, zErr, QFit, mockSurvey, tenToA0=tenToA0, B0=B0,
        Mpivot=Mpivot, sigma_int=sigma_int, Ez_gamma=Ez_gamma,
        onePlusRedshift_power=onePlusRedshift_power,
        applyMFDebiasCorrection=applyMFDebiasCorrection,
        applyRelativisticCorrection=applyRelativisticCorrection,
        fRelWeightsDict=fRelWeightsDict, tileName=tileName, returnQ=True)
    M500, errMinus, errPlus = getM500FromP(P, mockSurvey.log10M,
                                           calcErrors=calcErrors)
    label = mockSurvey.mdefLabel
    return {label: M500, "%s_errPlus" % label: errPlus,
            "%s_errMinus" % label: errMinus, "Q": bestQ}


def _massGridTerms(y0s, y0Errs, zs, zErrs, QFit, mockSurvey, tileNames,
                   tenToA0, B0, Mpivot, Ez_gamma, onePlusRedshift_power,
                   applyRelativisticCorrection):
    """Flatten every cluster's redshift window into per-(row, z) "terms".

    Each term carries the log predicted y0~ over the full log10M grid plus
    the normalised HMF prior and the Gaussian redshift weight - exactly the
    quantities the reference builds inside its per-cluster z loop
    (``signals.py:1380-1422``), but staged for one batched device call.
    """
    zGrid = mockSurvey.z
    log10Ms = mockSurvey.log10M
    nM = len(log10Ms)

    # Per z-slice grids over the full mass grid.  For M500c the mass-def
    # conversion is the identity, so theta500/fRel depend only on the grid
    # z index and can be precomputed row-independently; otherwise the
    # reference converts at the cluster's *exact* z (``signals.py:1394``)
    # and the splines are evaluated per term below.
    isM500c = (mockSurvey.delta == 500
               and mockSurvey.rhoType == "critical")
    if isM500c:
        theta500Grid = np.empty((len(zGrid), nM))
        fRelGrid = np.empty((len(zGrid), nM))
        for k in range(len(zGrid)):
            theta500Grid[k] = interpolate.splev(
                log10Ms, mockSurvey.theta500Splines[k], ext=3)
            fR = interpolate.splev(log10Ms, mockSurvey.fRelSplines[k],
                                   ext=3)
            fRelGrid[k] = np.where(fR <= 0, 1e-4, fR)

    pLog10MCache = {}

    def _pLog10M(zVal):
        key = float(zVal)
        if key not in pLog10MCache:
            P = mockSurvey.getPLog10M(key)
            pLog10MCache[key] = P / np.trapezoid(P, log10Ms)
        return pLog10MCache[key]

    massTerm = (10 ** log10Ms / Mpivot) ** (1 + B0)

    # Terms are cached by (tileName, z): for photo-z rows (zErr > 0) the
    # z window walks the GRID z values, so at most nTiles * nz unique
    # terms exist no matter how many rows share them - the per-row spline
    # and Q evaluations that dominated large-catalog host time collapse
    # to one pass over the unique (tile, z) pairs.  Spec-z rows (zErr=0)
    # use the cluster's exact z; real catalogs quote z to a few decimals,
    # so those terms dedupe heavily too.
    termCache = {}  # (tileName, float(z)) -> unique-term index
    ly0uniq, prioruniq, Qsuniq = [], [], []

    def _term(tileName, zk):
        key = (tileName, float(zk))
        uidx = termCache.get(key)
        if uidx is not None:
            return uidx
        zIndex = int(np.argmin(np.abs(zGrid - zk)))
        if isM500c:
            theta500s = theta500Grid[zIndex]
            fRels = fRelGrid[zIndex]
        else:
            log10M500c = np.log10(
                mockSurvey._toM500c(10 ** log10Ms, zk))
            theta500s = interpolate.splev(
                log10M500c, mockSurvey.theta500Splines[zIndex], ext=3)
            fRels = interpolate.splev(
                log10M500c, mockSurvey.fRelSplines[zIndex], ext=3)
            fRels = np.where(fRels <= 0, 1e-4, fRels)
        Qs = QFit.getQ(theta500s, zk, tileName=tileName)
        y0p = tenToA0 * mockSurvey.Ez[zIndex] ** Ez_gamma \
            * massTerm * Qs * (1 + zk) ** onePlusRedshift_power
        if applyRelativisticCorrection:
            y0p = y0p * fRels
        if np.any(y0p < 0):
            raise ValueError("Some predicted y0 values are negative")
        with np.errstate(divide="ignore"):
            ly0uniq.append(np.log(y0p))
        prioruniq.append(_pLog10M(zk))
        Qsuniq.append(Qs)
        uidx = len(ly0uniq) - 1
        termCache[key] = uidx
        return uidx

    rowIdx, weights, termIdx, lastQ = [], [], [], {}
    for r in range(len(y0s)):
        if zErrs[r] > 0:
            zMask = (zGrid >= zs[r] - zErrs[r] * 5) \
                & (zGrid < zs[r] + zErrs[r] * 5)
            zRange = zGrid[zMask]
            Pz = np.exp(-((zs[r] - zRange) ** 2) / (2 * zErrs[r] ** 2))
            Pz = Pz / np.trapezoid(Pz, zRange)
        else:
            zRange = [zs[r]]
            Pz = np.ones(1)
        for k, zk in enumerate(zRange):
            uidx = _term(tileNames[r], zk)
            rowIdx.append(r)
            weights.append(Pz[k])
            termIdx.append(uidx)
            lastQ[r] = uidx
    return (np.asarray(rowIdx, dtype=np.int32), np.asarray(weights),
            np.asarray(termIdx, dtype=np.int32), np.stack(ly0uniq),
            np.stack(prioruniq), np.stack(Qsuniq), lastQ)


def _batchedPosterior(rowIdx, weights, termIdx, ly0uniq, prioruniq, ly0,
                      s2, nRows, log10Ms, device, dtype):
    """One device pass on ``device`` in ``dtype``: Gaussian likelihood per
    term, trapezoid normalisation, prior weighting, a sum of the terms
    into their rows (``index_add_``).  Returns the normalised P(log10M)
    with and without the HMF de-biasing prior, as numpy arrays.

    The per-term prediction/prior grids are passed as the UNIQUE
    (tile, z) matrices plus a per-term index and gathered on the device -
    the host->device transfer is O(unique terms), not O(rows x z-window).
    """
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    rowIdx = torch.as_tensor(np.asarray(rowIdx, dtype=np.int64),
                             device=device)
    termIdx = torch.as_tensor(np.asarray(termIdx, dtype=np.int64),
                              device=device)
    weights, ly0uniq, prioruniq = t(weights), t(ly0uniq), t(prioruniq)
    ly0, s2 = t(ly0), t(s2)
    dM = float(log10Ms[1] - log10Ms[0])
    ly0pred = ly0uniq[termIdx]
    G = torch.exp(-((ly0[rowIdx][:, None] - ly0pred) ** 2)
                  / (2 * s2[rowIdx][:, None]))
    norm = torch.trapezoid(G, dx=dM, dim=1)
    G = torch.where((norm > 0)[:, None], G / norm[:, None], G)
    wG = weights[:, None] * G
    P = torch.zeros((nRows, G.shape[1]), dtype=dtype, device=device)
    P.index_add_(0, rowIdx, wG * prioruniq[termIdx])
    PU = torch.zeros_like(P)
    PU.index_add_(0, rowIdx, wG)
    P = P / torch.trapezoid(P, dx=dM, dim=1)[:, None]
    PU = PU / torch.trapezoid(PU, dx=dM, dim=1)[:, None]
    return P.cpu().numpy(), PU.cpu().numpy()


def _notAKnotSplineBatch(Y, x0, h, xq=None):
    """Second derivatives of interpolating cubic splines, many rows at once.

    ``Y`` is (nRows, n) sampled on the uniform grid x0 + h*[0..n-1].
    Not-a-knot boundary conditions - the same spline ``splrep(x, y, s=0)``
    builds - so this is the batched equivalent of the reference's
    per-cluster splev refinement (``signals.py:1218-1220``).  For a
    uniform grid the not-a-knot system reduces to M_1 = d_1/6,
    M_{n-2} = d_{n-2}/6 and a constant-coefficient tridiagonal solve for
    the interior second derivatives, so one Thomas factorisation serves
    every row.  Evaluation happens on device in ``_fineGridMLSearch``.
    """
    Y = np.asarray(Y, dtype=float)
    nR, n = Y.shape
    d = 6.0 * (Y[:, 2:] - 2 * Y[:, 1:-1] + Y[:, :-2]) / h ** 2  # (nR, n-2)
    M = np.zeros((nR, n))
    M[:, 1] = d[:, 0] / 6.0
    M[:, n - 2] = d[:, -1] / 6.0
    m = n - 4  # unknowns M[2..n-3]
    if m > 0:
        rhs = d[:, 1:-1].copy()
        rhs[:, 0] -= M[:, 1]
        rhs[:, -1] -= M[:, n - 2]
        # Thomas with constant (1, 4, 1) coefficients
        w = np.empty(m)
        w[0] = 4.0
        for i in range(1, m):
            w[i] = 4.0 - 1.0 / w[i - 1]
        for i in range(1, m):
            rhs[:, i] -= rhs[:, i - 1] / w[i - 1]
        sol = np.empty_like(rhs)
        sol[:, -1] = rhs[:, -1] / w[-1]
        for i in range(m - 2, -1, -1):
            sol[:, i] = (rhs[:, i] - sol[:, i + 1]) / w[i]
        M[:, 2:n - 2] = sol
    M[:, 0] = 2 * M[:, 1] - M[:, 2]
    M[:, n - 1] = 2 * M[:, n - 2] - M[:, n - 3]

    return M


def _fineGridMLSearch(Y, M, x0, h, xlo, xhi, calcErrors, device, dtype):
    """One device pass: evaluate the splines on the 10000-point fine grid,
    normalise, take the ML point, and find the symmetric growing window's
    68.3% crossing (first-crossing semantics of ``signals.py:1225-1240``)
    by a bisection over every row at once.  Returns (logM_ML, logM_lo,
    logM_hi) as numpy arrays."""
    N = 10000

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    Y, M, xq = t(Y), t(M), t(np.linspace(xlo, xhi, N))
    n = Y.shape[1]
    idx = torch.clamp(((xq - x0) / h).to(torch.int64), 0, n - 2)
    tt = (xq - (x0 + idx.to(dtype) * h)) / h
    u = 1.0 - tt
    fineP = (Y[:, idx] * u + Y[:, idx + 1] * tt
             + (h ** 2 / 6.0) * ((u * u * u - u) * M[:, idx]
                                 + (tt * tt * tt - tt) * M[:, idx + 1]))
    dx = xq[1] - xq[0]
    norm = torch.trapezoid(fineP, dx=float(dx), dim=1)
    fineP = fineP / norm[:, None]
    i = torch.argmax(fineP, dim=1)
    xML = xq[i]
    if not calcErrors:
        out = xML.cpu().numpy()
        return out, out, out
    # Clipping the spline at zero makes the window integral
    # p(n) = C[i+n-1] - C[i-n] monotone in n, so the reference's
    # first-crossing scan becomes a per-row binary search (the spline only
    # undershoots zero in the far tails where P ~ 0, outside any 68.3%
    # window).
    finePos = torch.clamp(fineP, min=0.0)
    C = torch.cat([torch.zeros((Y.shape[0], 1), dtype=dtype, device=device),
                   torch.cumsum((finePos[:, 1:] + finePos[:, :-1]) / 2 * dx,
                                dim=1)], dim=1)
    T = 0.6827
    nMax = torch.minimum(i, N - 1 - i)

    def pval(nn):
        hiIdx = torch.clamp(i + nn - 1, 0, N - 1)
        loIdx = torch.clamp(i - nn, 0, N - 1)
        return (torch.gather(C, 1, hiIdx[:, None])[:, 0]
                - torch.gather(C, 1, loIdx[:, None])[:, 0])

    nTop = torch.clamp(nMax, min=1)
    found = (nMax >= 1) & (pval(nTop) >= T)
    lo = torch.ones_like(nTop)
    hi = nTop.clone()
    for _ in range(15):
        mid = (lo + hi) // 2
        ge = pval(mid) >= T
        lo = torch.where(ge, lo, mid + 1)
        hi = torch.where(ge, mid, hi)
    xLo = torch.where(found, xq[torch.clamp(i - lo, 0, N - 1)], xML)
    xHi = torch.where(found, xq[torch.clamp(i + lo, 0, N - 1)], xML)
    return xML.cpu().numpy(), xLo.cpu().numpy(), xHi.cpu().numpy()


def getM500FromPBatch(P, log10M, calcErrors=True, device="cuda",
                      dtype=None):
    """Vectorised ML mass + 68.3% interval for a stack of P(log10M) rows.

    Same fine grid, spline and first-crossing semantics as
    ``getM500FromP`` (``signals.py:1207-1245``), evaluated for all rows
    at once on ``device`` (the card unless the caller asks for the CPU) in
    ``dtype`` (default: the device policy's).  Returns (M500, errMinus,
    errPlus) (1e14 MSun).
    """
    if dtype is None:
        dtype = device_mod.policy(device).dtype
    device = torch.device(device)
    P = np.atleast_2d(np.asarray(P, dtype=float))
    x0 = float(log10M[0])
    h = float(log10M[1] - log10M[0])
    M = _notAKnotSplineBatch(P, x0, h, None)
    xML, xLo, xHi = _fineGridMLSearch(P, M, x0, h, float(log10M.min()),
                                      float(log10M.max()), calcErrors,
                                      device, dtype)
    M500 = 10 ** xML / 1e14
    errMinus = (10 ** xML - 10 ** xLo) / 1e14
    errPlus = (10 ** xHi - 10 ** xML) / 1e14
    return M500, errMinus, errPlus


def calcMassBatch(y0s, y0Errs, zs, zErrs, QFit, mockSurvey, tenToA0=4.95e-5,
                  B0=0.08, Mpivot=3e14, sigma_int=0.2, Ez_gamma=2,
                  onePlusRedshift_power=0.0,
                  applyRelativisticCorrection=True, calcErrors=True,
                  tileNames=None, device=None, dtype=None):
    """Masses for a whole catalog in one batched device computation.

    The batched replacement for the reference's per-row hot loop
    (``bin/nemoMass:103-215`` calling ``signals.py:1339-1452`` one cluster
    at a time): the P(log10M | y0~, z) grids for every row are evaluated
    together on the device, then the ML mass + 68.3% interval per row.
    ``device`` defaults to the mock survey's; ``dtype`` to the device
    policy's (float32 on CUDA, float64 on the CPU).

    Returns a dict of arrays: the mass-definition label and its errors for
    both the de-biased and the Uncorr (no HMF prior) estimates, plus Q.
    Rows must be pre-filtered to valid (y0>0, finite z) entries.
    """
    if device is None:
        device = mockSurvey.device
    if dtype is None:
        dtype = device_mod.policy(device).dtype
    device = torch.device(device)
    y0s = np.asarray(y0s, dtype=float)
    y0Errs = np.asarray(y0Errs, dtype=float)
    zs = np.asarray(zs, dtype=float)
    zErrs = np.asarray(zErrs, dtype=float)
    nRows = len(y0s)
    if tileNames is None:
        tileNames = [None] * nRows
    if np.any(y0s < 0):
        raise ValueError("y0 cannot be negative")
    if np.any(y0s > 1e-2):
        raise ValueError("y0 suspiciously large - multiply by 1e-4?")

    (rowIdx, weights, termIdx, ly0uniq, prioruniq, Qsuniq,
     lastQ) = _massGridTerms(
        y0s, y0Errs, zs, zErrs, QFit, mockSurvey, tileNames, tenToA0, B0,
        Mpivot, Ez_gamma, onePlusRedshift_power,
        applyRelativisticCorrection)
    ly0 = np.log(y0s)
    s2 = (y0Errs / y0s) ** 2 + sigma_int ** 2
    P, PU = _batchedPosterior(rowIdx, weights, termIdx, ly0uniq, prioruniq,
                              ly0, s2, nRows, mockSurvey.log10M, device,
                              dtype)

    label = mockSurvey.mdefLabel
    out = {label: np.zeros(nRows), label + "_errPlus": np.zeros(nRows),
           label + "_errMinus": np.zeros(nRows),
           label + "Uncorr": np.zeros(nRows),
           label + "Uncorr_errPlus": np.zeros(nRows),
           label + "Uncorr_errMinus": np.zeros(nRows),
           "Q": np.zeros(nRows)}
    log10Ms = mockSurvey.log10M
    M500, eM, eP = getM500FromPBatch(np.concatenate([P, PU]), log10Ms,
                                     calcErrors=calcErrors, device=device,
                                     dtype=dtype)
    out[label], out[label + "_errMinus"], out[label + "_errPlus"] = \
        M500[:nRows], eM[:nRows], eP[:nRows]
    (out[label + "Uncorr"], out[label + "Uncorr_errMinus"],
     out[label + "Uncorr_errPlus"]) = \
        M500[nRows:], eM[nRows:], eP[nRows:]
    # Fitted Q per row: Q at the argmax of P normalised against the
    # row's Q(theta500(M)) coordinate (``signals.py``'s fittedQ).  The
    # normalising trapezoid is a per-row scalar, so it is computed
    # vectorised over the stacked unique-Q rows.
    QsRows = Qsuniq[np.array([lastQ[r] for r in range(nRows)])]
    norms = np.trapezoid(P, QsRows, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        PQ = P / norms[:, None]
    out["Q"] = QsRows[np.arange(nRows), np.argmax(PQ, axis=1)]
    return out


def y0FromLogM500(log10M500, z, QFit, cosmoModel, tenToA0=4.95e-5, B0=0.08,
                  Mpivot=3e14, sigma_int=0.2,
                  applyRelativisticCorrection=True,
                  fRelWeightsDict={148.0: 1.0}, tileName=None):
    """Predicted y0~ for a given mass and redshift (``signals.py:1248-1290``)."""
    from . import cosmology as cosmo_mod
    M500 = 10 ** np.asarray(log10M500)
    theta500Arcmin = cosmo_mod.calcTheta500Arcmin(z, M500, cosmoModel)
    Q = QFit.getQ(theta500Arcmin, z, tileName=tileName)
    Ez = cosmoModel.Ez(z)
    if applyRelativisticCorrection:
        fRel = sz.calcWeightedFRel(z, M500, Ez, fRelWeightsDict)
    else:
        fRel = 1.0
    y0pred = tenToA0 * Ez ** 2 * (M500 / Mpivot) ** (1 + B0) * Q * fRel
    return y0pred, theta500Arcmin, Q
