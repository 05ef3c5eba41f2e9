"""Curved-sky spherical-harmonic transforms on CAR iso-latitude rings, on
torch tensors.

Port of ``nemo_tpu/ops/sht.py``.  A CAR grid is a stack of iso-latitude
rings with uniform azimuth spacing, so the transform factorises as

    T(theta_r, phi_j) = Re sum_m (2 - delta_m0) F_m(theta_r) e^{i m phi_j}
    F_m(theta_r)      = sum_l a_lm lambda_lm(theta_r)

an FFT over m per ring (``torch.fft`` in float64 on the tensors' device)
plus an associated-Legendre contraction over l (:func:`legendre_contract`),
orthonormal with the Condon-Shortley phase:

    lambda_mm   = -sqrt((2m+1)/(2m)) sin(theta) lambda_{m-1,m-1}
    lambda_l m  = a_lm (cos(theta) lambda_{l-1,m} - b_lm lambda_{l-2,m})
    a_lm = sqrt((4l^2-1)/(l^2-m^2)),  b_lm = sqrt(((l-1)^2-m^2)/(4(l-1)^2-1))

The recurrence runs in scaled form, as in the JAX package: each (m, ring)
lane carries a value in (-2^48, 2^48) and a power-of-two exponent, seeded
from log2|lambda_mm| = lgc_m + m log2 sin(theta) and renormalised in hops
of at most 2^96.  Two versions of the contraction:

* ``csrc/legendre_contract.cu``, the hand-written CUDA kernel (both
  directions: several (m, ring) lanes a thread from l = m, one block per m
  with the (l, m) factors filled once; analysis sums each thread's rings
  in registers, reduces a warp's rows once every 8 l and writes alm in
  place; see the source), launched on CUDA tensors, counted in
  ``legendre_contract.launches``;
* :func:`_legendre_contract_plain`, the JAX scan as a Python loop over l
  in torch ops with its expressions and masks, run for the CPU, counted in
  ``_legendre_contract_plain.calls``.

Both read one table of seeds (:func:`_seed_tables`) computed with the same
torch expressions on the same device.  Random draws take an explicit
``torch.Generator``; each drawing function also takes the draw itself.
"""

import ctypes

import numpy as np
import torch

from .. import cuda_build
from . import _exact, grf

__all__ = ["alm2map_car", "map2alm_car", "rand_alm", "sim_cmb_map_curved",
           "sim_noise_map_curved", "legendre_rings", "ring_weights",
           "car_ring_geometry", "legendre_contract"]

SOURCE = "legendre_contract.cu"
# in both directions each thread runs several (m, ring) lanes of one m (4 in
# float32, 2 in float64, fixed by type in the kernel's source), and one
# block of up to MAX_THREADS threads takes all the rings of an m, further
# rings further blocks (in analysis, each block's partial rows a plane of
# its own, summed by the wrapper)
MAX_THREADS = 512
RINGS_A_THREAD = {torch.float32: 4, torch.float64: 2}


# ---------------------------------------------------------------------------
# Host-side coefficient tables


def _lgc_table(mmax):
    """log2 of the diagonal amplitude c_m, where
    lambda_mm = (-1)^m c_m sin^m(theta):
    c_m = sqrt(1/4pi) * prod_{k=1..m} sqrt((2k+1)/(2k))."""
    k = np.arange(1, mmax + 1, dtype=np.float64)
    steps = 0.5 * np.log2((2 * k + 1) / (2 * k))
    lgc = np.empty(mmax + 1)
    lgc[0] = 0.5 * np.log2(1.0 / (4 * np.pi))
    lgc[1:] = lgc[0] + np.cumsum(steps)
    return lgc


def _as_device(a, dtype, dev):
    """``a`` (an array or a tensor) as a ``dtype`` tensor on ``dev``.  A host
    array bound for the card is copied from pinned memory without blocking,
    so the copy makes no host sync."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    t = torch.as_tensor(np.ascontiguousarray(a)).to(dtype)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _seed_tables(thetas, mmax):
    """(cos theta (R,), seed mantissa (M1, R), seed exponent (M1, R)) in
    ``thetas``' dtype and device, with the reference's expressions:
    lg = lgc_m + m log2 max(sin theta, 1e-30), S = round(lg) (half to
    even), mantissa (-1)^m 2^(lg - S)."""
    dtype, dev = thetas.dtype, thetas.device
    M1 = mmax + 1
    ct = torch.cos(thetas)
    # clamp away sin(theta) = 0 at exact poles (no 0 * log2(0) = nan)
    lg2sin = torch.log2(torch.clamp(torch.sin(thetas), min=1e-30))[None, :]
    mv = torch.arange(M1, dtype=dtype, device=dev)[:, None]
    lgc = _as_device(_lgc_table(mmax), dtype, dev)[:, None]
    msign = torch.where(torch.arange(M1, device=dev)[:, None] % 2 == 0,
                        1.0, -1.0).to(dtype)
    lg = lgc + mv * lg2sin
    S = torch.round(lg)
    return ct, msign * torch.exp2(lg - S), S


# ---------------------------------------------------------------------------
# Core contraction: F_m(ring) = sum_l a_lm lambda_lm(theta_ring)


def _legendre_contract_plain(thetas, alm_re, alm_im, lmax, mmax,
                             adjoint=False, weights=None):
    """The JAX package's scan as a loop over l, in torch ops on the inputs'
    device and in ``thetas``' dtype (every argument a tensor there).

    Synthesis: ``alm_*`` (lmax+1, mmax+1) -> F (2, mmax+1, nrings).
    Analysis (``adjoint``): ``alm_*`` are G (mmax+1, nrings), ``weights``
    (nrings,) -> alm (2, lmax+1, mmax+1)."""
    _legendre_contract_plain.calls += 1
    dtype, dev = thetas.dtype, thetas.device
    M1 = mmax + 1
    ct, seedP, seedS = _seed_tables(thetas, mmax)
    ct = ct[None, :]
    mv = torch.arange(M1, dtype=dtype, device=dev)[:, None]
    BIG = torch.tensor(2.0 ** 48, dtype=dtype, device=dev)
    HOP = torch.tensor(96.0, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    if adjoint:
        Gre = alm_re * weights[None, :]
        Gim = alm_im * weights[None, :]
    z = torch.zeros((M1, thetas.shape[0]), dtype=dtype, device=dev)
    P, Pp, S, Fre, Fim = z, z, z, z, z
    rows = []
    for l in range(lmax + 1):
        lf = torch.tensor(float(l), dtype=dtype, device=dev)
        active = mv < lf
        den = torch.where(active, lf * lf - mv * mv, one)
        a = _exact.sqrt((4.0 * lf * lf - 1.0) / den)
        lm1 = lf - 1.0
        b = _exact.sqrt(torch.where(active, ((lm1 * lm1 - mv * mv)
                                            / (4.0 * lm1 * lm1 - 1.0)), zero))
        Pnew = torch.where(active, a * (ct * P - b * Pp), zero)
        seed = mv == lf
        Pnew = torch.where(seed, seedP, Pnew)
        S = torch.where(seed, seedS, S)
        grew = torch.abs(Pnew) > BIG
        hop = torch.where(grew, torch.minimum(HOP, -S), zero)
        fac = torch.exp2(-hop)
        Pnew = Pnew * fac
        Pkeep = P * fac
        S = S + hop
        lam = Pnew * torch.exp2(S)
        P, Pp = Pnew, Pkeep
        if adjoint:
            rows.append(torch.stack([torch.sum(lam * Gre, dim=1),
                                     torch.sum(lam * Gim, dim=1)]))
        else:
            Fre = Fre + alm_re[l][:, None] * lam
            Fim = Fim + alm_im[l][:, None] * lam
    if adjoint:
        return torch.stack(rows, dim=1)
    return torch.stack([Fre, Fim])


_legendre_contract_plain.calls = 0


def _declare(lib):
    # synthesis: 7 pointers, then ldA, R, lmax, nm, threads, blocks;
    # analysis: 8 pointers, then ldA, R, lmax, nm, threads, blocks, and the
    # plane stride of its partial rows
    for suffix in ("f32", "f64"):
        fn = getattr(lib, "nemo_legendre_synthesis_" + suffix)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn = getattr(lib, "nemo_legendre_analysis_" + suffix)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_longlong, ctypes.c_void_p]


def load_kernel():
    """Build (first call) and load the Legendre kernel's library."""
    return cuda_build.load_library(SOURCE, _declare)


def legendre_geometry(R, nm, dtype):
    """Launch geometry of the Legendre kernel, either direction, over ``R``
    rings and ``nm`` values of m in ``dtype``: ``(k, threads, (ring blocks,
    nm))``, ``k`` the rings a thread, 4 in float32 and 2 in float64 as the
    kernel's ``Rings`` fixes them.  The fewest blocks of at most
    ``MAX_THREADS`` threads cover ceil(R / k) threads, each block's threads
    rounded up to a warp: up to ``MAX_THREADS`` x k rings an m's factors are
    filled once, by one block whose idle lanes lie in its last warp; with
    more, each of the m's analysis blocks writes its partial rows to a plane
    of its own."""
    if dtype not in RINGS_A_THREAD or R < 1 or not 1 <= nm <= 65535:
        raise ValueError("legendre geometry: float32 or float64, R >= 1 and "
                         "1 <= nm <= 65535, got %s, R %d, nm %d"
                         % (dtype, R, nm))
    k = RINGS_A_THREAD[dtype]
    lanes = -(-R // k)
    blocks = -(-lanes // MAX_THREADS)
    threads = 32 * -(-(-(-lanes // blocks)) // 32)
    return k, threads, (blocks, nm)


def _triangle(nm, lmax, device):
    """(nm, lmax+1) mask of l >= m."""
    ls = torch.arange(lmax + 1, device=device)
    return ls[None, :] >= torch.arange(nm, device=device)[:, None]


def _launch(direction, dtype, *args):
    lib = load_kernel()
    fn = getattr(lib, "nemo_legendre_%s_%s" % (
        direction, "f32" if dtype == torch.float32 else "f64"))
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("legendre_contract kernel (%s) launch failed: "
                           "CUDA error %d" % (direction, err))
    legendre_contract.launches += 1
    legendre_contract.direction_launches[direction] += 1


def _legendre_contract_cuda(thetas, alm_re, alm_im, lmax, mmax,
                            adjoint=False, weights=None):
    """The kernel: same arguments and result as the plain version, CUDA
    tensors."""
    dtype, dev = thetas.dtype, thetas.device
    if dev.type != "cuda" or any(x is not None and x.device != dev
                                 for x in (alm_re, alm_im, weights)):
        raise ValueError("the CUDA Legendre kernel needs CUDA tensors, all "
                         "on one card")
    R = thetas.shape[0]
    M1 = mmax + 1
    nm = min(mmax, lmax) + 1            # lanes m > lmax are never active
    # synthesis reads alm rows 0..lmax of an (>= lmax+1, mmax+1) array
    rows = M1 if adjoint else lmax + 1
    cols = R if adjoint else M1
    if any(x.ndim != 2 or x.dtype != dtype or x.shape[1] != cols
           or x.shape[0] < rows or (adjoint and x.shape[0] != rows)
           for x in (alm_re, alm_im)) or (adjoint and (
               weights is None or tuple(weights.shape) != (R,)
               or weights.dtype != dtype)) or nm > 65535:
        raise ValueError("legendre_contract: want (%d, %d) %s inputs (and "
                         "(%d,) weights in analysis), mmax <= 65535"
                         % (rows, cols, dtype, R))
    ct, seedP, seedS = _seed_tables(thetas, mmax)
    ct = ct.contiguous()
    seedP = seedP[:nm].contiguous()
    seedS = seedS[:nm].contiguous()
    with torch.cuda.device(dev):
        if adjoint:
            # G and w are read as they are (the kernel takes G w), and alm
            # written in place: rows l >= m of columns m < nm, one plane a
            # ring block, summed in block order
            Gre = alm_re.contiguous()
            Gim = alm_im.contiguous()
            w = weights.contiguous()
            _, threads, (blocks, _) = legendre_geometry(R, nm, dtype)
            planes = torch.zeros((blocks, 2, lmax + 1, M1), dtype=dtype,
                                 device=dev)
            _launch("analysis", dtype, ct.data_ptr(), w.data_ptr(),
                    seedP.data_ptr(), seedS.data_ptr(), Gre.data_ptr(),
                    Gim.data_ptr(), planes[0, 0].data_ptr(),
                    planes[0, 1].data_ptr(), M1, R, lmax, nm, threads,
                    blocks, planes[0].numel())
            return planes[0] if blocks == 1 else planes.sum(dim=0)
        # the kernel reads alm[l, m] in place: rows 0..lmax, row stride M1
        almRe = alm_re.contiguous()
        almIm = alm_im.contiguous()
        F = torch.zeros((2, M1, R), dtype=dtype, device=dev)
        _, threads, (blocks, _) = legendre_geometry(R, nm, dtype)
        _launch("synthesis", dtype, ct.data_ptr(), seedP.data_ptr(),
                seedS.data_ptr(), almRe.data_ptr(), almIm.data_ptr(),
                F[0].data_ptr(), F[1].data_ptr(), M1, R, lmax, nm, threads,
                blocks)
        return F


def legendre_contract(thetas, alm_re, alm_im, lmax, mmax, adjoint=False,
                      weights=None, dtype=torch.float32, device="cuda"):
    """Scaled-recurrence Legendre contraction.

    Synthesis (``adjoint=False``): ``alm_*`` are (lmax+1, mmax+1) and the
    result is F (2, mmax+1, nrings) = sum_l alm[l] * lambda_lm(theta).

    Analysis (``adjoint=True``): ``alm_*`` are G (mmax+1, nrings) ring
    coefficients, ``weights`` the per-ring quadrature weights, and the
    result is alm (2, lmax+1, mmax+1) = sum_r w_r G[:, r] lambda_lm.

    ``device="cuda"`` launches ``csrc/legendre_contract.cu`` (and raises if
    it cannot be built or launched); ``device="cpu"`` runs
    :func:`_legendre_contract_plain`.  Arrays are cast to ``dtype``
    (float32 or float64) on ``device``; the result is a tensor there.
    """
    dev = torch.device(device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError("legendre_contract runs in float32 or float64")
    th = _as_device(np.asarray(thetas, dtype=np.float64), dtype, dev)
    re = _as_device(alm_re, dtype, dev)
    im = _as_device(alm_im, dtype, dev)
    w = None if weights is None else _as_device(
        np.asarray(weights, dtype=np.float64), dtype, dev)
    if adjoint and w is None:
        raise ValueError("analysis needs the ring weights")
    if dev.type == "cpu":
        return _legendre_contract_plain(th, re, im, lmax, mmax, adjoint, w)
    if dev.type != "cuda":
        raise ValueError("device must be 'cpu' or 'cuda', got %r" % device)
    return _legendre_contract_cuda(th, re, im, lmax, mmax, adjoint, w)


legendre_contract.launches = 0
legendre_contract.direction_launches = {"synthesis": 0, "analysis": 0}


def legendre_rings(thetas, lmax, mmax=None, dtype=torch.float64,
                   device="cuda"):
    """lambda_lm(theta) for every (l, m, ring) - test/analysis helper.

    Returns a (lmax+1, mmax+1, nrings) numpy array, computed by
    synthesising with one-hot alm per l.  Small problems only."""
    if mmax is None:
        mmax = lmax
    out = np.zeros((lmax + 1, mmax + 1, len(thetas)))
    for l in range(lmax + 1):
        are = np.zeros((lmax + 1, mmax + 1))
        are[l, :] = 1.0
        F = legendre_contract(thetas, are, np.zeros_like(are), lmax, mmax,
                              dtype=dtype, device=device)
        out[l] = F[0].cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# CAR ring geometry


def car_ring_geometry(shape, wcs):
    """(thetas, nphi_full, phi0, dphi_sign) for a CAR map.

    ``thetas`` are the colatitudes of the map rows; ``nphi_full`` the
    number of samples a full 2pi ring would hold at the map's azimuth
    spacing (the FFT length); ``phi0`` the azimuth of column 0 in
    radians; ``dphi_sign`` -1 when RA decreases with x (the astronomical
    convention), +1 otherwise."""
    ny, nx = shape
    cx = shape[1] // 2
    out = wcs.pix2wcs(np.full(ny, float(cx)), np.arange(ny, dtype=float))
    decs = np.asarray(out)[:, 1]
    thetas = np.radians(90.0 - decs)
    ra0, _ = np.asarray(wcs.pix2wcs(0.0, float(ny // 2))).ravel()
    ra1, _ = np.asarray(wcs.pix2wcs(1.0, float(ny // 2))).ravel()
    dra = ra1 - ra0
    if dra > 180:
        dra -= 360.0
    if dra < -180:
        dra += 360.0
    # CAR: the cdelt1 azimuth step is constant in RA
    dphi = np.radians(abs(dra))
    nphi_full = int(round(2 * np.pi / dphi))
    phi0 = np.radians(ra0 % 360.0)
    return thetas, nphi_full, phi0, (-1.0 if dra < 0 else 1.0)


def ring_weights(thetas, dphi):
    """Quadrature weights for map2alm on iso-latitude rings.

    Midpoint rule in colatitude: w_r = sin(theta_r) dtheta dphi.  Exact
    Clenshaw-Curtis weights need pole-anchored full-sphere grids; survey
    cutouts are not, and the reference's own partial-sky ``map2alm`` is
    approximate there too (quadrature over the stored rows only)."""
    thetas = np.asarray(thetas)
    if len(thetas) > 1:
        dtheta = abs(float(thetas[1] - thetas[0]))
    else:
        dtheta = dphi
    return np.sin(thetas) * dtheta * dphi


def _ring_dtheta(thetas):
    return abs(float(thetas[1] - thetas[0])) if len(thetas) > 1 else None


# ---------------------------------------------------------------------------
# Public transforms


def alm2map_car(alm, shape, wcs, lmax=None, dtype=torch.float32,
                device="cuda"):
    """Synthesise a real CAR map (a float64 tensor on ``device``) from
    (lmax+1, mmax+1) complex alm (a tensor or array).  The Legendre
    contraction runs in ``dtype``, the ring FFTs in float64."""
    dev = torch.device(device)
    alm = torch.as_tensor(alm, device=dev).to(torch.complex128)
    if lmax is None:
        lmax = alm.shape[0] - 1
    mmax = alm.shape[1] - 1
    thetas, nphi, phi0, sgn = car_ring_geometry(shape, wcs)
    F = legendre_contract(thetas, alm.real, alm.imag, lmax, mmax,
                          dtype=dtype, device=dev)
    Fc = torch.complex(F[0].to(torch.float64), F[1].to(torch.float64))
    # Ring FFT: T_j = Re sum_m (2-delta_m0) F_m e^{i m phi_j},
    # phi_j = phi0 + sgn * j * 2pi/nphi.  With sgn=-1 the rfft convention
    # e^{+2pi i m j/N} needs the conjugate coefficients.
    M1 = mmax + 1
    nb = nphi // 2 + 1
    c = torch.zeros((len(thetas), nb), dtype=torch.complex128, device=dev)
    phase = torch.as_tensor(np.exp(1j * np.arange(M1) * phi0), device=dev)
    ring = Fc.T * phase[None, :]
    if sgn < 0:
        ring = torch.conj(ring)
    c[:, :min(M1, nb)] = ring[:, :min(M1, nb)]
    # irfft contributes (2/n) Re(X_k e^{2pi i k j/n}) per k>0 and X_0/n,
    # so X_0 = n F_0 and X_k = n F_k reproduce (2 - delta_m0) Re(F_m ...)
    c = c * nphi
    full = torch.fft.irfft(c, n=nphi, dim=1)
    return full[:, :shape[1]]


def map2alm_car(m, shape, wcs, lmax, dtype=torch.float32, device="cuda"):
    """Ring-quadrature analysis of a real CAR map to complex128 alm
    (lmax+1, lmax+1) on ``device``; adjoint of :func:`alm2map_car` with
    midpoint ring weights (see :func:`ring_weights`)."""
    dev = torch.device(device)
    thetas, nphi, phi0, sgn = car_ring_geometry(shape, wcs)
    dphi = 2 * np.pi / nphi
    M1 = lmax + 1
    padded = torch.zeros((shape[0], nphi), dtype=torch.float64, device=dev)
    padded[:, :shape[1]] = torch.as_tensor(m, device=dev).to(torch.float64)
    cb = torch.fft.rfft(padded, dim=1)                 # (R, nphi//2+1)
    c = torch.zeros((shape[0], M1), dtype=torch.complex128, device=dev)
    nm = min(M1, cb.shape[1])                          # Nyquist: unsampled
    c[:, :nm] = cb[:, :nm]
    if sgn < 0:
        c = torch.conj(c)
    phase = torch.as_tensor(np.exp(-1j * np.arange(M1) * phi0), device=dev)
    G = (c * phase[None, :]).T * dphi                  # (M1, R)
    w = ring_weights(thetas, 1.0)                      # dphi folded into G
    out = legendre_contract(thetas, G.real, G.imag, lmax, lmax,
                            adjoint=True, weights=w, dtype=dtype, device=dev)
    alm = torch.complex(out[0].to(torch.float64), out[1].to(torch.float64))
    # alm = sum_r w_r lambda_lm(theta_r) * [dphi sum_j T_j e^{-im phi_j}]
    # approximates the integral T Y*_lm dOmega for every m (the conjugate
    # -m term of the real map integrates to zero against e^{-im phi}), so
    # no (2 - delta_m0) correction belongs here.
    tri = _triangle(lmax + 1, lmax, dev).T              # l >= m
    return torch.where(tri, alm, torch.zeros((), dtype=alm.dtype,
                                             device=dev))


def rand_alm(Cl, lmax=None, generator=None, device="cuda", white=None):
    """Gaussian random alm from C_l (healpy ``synalm`` semantics):
    a_l0 ~ N(0, C_l); Re/Im a_lm ~ N(0, C_l/2) for m > 0.  A complex128
    (lmax+1, lmax+1) tensor on ``device``.

    The draw is two float32 standard-normal (lmax+1, lmax+1) fields from
    ``generator`` (as the JAX package draws), or ``white`` = (re, im)
    given."""
    dev = torch.device(device)
    Cl = np.asarray(Cl, dtype=np.float64)
    if lmax is None:
        lmax = len(Cl) - 1
    L1 = lmax + 1
    re, im = (None, None) if white is None else white
    re = grf._white((L1, L1), torch.float32, dev, generator, re, "rand_alm")
    im = grf._white((L1, L1), torch.float32, dev, generator, im, "rand_alm")
    re = re.to(torch.float64)
    im = im.to(torch.float64)
    amp = torch.as_tensor(np.sqrt(Cl[:L1]), device=dev)
    ls = torch.arange(L1, device=dev)
    tri = ls[None, :] <= ls[:, None]
    alm = torch.complex(re, im) * (amp[:, None] / np.sqrt(2.0))
    alm[:, 0] = re[:, 0] * amp
    return torch.where(tri, alm, torch.zeros((), dtype=alm.dtype,
                                             device=dev))


def sim_cmb_map_curved(shape, wcs, beamBell=None, beamEll=None,
                       noiseLevel=None, ClTT=None, lmax=None,
                       dtype=torch.float32, device="cuda", generator=None,
                       alm=None, noise_white=None):
    """Curved-sky CMB realisation on a CAR footprint (a float64 tensor on
    ``device``) - the SHT-exact counterpart of ``grf.sim_cmb_map``.

    The beam is applied to C_l as amplitude (the reference's
    ``ps *= lbeam``).  ``lmax`` defaults to the smaller of the spectrum
    extent and the map's row Nyquist scale pi / dtheta.  Draws, in order,
    the alm (:func:`rand_alm`) and, with ``noiseLevel``, the white noise
    from ``generator``; ``alm`` and ``noise_white`` give them instead."""
    dev = torch.device(device)
    Cl = np.asarray(grf.lensedClTT() if ClTT is None else ClTT)
    if beamBell is not None:
        Cl = Cl * np.interp(np.arange(len(Cl), dtype=float),
                            np.asarray(beamEll), np.asarray(beamBell))
    if lmax is None:
        thetas, _, _, _ = car_ring_geometry(shape, wcs)
        dtheta = _ring_dtheta(thetas) or 1e-3
        lmax = int(np.pi / dtheta)
    lmax = int(min(lmax, len(Cl) - 1))
    if alm is None:
        alm = rand_alm(Cl, lmax=lmax, generator=generator, device=dev)
    m = alm2map_car(alm, shape, wcs, dtype=dtype, device=dev)
    if noiseLevel is not None:
        m = m + grf.sim_noise_map(shape, noiseLevel, generator=generator,
                                  white=noise_white, device=dev)
    return m


def sim_noise_map_curved(shape, wcs, noiseLevel, lKnee, alpha=-3.0,
                         lmax=6000, dtype=torch.float32, device="cuda",
                         generator=None, white=None):
    """1/f ('atmospheric') noise through the curved-sky transform (a
    float64 tensor on ``device``): the reference's alm round trip - white
    map -> ``map2alm`` at ``lmax``, shape the alm by
    sqrt((lKnee/l)^-alpha + 1), ``alm2map``, and ADD BACK the
    above-band-limit residual of the white map, so white power above
    ``lmax`` is preserved.  The white map is drawn in float64 from
    ``generator``, or given as ``white``."""
    dev = torch.device(device)
    thetas, _, _, _ = car_ring_geometry(shape, wcs)
    if len(thetas) > 1:
        lmax = int(min(lmax, np.pi / _ring_dtheta(thetas)))
    white = grf._white(shape, torch.float64, dev, generator, white,
                       "sim_noise_map_curved")
    alm = map2alm_car(white, shape, wcs, lmax, dtype=dtype, device=dev)
    band = alm2map_car(alm, shape, wcs, dtype=dtype, device=dev)
    ls = np.maximum(np.arange(lmax + 1, dtype=np.float64), 1e-9)
    Nl = (lKnee / ls) ** -alpha + 1.0
    Nl[0] = 0.0
    alm = alm * torch.as_tensor(np.sqrt(Nl), device=dev)[:, None]
    shaped = (white - band) + alm2map_car(alm, shape, wcs, dtype=dtype,
                                          device=dev)
    noiseLevel = np.asarray(noiseLevel)
    if noiseLevel.ndim == 0:
        return shaped * float(noiseLevel)
    nl = torch.as_tensor(noiseLevel, dtype=torch.float64, device=dev)
    return torch.where(nl > 0, shaped * nl, torch.zeros((), dtype=torch.float64,
                                                        device=dev))
