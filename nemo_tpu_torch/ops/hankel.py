"""Radial (Hankel) Fourier transforms via FFTLog.

Replaces pixell ``utils.RadialFourierTransform`` and
``curvedsky.profile2harm/harm2profile`` as used by the reference's signal
painter (``nemo/signals.py:622-672``) and beam handling
(``signals.py:116,125``).

For an azimuthally-symmetric field f(r) on the flat sky, its 2-d Fourier
transform is radial:

    F(l) = 2 pi * integral f(r) J0(l r) r dr        (real2harm)
    f(r) = 1/(2 pi) * integral F(l) J0(l r) l dl     (harm2real)

Both directions are order-0 Hankel transforms, computed here with the FFTLog
algorithm (Hamilton 2000) on log-spaced grids: exact for profiles expandable
in power laws, O(N log N), and runs at profile-construction time on the host
(numpy) - the results feed the device as small 1-d interpolation tables.

The curved-sky Legendre version the reference uses differs at
O(theta^2) ~ 1e-5 for arcminute-scale beams; this is documented, not hidden.
"""

import numpy as np
from scipy.special import loggamma


class RadialFourierTransform:
    """Order-0 Hankel transform pair on matched log grids.

    Attributes:
        r: radii in radians (log-spaced, includes padding).
        l: multipoles (log-spaced, same number of points).
    """

    def __init__(self, rrange=(1e-7, 10.0), n=1024, pad=256):
        self.n_core = n
        self.pad = pad
        n_tot = n + 2 * pad
        logr_lo, logr_hi = np.log(rrange[0]), np.log(rrange[1])
        dlog = (logr_hi - logr_lo) / (n - 1)
        logr = logr_lo + (np.arange(n_tot) - pad) * dlog
        self.dlog = dlog
        self.r = np.exp(logr)
        # Reciprocal grid: l_j * r_{N-1-j} = const. Choose the standard
        # low-ringing-free pairing l = 1/r reversed.
        self.l = 1.0 / self.r[::-1]
        self._n_tot = n_tot
        # Mellin multipliers for J0, bias q=0:
        #   M(s) = 2^(s-1) Gamma(s/2) / Gamma(1 - s/2), evaluated at
        #   s = 1 - i*eta_m with eta_m = 2 pi m / (N dlog).
        m = np.fft.fftfreq(n_tot) * (2 * np.pi / dlog)
        s = 1.0 - 1j * m
        self._u = np.exp((s - 1) * np.log(2.0)
                         + loggamma(s / 2) - loggamma(1 - s / 2))

    def _hankel(self, f, x, k):
        """g(k) = integral f(x) J0(k x) x dx, with f sampled on log grid x
        and g returned on the reciprocal log grid k = 1/x[::-1].

        Decompose f(x) = sum_m A_m x^{i eta_m - 1}; each power law transforms
        analytically through the Mellin pair
        integral x^{s-1} J0(x) dx = 2^{s-1} Gamma(s/2)/Gamma(1-s/2).
        """
        a = f * x  # f(x) * x
        # c-hat_m relative to ln x grid:  a_j = sum_m ch_m e^{-i eta_m j dlog}
        ch = np.fft.fft(a) / self._n_tot  # a_j = sum_m ch_m e^{+2pi i m j/N}
        # a_j = sum ch_m e^{2pi i mj/N}; with eta_m = 2pi m/(N dlog) and
        # x_j = x0 e^{j dlog}:  x_j^{-i eta_m} = e^{-i eta_m ln x0} e^{-2pi i mj/N}
        # => c_m = conj-side; easiest is to carry explicit phase factors:
        j0 = np.log(x[0])
        # a(x) = sum_m A_m x^{+i eta_m} with A_m = ch_m * e^{-i eta_m ln x0}
        eta = np.fft.fftfreq(self._n_tot) * (2 * np.pi / self.dlog)
        A = ch * np.exp(-1j * eta * j0)
        # f(x) = a(x)/x = sum_m A_m x^{i eta_m - 1}
        # g(k) = sum_m A_m int x^{i eta_m - 1} J0(kx) x dx
        #      = sum_m A_m k^{-1 - i eta_m} M(1 + i eta_m)
        Mplus = np.exp((1j * eta) * np.log(2.0)
                       + loggamma((1 + 1j * eta) / 2)
                       - loggamma((1 - 1j * eta) / 2))
        gk_k = A * Mplus  # coefficients of k^{-i eta_m}, times 1/k overall
        lnk = np.log(k)
        # g(k_i) * k_i = sum_m gk_k_m e^{-i eta_m ln k_i}
        phases = np.exp(-1j * eta * lnk[0])
        series = gk_k * phases
        # k_i = k_0 e^{i' dlog} => e^{-i eta_m ln k_i} = phases_m e^{-2pi i m i'/N}
        vals = np.fft.fft(series)  # sum_m series_m e^{-2pi i m i'/N}... check sign
        g = np.real(vals) / k
        return g

    def real2harm(self, rprof):
        """F(l) = 2 pi * integral f(r) J0(l r) r dr."""
        return 2 * np.pi * self._hankel(
            np.asarray(rprof, dtype=np.float64), self.r, self.l)

    def harm2real(self, lprof):
        """f(r) = 1/(2 pi) integral F(l) J0(l r) l dl.

        The grids are reciprocal (r = 1/l reversed), so the same FFTLog
        kernel applies with the roles of the grids swapped.
        """
        return self._hankel(np.asarray(lprof, dtype=np.float64),
                            self.l, self.r) / (2 * np.pi)

    def unpad(self, *arrays):
        """Strip the padding region; mirrors pixell's API."""
        sl = slice(self.pad, self._n_tot - self.pad)
        out = tuple(a[sl] for a in arrays)
        return out if len(out) > 1 else out[0]


def profile_to_harm(rprof_func, lmax=None, rft=None):
    """Convenience: tabulate B(l) for a radial profile function f(r[rad])."""
    rft = rft or RadialFourierTransform()
    fr = rprof_func(rft.r)
    return rft.l, rft.real2harm(fr)
