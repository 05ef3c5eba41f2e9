"""Seeded survey skies: a CAR map of tiles in two or more bands with one
CMB realisation, white noise and A10 clusters, written as FITS.

Everything is drawn from the run's seed: the cluster positions and
amplitudes by numpy, the CMB and noise fields by a torch generator on
the device.  Every seed gives the same tiles, cluster count and sizes;
only the draws differ.  The painting is the benchmark's own plain torch.
"""

import os

import numpy as np
import torch

from . import fitsio
from .reference import model

CL_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "lensed_cl_tt.txt")


class Survey:
    """The survey's geometry and files: ``tiles`` (name, y0, x0) in
    survey order, ``bands`` (freqGHz, mapPath, beamPath), ``maskPath``
    and the CAR header."""

    def __init__(self, cfg, workdir):
        s = cfg["survey"]
        self.tileShape = tuple(s["tile_shape"])
        self.grid = tuple(s["tile_grid"])
        self.pixDeg = s["pixel_arcmin"] / 60.0
        ty, tx = self.tileShape
        self.shape = (self.grid[0] * ty, self.grid[1] * tx)
        ny, nx = self.shape
        self.crval1 = float(s["centre_ra_deg"])
        self.crpix1 = nx / 2.0 + 0.5
        self.crpix2 = ny / 2.0 + 0.5 - s.get("centre_dec_deg", 0.0) \
            / self.pixDeg
        self.header = fitsio.car_header(self.shape, self.pixDeg, self.crval1,
                                        self.crpix1, self.crpix2)
        self.tiles = [("T%02d" % (r * self.grid[1] + c), r * ty, c * tx)
                      for r in range(self.grid[0])
                      for c in range(self.grid[1])]
        self.workdir = workdir
        self.maskPath = os.path.join(workdir, "surveyMask.fits")
        self.bands = [(b["freq_ghz"],
                       os.path.join(workdir, "map_%s.fits" % b["name"]),
                       os.path.join(workdir, "beam_%s.txt" % b["name"]))
                      for b in cfg["bands"]]

    def pix2sky(self, x, y):
        """Survey pixel (0-based) -> (RA, dec) degrees."""
        ra = self.crval1 + (x + 1.0 - self.crpix1) * -self.pixDeg
        dec = (y + 1.0 - self.crpix2) * self.pixDeg
        return np.mod(ra, 360.0), dec

    def sky2pix(self, ra, dec):
        dra = (np.asarray(ra) - self.crval1 + 180.0) % 360.0 - 180.0
        return (dra / -self.pixDeg + self.crpix1 - 1.0,
                np.asarray(dec) / self.pixDeg + self.crpix2 - 1.0)

    def tile_definitions(self, names=None):
        """nemo's tileDefinitions: each tile's RA/dec section, which the
        program clips back to exactly the tile's pixel box."""
        ty, tx = self.tileShape
        out = []
        for name, y0, x0 in self.tiles:
            if names is not None and name not in names:
                continue
            ra0, dec0 = self.pix2sky(x0, y0)
            ra1, dec1 = self.pix2sky(x0 + tx, y0 + ty)
            out.append({"tileName": name,
                        "RADecSection": [float(ra1), float(ra0),
                                         float(dec0), float(dec1)]})
        return out

    def tile_scales(self, y0, x0):
        """(dy, dx) pixel scales in radians at a tile's centre, as
        great-circle separations of neighbouring pixels."""
        ty, tx = self.tileShape
        cy, cx = y0 + ty // 2, x0 + tx // 2
        ra0, dec0 = self.pix2sky(cx, cy)
        ra1, dec1 = self.pix2sky(cx + 1, cy + 1)
        from .reference.mf import ang_sep_deg
        return (np.radians(float(ang_sep_deg(ra0, dec0, ra0, dec1))),
                np.radians(float(ang_sep_deg(ra0, dec0, ra1, dec0))))


def _cmb_white_to_field(white, pixRad, fwhmArcmin):
    """Beam-smoothed CMB-like field (uK) from a white draw, with the
    lensed D_l table (log-linear interpolation, power-law tail)."""
    tab = np.loadtxt(CL_TABLE)
    lTab, logDl = np.ascontiguousarray(tab[:, 0]), np.log(tab[:, 1])
    ny, nx = white.shape
    dev = white.device
    ly = 2 * np.pi * torch.fft.fftfreq(ny, d=pixRad, device=dev,
                                       dtype=torch.float64)
    lx = 2 * np.pi * torch.fft.rfftfreq(nx, d=pixRad, device=dev,
                                        dtype=torch.float64)
    ell = torch.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2)
    lt = torch.as_tensor(lTab, device=dev)
    ld = torch.as_tensor(logDl, device=dev)
    i = torch.clamp(torch.searchsorted(lt, ell.contiguous()), 1,
                    len(lTab) - 1)
    logD = ld[i - 1] + (ell - lt[i - 1]) / (lt[i] - lt[i - 1]) \
        * (ld[i] - ld[i - 1])
    slope = (logDl[-1] - logDl[-2]) / (lTab[-1] - lTab[-2])
    logD = torch.where(ell <= lTab[-1], logD,
                       logDl[-1] + slope * (ell - lTab[-1]))
    safe = torch.clamp(ell, min=1.0)
    Cl = torch.where(ell >= 2, torch.exp(logD) * 2 * np.pi
                     / (safe * (safe + 1)), torch.zeros_like(ell))
    sigma = np.radians(fwhmArcmin / 60.0) / np.sqrt(8 * np.log(2))
    beam = torch.exp(-0.5 * ell ** 2 * sigma ** 2)
    return torch.fft.irfft2(torch.fft.rfft2(white)
                            * torch.sqrt(Cl / pixRad ** 2) * beam,
                            s=(ny, nx))


def _pixel_window(m):
    ny, nx = m.shape
    wy = torch.as_tensor(np.sinc(np.fft.fftfreq(ny)), device=m.device)
    wx = torch.as_tensor(np.sinc(np.fft.rfftfreq(nx)), device=m.device)
    return torch.fft.irfft2(torch.fft.rfft2(m) * (wy[:, None] * wx[None]),
                            s=(ny, nx))


def write_beam(path, fwhmArcmin):
    r, prof = model.gaussian_beam_profile(fwhmArcmin)
    with open(path, "w") as f:
        f.write("# Gaussian beam, FWHM = %.3f arcmin\n" % fwhmArcmin)
        for ri, pi in zip(r, prof):
            f.write("%.8e %.8e\n" % (ri, pi))


def make_survey(cfg, traffic, seed, workdir, device):
    """Draw the survey of ``cfg`` under the ``traffic`` mix from ``seed``
    and write its maps, mask and beams under ``workdir``.  Returns the
    :class:`Survey`; its ``maps`` holds each band's float32 map as
    written (host numpy) for the reference."""
    os.makedirs(workdir, exist_ok=True)
    sv = Survey(cfg, workdir)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    ty, tx = sv.tileShape
    ny, nx = sv.shape
    nPer = int(traffic["clusters_per_tile"])
    inset = int(traffic["cluster_inset_pix"])
    rows = int(np.floor(np.sqrt(nPer)))
    cols = -(-nPer // rows)
    ys, xs = [], []
    for _, y0, x0 in sv.tiles:
        gy = np.repeat(np.linspace(y0 + inset, y0 + ty - inset, rows), cols)
        gx = np.tile(np.linspace(x0 + inset, x0 + tx - inset, cols), rows)
        jit = traffic["cluster_jitter_pix"]
        ys.append(gy[:nPer] + rng.uniform(-jit, jit, nPer))
        xs.append(gx[:nPer] + rng.uniform(-jit, jit, nPer))
    ys, xs = np.concatenate(ys), np.concatenate(xs)
    lo, hi = traffic["cluster_y_c"]
    yc = rng.uniform(lo, hi, ys.size) * 1e-4

    pixRad = np.radians(sv.pixDeg)
    cm = traffic["cluster_model"]
    half = int(traffic["cluster_stamp_pix"]) // 2
    white = torch.randn((ny, nx), generator=gen, device=device,
                        dtype=torch.float64)
    fitsio.write_image(sv.maskPath, np.ones((ny, nx), dtype=np.uint8),
                       sv.header)
    sv.maps = []
    for (freq, mapPath, beamPath), b in zip(sv.bands, cfg["bands"]):
        write_beam(beamPath, b["beam_fwhm_arcmin"])
        r, v, unit = model.template_table(cm["M500MSun"], cm["z"], beamPath,
                                          amplitude=1.0)
        rT = torch.as_tensor(r, device=device)
        vT = torch.as_tensor(v, device=device)
        sig = torch.zeros((ny, nx), dtype=torch.float64, device=device)
        ar = torch.arange(2 * half, dtype=torch.float64, device=device)
        for y, x, amp in zip(ys, xs, yc):
            iy, ix = int(y) - half, int(x) - half
            dy = (ar - (y - iy))[:, None] * pixRad
            dx = (ar - (x - ix))[None, :] * pixRad
            rr = torch.sqrt(dy ** 2 + dx ** 2).contiguous()
            k = torch.clamp(torch.searchsorted(rT, rr), 1, len(r) - 1)
            val = vT[k - 1] + (rr - rT[k - 1]) / (rT[k] - rT[k - 1]) \
                * (vT[k] - vT[k - 1])
            val = torch.where(rr > rT[-1], torch.zeros_like(val), val)
            sig[iy:iy + 2 * half, ix:ix + 2 * half] += \
                float(unit * model.y_to_uK(amp, freq)) * val
        sky = _pixel_window(sig)
        sky += _cmb_white_to_field(white, pixRad, b["beam_fwhm_arcmin"])
        sky += b["white_noise_uK"] * torch.randn(
            (ny, nx), generator=gen, device=device, dtype=torch.float64)
        m = sky.to(torch.float32).cpu().numpy()
        fitsio.write_image(mapPath, m, sv.header)
        sv.maps.append(m)
        del sig, sky
    del white
    return sv
