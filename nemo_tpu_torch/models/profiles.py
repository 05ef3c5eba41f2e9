"""Cluster / source signal templates for the filter bank.

Port of ``nemo_tpu/models/profiles.py`` in its centred (template) mode:
1-d GNFW line-of-sight profile -> beam convolution in harmonic space
(FFTLog Hankel transform, host numpy) -> radial painting at the map centre
(torch, on the policy's device).  Painting many objects at sub-pixel
positions (``ys``/``xs``) waits for the port of ``ops.paint.paint_objects``.
"""

import numpy as np
import torch

from ..ops import paint as paint_ops
from ..ops.hankel import RadialFourierTransform
from . import cosmology as cosmo_mod
from . import gnfw
from .beams import BeamProfile

_OBJECTS_TODO = ("painting objects at given positions (ys/xs) needs "
                 "ops.paint.paint_objects, not ported yet (ROADMAP.md "
                 "queue 1, item 10: sims and injection)")


def makeArnaudModelProfile(z, M500, GNFWParams="default", cosmoModel=None):
    """Unit-peak cylindrical A10 profile for a cluster of (z, M500c):
    dict with 'rDeg', 'prof' and 'theta500Arcmin'."""
    cosmoModel = cosmoModel or cosmo_mod.fiducialCosmoModel()
    params = None if GNFWParams == "default" else GNFWParams
    b, prof = gnfw.cylindrical_profile(params)
    theta500Arcmin = cosmo_mod.calcTheta500Arcmin(z, M500, cosmoModel)
    rDeg = b * (theta500Arcmin / 60.0)
    return {"rDeg": rDeg, "prof": prof, "theta500Arcmin": theta500Arcmin}


def makeBattagliaModelProfile(z, M500c, GNFWParams="default", cosmoModel=None):
    """Battaglia et al. (2012) profile with mass/z-evolving shape, GNFW
    parameters expressed in A10 conventions."""
    cosmoModel = cosmoModel or cosmo_mod.fiducialCosmoModel()
    if GNFWParams == "default":
        GNFWParams = dict(gnfw.BATTAGLIA12_PARAMS)
    p = dict(GNFWParams)
    P0 = p["P0"]
    xc = 1.0 / p["c500"]
    beta = p["beta"] - 0.3
    M200c = cosmoModel.convertMassDef(M500c, z, 500, "critical",
                                      200, "critical")
    P0z = P0 * (M200c / 1e14) ** 0.226 * (1 + z) ** -0.957
    xcz = xc * (M200c / 1e14) ** -0.0833 * (1 + z) ** 0.853
    betaz = beta * (M200c / 1e14) ** 0.0480 * (1 + z) ** 0.615
    params = {"P0": P0z, "c500": 1.0 / xcz, "gamma": 0.3, "alpha": 1.0,
              "beta": betaz + 0.3}
    b, prof = gnfw.cylindrical_profile(params)
    theta500Arcmin = cosmo_mod.calcTheta500Arcmin(z, M500c, cosmoModel)
    rDeg = b * (theta500Arcmin / 60.0)
    return {"rDeg": rDeg, "prof": prof, "theta500Arcmin": theta500Arcmin}


def convolveProfileWithBeam(rDeg, prof, beam):
    """Beam-convolve a radial profile in harmonic space; returns
    (r_rad, prof_conv) on the transform's (unpadded) radial grid."""
    if isinstance(beam, str):
        beam = BeamProfile(beamFileName=beam)
    rft = RadialFourierTransform()
    rprof = np.interp(rft.r, np.radians(np.asarray(rDeg)), np.asarray(prof),
                      left=prof[0], right=0.0)
    lprof = rft.real2harm(rprof)
    # zero beyond the tabulated B_ell range (end-clamping would alias a
    # high-l plateau into a spike at r=0 on the log grid)
    lbeam = np.interp(rft.l, beam.ell, beam.Bell, right=0.0)
    rconv = rft.harm2real(lprof * lbeam)
    r, rconv = rft.unpad(rft.r, rconv)
    return r, rconv


def signalTemplateTable(rDeg, prof, beam=None, amplitude=None,
                        maxSizeDeg=10.0, convolveWithBeam=True):
    """Radial table of the painted template, ``(r, vAbs, scale)`` with the
    painted map = ``scale * paint(interp(vAbs))``."""
    if convolveWithBeam:
        if beam is None:
            raise ValueError("No beam supplied")
        r, rprof = convolveProfileWithBeam(rDeg, prof, beam)
    else:
        r = np.radians(np.logspace(np.log10(1e-6), np.log10(maxSizeDeg), 5000))
        rprof = np.interp(r, np.radians(rDeg), prof, left=prof[0], right=0.0)
    amp = 1.0
    if amplitude is not None:
        # rprof[0] is the post-convolution peak of the unit-peak profile;
        # amplitude scales the *unconvolved* peak
        amp = rprof[0] * np.asarray(amplitude)
        rprof = rprof / rprof[0]
    sign = 1.0
    if rprof[0] < 0:
        sign = -1.0
    return r, np.abs(rprof), sign * amp


def _centred(shape, pix_scales_rad, r, v, scale, returnDevice, device,
             dtype):
    ny, nx = shape
    out = paint_ops.paint_template_centered(
        shape, pix_scales_rad, r, v, center=(ny / 2.0, nx / 2.0),
        device=device, dtype=dtype)
    if returnDevice:
        return float(scale) * out
    return np.asarray(scale) * out.cpu().numpy()


def paintSignalMap(shape, pix_scales_rad, rDeg, prof, beam=None,
                   ys=None, xs=None, amplitude=None, maxSizeDeg=10.0,
                   convolveWithBeam=True, returnDevice=False,
                   device=None, dtype=torch.float64):
    """Paint a radial profile centred on a (ny, nx) map.

    Args:
        beam: BeamProfile or beam file path (required if convolveWithBeam).
        amplitude: peak amplitude *before* beam convolution; None = the
            unnormalised template.
        returnDevice: return the torch tensor (on ``device``) instead of a
            host numpy array.
    """
    if ys is not None or xs is not None:
        raise NotImplementedError(_OBJECTS_TODO)
    r, vAbs, scale = signalTemplateTable(
        rDeg, prof, beam=beam, amplitude=amplitude, maxSizeDeg=maxSizeDeg,
        convolveWithBeam=convolveWithBeam)
    return _centred(shape, pix_scales_rad, r, vAbs, scale, returnDevice,
                    device, dtype)


def beamTemplateTable(beam, amplitude=None):
    """``(r, v, scale)`` table for the beam (point-source) template."""
    if isinstance(beam, str):
        beam = BeamProfile(beamFileName=beam)
    amp = 1.0 if amplitude is None else amplitude
    return np.radians(beam.rDeg), beam.profile1d, amp


def makeBeamModelSignalMap(shape, pix_scales_rad, beam, ys=None, xs=None,
                           amplitude=None, maxSizeDeg=None,
                           returnDevice=False, device=None,
                           dtype=torch.float64):
    """Signal map containing the beam itself (point-source template),
    centred on the map."""
    if ys is not None or xs is not None:
        raise NotImplementedError(_OBJECTS_TODO)
    r, prof, amp = beamTemplateTable(beam, amplitude)
    return _centred(shape, pix_scales_rad, r, prof, amp, returnDevice,
                    device, dtype)


def makeArnaudModelSignalMap(z, M500, shape, pix_scales_rad, beam=None,
                             ys=None, xs=None, GNFWParams="default",
                             amplitude=None, maxSizeDeg=15.0,
                             convolveWithBeam=True, cosmoModel=None,
                             returnDevice=False, device=None,
                             dtype=torch.float64):
    """A10 cluster template centred on the map."""
    d = makeArnaudModelProfile(z, M500, GNFWParams=GNFWParams,
                               cosmoModel=cosmoModel)
    return paintSignalMap(shape, pix_scales_rad, d["rDeg"], d["prof"],
                          beam=beam, ys=ys, xs=xs, amplitude=amplitude,
                          maxSizeDeg=maxSizeDeg,
                          convolveWithBeam=convolveWithBeam,
                          returnDevice=returnDevice, device=device,
                          dtype=dtype)


def makeBattagliaModelSignalMap(z, M500, shape, pix_scales_rad, beam=None,
                                ys=None, xs=None, GNFWParams="default",
                                amplitude=None, maxSizeDeg=15.0,
                                convolveWithBeam=True, cosmoModel=None,
                                returnDevice=False, device=None,
                                dtype=torch.float64):
    """B12 cluster template centred on the map."""
    d = makeBattagliaModelProfile(z, M500, GNFWParams=GNFWParams,
                                  cosmoModel=cosmoModel)
    return paintSignalMap(shape, pix_scales_rad, d["rDeg"], d["prof"],
                          beam=beam, ys=ys, xs=xs, amplitude=amplitude,
                          maxSizeDeg=maxSizeDeg,
                          convolveWithBeam=convolveWithBeam,
                          returnDevice=returnDevice, device=device,
                          dtype=dtype)
