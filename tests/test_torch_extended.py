"""The port's ``maps.makeExtendedSourceMask`` and ``maps.saveFITS``
against the JAX package's, float64 on the CPU, and the card default of the
port's entry points that take a device policy.

The sky is a seeded two-band map (white noise over an inverse-variance map
with a zero border, a few compact sources and one extended blob), written
with numpy.  Tolerance: the extended mask equal to JAX's pixel for pixel
(both packages threshold the same float64 band-pass, whose two Gaussians
agree to ~1e-15 of the map), the FITS bitwise the same array.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from nemo_tpu import maps as jmaps
from nemo_tpu import startup as jstartup
from nemo_tpu_torch import device, filters, maps, startup
from nemo_tpu_torch.models import beams
from nemo_tpu_torch.utils import fits as nfits
from nemo_tpu_torch.utils import wcs as nwcs

SHAPE = (300, 420)           # 2.5 x 3.5 deg at 0.5'
PIX_ARCMIN = 0.5
BANDS = (("f150", 149.6, 1.4, 20.0), ("f090", 97.8, 2.1, 30.0))
EXTENDED = {"thresholdSigma": 5.0, "bigScaleDeg": 1.0,
            "smallScaleDeg": 0.1, "dilationPix": 2, "minSizeArcmin2": 1000.0}


@pytest.fixture(scope="module")
def sky(tmp_path_factory):
    """Two bands and their weights as FITS; returns (work dir, map dicts,
    wcs)."""
    work = tmp_path_factory.mktemp("torch_extended")
    rng = np.random.default_rng(12)
    w = nwcs.makeWCS(SHAPE, PIX_ARCMIN / 60.0, centreRADeg=30.0,
                     centreDecDeg=0.0)
    yy, xx = np.mgrid[:SHAPE[0], :SHAPE[1]]
    ivar = 1.0 + 0.5 * xx / SHAPE[1]
    ivar[:, :5] = 0.0
    # a large blob, and a smaller one that the size cut removes
    blob = np.exp(-((yy - 150) ** 2 + (xx - 260) ** 2) / (2 * 25.0 ** 2)) \
        + np.exp(-((yy - 60) ** 2 + (xx - 370) ** 2) / (2 * 10.0 ** 2))
    ys, xs = rng.uniform(20, SHAPE[0] - 20, 4), rng.uniform(20, 200, 4)
    entries = []
    for band, freq, fwhm, noise in BANDS:
        sigmaPix = fwhm / PIX_ARCMIN / 2.355
        data = 3000.0 * blob + rng.normal(0, noise, SHAPE) / np.sqrt(
            np.maximum(ivar, 1e-3))
        for y, x in zip(ys, xs):
            data += 4000.0 * np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                    / (2 * sigmaPix ** 2))
        data[ivar == 0] = 0.0
        mapPath = str(work / ("sim_%s.fits" % band))
        ivarPath = str(work / ("ivar_%s.fits" % band))
        beamPath = str(work / ("beam_%s.txt" % band))
        nfits.write_image(mapPath, data, w.header)
        nfits.write_image(ivarPath, ivar, w.header)
        beams.makeGaussianBeamFile(beamPath, fwhm)
        entries.append({"mapFileName": mapPath, "weightsFileName": ivarPath,
                        "obsFreqGHz": freq, "units": "uK",
                        "beamFileName": beamPath})
    return work, entries, w


def write_config(work, name, entries):
    cfg = {"unfilteredMaps": entries, "thresholdSigma": 5.0,
           "minObjPix": 1, "removeRings": False, "photFilter": None,
           "outputDir": str(work / name),
           "findAndMaskExtended": dict(EXTENDED),
           "mapFilters": [
               {"label": "Beam", "class": "BeamMatchedFilter",
                "params": {"noiseParams": {"method": "dataMap",
                                           "noiseGridArcmin": 20.0},
                           "outputUnits": "uK", "edgeTrimArcmin": 0.0}}]}
    path = str(work / (name + ".yml"))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_extended_source_mask_matches_jax(sky):
    """The mask equal to JAX's, non-trivial (the large blob masked and
    dilated, the smaller one removed by the size cut), written as PLIO_1
    FITS and set on every map dict."""
    work, entries, _ = sky
    jconfig = jstartup.NemoConfig(write_config(work, "jax", entries),
                                  writeTileInfo=True)
    config = startup.NemoConfig(write_config(work, "torch", entries),
                                device="cpu", writeTileInfo=True)
    ref = np.asarray(jmaps.makeExtendedSourceMask(jconfig, "PRIMARY"))
    got = maps.makeExtendedSourceMask(config, "PRIMARY")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    assert got[150, 260] == 1 and got[60, 370] == 0
    assert 0.01 < got.mean() < 0.25
    outDir = os.path.join(config.diagnosticsDir, "extendedMask")
    written, _ = nfits.read_image(os.path.join(outDir, "PRIMARY.fits"))
    np.testing.assert_array_equal(np.asarray(written), got)
    assert all(m["extendedMask"] == outDir
               for m in config.unfilteredMapsDictList)
    # without the size cut, the smaller blob is kept too
    config.parDict["findAndMaskExtended"]["minSizeArcmin2"] = 0
    jconfig.parDict["findAndMaskExtended"]["minSizeArcmin2"] = 0
    ref0 = np.asarray(jmaps.makeExtendedSourceMask(jconfig, "PRIMARY"))
    got0 = maps.makeExtendedSourceMask(config, "PRIMARY")
    np.testing.assert_array_equal(got0, ref0)
    assert got0[60, 370] == 1 and got0.sum() > got.sum()


@pytest.mark.parametrize("compression", [None, "PLIO_1"])
def test_save_fits_round_trip(sky, tmp_path, compression):
    """saveFITS writes the array and the WCS; the JAX package reads the
    port's file back to the same array and header keys."""
    _, _, w = sky
    data = (np.arange(SHAPE[0] * SHAPE[1]).reshape(SHAPE) % 7).astype(
        np.uint8 if compression else np.float64)
    path = str(tmp_path / "map.fits")
    maps.saveFITS(path, data, w, compressionType=compression)
    got, header = nfits.read_image(path)
    np.testing.assert_array_equal(np.asarray(got), data)
    assert nwcs.WCS(header).getCentreWCSCoords() == pytest.approx(
        w.getCentreWCSCoords(), abs=1e-9)
    ref = str(tmp_path / "ref.fits")
    jmaps.saveFITS(ref, data, w, compressionType=compression)
    refData, refHeader = nfits.read_image(ref)
    np.testing.assert_array_equal(np.asarray(refData), np.asarray(got))
    assert refHeader["CRVAL1"] == header["CRVAL1"]


def _entry_points(entries):
    f = {"label": "Beam", "class": "BeamMatchedFilter",
         "params": {"noiseParams": {"method": "dataMap",
                                    "noiseGridArcmin": 20.0},
                    "outputUnits": "uK", "edgeTrimArcmin": 0.0}}
    cpuDicts = [maps.MapDict(e, policy=device.CPU) for e in entries]
    return {
        "MapDict": lambda: maps.MapDict(entries[0]),
        "MapDictList": lambda: maps.MapDictList(entries),
        "MapFilter": lambda: filters.BeamMatchedFilter(
            "Beam", cpuDicts, f["params"], tileName="PRIMARY"),
        "filterMaps": lambda: filters.filterMaps(
            cpuDicts, f, "PRIMARY", diagnosticsDir=None, selFnDir=None,
            verbose=False)}


@pytest.mark.parametrize("name", ["MapDict", "MapDictList", "MapFilter",
                                  "filterMaps"])
def test_entry_points_default_to_the_card(sky, monkeypatch, name):
    """With no policy, each entry point asks ``device.policy`` for the
    card: with no card that raises (no silent CPU), and the request is
    the card's either way."""
    _, entries, _ = sky
    run = _entry_points(entries)[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    asked = []
    real = device.policy

    def recording(dev="cuda", x64=False):
        asked.append(dev)
        return real("cpu")

    monkeypatch.setattr(device, "policy", recording)
    run()
    assert asked and set(asked) == {"cuda"}
