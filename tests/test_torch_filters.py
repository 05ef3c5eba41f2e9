"""The port's matched filter (nemo_tpu_torch.filters) against the JAX
package's, float64 on the CPU: the numeric cores on seeded inputs, a
filter built by each package on the same small two-band tile, and the
filter state carried from one package to the other (through
``loadFilterState`` and through the ``filter_*.fits`` cache, both ways),
applied by both to the same maps.  Tolerance rtol 1e-10: both sides are
float64 and differ only in summation order."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nemo_tpu import filters as jflt
from nemo_tpu.models import beams as jbeams
from nemo_tpu.utils import wcs as jwcs
from nemo_tpu_torch import device as device_mod
from nemo_tpu_torch import filters as tflt
from nemo_tpu_torch.models import beams as tbeams
from nemo_tpu_torch.utils import wcs as twcs

SHAPE = (120, 150)
BANDS = (("f150", 149.6, 1.4, 25.0), ("f090", 97.8, 2.1, 35.0))
PARAMS = {"noiseParams": {"method": "dataMap", "noiseGridArcmin": 8.0},
          "outputUnits": "yc", "M500MSun": 2.0e14, "z": 0.4,
          "saveFilter": True}


def close(t, j, rtol=1e-10):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-300))


# -- numeric cores --------------------------------------------------------------

@pytest.mark.parametrize("nf", [1, 2, 3])
def test_build_and_apply_cores(nf):
    rng = np.random.default_rng(nf)
    ny, nx, pad = 40, 50, (45, 54)
    noise = rng.normal(size=(nf, ny, nx))
    apod = rng.random((ny, nx))
    sig = np.abs(rng.normal(size=(nf, pad[0], pad[1] // 2 + 1))) + 0.1
    w = rng.random(nf) + 0.5
    filt = tflt._build_filter_core(torch.as_tensor(noise),
                                   torch.as_tensor(sig), torch.as_tensor(w),
                                   torch.as_tensor(apod), pad)
    jfilt = jflt._build_filter_core(jnp.asarray(noise), jnp.asarray(sig),
                                    jnp.asarray(w), jnp.asarray(apod),
                                    padShape=pad)
    close(filt.numpy(), jfilt)
    fm = np.fft.rfft2(rng.normal(size=(nf,) + pad))
    close(tflt._apply_filter_fourier(torch.as_tensor(fm), filt, pad).numpy(),
          jflt._apply_filter_fourier(jnp.asarray(fm), jfilt, pad))


@pytest.mark.parametrize("gridSize,trim,estimator,undo", [
    (16, 48, "default", True), (20, 0, "percentile", False),
    (None, 30, "default", False)])
def test_postprocess_filtered(gridSize, trim, estimator, undo):
    rng = np.random.default_rng(7)
    m = rng.normal(0, 1e-5, SHAPE)
    m[:, :9] = 0                                   # a zero border
    ps = np.ones(SHAPE)
    ps[50:56, 60:70] = 0                           # a point-source hole
    survey = np.ones(SHAPE)
    survey[100:, :] = 0
    out = tflt._postprocess_filtered(
        torch.as_tensor(m), torch.as_tensor(ps), torch.as_tensor(survey),
        gridSize, trim, 20, estimator, undoPixelWindow=undo)
    ref = jflt._postprocess_filtered(
        jnp.asarray(m), jnp.asarray(ps), jnp.asarray(survey), gridSize,
        trim, 20, estimator, undoPixelWindow=undo)
    for a, b in zip(out, ref):
        close(a.numpy(), b)
    assert out[3].dtype == torch.uint8


# -- the filter on a small two-band tile ------------------------------------------

@pytest.fixture(scope="module")
def tile(tmp_path_factory):
    """Seeded two-band noise + a bright cluster-like blob, with beam files
    and per-package map dicts (the preprocessed-map layout)."""
    d = tmp_path_factory.mktemp("filters")
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[:SHAPE[0], :SHAPE[1]]
    blob = np.exp(-((yy - 60.3) ** 2 + (xx - 71.6) ** 2) / (2 * 4.0 ** 2))
    maps_ = {}
    for band, freq, fwhm, noise in BANDS:
        beam = str(d / ("beam_%s.txt" % band))
        jbeams.makeGaussianBeamFile(beam, fwhm)
        maps_[band] = (rng.normal(0, noise, SHAPE) - 300 * blob, freq, beam)

    def dicts(wcsmod):
        w = wcsmod.makeWCS(SHAPE, 0.5 / 60.0, centreRADeg=30.0,
                           centreDecDeg=-5.0)
        return [{"data": data, "wcs": w, "obsFreqGHz": freq, "units": "uK",
                 "beamFileName": beam, "weights": np.ones(SHAPE),
                 "flagMask": np.zeros(SHAPE, np.uint8),
                 "surveyMask": np.ones(SHAPE, np.uint8),
                 "pointSourceMask": np.ones(SHAPE, np.uint8)}
                for data, freq, beam in maps_.values()]
    return d, dicts(jwcs), dicts(twcs)


def jax_filter(mapDicts, diag):
    diag = None if diag is None else str(diag)
    return jflt.ArnaudModelMatchedFilter(
        "A", mapDicts, PARAMS, tileName="T", diagnosticsDir=diag,
        selFnDir=diag)


def torch_filter(mapDicts, diag):
    diag = None if diag is None else str(diag)
    return tflt.ArnaudModelMatchedFilter(
        "A", mapDicts, PARAMS, tileName="T", diagnosticsDir=diag,
        selFnDir=diag, policy=device_mod.CPU)


def assert_same_output(t, j):
    for key in ("data", "SNMap", "surveyMask"):
        close(t[key], j[key])


def test_built_filters_match(tile):
    d, jdicts, tdicts = tile
    jf = jax_filter(jdicts, d / "built_jax")
    jout = jf.buildAndApply(undoPixelWindow=True)
    tf = torch_filter(tdicts, d / "built_torch")
    tout = tf.buildAndApply(undoPixelWindow=True)
    close(tf.filt.numpy(), np.asarray(jf.filt))
    close(tf.signalNorm, jf.signalNorm)
    assert list(tf.fRelWeights) == list(jf.fRelWeights)
    close(list(tf.fRelWeights.values()), list(jf.fRelWeights.values()))
    assert_same_output(tout, jout)
    assert np.max(tout["SNMap"]) > 5          # the blob is detected


def test_state_carried_by_loadFilterState(tile):
    d, jdicts, tdicts = tile
    jf = jax_filter(jdicts, None)
    jf.buildAndApply()
    tf = torch_filter(tdicts, None)
    tf.loadFilterState(np.asarray(jf.filt), jf.signalNorm, jf.fRelWeights)
    stack = np.stack([m["data"] for m in tdicts])
    close(tf.applyFilter(stack), jf.applyFilter(jnp.asarray(stack)))


@pytest.mark.parametrize("made_by", ["jax", "torch"])
def test_filter_fits_cache_read_both_ways(tile, made_by):
    """A filter built and cached by one package is loaded from its
    filter_*.fits by the other and applied to the same maps."""
    d, jdicts, tdicts = tile
    diag = d / ("cache_" + made_by)
    if made_by == "jax":
        built = jax_filter(jdicts, diag)
        out = built.buildAndApply(undoPixelWindow=True)
        loader = torch_filter(tdicts, diag)
    else:
        built = torch_filter(tdicts, diag)
        out = built.buildAndApply(undoPixelWindow=True)
        loader = jax_filter(jdicts, diag)
    assert os.path.exists(built.filterFileName)
    loaded = loader.buildAndApply(undoPixelWindow=True)
    close(loader.signalNorm, built.signalNorm)
    assert loader.fRelWeights == pytest.approx(built.fRelWeights, rel=1e-12)
    assert_same_output(loaded, out)


# -- the tile state a bank's filters share -----------------------------------------

@pytest.mark.parametrize("case", ["map_to_use", "solid_angle_header",
                                  "missing_beam_file"])
def test_tile_state_of_a_filter(tile, case):
    """A filter built on a tile's shared state (``tileState``: the flag
    mask and beam solid angles the staging worker makes once a tile) and
    one that makes its own: a filter that picks its band with
    ``mapToUse`` makes its own from that band; a beam file's declared
    solid angle reads the same through both routes and ``BeamProfile``;
    a missing beam file raises at construction, as it did when the
    constructor read the whole beam file."""
    d, _, tdicts = tile
    rng = np.random.default_rng(3)
    dicts = [dict(m, label=band,
                  flagMask=(rng.random(SHAPE) < 0.1).astype(np.uint8))
             for m, (band, *_) in zip(tdicts, BANDS)]

    def build(**k):
        return tflt.ArnaudModelMatchedFilter(
            "A", dicts, dict(PARAMS, **k.pop("params", {})), tileName="T",
            policy=device_mod.CPU, **k)

    if case == "missing_beam_file":
        dicts[1]["beamFileName"] = str(d / "no_such_beam.txt")
        with pytest.raises(FileNotFoundError):
            build()
        with pytest.raises(FileNotFoundError):
            tflt.beamSolidAngles(dicts)
        return
    if case == "solid_angle_header":
        beam = str(d / "beam_declared.txt")
        with open(dicts[0]["beamFileName"]) as f:
            rows = f.readlines()[1:]
        with open(beam, "w") as f:
            f.writelines(["# solid angle = 123.5 nsr\n"] + rows)
        dicts[0]["beamFileName"] = beam
    state = {"flagMask": tflt.combinedFlagMask(dicts, SHAPE),
             "beamSolidAngles": tflt.beamSolidAngles(dicts)}
    own, shared = build(), build(tileState=state)
    assert shared.flagMask is state["flagMask"]
    assert own.flagMask.dtype == shared.flagMask.dtype
    np.testing.assert_array_equal(own.flagMask, shared.flagMask)
    assert own.beamSolidAnglesDict == shared.beamSolidAnglesDict == {
        m["obsFreqGHz"]: tbeams.BeamProfile(
            beamFileName=m["beamFileName"]).solidAngle_nsr for m in dicts}
    if case == "solid_angle_header":
        assert shared.beamSolidAnglesDict[dicts[0]["obsFreqGHz"]] == 123.5
        return
    one = build(params={"mapToUse": "f090"}, tileState=state)
    assert one.flagMask is not state["flagMask"]
    np.testing.assert_array_equal(one.flagMask, dicts[1]["flagMask"])
    assert one.flagMask.max() == 1 and state["flagMask"].max() == 3
    assert list(one.beamSolidAnglesDict) == [dicts[1]["obsFreqGHz"]]
