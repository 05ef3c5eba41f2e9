"""The port's object painting (``ops.paint.paint_objects``) and the
positioned modes of ``models.profiles.make*ModelSignalMap`` against the
JAX package's, float64 on the CPU, on numpy-seeded objects.

JAX scans the objects one at a time; the port evaluates all windows of a
chunk at once and adds each pixel's contributions in object order.  The
windows, the interpolation and the sum order are the reference's, so the
two agree to rounding: rtol 1e-12 of the map's peak.  Chunking never
changes a bit, and the in-order accumulation is bitwise a sequential
scan's.
"""

import numpy as np
import pytest
import torch

from nemo_tpu.models import profiles as jprofiles
from nemo_tpu.ops import paint as jpaint
from nemo_tpu_torch.models import beams, profiles
from nemo_tpu_torch.ops import paint

RTOL = 1e-12
PIX = np.radians(0.5 / 60.0)
SHAPE = (70, 96)


def close(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def gaussian_table(fwhmArcmin=2.0, n=400, rmaxArcmin=20.0):
    r = np.radians(np.linspace(0.0, rmaxArcmin, n) / 60.0)
    sigma = np.radians(fwhmArcmin / 60.0) / np.sqrt(8 * np.log(2))
    return r, np.exp(-0.5 * (r / sigma) ** 2)


def objects(seed, n, shape=SHAPE, edges=False):
    rng = np.random.default_rng(seed)
    ys = rng.uniform(0, shape[0], n)
    xs = rng.uniform(0, shape[1], n)
    if edges:
        # on and next to the map's edges
        ys[:6] = [0.0, shape[0] - 1e-3, 0.49, shape[0] - 1.0, 3.0, 60.2]
        xs[:6] = [0.0, shape[1] - 1e-3, 5.5, 0.0, shape[1] - 0.5, 0.25]
    return ys, xs, rng.normal(0, 2.0, n)


def dx_rows(shape=SHAPE, decDeg=55.0):
    """Per-row x scales of a CAR tile spanning the rows' declinations."""
    dec = np.radians(decDeg + (np.arange(shape[0]) - shape[0] / 2) * 0.5
                     / 60.0)
    return PIX * np.cos(dec)


CASES = {
    # name: (shape, rmax arcmin, dx_rows?, edges?, scalar amp?, chunk bytes)
    "scalar_dx": ((70, 96), 6.0, False, False, False, None),
    "dx_rows": ((70, 96), 6.0, True, False, False, None),
    "capped_window": ((24, 30), 40.0, True, False, False, None),
    "edges": ((70, 96), 6.0, True, True, False, None),
    "scalar_amplitude": ((70, 96), 6.0, True, False, True, None),
    "chunked_one_object": ((70, 96), 6.0, True, True, False, 1),
    "chunked_budget": ((70, 96), 6.0, False, False, False,
                       25 * 25 * 160 * 7),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paint_objects_matches_jax(name):
    shape, rmaxArcmin, useDx, edges, scalar, chunk = CASES[name]
    ys, xs, amps = objects(11, 40, shape, edges=edges)
    if scalar:
        amps = 1.7
    r, v = gaussian_table()
    rmax = np.radians(rmaxArcmin / 60.0)
    dxr = dx_rows(shape) if useDx else None
    kw = {} if chunk is None else {"chunk_bytes": chunk}
    calls = paint.paint_objects.calls
    got = paint.paint_objects(shape, (PIX, PIX), ys, xs, amps, r, v, rmax,
                              dx_rows=dxr, **kw)
    assert paint.paint_objects.calls == calls + 1
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    ref = jpaint.paint_objects(shape, (PIX, PIX), ys, xs, amps, r, v, rmax,
                               dx_rows=dxr)
    close(got, ref)
    if chunk is not None:
        # chunking changes no bit: each pixel still sums in object order
        whole = paint.paint_objects(shape, (PIX, PIX), ys, xs, amps, r, v,
                                    rmax, dx_rows=dxr)
        assert torch.equal(got, whole)


def test_window_capped_by_canvas():
    """rmax beyond the map: the window is the canvas, each object still
    paints every pixel of the map."""
    shape = CASES["capped_window"][0]
    r, v = gaussian_table(fwhmArcmin=40.0, rmaxArcmin=60.0)
    got = paint.paint_objects(shape, (PIX, PIX), [0.2], [29.9], [1.0], r, v,
                              np.radians(40.0 / 60.0))
    assert torch.all(got > 0)


def test_accumulation_is_the_scans_order():
    """The rank-by-rank accumulation adds each pixel's contributions in
    the order given: bitwise a sequential loop's sum, duplicates and all."""
    rng = np.random.default_rng(5)
    index = torch.as_tensor(rng.integers(0, 50, 4000))
    values = torch.as_tensor(rng.normal(0, 1, 4000) * 10.0
                             ** rng.integers(-8, 8, 4000))
    canvas = torch.zeros(5, 10, dtype=torch.float64)
    paint._accumulate_in_order(canvas, index, values)
    ref = np.zeros(50)
    for i, val in zip(index.numpy(), values.numpy()):
        ref[i] = ref[i] + val
    np.testing.assert_array_equal(canvas.numpy().ravel(), ref)


def beam_file(tmp_path, fwhm=1.4):
    path = str(tmp_path / "beam.txt")
    beams.makeGaussianBeamFile(path, fwhm)
    return path


SIGNAL_MAPS = ["arnaud", "battaglia", "beam"]


@pytest.mark.parametrize("kind", SIGNAL_MAPS)
def test_positioned_signal_maps_match_jax(kind, tmp_path):
    """make{Arnaud,Battaglia,Beam}ModelSignalMap at ys/xs with per-object
    amplitudes and dx_rows, on the host and as a tensor."""
    beamPath = beam_file(tmp_path)
    ys, xs, amps = objects(3, 12, edges=True)
    dxr = dx_rows()
    if kind == "beam":
        kw = {"ys": ys, "xs": xs, "amplitude": amps * 100, "maxSizeDeg": 0.1,
              "dx_rows": dxr}
        ref = jprofiles.makeBeamModelSignalMap(SHAPE, (PIX, PIX), beamPath,
                                               **kw)
        got = profiles.makeBeamModelSignalMap(SHAPE, (PIX, PIX), beamPath,
                                              **kw)
        dev = profiles.makeBeamModelSignalMap(SHAPE, (PIX, PIX), beamPath,
                                              returnDevice=True, **kw)
    else:
        name = "makeArnaudModelSignalMap" if kind == "arnaud" \
            else "makeBattagliaModelSignalMap"
        kw = {"beam": beamPath, "ys": ys, "xs": xs, "amplitude": amps * 1e-4,
              "maxSizeDeg": 0.25, "dx_rows": dxr}
        ref = getattr(jprofiles, name)(0.4, 2e14, SHAPE, (PIX, PIX), **kw)
        got = getattr(profiles, name)(0.4, 2e14, SHAPE, (PIX, PIX), **kw)
        dev = getattr(profiles, name)(0.4, 2e14, SHAPE, (PIX, PIX),
                                      returnDevice=True, **kw)
    assert isinstance(got, np.ndarray)
    close(got, ref)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), got)
