"""The port's FITS writer (``nemo_tpu_torch.utils.fits``), which codes a
compressed image one whole image at a time with the library built from
``utils/fits_rows.cpp``, writes the bytes of the JAX package's per-row
writer (``nemo_tpu.utils.fits``): RICE_1 floats (with and without
dithering) and ints, PLIO_1 masks, MEFs with per-extension headers,
GZIP_1, HCOMPRESS_1 and uncompressed images, the rows that leave the
whole-image path (non-finite values, dithered writes, refused rows), the
writer with no compiler, the counters that split the rows, and a round
trip through ``fits.read``."""

import warnings

import numpy as np
import pytest

from nemo_tpu.utils import fits as jfits
from nemo_tpu_torch.utils import fits as nfits
from nemo_tpu_torch.utils import timing


def rms_map(rng, shape=(96, 160)):
    """An RMS map as the search writes one: float32, zero outside the
    survey mask and the trimmed edges, smooth noise levels of ~1e-5 in
    cells, constant rows and all-zero rows."""
    cells = rng.uniform(1e-5, 3e-5, (shape[0] // 16 + 1, shape[1] // 16 + 1))
    img = np.kron(cells, np.ones((16, 16)))[:shape[0], :shape[1]]
    img = img * (1 + 1e-3 * rng.standard_normal(shape))
    img[:7] = 0.0
    img[:, -11:] = 0.0
    img[shape[0] // 3] = 2.5e-5
    return img.astype(np.float32)


def _plio_jumps(rng):
    a = rng.integers(0, 3, (12, 200)).astype(np.int32)
    a[1, 50:] = 5000                        # a jump of 4999 up
    a[2, :100] = 2 ** 26
    a[2, 100:] = 3                          # and a large one down
    a[3] = np.repeat([1, 4097, 1, 9000, 8000], 40)
    return a


def _plio_wide(rng):
    a = np.ones((5, 9001), dtype=np.int32)
    a[1] = 0                                # a zero run of 9001
    a[2, 4000:] = 7                         # runs of 4000 and 5001
    a[3, ::3] = 0
    return a


def _nonfinite(rng):
    img = rms_map(rng)
    img[9, 30] = np.nan
    img[10] = np.nan                        # a row of NaN
    img[11, :5] = np.inf
    img[12, 40] = -np.inf
    return img


def _negative(rng):
    a = _plio_jumps(rng)
    a[4, 17] = -1
    a[6, 0] = 2 ** 27
    return a


IMAGES = {
    "rice_f32_rms_map": (lambda r: rms_map(r), "RICE_1"),
    "rice_f64": (lambda r: r.standard_normal((40, 333)) * 1e3, "RICE_1"),
    "rice_f32_constant_rows": (
        lambda r: np.repeat(r.standard_normal((30, 1)), 77, axis=1)
        .astype(np.float32), "RICE_1"),
    "rice_f32_zeros": (lambda r: np.zeros((8, 64), np.float32), "RICE_1"),
    "rice_nonfinite": (_nonfinite, "RICE_1"),
    "rice_f32_dithered": (_nonfinite, "RICE_1"),
    "rice_uint8": (lambda r: r.integers(0, 256, (33, 129))
                   .astype(np.uint8), "RICE_1"),
    "rice_int16": (lambda r: np.cumsum(r.integers(-300, 300, (20, 500)),
                                       axis=1).astype(np.int16), "RICE_1"),
    "rice_int32": (lambda r: r.integers(-2 ** 31, 2 ** 31 - 1, (9, 300))
                   .astype(np.int32), "RICE_1"),
    "rice_int64": (lambda r: r.integers(-5000, 5000, (6, 70)), "RICE_1"),
    "plio_mask01": (lambda r: (r.random((64, 300)) < 0.7)
                    .astype(np.uint8), "PLIO_1"),
    "plio_bool": (lambda r: r.random((16, 50)) < 0.5, "PLIO_1"),
    "plio_float_mask": (lambda r: (r.random((16, 90)) < 0.5)
                        .astype(np.float64) * 3, "PLIO_1"),
    "plio_float_non_integral": (lambda r: r.random((6, 40)) * 2, "PLIO_1"),
    "plio_jumps": (_plio_jumps, "PLIO_1"),
    "plio_wide_runs": (_plio_wide, "PLIO_1"),
    "plio_negative": (_negative, "PLIO_1"),
    "plio_3d": (lambda r: r.integers(0, 4, (3, 7, 40)).astype(np.int16),
                "PLIO_1"),
}
# images whose rows all stay on the whole-image path
ALL_NATIVE = {"rice_f32_rms_map", "rice_f64", "rice_f32_constant_rows",
              "rice_f32_zeros", "rice_uint8", "rice_int16", "rice_int32",
              "rice_int64", "plio_mask01", "plio_bool", "plio_float_mask",
              "plio_float_non_integral", "plio_jumps", "plio_wide_runs",
              "plio_3d"}
# SUBTRACTIVE_DITHER_1 writes, by their ZDITHER0: every row is quantised
# one at a time
DITHER_SEEDS = {"rice_f32_dithered": 7}
HEADER = {"CTYPE1": "RA---CAR", "CRVAL1": 30.0, "CDELT1": -0.0083333,
          "BUNIT": "uK"}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _counters():
    return {k: timing.RECORDER.counters.get(k, 0)
            for k in ("fits.rows_native", "fits.rows_fallback")}


def _write_both(tmp_path, data, compressionType, ditherSeed=None):
    a, b = str(tmp_path / "jax.fits"), str(tmp_path / "rows.fits")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfits.write_image(a, data, HEADER, compressionType=compressionType,
                          ditherSeed=ditherSeed)
        before = _counters()
        nfits.write_image(b, data, HEADER, compressionType=compressionType,
                          ditherSeed=ditherSeed)
    after = _counters()
    return _bytes(a), _bytes(b), {k: after[k] - before[k] for k in after}


def test_library_builds():
    assert nfits._rows_library() is not None


@pytest.mark.parametrize("case", sorted(IMAGES))
def test_write_image_bytes_match(case, tmp_path):
    make, compressionType = IMAGES[case]
    data = make(np.random.default_rng(len(case)))
    ref, got, counted = _write_both(tmp_path, data, compressionType,
                                    DITHER_SEEDS.get(case))
    assert got == ref
    rows = int(np.prod(np.shape(data)[:-1]))
    assert counted["fits.rows_native"] + counted["fits.rows_fallback"] \
        == rows
    if case in ALL_NATIVE:
        assert counted == {"fits.rows_native": rows, "fits.rows_fallback": 0}
    if case in DITHER_SEEDS:
        assert b"SUBTRACTIVE_DITHER_1" in got
        assert counted == {"fits.rows_native": 0, "fits.rows_fallback": rows}


@pytest.mark.parametrize("case,fallback", [("rice_nonfinite", 4),
                                           ("plio_negative", 2)])
def test_rows_that_leave_the_whole_image_path(case, fallback, tmp_path):
    """Only the rows that hold a non-finite value, or a PLIO value outside
    [0, 2^27) (the gzip column), are counted off the whole-image path."""
    make, compressionType = IMAGES[case]
    data = make(np.random.default_rng(len(case)))
    ref, got, counted = _write_both(tmp_path, data, compressionType)
    assert got == ref
    assert counted["fits.rows_fallback"] == fallback
    assert counted["fits.rows_native"] == data.shape[0] - fallback


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32,
                                   np.float32])
def test_refused_rice_rows_take_the_gzip_column(dtype, tmp_path,
                                                monkeypatch):
    """A row the Rice coder refuses goes to the gzip column, in both
    writers.  The coder's capacity is more than any row's stream needs,
    so both coders are made to refuse rows 1 and 4."""
    from nemo_tpu import native as jnative
    refuse = {1, 4}
    calls = []
    encode = jnative.rice_encode

    def refusing(arr, bytepix=None):
        row = len(calls)
        calls.append(row)
        if row in refuse:
            raise ValueError("RICE stream would overflow; use GZIP")
        return encode(arr, bytepix)

    rows = nfits._encode_rows

    def refusingRows(lib, ints, compressionType, bytepix):
        stream, lens = rows(lib, ints, compressionType, bytepix)
        starts = np.concatenate([[0], np.cumsum(lens)])
        keep = [stream[starts[t]:starts[t + 1]] for t in range(len(lens))
                if t not in refuse]
        lens = lens.copy()
        lens[sorted(refuse)] = -1
        return b"".join(keep), lens

    monkeypatch.setattr(jnative, "rice_encode", refusing)
    monkeypatch.setattr(nfits, "_encode_rows", refusingRows)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 120, (6, 100)).astype(dtype)
    ref, got, counted = _write_both(tmp_path, data, "RICE_1")
    assert len(calls) == 6
    assert b"GZIP_COMPRESSED_DATA" in got
    assert got == ref
    assert counted == {"fits.rows_native": 4, "fits.rows_fallback": 2}
    back = nfits.read_image(str(tmp_path / "rows.fits"))[0]
    if dtype != np.float32:
        np.testing.assert_array_equal(back, data)
    else:
        np.testing.assert_array_equal(back[[1, 4]], data[[1, 4]])


@pytest.mark.parametrize("compressionType", ["RICE_1", "PLIO_1"])
def test_write_mef_bytes_match(compressionType, tmp_path):
    rng = np.random.default_rng(11)
    arrays = {"T%02d" % i: (rms_map(rng, (48, 70 + i))
                            if compressionType == "RICE_1"
                            else (rng.random((48, 70 + i)) < 0.8)
                            .astype(np.float64))
              for i in range(4)}
    headers = {name: dict(HEADER, CRPIX1=10.0 + i, TILENAME=name)
               for i, name in enumerate(arrays) if i != 2}
    a, b = str(tmp_path / "jax.fits"), str(tmp_path / "rows.fits")
    jfits.write_mef(a, arrays, headers=headers,
                    compressionType=compressionType)
    before = _counters()
    nfits.write_mef(b, arrays, headers=headers,
                    compressionType=compressionType)
    after = _counters()
    assert _bytes(b) == _bytes(a)
    assert after["fits.rows_native"] - before["fits.rows_native"] == 4 * 48
    assert after["fits.rows_fallback"] == before["fits.rows_fallback"]


@pytest.mark.parametrize("case", ["rice_f32_rms_map", "rice_nonfinite",
                                  "plio_jumps", "plio_negative"])
def test_no_compiler_takes_the_per_row_writer(case, tmp_path, monkeypatch):
    """Where the library cannot be built every row is coded one at a
    time, and the bytes are the same."""
    monkeypatch.setattr(nfits, "_rows_library", lambda: None)
    make, compressionType = IMAGES[case]
    data = make(np.random.default_rng(len(case)))
    ref, got, counted = _write_both(tmp_path, data, compressionType)
    assert got == ref
    assert counted == {"fits.rows_native": 0,
                       "fits.rows_fallback": data.shape[0]}


@pytest.mark.parametrize("compressionType", [None, "GZIP_1", "HCOMPRESS_1"])
def test_other_compressions_bytes_match(compressionType, tmp_path):
    """Any other compression (HCOMPRESS_1 is gzipped a row at a time, as
    GZIP_1) and no compression write the per-row writer's bytes, images
    and MEFs, and count no RICE_1/PLIO_1 rows."""
    rng = np.random.default_rng(2)
    data = rms_map(rng)
    ints = rng.integers(-300, 300, (20, 50)).astype(np.int16)
    before = _counters()
    ref, got, _ = _write_both(tmp_path, data, compressionType)
    assert got == ref
    a, b = str(tmp_path / "jax.fits"), str(tmp_path / "rows.fits")
    jfits.write_mef(a, {"A": data, "B": ints}, {"B": HEADER},
                    compressionType)
    nfits.write_mef(b, {"A": data, "B": ints}, {"B": HEADER},
                    compressionType)
    assert _bytes(b) == _bytes(a)
    assert _counters() == before


@pytest.mark.parametrize("compressionType", [None, "GZIP_1", "PLIO_1"])
def test_tile_dict_mef_bytes_match(compressionType, tmp_path):
    """``TileDict.saveMEF`` writes the per-row writer's bytes, and only
    its PLIO_1 rows are counted."""
    from nemo_tpu_torch.maps import TileDict
    rng = np.random.default_rng(5)
    arrays = {"T%d" % i: (rng.random((20, 30 + i)) < 0.7).astype(np.float64)
              for i in range(3)}
    coords = {"T0": {"header": HEADER}, "T2": {"header": dict(HEADER,
                                                              CRPIX1=4.0)}}
    a, b = str(tmp_path / "jax.fits"), str(tmp_path / "rows.fits")
    jfits.write_mef(a, arrays, headers={k: v["header"]
                                        for k, v in coords.items()},
                    compressionType=compressionType)
    before = _counters()
    TileDict(arrays, tileCoordsDict=coords).saveMEF(
        b, compressionType=compressionType)
    after = _counters()
    assert _bytes(b) == _bytes(a)
    native = 60 if compressionType == "PLIO_1" else 0
    assert after["fits.rows_native"] - before["fits.rows_native"] == native
    assert after["fits.rows_fallback"] == before["fits.rows_fallback"]


def test_round_trip_through_read(tmp_path):
    rng = np.random.default_rng(4)
    img = rms_map(rng)
    mask = (rng.random((30, 9001)) < 0.6).astype(np.uint8)
    mask[:, 100:5000] = 1
    imgPath, mefPath = str(tmp_path / "rms.fits"), str(tmp_path / "m.fits")
    nfits.write_image(imgPath, img, HEADER, compressionType="RICE_1")
    nfits.write_mef(mefPath, {"A": mask, "B": 1 - mask},
                    headers={"A": HEADER}, compressionType="PLIO_1")
    hdus = nfits.read(imgPath)
    back = hdus[-1].data
    assert back.shape == img.shape
    # NO_DITHER quantisation: within half a step (std / 16) a row
    step = img.std(axis=1, keepdims=True) / 16.0
    assert np.all(np.abs(back - img) <= 0.51 * step)
    np.testing.assert_array_equal(back[img == 0], 0)
    assert hdus[-1].header["BUNIT"] == "uK"
    np.testing.assert_array_equal(nfits.read_image(mefPath, ext="A")[0],
                                  mask)
    np.testing.assert_array_equal(nfits.read_image(mefPath, ext="B")[0],
                                  1 - mask)


@pytest.mark.parametrize("seed", range(6))
def test_random_images_bytes_match(seed, tmp_path):
    """Random shapes, types and scales: steps of every size, so every
    Rice split, the raw blocks and the all-zero blocks are written."""
    rng = np.random.default_rng(100 + seed)
    shape = (int(rng.integers(1, 12)), int(rng.integers(1, 700)))
    scale = 10.0 ** rng.integers(-3, 9)
    walk = np.cumsum(rng.standard_normal(shape) * scale, axis=1)
    walk[:, rng.random(shape[1]) < 0.3] = 0
    for dtype in (np.float32, np.float64, np.uint8, np.int16, np.int32):
        data = walk.astype(dtype) if dtype in (np.float32, np.float64) \
            else np.mod(walk, np.iinfo(dtype).max).astype(dtype)
        ref, got, counted = _write_both(tmp_path, data, "RICE_1")
        assert got == ref, dtype
        assert counted["fits.rows_fallback"] == 0
    masks = np.mod(np.abs(walk), 2 ** 27).astype(np.int32)
    ref, got, _ = _write_both(tmp_path, masks, "PLIO_1")
    assert got == ref
