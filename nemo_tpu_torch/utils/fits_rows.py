"""Tile-compressed FITS images encoded one whole image at a time.

:mod:`.fits` writes a compressed image one row per FITS tile and loops
over the rows in Python: per row a quantisation and one native Rice call
(RICE_1), or a Python line-list encoder (PLIO_1).  This module writes the
same bytes with no Python loop over rows:

* float images are quantised in numpy, every row at once (per-row
  ``std`` and ``min`` along the rows, ``ZSCALE = std / 16`` or 1
  where ``std == 0``, round, clip, cast);
* the rows are Rice-coded, or turned into PLIO line lists, in one call of
  the library built from ``fits_rows.cpp`` (with g++, on first use, as
  :mod:`..native` builds its codec), which returns the rows' streams end
  to end and each row's length;
* the heap and the descriptors come from those lengths.

A row leaves that path only on what it holds: a non-finite value (it is
quantised as the per-row writer does it), a Rice stream that would
overflow, or a PLIO value outside [0, 2^27) (both go to the gzip column,
as there).  A machine with no compiler takes :mod:`.fits`'s per-row
writer whole.  Counters ``fits.rows_native`` and ``fits.rows_fallback``
split the rows written between the two paths.

Only RICE_1 and PLIO_1 at :mod:`.fits`'s defaults (``quantizeLevel`` 16,
no dithering) are written here; other writes go to :mod:`.fits` itself.
"""

import ctypes
import os
import subprocess
import tempfile
import threading
import zlib

import numpy as np

from . import fits as nfits
from . import timing

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fits_rows.cpp")
_DEPS = (_SRC, os.path.join(os.path.dirname(_HERE), "native", "rice.cpp"))
_LIB = os.path.join(_HERE, "_libfitsrows.so")
_lock = threading.Lock()
_lib = None
_lib_failed = False

_RICE_INTS = {1: np.uint8, 2: np.int16, 4: np.int32}
TYPES = ("RICE_1", "PLIO_1")
_QUANTIZE_LEVEL = 16.0


def _load():
    """The whole-image encoders (ctypes), built on first use; None where
    they cannot be built."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if (not os.path.exists(_LIB) or os.path.getmtime(_LIB)
                    < max(os.path.getmtime(p) for p in _DEPS)):
                # build beside the library and rename: processes that
                # build at once never load a half-written file
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
                os.close(fd)
                try:
                    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o",
                                    tmp, _SRC], check=True,
                                   capture_output=True)
                    os.replace(tmp, _LIB)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(_LIB)
            lib.nemo_rice_encode_rows.restype = ctypes.c_long
            lib.nemo_rice_encode_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.nemo_plio_encode_rows.restype = ctypes.c_long
            lib.nemo_plio_encode_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
        except Exception:
            _lib_failed = True
    return _lib


def _quantise(img):
    """NO_DITHER quantisation of every row of a float image, bitwise as
    :mod:`.fits`'s per-row writer: (int32 rows, ZSCALE, ZZERO, the rows
    that hold a non-finite value, which were quantised one at a time)."""
    bad = np.flatnonzero(~np.isfinite(img).all(axis=1))
    src = img
    if bad.size:
        src = img.copy()
        src[bad] = 0
    std = src.std(axis=1).astype(np.float64)
    zscale = np.where(std > 0, std / _QUANTIZE_LEVEL, 1.0)
    zmin = src.min(axis=1)
    q = np.round((src - zmin[:, None])
                 / zscale.astype(img.dtype)[:, None])
    ints = np.clip(q, -2**31, 2**31 - 1).astype(np.int32)
    zzero = zmin.astype(np.float64)
    for t in bad:
        tile = img[t]
        finite = tile[np.isfinite(tile)]
        sd = float(finite.std()) if finite.size else 0.0
        sc = sd / _QUANTIZE_LEVEL if sd > 0 else 1.0
        zz = float(finite.min()) if finite.size else 0.0
        q = np.round((tile - zz) / sc)
        ints[t] = np.clip(q, -2**31, 2**31 - 1).astype(np.int32)
        zscale[t], zzero[t] = sc, zz
    return ints, zscale, zzero, bad


def _gzip(raw):
    gz = zlib.compressobj(6, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
    return gz.compress(raw) + gz.flush()


def _encode_rows(lib, ints, compressionType, bytepix):
    """Every row in one native call: (the streams end to end as bytes,
    each row's length in bytes, -1 where the coder refused the row)."""
    nrows, ncols = ints.shape
    lens = np.empty(nrows, dtype=np.int64)
    if compressionType == "RICE_1":
        rows = np.ascontiguousarray(ints, dtype=_RICE_INTS[bytepix])
        out = np.empty(nrows * (ncols * bytepix + ncols // 2 + 64),
                       dtype=np.uint8)
        total = lib.nemo_rice_encode_rows(rows.ctypes.data, nrows, ncols,
                                          bytepix, out.ctypes.data,
                                          lens.ctypes.data)
        stream = out[:total].tobytes()
    else:
        rows = np.ascontiguousarray(ints, dtype=np.int32)
        out = np.empty(nrows * (3 * ncols + 7), dtype=np.int16)
        total = lib.nemo_plio_encode_rows(rows.ctypes.data, nrows, ncols,
                                          out.ctypes.data, lens.ctypes.data)
        stream = out[:total].astype(">i2").tobytes()
        lens = np.where(lens < 0, -1, 2 * lens)
    if total < 0:
        raise ValueError("%s row encoder error %d" % (compressionType, total))
    return stream, lens


def compressed_image_hdu_bytes(data, header, compressionType, name=""):
    """:func:`.fits._compressed_image_hdu_bytes`'s bytes (one image row a
    tile, RICE_1 or PLIO_1, no dithering), encoded one whole image at a
    time."""
    if compressionType not in TYPES:
        raise ValueError("fits_rows writes %s, not %r"
                         % (" or ".join(TYPES), compressionType))
    lib = _load()
    arr = np.asarray(data)
    nrows = int(np.prod(arr.shape[:-1])) if arr.ndim else 0
    # an image of no pixels has no rows to encode
    if lib is None or arr.size == 0:
        timing.count("fits.rows_native", 0)
        timing.count("fits.rows_fallback", nrows)
        return nfits._compressed_image_hdu_bytes(data, header,
                                                 compressionType, name=name)

    data = arr
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if compressionType == "PLIO_1" and data.dtype.kind == "f":
        # as the per-row writer: integral mask values are cast, anything
        # else is written as RICE_1 on the uint8 cast, with a warning
        rounded = np.round(data)
        if np.all(np.isfinite(data)) and np.array_equal(data, rounded) \
                and data.min() >= 0 and data.max() < 2 ** 27:
            data = rounded.astype(np.int32)
        else:
            import warnings
            warnings.warn("PLIO_1 write requested for non-integral float "
                          "data; substituting RICE_1 on the uint8 cast")
            compressionType = "RICE_1"
            data = data.astype(np.uint8)
    isfloat = data.dtype.kind == "f"
    if isfloat:
        zbitpix = -32 if data.dtype == np.float32 else -64
        bytepix = 4
    elif data.dtype.itemsize == 1:
        zbitpix, bytepix = 8, 1
    elif data.dtype.itemsize == 2:
        zbitpix, bytepix = 16, 2
    else:
        data = data.astype(np.int32)
        zbitpix, bytepix = 32, 4

    img = np.ascontiguousarray(data.reshape(-1, data.shape[-1]))
    ntiles, tileLen = img.shape
    useQuant = isfloat and compressionType == "RICE_1"
    if useQuant:
        ints, zscales, zzeros, slow = _quantise(img)
    else:
        ints, slow = img, np.zeros(0, dtype=np.int64)
    stream, lens = _encode_rows(lib, ints, compressionType, bytepix)

    # rows the coder refused: gzip of the row (the float row itself under
    # RICE_1), in the gzip column for RICE_1 and the data column for PLIO
    refused = np.flatnonzero(lens < 0)
    dt = nfits._BITPIX_TO_DTYPE[zbitpix]
    gzips = {int(t): _gzip(np.ascontiguousarray(
        img[t] if isfloat else ints[t], dtype=dt).tobytes())
        for t in refused}
    compLens = np.maximum(lens, 0)
    gzipLens = np.zeros(ntiles, dtype=np.int64)
    haveGzipCol = compressionType == "RICE_1" and bool(gzips)
    for t, gz in gzips.items():
        if haveGzipCol:
            gzipLens[t] = len(gz)
        else:
            compLens[t] = len(gz)
    fellBack = np.union1d(slow, refused).size
    timing.count("fits.rows_native", ntiles - fellBack)
    timing.count("fits.rows_fallback", fellBack)

    # the heap: each row's compressed stream, then its gzip stream; a
    # refused row's gzip stream goes where its own stream would have been
    if gzips:
        pieces, at = [], 0
        starts = np.concatenate([[0], np.cumsum(np.maximum(lens, 0))])
        for t in sorted(gzips):
            pieces.append(stream[at:starts[t]])
            pieces.append(gzips[t])
            at = starts[t]
        pieces.append(stream[at:])
        heap = b"".join(pieces)
    else:
        heap = stream

    # P-descriptor counts are in ELEMENTS of the column type (PLIO tiles
    # are 16-bit words in a '1PI' column)
    elemSize = 2 if compressionType == "PLIO_1" else 1
    offsets = np.concatenate([[0], np.cumsum(compLens + gzipLens)[:-1]])
    desc1 = np.stack([compLens // elemSize, offsets], axis=1).astype(">i4")
    desc2 = np.stack([gzipLens, offsets + compLens], axis=1).astype(">i4")
    compTform = "1P%s(%d)" % ("I" if elemSize == 2 else "B",
                              int((compLens // elemSize).max()))
    cols = [("COMPRESSED_DATA", compTform, desc1.view(np.uint8))]
    if haveGzipCol:
        cols.append(("GZIP_COMPRESSED_DATA",
                     "1PB(%d)" % int(gzipLens.max()), desc2.view(np.uint8)))
    if useQuant:
        cols.append(("ZSCALE", "1D",
                     zscales.astype(">f8").reshape(-1, 1).view(np.uint8)))
        cols.append(("ZZERO", "1D",
                     zzeros.astype(">f8").reshape(-1, 1).view(np.uint8)))

    fmt = nfits._format_card
    rowbytes = sum(c[2].shape[1] for c in cols)
    cards = [
        fmt("XTENSION", "BINTABLE"),
        fmt("BITPIX", 8),
        fmt("NAXIS", 2),
        fmt("NAXIS1", rowbytes),
        fmt("NAXIS2", ntiles),
        fmt("PCOUNT", len(heap)),
        fmt("GCOUNT", 1),
        fmt("TFIELDS", len(cols)),
    ]
    for i, (cname, tform, _) in enumerate(cols):
        cards.append(fmt("TTYPE%d" % (i + 1), cname))
        cards.append(fmt("TFORM%d" % (i + 1), tform))
    cards.append(fmt("ZIMAGE", True))
    cards.append(fmt("ZSIMPLE", True))
    cards.append(fmt("ZCMPTYPE", compressionType))
    cards.append(fmt("ZBITPIX", zbitpix))
    cards.append(fmt("ZNAXIS", data.ndim))
    for i, n in enumerate(data.shape[::-1]):
        cards.append(fmt("ZNAXIS%d" % (i + 1), int(n)))
    cards.append(fmt("ZTILE1", tileLen))
    for i in range(2, data.ndim + 1):
        cards.append(fmt("ZTILE%d" % i, 1))
    if compressionType == "RICE_1":
        cards.append(fmt("ZNAME1", "BLOCKSIZE"))
        cards.append(fmt("ZVAL1", 32))
        cards.append(fmt("ZNAME2", "BYTEPIX"))
        cards.append(fmt("ZVAL2", bytepix))
    if useQuant:
        cards.append(fmt("ZQUANTIZ", "NO_DITHER"))
    if name:
        cards.append(fmt("EXTNAME", name))
    if header is not None:
        skip = {"SIMPLE", "BITPIX", "EXTEND", "XTENSION", "PCOUNT",
                "GCOUNT", "EXTNAME", "TFIELDS", "ZIMAGE"}
        for key, value in header.items():
            if key in skip or key.startswith(("NAXIS", "Z", "TTYPE",
                                              "TFORM")):
                continue
            cards.append(fmt(key, value))
    blob = nfits._finish_header(cards)
    body = np.concatenate([c[2] for c in cols], axis=1).tobytes() + heap
    return blob + body + b"\x00" * (nfits._padded(len(body)) - len(body))


def _write(path, images, compressionType):
    """An empty primary HDU, then each (data, header, name) of ``images``
    as a compressed image HDU, as :func:`.fits.write` lays them out."""
    blob = nfits._image_hdu_bytes(None, None, primary=True)
    for data, header, name in images:
        blob += compressed_image_hdu_bytes(
            data, header, compressionType, name=name or "COMPRESSED_IMAGE")
    with nfits._open_maybe_gzip(path, "wb") as f:
        f.write(blob)


def write_image(path, data, header, compressionType):
    """:func:`.fits.write_image` of a RICE_1 or PLIO_1 image, encoded
    here."""
    data = np.asarray(data)
    if compressionType != "PLIO_1" and data.dtype == np.float64:
        data = data.astype(np.float32)
    _write(path, [(data, header, "")], compressionType)


def write_mef(path, named_arrays, headers, compressionType):
    """:func:`.fits.write_mef` of RICE_1 or PLIO_1 images, encoded
    here."""
    images = []
    for name, arr in named_arrays.items():
        arr = np.asarray(arr)
        if compressionType == "PLIO_1":
            arr = arr.astype(np.uint8)
        elif arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        images.append((arr, headers.get(name), name))
    _write(path, images, compressionType)
