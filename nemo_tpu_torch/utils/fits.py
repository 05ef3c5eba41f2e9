"""Minimal, dependency-free FITS reader/writer.

The reference package (Nemo) uses astropy.io.fits for all of its map and
catalog I/O (e.g. ``nemo/maps.py:2371`` ``saveFITS``, ``nemo/catalogs.py:492``
``writeCatalog``).  astropy is not part of this framework's runtime, so we
implement the subset of FITS that the pipeline needs natively:

* image HDUs (primary + IMAGE extensions), BITPIX 8/16/32/64/-32/-64,
  BSCALE/BZERO, 2-d and 3-d arrays;
* binary tables (``XTENSION = 'BINTABLE'``) with column types
  L (logical), B, I, J, K (ints), E, D (floats) and A (strings);
* multi-extension files (MEFs), extensions addressed by EXTNAME;
* transparent gzip support for ``*.gz`` paths.

* tile-compressed image HDUs per the FITS tiled-image convention
  (``ZIMAGE`` binary tables): RICE_1 (via the native C++ codec in
  :mod:`nemo_tpu.native`), PLIO_1 (IRAF line-list, the reference's mask
  format - validated both ways against libcfitsio's ``pl_p2li`` /
  ``pl_l2pi``), GZIP_1/GZIP_2 and NOCOMPRESS on read; RICE_1, PLIO_1
  and GZIP_1 on write, with per-tile linear quantisation (``ZSCALE`` /
  ``ZZERO``, ``NO_DITHER``) for float images.  This covers the
  reference's ``CompImageHDU`` usage (``nemo/maps.py:2371`` ``saveFITS``)
  and reading RICE- or PLIO-compressed ACT/SO survey products.
  SUBTRACTIVE_DITHER_1/_2 quantisation is fully supported on read (the
  deterministic random sequence from ``ZDITHER0`` per the tiled-image
  convention / cfitsio ``fits_init_randoms``, including the integer NULL
  and DITHER_2 zero sentinels) and on write via the ``ditherSeed``
  argument.

All I/O is host-side numpy; device code never touches this module.
"""

import gzip
import os
import threading

import numpy as np

BLOCK = 2880


class ExtensionNotFound(KeyError):
    """A requested extension does not exist in the file.  Distinct from
    the KeyErrors a malformed HDU can raise during decode, so callers
    with a first-image fallback (``completeness._loadTile``) cannot
    mistake a decode failure for a missing extension."""


def _package_version():
    try:
        from .. import __version__
        return __version__
    except Exception:
        return "unknown"

_BITPIX_TO_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}
_DTYPE_TO_BITPIX = {
    "uint8": 8,
    "int8": 16,
    "bool": 8,
    "int16": 16,
    "uint16": 32,
    "int32": 32,
    "uint32": 64,
    "int64": 64,
    "float32": -32,
    "float64": -64,
}

# Binary-table TFORM codes <-> numpy
_TFORM_TO_DTYPE = {
    "L": np.dtype(">u1"),
    "B": np.dtype(">u1"),
    "I": np.dtype(">i2"),
    "J": np.dtype(">i4"),
    "K": np.dtype(">i8"),
    "E": np.dtype(">f4"),
    "D": np.dtype(">f8"),
}


class Header(dict):
    """An ordered FITS header: a dict plus COMMENT/HISTORY passthrough.

    Keys are upper-case strings; values are python ints/floats/bools/strings.
    """

    def copy(self):
        new = Header()
        new.update(self)
        return new


class HDU:
    """One header-data unit: ``header`` (Header), ``data`` (ndarray or
    dict-of-columns for tables), ``name`` (EXTNAME or '' for primary),
    ``is_table`` flag."""

    def __init__(self, data=None, header=None, name=""):
        self.data = data
        self.header = header if header is not None else Header()
        self.name = name
        self.is_table = isinstance(data, dict)


def _parse_value(raw):
    raw = raw.strip()
    if raw == "":
        return None
    if raw.startswith("'"):
        # string: ends at closing quote ('' escapes ')
        end = 1
        out = []
        while end < len(raw):
            if raw[end] == "'":
                if end + 1 < len(raw) and raw[end + 1] == "'":
                    out.append("'")
                    end += 2
                    continue
                break
            out.append(raw[end])
            end += 1
        return "".join(out).rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw.replace("D", "E").replace("d", "e"))
    except ValueError:
        return raw


def _read_header(fileobj):
    """Read header blocks from current position; returns Header or None at EOF."""
    header = Header()
    cards = b""
    while True:
        block = fileobj.read(BLOCK)
        if len(block) == 0 and len(cards) == 0:
            return None
        if len(block) < BLOCK:
            raise IOError("Truncated FITS header block")
        cards += block
        if b"END     " in block or block.rstrip().endswith(b"END"):
            # Check card-aligned END
            found_end = False
            lastKey = None
            for i in range(0, len(cards), 80):
                card = cards[i:i + 80].decode("ascii", errors="replace")
                key = card[:8].strip()
                if key == "END":
                    found_end = True
                    break
                if key == "CONTINUE" and lastKey is not None and \
                        isinstance(header.get(lastKey), str):
                    # long-string convention: previous value ends with '&'
                    cont = _parse_value(card[10:].split("/")[0]
                                        if not card[10:].strip(
                                            ).startswith("'")
                                        else card[10:])
                    prev = header[lastKey]
                    if prev.endswith("&"):
                        header[lastKey] = prev[:-1] + str(cont)
                    continue
                if key in ("COMMENT", "HISTORY", ""):
                    continue
                if card[8:10] == "= ":
                    val = card[10:]
                    if "/" in val:
                        # careful: '/' inside strings
                        if val.strip().startswith("'"):
                            # find closing quote then slash
                            body = val
                            q = body.find("'", body.find("'") + 1)
                            while q != -1 and q + 1 < len(body) and body[q + 1] == "'":
                                q = body.find("'", q + 2)
                            comment_pos = body.find("/", q if q != -1 else 0)
                        else:
                            comment_pos = val.find("/")
                        if comment_pos != -1:
                            val = val[:comment_pos]
                    header[key] = _parse_value(val)
                    lastKey = key
            if found_end:
                return header


def _data_size_bytes(header):
    if header.get("NAXIS", 0) == 0:
        return 0
    nbytes = abs(int(header["BITPIX"])) // 8
    for i in range(1, int(header["NAXIS"]) + 1):
        nbytes *= int(header["NAXIS%d" % i])
    nbytes *= int(header.get("GCOUNT", 1))
    nbytes += int(header.get("PCOUNT", 0))
    return nbytes


def _padded(n):
    return ((n + BLOCK - 1) // BLOCK) * BLOCK


def _read_image_data(fileobj, header):
    nbytes = _data_size_bytes(header)
    if nbytes == 0:
        return None
    raw = fileobj.read(_padded(nbytes))[:nbytes]
    dtype = _BITPIX_TO_DTYPE[int(header["BITPIX"])]
    shape = tuple(int(header["NAXIS%d" % i])
                  for i in range(int(header["NAXIS"]), 0, -1))
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    bscale = header.get("BSCALE", 1)
    bzero = header.get("BZERO", 0)
    if bscale != 1 or bzero != 0:
        arr = arr.astype(np.float64) * bscale + bzero
    else:
        arr = arr.astype(dtype.newbyteorder("="))
    return arr


def _parse_tform(tform):
    """Return (repeat, code)."""
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i > 0 else 1
    code = tform[i].upper()
    return repeat, code


def _read_table_data(fileobj, header):
    nrows = int(header["NAXIS2"])
    rowbytes = int(header["NAXIS1"])
    ncols = int(header["TFIELDS"])
    total = nrows * rowbytes + int(header.get("PCOUNT", 0))
    raw = fileobj.read(_padded(total))[:nrows * rowbytes]
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(nrows, rowbytes)

    cols = {}
    offset = 0
    for c in range(1, ncols + 1):
        name = str(header.get("TTYPE%d" % c, "col%d" % c)).strip()
        repeat, code = _parse_tform(str(header["TFORM%d" % c]).strip())
        if code == "A":
            width = repeat
            chunk = rows[:, offset:offset + width]
            vals = np.array([bytes(r).decode("ascii", errors="replace").rstrip()
                             for r in chunk])
            cols[name] = vals
            offset += width
        else:
            dt = _TFORM_TO_DTYPE[code]
            width = dt.itemsize * repeat
            chunk = rows[:, offset:offset + width].copy()
            vals = chunk.view(dt).reshape(nrows, repeat)
            if repeat == 1:
                vals = vals[:, 0]
            if code == "L":
                vals = vals == ord("T")
            else:
                vals = vals.astype(dt.newbyteorder("="))
            cols[name] = vals
            offset += width
    return cols


# ---------------------------------------------------------------------------
# Tile-compressed images (FITS tiled-image convention; astropy CompImageHDU
# equivalent).  RICE_1 runs through the native codec in nemo_tpu.native.

def _zimage_header(header):
    """Reconstruct the uncompressed-image header from a ZIMAGE bintable."""
    out = Header()
    for key, value in header.items():
        if key.startswith(("Z", "TTYPE", "TFORM", "TFIELDS")) \
                or key in ("XTENSION", "PCOUNT", "GCOUNT", "THEAP") \
                or key.startswith("NAXIS"):
            continue
        out[key] = value
    out["BITPIX"] = int(header["ZBITPIX"])
    out["NAXIS"] = int(header["ZNAXIS"])
    for i in range(1, int(header["ZNAXIS"]) + 1):
        out["NAXIS%d" % i] = int(header["ZNAXIS%d" % i])
    return out


def _zvals(header):
    """ZNAMEn/ZVALn compression parameters as a dict."""
    out = {}
    for i in range(1, 10):
        if "ZNAME%d" % i in header:
            out[str(header["ZNAME%d" % i]).strip().upper()] = \
                header["ZVAL%d" % i]
    return out


def _tile_grid(header):
    znaxis = int(header["ZNAXIS"])
    dims = [int(header["ZNAXIS%d" % i]) for i in range(1, znaxis + 1)]
    tiles = []
    for i in range(1, znaxis + 1):
        default = dims[0] if i == 1 else 1
        tiles.append(int(header.get("ZTILE%d" % i, default)))
    return dims, tiles


def _read_var_column(rows, heap, header, colIdx, offset):
    """Read a P/Q variable-length descriptor column; returns list of bytes.

    The descriptor count is in ELEMENTS of the column type (FITS
    standard 7.3.5), not bytes - e.g. cfitsio stores PLIO_1 tiles in a
    '1PI' column of 16-bit words."""
    tform = str(header["TFORM%d" % colIdx]).strip().upper()
    if "P" in tform:
        desc = rows[:, offset:offset + 8].copy().view(">i4")
        width = 8
        code = tform.split("P", 1)[1][:1]
    else:
        desc = rows[:, offset:offset + 16].copy().view(">i8")
        width = 16
        code = tform.split("Q", 1)[1][:1]
    isize = _TFORM_TO_DTYPE.get(code, np.dtype(np.uint8)).itemsize
    out = []
    for n, off in desc:
        out.append(bytes(heap[int(off):int(off) + int(n) * isize]))
    return out, width


def _gzip_decompress(buf):
    import zlib
    try:
        return zlib.decompress(buf, 16 + zlib.MAX_WBITS)  # gzip wrapper
    except zlib.error:
        return zlib.decompress(buf)  # raw zlib, just in case


def _unshuffle(raw, itemsize):
    """Undo GZIP_2 byte shuffling (bytes of each value split across planes)."""
    arr = np.frombuffer(raw, dtype=np.uint8)
    n = arr.size // itemsize
    return arr.reshape(itemsize, n).T.reshape(-1).tobytes()


def _plio_decode(buf, npix):
    """Decode an IRAF PLIO line list (cfitsio ``pl_l2pi`` semantics).

    Format (new/"-100" variant, the only one cfitsio writes): a header
    of ``ll[1]`` 16-bit words - ``ll[2] == -100`` magic, total length
    ``(ll[3] & 0x7FFF) | (ll[4] << 15)`` - followed by opcode words with
    the operation in bits 14-12 and 12-bit data: 0 skip-N-zeros, 1 set
    high value from two words, 2/3 increment/decrement high value,
    4 write-high-N-times, 5 skip-(N-1)-then-write, 6/7 increment/
    decrement-then-write-one.  Validated against libcfitsio's
    ``pl_p2li``/``pl_l2pi`` in tests/test_plio.py.
    """
    ll = np.frombuffer(buf, dtype=">i2").astype(np.int64)
    out = np.zeros(npix, dtype=np.int32)
    if ll.size < 7:
        return out
    if ll[2] != -100:
        raise IOError("Unsupported PLIO line-list format (ll[2]=%d; "
                      "only the cfitsio/new format is implemented)"
                      % ll[2])
    hdrLen = int(ll[1])
    nWords = (int(ll[3]) & 0x7FFF) | (int(ll[4]) << 15)
    nWords = min(nWords, ll.size)
    x = 0
    hi = 1
    i = hdrLen
    while i < nWords:
        w = int(ll[i]) & 0xFFFF
        i += 1
        op = (w >> 12) & 0x7
        d = w & 0xFFF
        if op == 0:
            x += d
        elif op == 4:
            out[x:x + d] = hi
            x += d
        elif op == 5:
            x += d - 1
            out[x] = hi
            x += 1
        elif op == 1:
            hi = ((int(ll[i]) & 0xFFFF) << 12) | d
            i += 1
        elif op == 2:
            hi += d
        elif op == 3:
            hi -= d
        elif op == 6:
            hi += d
            out[x] = hi
            x += 1
        else:           # op == 7
            hi -= d
            out[x] = hi
            x += 1
    return out


def _plio_encode(ints):
    """Encode non-negative ints as an IRAF PLIO line list (int16 words,
    decodable by cfitsio ``pl_l2pi`` - round-trip tested against it).
    Raises ValueError for negative values or values needing > 27 bits
    (callers fall back to the gzip column)."""
    a = np.asarray(ints, dtype=np.int64).ravel()
    if a.size and (a.min() < 0 or a.max() >= (1 << 27)):
        raise ValueError("PLIO requires 0 <= value < 2^27")
    change = np.flatnonzero(np.diff(a)) + 1
    starts = np.concatenate([[0], change])
    lens = np.diff(np.concatenate([starts, [a.size]]))
    vals = a[starts]
    ops = []
    hi = 1
    for v, n in zip(vals.tolist(), lens.tolist()):
        if v == 0:
            while n > 4095:
                ops.append(4095)
                n -= 4095
            if n:
                ops.append(n)
            continue
        if v != hi:
            d = v - hi
            if 0 < d <= 4095:
                ops.append((2 << 12) | d)
            elif -4095 <= d < 0:
                ops.append((3 << 12) | (-d))
            else:
                ops.append((1 << 12) | (v & 0xFFF))
                ops.append(v >> 12)
            hi = v
        while n > 4095:
            ops.append((4 << 12) | 4095)
            n -= 4095
        if n:
            ops.append((4 << 12) | n)
    lllen = len(ops) + 7
    words = [0, 7, -100, lllen & 0x7FFF, lllen >> 15, 0, 0] + ops
    return np.array(words, dtype=np.int32).astype(np.int16)


def _read_compressed_image(fileobj, header):
    import zlib  # noqa: F401  (via _gzip_decompress)
    from .. import native

    nrows = int(header["NAXIS2"])
    rowbytes = int(header["NAXIS1"])
    pcount = int(header.get("PCOUNT", 0))
    theap = int(header.get("THEAP", nrows * rowbytes))
    total = max(theap + pcount, nrows * rowbytes + pcount)
    raw = fileobj.read(_padded(total))
    rows = np.frombuffer(raw[:nrows * rowbytes], dtype=np.uint8).reshape(
        nrows, rowbytes)
    heap = np.frombuffer(raw[theap:theap + pcount], dtype=np.uint8)

    # Column map
    ncols = int(header["TFIELDS"])
    colData = {}
    offset = 0
    for c in range(1, ncols + 1):
        name = str(header.get("TTYPE%d" % c, "")).strip().upper()
        tform = str(header["TFORM%d" % c]).strip().upper()
        if "P" in tform or "Q" in tform:
            vals, width = _read_var_column(rows, heap, header, c, offset)
            colData[name] = vals
            offset += width
        else:
            repeat, code = _parse_tform(tform)
            dt = _TFORM_TO_DTYPE[code]
            width = dt.itemsize * repeat
            chunk = rows[:, offset:offset + width].copy()
            colData[name] = chunk.view(dt).reshape(-1)
            offset += width

    zbitpix = int(header["ZBITPIX"])
    cmptype = str(header.get("ZCMPTYPE", "RICE_1")).strip().upper()
    zvals = _zvals(header)
    bytepix = int(zvals.get("BYTEPIX", 4))
    dims, tiles = _tile_grid(header)
    # dims are FITS order (axis1 fastest); numpy shape is reversed
    shape = tuple(dims[::-1])
    tshape = tuple(tiles[::-1])
    isfloat = zbitpix < 0
    # Allocate in the FINAL dtype: per-tile assignments cast on the fly,
    # avoiding a whole-map astype pass (and 2x peak memory) at the end.
    bscale = header.get("BSCALE", 1)
    bzero = header.get("BZERO", 0)
    if isfloat:
        outDtype = np.float64 if zbitpix == -64 else np.float32
    elif bscale != 1 or bzero != 0:
        outDtype = np.float64
    else:
        outDtype = {8: np.uint8, 16: np.int16, 32: np.int32,
                    64: np.int64}[zbitpix]
    out = np.zeros(shape, dtype=outDtype)

    # tile iteration, FITS order: axis1 fastest
    ntile_per_axis = [(d + t - 1) // t for d, t in zip(dims, tiles)]
    ntiles = 1
    for n in ntile_per_axis:
        ntiles *= n

    comp = colData.get("COMPRESSED_DATA", [b""] * ntiles)
    gz = colData.get("GZIP_COMPRESSED_DATA", [b""] * ntiles)
    zscale = colData.get("ZSCALE")
    zzero = colData.get("ZZERO")
    zquantiz = str(header.get("ZQUANTIZ", "NO_DITHER")).strip().upper()
    dithered = zquantiz.startswith("SUBTRACTIVE_DITHER")
    dither2 = zquantiz == "SUBTRACTIVE_DITHER_2"
    zdither0 = int(header.get("ZDITHER0", 1))

    for t in range(ntiles):
        # tile index per axis (axis1 fastest)
        rem = t
        idx = []
        for n in ntile_per_axis:
            idx.append(rem % n)
            rem //= n
        starts = [i * tl for i, tl in zip(idx, tiles)]
        lens = [min(tl, d - s) for tl, d, s in zip(tiles, dims, starts)]
        npix = 1
        for ln in lens:
            npix *= ln

        # No per-tile astype anywhere below: upcasts ride the arithmetic
        # or the assignment into ``out`` (tens of thousands of tiles per
        # survey map make explicit casts a measurable second pass).
        buf = comp[t] if t < len(comp) else b""
        gbuf = gz[t] if t < len(gz) else b""
        if len(buf) == 0 and len(gbuf) > 0:
            rawb = _gzip_decompress(gbuf)
            # gzip fallback tiles store the raw big-endian pixels
            dt = _BITPIX_TO_DTYPE[zbitpix]
            vals = np.frombuffer(rawb[:npix * dt.itemsize], dtype=dt)
            quantized = False
        elif cmptype in ("RICE_1", "RICE_ONE"):
            vals = native.rice_decode(buf, npix, bytepix)
            quantized = True
        elif cmptype in ("PLIO_1", "PLIO_ONE"):
            vals = _plio_decode(buf, npix)
            quantized = True
        elif cmptype in ("GZIP_1", "GZIP_2"):
            rawb = _gzip_decompress(buf)
            dt = _BITPIX_TO_DTYPE[zbitpix]
            if cmptype == "GZIP_2":
                rawb = _unshuffle(rawb, dt.itemsize)
            vals = np.frombuffer(rawb[:npix * dt.itemsize], dtype=dt)
            quantized = False
        elif cmptype == "NOCOMPRESS":
            dt = _BITPIX_TO_DTYPE[zbitpix]
            vals = np.frombuffer(buf[:npix * dt.itemsize], dtype=dt)
            quantized = False
        else:
            raise IOError("Unsupported ZCMPTYPE %r" % cmptype)

        if isfloat and quantized:
            sc = float(zscale[t]) if zscale is not None else 1.0
            zz = float(zzero[t]) if zzero is not None else 0.0
            if dithered:
                # subtract the deterministic dither before rescaling
                # (tiled-image convention; cfitsio unquantize with
                # SUBTRACTIVE_DITHER_1/_2)
                rvals = _dither_stream(t, zdither0, npix)
                out_t = (vals - rvals + 0.5) * sc + zz
                out_t[vals == _DITHER_NULL] = np.nan
                if dither2:
                    out_t[vals == _DITHER_ZERO] = 0.0
                vals = out_t
            else:
                vals = vals * sc + zz

        # place the tile (numpy index order reversed)
        sl = tuple(slice(s, s + ln)
                   for s, ln in zip(starts[::-1], lens[::-1]))
        out[sl] = vals.reshape(lens[::-1])

    if not isfloat and (bscale != 1 or bzero != 0):
        out *= bscale
        out += bzero
    return out


_N_RANDOM = 10000
_DITHER_NULL = -2147483647      # quantised-integer sentinel for NaN
_DITHER_ZERO = -2147483646      # SUBTRACTIVE_DITHER_2 sentinel for 0.0
_dither_seq = None


def _dither_randoms():
    """The 10000-value pseudo-random sequence of the FITS tiled-image
    convention (cfitsio ``fits_init_randoms``): a Lehmer LCG with
    a = 16807, m = 2^31 - 1, seed 1."""
    global _dither_seq
    if _dither_seq is None:
        a, m = 16807.0, 2147483647.0
        seed = 1.0
        vals = np.empty(_N_RANDOM)
        for i in range(_N_RANDOM):
            temp = a * seed
            seed = temp - m * int(temp / m)
            vals[i] = seed / m
        _dither_seq = vals
    return _dither_seq


def _dither_stream(tileIndex, zdither0, npix):
    """Per-pixel dither offsets for (0-based) tile ``tileIndex``: start at
    I0 = (tile + ZDITHER0 - 1) mod 10000, I1 = int(RN[I0] * 500); when I1
    wraps, advance I0 and re-seed I1 (tiled-image convention sect. on
    subtractive dithering)."""
    r = _dither_randoms()
    i0 = int((tileIndex + zdither0 - 1) % _N_RANDOM)
    i1 = int(r[i0] * 500.0)
    chunks = []
    need = npix
    while need > 0:
        take = min(_N_RANDOM - i1, need)
        chunks.append(r[i1:i1 + take])
        need -= take
        i0 = (i0 + 1) % _N_RANDOM
        i1 = int(r[i0] * 500.0)
    return np.concatenate(chunks) if len(chunks) > 1 else chunks[0]


def _compressed_image_hdu_bytes(data, header, compressionType,
                                quantizeLevel=16.0, name="",
                                ditherSeed=None):
    """Serialise a tile-compressed image HDU (one image row per tile).

    ``ditherSeed`` (1..10000) enables SUBTRACTIVE_DITHER_1 quantisation
    for float data (``ZDITHER0 = ditherSeed``); None writes NO_DITHER.
    """
    from .. import native
    import zlib

    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if compressionType == "PLIO_1" and data.dtype.kind == "f":
        # PLIO is an integer (mask) format.  The pipeline's mask arrays
        # are float (they ride through float device programs), but their
        # VALUES are small non-negative integers - cast losslessly and
        # write real PLIO, matching the reference's on-disk mask format
        # (nemo/maps.py:2371).  Genuinely non-integral floats fall back
        # to lossless-for-masks RICE with a warning.
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
    else:
        if data.dtype.itemsize == 1:
            zbitpix, bytepix = 8, 1
        elif data.dtype.itemsize == 2:
            zbitpix, bytepix = 16, 2
        else:
            data = data.astype(np.int32)
            zbitpix, bytepix = 32, 4

    img2d = data.reshape(-1, data.shape[-1])
    ntiles = img2d.shape[0]
    tileLen = img2d.shape[1]

    compTiles, gzipTiles = [], []
    zscales = np.ones(ntiles)
    zzeros = np.zeros(ntiles)
    for t in range(ntiles):
        tile = img2d[t]
        if isfloat:
            finite = tile[np.isfinite(tile)]
            std = float(finite.std()) if finite.size else 0.0
            sc = std / float(quantizeLevel) if std > 0 else 1.0
            zz = float(finite.min()) if finite.size else 0.0
            if ditherSeed is not None:
                rvals = _dither_stream(t, int(ditherSeed), tile.size)
                q = np.round((tile - zz) / sc + rvals - 0.5)
                q = np.clip(q, -2**31 + 2, 2**31 - 1)
                q[~np.isfinite(tile)] = _DITHER_NULL
                q = q.astype(np.int32)
            else:
                q = np.round((tile - zz) / sc)
                q = np.clip(q, -2**31, 2**31 - 1).astype(np.int32)
            zscales[t], zzeros[t] = sc, zz
            ints = q
        else:
            ints = tile
        if compressionType == "RICE_1":
            try:
                compTiles.append(native.rice_encode(ints, bytepix))
                gzipTiles.append(b"")
                continue
            except ValueError:
                pass  # pathological tile: fall through to the gzip column
        if compressionType == "PLIO_1":
            try:
                compTiles.append(
                    _plio_encode(ints).astype(">i2").tobytes())
                gzipTiles.append(b"")
                continue
            except ValueError:
                pass  # negative/out-of-range values: gzip column
        # GZIP_1 (also the RICE overflow fallback)
        dt = _BITPIX_TO_DTYPE[zbitpix]
        if isfloat and compressionType != "RICE_1":
            rawb = np.ascontiguousarray(tile, dtype=dt).tobytes()
        elif isfloat:
            rawb = np.ascontiguousarray(tile, dtype=dt).tobytes()
        else:
            rawb = np.ascontiguousarray(ints, dtype=dt).tobytes()
        gzbuf = zlib.compressobj(6, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
        gz = gzbuf.compress(rawb) + gzbuf.flush()
        if compressionType == "RICE_1":
            compTiles.append(b"")
            gzipTiles.append(gz)
        else:
            compTiles.append(gz)
            gzipTiles.append(b"")

    useQuant = isfloat and compressionType == "RICE_1"
    haveGzipCol = any(len(g) for g in gzipTiles)

    # Build heap + descriptors (P-descriptor counts are in ELEMENTS of
    # the column type; PLIO tiles are 16-bit words in a '1PI' column)
    elemSize = 2 if compressionType == "PLIO_1" else 1
    heap = bytearray()
    desc1 = np.zeros((ntiles, 2), dtype=">i4")
    desc2 = np.zeros((ntiles, 2), dtype=">i4")
    for t in range(ntiles):
        desc1[t] = (len(compTiles[t]) // elemSize, len(heap))
        heap += compTiles[t]
        if haveGzipCol:
            desc2[t] = (len(gzipTiles[t]), len(heap))
            heap += gzipTiles[t]

    compTform = "1P%s(%d)" % ("I" if elemSize == 2 else "B", max(
        (len(c) // elemSize for c in compTiles), default=0))
    cols = [("COMPRESSED_DATA", compTform, desc1.view(np.uint8))]
    if haveGzipCol:
        cols.append(("GZIP_COMPRESSED_DATA", "1PB(%d)" % max(
            (len(g) for g in gzipTiles), default=0), desc2.view(np.uint8)))
    if useQuant:
        cols.append(("ZSCALE", "1D",
                     zscales.astype(">f8").reshape(-1, 1).view(np.uint8)))
        cols.append(("ZZERO", "1D",
                     zzeros.astype(">f8").reshape(-1, 1).view(np.uint8)))

    rowbytes = sum(c[2].shape[1] for c in cols)
    cards = [
        _format_card("XTENSION", "BINTABLE"),
        _format_card("BITPIX", 8),
        _format_card("NAXIS", 2),
        _format_card("NAXIS1", rowbytes),
        _format_card("NAXIS2", ntiles),
        _format_card("PCOUNT", len(heap)),
        _format_card("GCOUNT", 1),
        _format_card("TFIELDS", len(cols)),
    ]
    for i, (cname, tform, _) in enumerate(cols):
        cards.append(_format_card("TTYPE%d" % (i + 1), cname))
        cards.append(_format_card("TFORM%d" % (i + 1), tform))
    cards.append(_format_card("ZIMAGE", True))
    # ZSIMPLE marks the compressed HDU as the logical primary image -
    # cfitsio's open-time auto-navigation skips an empty primary only
    # when this is set (interop: funpack/astropy readers of our files)
    cards.append(_format_card("ZSIMPLE", True))
    cards.append(_format_card("ZCMPTYPE", compressionType))
    cards.append(_format_card("ZBITPIX", zbitpix))
    cards.append(_format_card("ZNAXIS", data.ndim))
    for i, n in enumerate(data.shape[::-1]):
        cards.append(_format_card("ZNAXIS%d" % (i + 1), int(n)))
    cards.append(_format_card("ZTILE1", tileLen))
    for i in range(2, data.ndim + 1):
        cards.append(_format_card("ZTILE%d" % i, 1))
    if compressionType == "RICE_1":
        cards.append(_format_card("ZNAME1", "BLOCKSIZE"))
        cards.append(_format_card("ZVAL1", 32))
        cards.append(_format_card("ZNAME2", "BYTEPIX"))
        cards.append(_format_card("ZVAL2", bytepix))
    if useQuant:
        if ditherSeed is not None:
            cards.append(_format_card("ZQUANTIZ", "SUBTRACTIVE_DITHER_1"))
            cards.append(_format_card("ZDITHER0", int(ditherSeed)))
        else:
            cards.append(_format_card("ZQUANTIZ", "NO_DITHER"))
    if name:
        cards.append(_format_card("EXTNAME", name))
    if header is not None:
        skip = {"SIMPLE", "BITPIX", "EXTEND", "XTENSION", "PCOUNT",
                "GCOUNT", "EXTNAME", "TFIELDS", "ZIMAGE"}
        for key, value in header.items():
            if key in skip or key.startswith(("NAXIS", "Z", "TTYPE",
                                              "TFORM")):
                continue
            cards.append(_format_card(key, value))
    blob = _finish_header(cards)

    body = np.concatenate([c[2] for c in cols], axis=1).tobytes() \
        + bytes(heap)
    blob += body + b"\x00" * (_padded(len(body)) - len(body))
    return blob


def _open_maybe_gzip(path, mode):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read(path):
    """Read a FITS file; returns a list of :class:`HDU`."""
    hdus = []
    with _open_maybe_gzip(path, "rb") as f:
        while True:
            header = _read_header(f)
            if header is None:
                break
            xtension = str(header.get("XTENSION", "")).strip()
            if xtension == "BINTABLE" and header.get("ZIMAGE"):
                data = _read_compressed_image(f, header)
                hdu = HDU(data=data, header=_zimage_header(header),
                          name=str(header.get("EXTNAME", "")).strip())
                hdu.is_table = False
            elif xtension == "BINTABLE":
                data = _read_table_data(f, header)
                hdu = HDU(data=data, header=header,
                          name=str(header.get("EXTNAME", "")).strip())
                hdu.is_table = True
            else:
                data = _read_image_data(f, header)
                hdu = HDU(data=data, header=header,
                          name=str(header.get("EXTNAME", "")).strip())
            hdus.append(hdu)
    return hdus


def scan_hdus(path):
    """Headers + byte offsets of every HDU without reading the data.

    Returns a list of (header, data_offset, data_nbytes).  Only works on
    uncompressed (non-.gz) files.
    """
    out = []
    with open(path, "rb") as f:
        while True:
            header = _read_header(f)
            if header is None:
                break
            offset = f.tell()
            if str(header.get("XTENSION", "")).strip() == "BINTABLE":
                nbytes = (int(header["NAXIS1"]) * int(header["NAXIS2"])
                          + int(header.get("PCOUNT", 0)))
            else:
                nbytes = _data_size_bytes(header)
            out.append((header, offset, nbytes))
            f.seek(offset + _padded(nbytes))
    return out


def read_image_header(path, ext=None):
    """Header of the first (or named) image HDU WITHOUT reading data.

    Survey maps run to ~GBs; WCS-consistency checks only need headers,
    so this seeks over the data (compressed-image BINTABLEs are
    translated to their effective image headers).  Falls back to a full
    read for .gz files, which :func:`scan_hdus` cannot seek."""
    try:
        scanned = scan_hdus(path)
    except (IOError, OSError):
        for hdu in read(path):
            if hdu.data is not None and not getattr(hdu, "is_table",
                                                    False):
                if ext is None or hdu.name == ext:
                    return hdu.header
        raise IOError("No matching image HDU in %s" % path)
    for header, offset, nbytes in scanned:
        name = str(header.get("EXTNAME", "")).strip()
        if header.get("ZIMAGE"):
            h = _zimage_header(header)
        elif str(header.get("XTENSION", "")).strip() == "BINTABLE":
            continue
        elif int(header.get("NAXIS", 0)) >= 1 and nbytes > 0:
            h = header
        else:
            continue
        if ext is None or name.upper() == str(ext).upper():
            return h
    raise IOError("No matching image HDU in %s" % path)


_MMAP_CACHE = {}
_MMAP_LOCK = threading.Lock()


def read_image_mmap(path, ext=None):
    """Memory-mapped view of an image HDU: (array, header).

    The returned array is a read-only big-endian view backed by the file -
    slice it and copy the slice; do NOT mutate.  Tile pipelines use this so
    loading one tile of a survey-sized map costs O(tile) I/O instead of a
    full-file read.  Raises IOError for gzip or tile-compressed HDUs
    (callers fall back to :func:`read_image`).
    """
    path = str(path)
    if path.endswith(".gz"):
        raise IOError("Cannot memory-map a gzip FITS file")
    key = (path, os.path.getmtime(path), ext)
    with _MMAP_LOCK:        # engine prefetch thread races main here
        if key in _MMAP_CACHE:
            return _MMAP_CACHE[key]
    for i, (header, offset, nbytes) in enumerate(scan_hdus(path)):
        if header.get("ZIMAGE"):
            raise IOError("Cannot memory-map a tile-compressed HDU")
        if str(header.get("XTENSION", "")).strip() == "BINTABLE":
            continue
        if header.get("NAXIS", 0) == 0 or nbytes == 0:
            continue
        name = str(header.get("EXTNAME", "")).strip()
        if ext is not None:
            if isinstance(ext, int) and i != ext:
                continue
            if isinstance(ext, str) and name.upper() != ext.upper():
                continue
        dtype = _BITPIX_TO_DTYPE[int(header["BITPIX"])]
        shape = tuple(int(header["NAXIS%d" % j])
                      for j in range(int(header["NAXIS"]), 0, -1))
        arr = np.memmap(path, dtype=dtype, mode="r", offset=offset,
                        shape=shape)
        if header.get("BSCALE", 1) != 1 or header.get("BZERO", 0) != 0:
            raise IOError("Cannot memory-map a BSCALE/BZERO-scaled image")
        with _MMAP_LOCK:
            _MMAP_CACHE[key] = (arr, header)
        return arr, header
    raise IOError("No matching image HDU to map in %s" % path)


def read_image(path, ext=None):
    """Read the first image HDU with data (or the named/indexed extension).

    Returns (data, header).  Seeks directly to the target HDU and decodes
    ONLY it - a survey-sized MEF holds hundreds of tile extensions, and
    per-tile loaders (``completeness._loadTile``) call this once per
    tile, so decoding the whole file each time is O(N^2) across a run.
    Falls back to a full read for .gz files, which ``scan_hdus`` cannot
    seek.
    """
    try:
        scanned = scan_hdus(path)
    except (IOError, OSError):
        scanned = None
    if scanned is None:             # .gz fallback
        hdus = read(path)
        if ext is not None:
            for i, h in enumerate(hdus):
                if (isinstance(ext, int) and i == ext) or \
                   (isinstance(ext, str) and h.name.upper() == ext.upper()):
                    return h.data, h.header
            raise ExtensionNotFound("Extension %r not found in %s"
                                % (ext, path))
        for h in hdus:
            if h.data is not None and not h.is_table:
                return h.data, h.header
        raise IOError("No image data found in %s" % path)

    for i, (header, offset, nbytes) in enumerate(scanned):
        zimage = bool(header.get("ZIMAGE"))
        isPlainTable = (str(header.get("XTENSION", "")).strip()
                        == "BINTABLE" and not zimage)
        name = str(header.get("EXTNAME", "")).strip()
        if ext is not None:
            if isinstance(ext, int):
                if i != ext:
                    continue
            elif name.upper() != str(ext).upper():
                continue
            if not zimage and int(header.get("NAXIS", 0)) == 0:
                return None, header     # matched an empty/primary HDU
        else:
            if isPlainTable or (not zimage
                                and (int(header.get("NAXIS", 0)) == 0
                                     or nbytes == 0)):
                continue
        with open(path, "rb") as f:
            f.seek(offset)
            if zimage:
                return _read_compressed_image(f, header), \
                    _zimage_header(header)
            if isPlainTable:    # explicit ext naming a table HDU
                return _read_table_data(f, header), header
            return _read_image_data(f, header), header
    if ext is not None:
        raise ExtensionNotFound("Extension %r not found in %s"
                        % (ext, path))
    raise IOError("No image data found in %s" % path)


def read_table(path, ext=None):
    """Read the first binary-table HDU (or named extension).

    Returns (columns dict, header).
    """
    hdus = read(path)
    for i, h in enumerate(hdus):
        if not h.is_table:
            continue
        if ext is None:
            return h.data, h.header
        if (isinstance(ext, int) and i == ext) or \
           (isinstance(ext, str) and h.name.upper() == str(ext).upper()):
            return h.data, h.header
    raise IOError("No matching table HDU in %s" % path)


def _format_card(key, value):
    key = key.upper()[:8]
    if isinstance(value, bool):
        vstr = "%20s" % ("T" if value else "F")
    elif isinstance(value, (int, np.integer)):
        vstr = "%20d" % value
    elif isinstance(value, (float, np.floating)):
        vstr = "%20s" % repr(float(value))
        if len(vstr) > 20:
            vstr = "%20.13E" % value
    elif value is None:
        vstr = " " * 20
    else:
        s = str(value).replace("'", "''")
        vstr = "'%s'" % s.ljust(8)
    card = "%-8s= %s" % (key, vstr)
    return card[:80].ljust(80)


def _header_bytes(header):
    cards = []
    for key, value in header.items():
        if key in ("SIMPLE", "BITPIX", "XTENSION", "PCOUNT", "GCOUNT",
                   "TFIELDS", "EXTEND") or key.startswith("NAXIS"):
            continue  # structural keys are emitted explicitly by callers
        cards.append(_format_card(key, value))
    return cards


def _finish_header(cards):
    # provenance stamp, as the reference writes NEMOVER into every product
    # (nemo/maps.py:2385, catalogs.py:513)
    if not any(c.startswith("NEMOVER") for c in cards):
        cards.append(_format_card("NEMOVER", _package_version()))
    cards.append("END".ljust(80))
    blob = "".join(cards).encode("ascii")
    return blob + b" " * (_padded(len(blob)) - len(blob))


def _image_hdu_bytes(data, header, primary, name=""):
    cards = []
    if data is None:
        shape = ()
        bitpix = 8
    else:
        data = np.asarray(data)
        if data.dtype == np.bool_:
            data = data.astype(np.uint8)
        bitpix = _DTYPE_TO_BITPIX[data.dtype.name]
        shape = data.shape
    if primary:
        cards.append(_format_card("SIMPLE", True))
    else:
        cards.append(_format_card("XTENSION", "IMAGE"))
    cards.append(_format_card("BITPIX", bitpix))
    cards.append(_format_card("NAXIS", len(shape)))
    for i, n in enumerate(shape[::-1]):
        cards.append(_format_card("NAXIS%d" % (i + 1), int(n)))
    if primary:
        cards.append(_format_card("EXTEND", True))
    else:
        cards.append(_format_card("PCOUNT", 0))
        cards.append(_format_card("GCOUNT", 1))
    if name:
        cards.append(_format_card("EXTNAME", name))
    if header is not None:
        skip = {"SIMPLE", "BITPIX", "EXTEND", "XTENSION", "PCOUNT", "GCOUNT",
                "EXTNAME"}
        for key, value in header.items():
            if key in skip or key.startswith("NAXIS"):
                continue
            cards.append(_format_card(key, value))
    blob = _finish_header(cards)
    if data is not None:
        target = _BITPIX_TO_DTYPE[bitpix]
        raw = np.ascontiguousarray(data, dtype=target).tobytes()
        blob += raw + b"\x00" * (_padded(len(raw)) - len(raw))
    return blob


def _column_tform(arr):
    arr = np.asarray(arr)
    kind = arr.dtype.kind
    if kind in ("U", "S", "O"):
        strs = np.array([str(v) for v in arr])
        width = max(1, max((len(s) for s in strs), default=1))
        return "%dA" % width, strs, width
    if kind == "b":
        return "L", arr, 1
    if kind in ("i", "u"):
        if arr.dtype.itemsize <= 2:
            return "I", arr.astype(np.int16), 2
        if arr.dtype.itemsize <= 4:
            return "J", arr.astype(np.int32), 4
        return "K", arr.astype(np.int64), 8
    if arr.dtype == np.float32:
        return "E", arr, 4
    return "D", arr.astype(np.float64), 8


def _table_hdu_bytes(columns, header, name=""):
    colinfo = []
    nrows = None
    for cname, arr in columns.items():
        tform, conv, width = _column_tform(arr)
        if nrows is None:
            nrows = len(conv)
        if len(conv) != nrows:
            raise ValueError("Column %s length mismatch" % cname)
        colinfo.append((cname, tform, conv, width))
    nrows = nrows or 0
    rowbytes = sum(w for _, _, _, w in colinfo)

    cards = [
        _format_card("XTENSION", "BINTABLE"),
        _format_card("BITPIX", 8),
        _format_card("NAXIS", 2),
        _format_card("NAXIS1", rowbytes),
        _format_card("NAXIS2", nrows),
        _format_card("PCOUNT", 0),
        _format_card("GCOUNT", 1),
        _format_card("TFIELDS", len(colinfo)),
    ]
    for i, (cname, tform, _, _) in enumerate(colinfo):
        cards.append(_format_card("TTYPE%d" % (i + 1), cname))
        cards.append(_format_card("TFORM%d" % (i + 1), tform))
    if name:
        cards.append(_format_card("EXTNAME", name))
    if header is not None:
        skip = {"XTENSION", "BITPIX", "PCOUNT", "GCOUNT", "TFIELDS", "EXTNAME"}
        for key, value in header.items():
            if key in skip or key.startswith(("NAXIS", "TTYPE", "TFORM")):
                continue
            cards.append(_format_card(key, value))
    blob = _finish_header(cards)

    rows = np.zeros((nrows, rowbytes), dtype=np.uint8)
    offset = 0
    for cname, tform, conv, width in colinfo:
        if tform.endswith("A"):
            for r in range(nrows):
                enc = str(conv[r]).encode("ascii", errors="replace")[:width]
                rows[r, offset:offset + len(enc)] = np.frombuffer(enc, np.uint8)
                if len(enc) < width:
                    rows[r, offset + len(enc):offset + width] = ord(" ")
        elif tform == "L":
            rows[:, offset] = np.where(conv, ord("T"), ord("F"))
        else:
            be = np.ascontiguousarray(conv).astype(conv.dtype.newbyteorder(">"))
            rows[:, offset:offset + width] = be.view(np.uint8).reshape(nrows, width)
        offset += width
    raw = rows.tobytes()
    blob += raw + b"\x00" * (_padded(len(raw)) - len(raw))
    return blob


def write(path, hdus, overwrite=True):
    """Write a list of HDUs (or (data, header) pairs) to a FITS file."""
    if os.path.exists(path) and not overwrite:
        raise IOError("%s exists" % path)
    norm = []
    for h in hdus:
        if isinstance(h, HDU):
            norm.append(h)
        else:
            data, header = h
            norm.append(HDU(data=data, header=header))
    blob = b""
    for i, h in enumerate(norm):
        comp = getattr(h, "compressionType", None)
        if h.is_table or isinstance(h.data, dict):
            if i == 0:
                # tables cannot be primary: emit empty primary first
                blob += _image_hdu_bytes(None, None, primary=True)
            blob += _table_hdu_bytes(h.data, h.header, name=h.name)
        elif comp is not None and h.data is not None:
            if i == 0:
                blob += _image_hdu_bytes(None, None, primary=True)
            blob += _compressed_image_hdu_bytes(
                h.data, h.header, comp,
                name=h.name or "COMPRESSED_IMAGE",
                ditherSeed=getattr(h, "ditherSeed", None))
        else:
            blob += _image_hdu_bytes(h.data, h.header, primary=(i == 0),
                                     name=h.name if i > 0 else "")
    with _open_maybe_gzip(path, "wb") as f:
        f.write(blob)


def write_image(path, data, header=None, compressionType=None,
                overwrite=True, ditherSeed=None):
    """Write a single image.  ``compressionType`` matches the reference's
    ``saveFITS`` interface (``maps.py:2371``): 'RICE_1' (lossy for floats,
    quantised per tile), 'GZIP_1' (lossless), or 'PLIO_1' (masks; written
    as RICE_1 on uint8).  ``ditherSeed`` (1..10000) selects
    SUBTRACTIVE_DITHER_1 quantisation for RICE-compressed floats."""
    if compressionType is not None and data is not None:
        if compressionType != "PLIO_1" \
                and np.asarray(data).dtype == np.float64:
            data = np.asarray(data).astype(np.float32)
        hdu = HDU(data=data, header=header)
        hdu.compressionType = compressionType
        if ditherSeed is not None:
            hdu.ditherSeed = int(ditherSeed)
        write(path, [hdu], overwrite=overwrite)
        return
    write(path, [HDU(data=data, header=header)], overwrite=overwrite)


def write_mef(path, named_arrays, headers=None, compressionType=None,
              overwrite=True):
    """Write a multi-extension FITS file from {extName: array}."""
    hdus = [HDU(data=None, header=None)]
    for name, arr in named_arrays.items():
        arr = np.asarray(arr)
        if compressionType == "PLIO_1":
            arr = arr.astype(np.uint8)
        elif compressionType is not None and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        hdr = None
        if headers is not None and name in headers:
            hdr = headers[name]
        hdu = HDU(data=arr, header=hdr, name=name)
        if compressionType is not None:
            hdu.compressionType = compressionType
        hdus.append(hdu)
    write(path, hdus, overwrite=overwrite)
