"""Minimal FITS image writing for the benchmark's own files: an
uncompressed primary image HDU with a CAR world coordinate system."""

import numpy as np

_DTYPES = {np.dtype(np.float32): (-32, ">f4"),
           np.dtype(np.float64): (-64, ">f8"),
           np.dtype(np.uint8): (8, ">u1")}


def _card(key, value):
    if isinstance(value, str):
        v = "'%-8s'" % value
    elif isinstance(value, bool):
        v = "T" if value else "F"
    elif isinstance(value, (int, np.integer)):
        v = "%d" % value
    else:
        v = "%.17G" % value
    return ("%-8s= %20s" % (key, v)).ljust(80)[:80]


def car_header(shape, pixDeg, crval1, crpix1, crpix2):
    """Header cards of a CAR map (CRVAL2 = 0, RA falling with x)."""
    ny, nx = shape
    return {"CTYPE1": "RA---CAR", "CTYPE2": "DEC--CAR", "CUNIT1": "deg",
            "CUNIT2": "deg", "CRVAL1": float(crval1), "CRVAL2": 0.0,
            "CRPIX1": float(crpix1), "CRPIX2": float(crpix2),
            "CDELT1": -float(pixDeg), "CDELT2": float(pixDeg),
            "NAXIS1": nx, "NAXIS2": ny}


def write_image(path, data, header):
    data = np.asarray(data)
    bitpix, be = _DTYPES[data.dtype]
    cards = [_card("SIMPLE", True), _card("BITPIX", bitpix),
             _card("NAXIS", 2), _card("NAXIS1", data.shape[1]),
             _card("NAXIS2", data.shape[0])]
    cards += [_card(k, v) for k, v in header.items()
              if k not in ("NAXIS1", "NAXIS2")]
    cards.append("END".ljust(80))
    head = "".join(cards)
    head += " " * (-len(head) % 2880)
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        raw = np.ascontiguousarray(data, dtype=be).tobytes()
        f.write(raw)
        f.write(b"\0" * (-len(raw) % 2880))
