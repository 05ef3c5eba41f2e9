"""Native (C++) runtime components, loaded through ctypes.

The shared library is compiled on first use with the system g++ (no build
step, no pybind11); if no compiler is available the pure-python fallbacks
are used transparently.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "rice.cpp")
_LIB = os.path.join(_HERE, "_librice.so")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, _SRC],
                    check=True, capture_output=True)
            lib = ctypes.CDLL(_LIB)
            lib.nemo_rice_encode.restype = ctypes.c_long
            lib.nemo_rice_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_int]
            lib.nemo_rice_decode.restype = ctypes.c_long
            lib.nemo_rice_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_int]
            _lib = lib
        except Exception:
            _lib_failed = True
    return _lib


_DTYPES = {1: np.uint8, 2: np.int16, 4: np.int32}


def rice_encode(arr, bytepix=None):
    """RICE_1-compress a 1-d integer array; returns bytes.

    Raises ValueError if the stream would expand pathologically (caller
    should fall back to GZIP for that tile).
    """
    arr = np.ascontiguousarray(arr)
    if bytepix is None:
        bytepix = arr.dtype.itemsize
    arr = arr.astype(_DTYPES[bytepix], copy=False)
    n = arr.size
    if n == 0:
        return b""
    cap = n * bytepix + n // 2 + 64
    lib = _load()
    if lib is not None:
        out = np.empty(cap, dtype=np.uint8)
        ln = lib.nemo_rice_encode(arr.ctypes.data, n, out.ctypes.data, cap,
                                  bytepix)
        if ln == -1:
            raise ValueError("RICE stream would overflow; use GZIP")
        if ln < 0:
            raise ValueError("RICE encode error %d" % ln)
        return out[:ln].tobytes()
    from . import rice_py
    return rice_py.encode(arr, bytepix)


def rice_decode(buf, npix, bytepix):
    """Decompress a RICE_1 stream into npix values of the given width."""
    if npix == 0:
        return np.zeros(0, dtype=_DTYPES[bytepix])
    buf = np.frombuffer(bytes(buf), dtype=np.uint8)
    lib = _load()
    if lib is not None:
        out = np.empty(npix, dtype=_DTYPES[bytepix])
        ln = lib.nemo_rice_decode(buf.ctypes.data, buf.size,
                                  out.ctypes.data, npix, bytepix)
        if ln != npix:
            raise ValueError("RICE decode error (%d of %d pixels)"
                             % (ln, npix))
        return out
    from . import rice_py
    return rice_py.decode(buf, npix, bytepix)


def using_native():
    """True when the compiled codec is in use (for tests/diagnostics)."""
    return _load() is not None
