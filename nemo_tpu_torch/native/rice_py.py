"""Pure-python RICE_1 codec, bit-identical to the C++ one (``rice.cpp``).

Used only when no compiler is available; also serves as the readable
specification of the bitstream for review and as the oracle in tests.
"""

import numpy as np

_PARAMS = {1: (3, 6, 8), 2: (4, 14, 16), 4: (5, 25, 32)}
_DTYPES = {1: np.uint8, 2: np.int16, 4: np.int32}


class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, val, n):
        self.acc = (self.acc << n) | (int(val) & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.bytes.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def put_unary(self, nzeros):
        while nzeros >= 24:
            self.put(0, 24)
            nzeros -= 24
        self.put(1, nzeros + 1)

    def finish(self):
        if self.nbits:
            self.bytes.append((self.acc << (8 - self.nbits)) & 0xFF)
        return bytes(self.bytes)


class _BitReader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def get(self, n):
        while self.nbits < n:
            if self.pos >= len(self.buf):
                raise ValueError("RICE stream truncated")
            self.acc = (self.acc << 8) | self.buf[self.pos]
            self.pos += 1
            self.nbits += 8
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def get_unary(self):
        c = 0
        while True:
            if self.get(1):
                return c
            c += 1


def encode(arr, bytepix):
    fsbits, fsmax, bbits = _PARAMS[bytepix]
    mask = (1 << bbits) - 1
    half = 1 << (bbits - 1)
    a = np.ascontiguousarray(arr).astype(_DTYPES[bytepix]).view(
        np.uint8 if bytepix == 1 else
        np.uint16 if bytepix == 2 else np.uint32).astype(np.int64)
    n = a.size
    if n == 0:
        return b""
    out = bytearray(int(a[0]).to_bytes(bytepix, "big"))
    bw = _BitWriter()
    last = int(a[0])
    for i in range(0, n, 32):
        block = a[i:i + 32]
        diffs = []
        psum = 0
        for pix in block:
            d = (int(pix) - last) & mask
            if d >= half:
                d -= 1 << bbits
            last = int(pix)
            m = (d << 1) if d >= 0 else (~(d << 1)) & mask
            m &= mask
            diffs.append(m)
            psum += m
        nb = len(block)
        dpsum = (psum - nb / 2.0 - 1.0) / nb
        if dpsum < 0:
            dpsum = 0.0
        p = int(dpsum) >> 1
        fs = 0
        while p > 0:
            p >>= 1
            fs += 1
        if fs == 0 and psum == 0:
            bw.put(0, fsbits)
        elif fs >= fsmax:
            bw.put(fsmax + 1, fsbits)
            for m in diffs:
                bw.put(m, bbits)
        else:
            bw.put(fs + 1, fsbits)
            for m in diffs:
                bw.put_unary(m >> fs)
                if fs:
                    bw.put(m & ((1 << fs) - 1), fs)
    out += bw.finish()
    return bytes(out)


def decode(buf, npix, bytepix):
    fsbits, fsmax, bbits = _PARAMS[bytepix]
    mask = (1 << bbits) - 1
    half = 1 << (bbits - 1)
    buf = bytes(buf)
    last = int.from_bytes(buf[:bytepix], "big")
    br = _BitReader(buf[bytepix:])
    out = np.zeros(npix, dtype=np.int64)
    for i in range(0, npix, 32):
        nb = min(32, npix - i)
        fs = br.get(fsbits) - 1
        if fs < 0:
            out[i:i + nb] = last
        elif fs == fsmax:
            for j in range(nb):
                m = br.get(bbits)
                d = (m >> 1) if (m & 1) == 0 else (~(m >> 1))
                last = (last + d) & mask
                out[i + j] = last
        else:
            for j in range(nb):
                m = (br.get_unary() << fs) | (br.get(fs) if fs else 0)
                d = (m >> 1) if (m & 1) == 0 else (~(m >> 1))
                last = (last + d) & mask
                out[i + j] = last
    u = out.astype(np.uint32)
    if bytepix == 1:
        return u.astype(np.uint8)
    if bytepix == 2:
        return u.astype(np.uint16).view(np.int16).copy()
    return u.view(np.int32).copy() if u.dtype == np.int32 \
        else u.astype(np.uint32).view(np.int32).copy()
