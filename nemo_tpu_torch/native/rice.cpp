// RICE_1 codec for FITS tile compression (cfitsio-compatible bitstream).
//
// TPU-native replacement for the cfitsio Rice routines astropy uses when
// the reference writes compressed masks/RMS maps (``nemo/maps.py:533-605``,
// ``nemo/completeness.py:1686-1716``) and when reading RICE-compressed
// ACT/SO survey maps.  The format (per the FITS tiled-image convention):
//
//   * the first pixel value is stored raw, big-endian, in `bytepix` bytes;
//   * successive differences are mapped to unsigned (d>=0 -> 2d,
//     d<0 -> -2d-1) and coded in blocks of 32 with Golomb-Rice split `fs`:
//     a per-block `fs+1` field of fsbits bits (0 => all-zero block,
//     fsmax+1 => raw 8*bytepix-bit values), then per pixel the top bits in
//     unary (zeros terminated by a one) and the bottom `fs` bits verbatim.
//
// Built as a shared library and called through ctypes; a pure-python
// fallback with identical semantics lives in ``rice_py.py``.

#include <cstdint>
#include <cstring>

namespace {

struct BitWriter {
    unsigned char *out;
    long cap;
    long pos;       // byte position
    int bitsfree;   // bits free in current byte
    bool overflow;

    BitWriter(unsigned char *o, long c) : out(o), cap(c), pos(0),
                                          bitsfree(8), overflow(false) {
        if (cap > 0) out[0] = 0;
    }
    inline void put_bits(uint32_t val, int n) {
        // write the n low bits of val, MSB first
        while (n > 0) {
            if (pos >= cap) { overflow = true; return; }
            int take = n < bitsfree ? n : bitsfree;
            uint32_t chunk = (val >> (n - take)) & ((1u << take) - 1u);
            out[pos] |= (unsigned char)(chunk << (bitsfree - take));
            bitsfree -= take;
            n -= take;
            if (bitsfree == 0) {
                pos++;
                bitsfree = 8;
                if (pos < cap) out[pos] = 0;
            }
        }
    }
    inline void put_unary(uint32_t nzeros) {
        while (nzeros >= 24) { put_bits(0, 24); nzeros -= 24; if (overflow) return; }
        put_bits(1u, (int)nzeros + 1);  // nzeros zeros then a one
    }
    long finish() {
        if (overflow) return -1;
        return bitsfree == 8 ? pos : pos + 1;
    }
};

struct BitReader {
    const unsigned char *in;
    long n;
    long pos;
    int bitsleft;

    BitReader(const unsigned char *i, long nn) : in(i), n(nn), pos(0),
                                                 bitsleft(8) {}
    inline int get_bit() {
        if (pos >= n) return -1;
        int b = (in[pos] >> (bitsleft - 1)) & 1;
        if (--bitsleft == 0) { bitsleft = 8; pos++; }
        return b;
    }
    inline int64_t get_bits(int nb) {
        uint64_t v = 0;
        for (int k = 0; k < nb; k++) {
            int b = get_bit();
            if (b < 0) return -1;
            v = (v << 1) | (uint64_t)b;
        }
        return (int64_t)v;
    }
    inline int64_t get_unary() {
        int64_t c = 0;
        for (;;) {
            int b = get_bit();
            if (b < 0) return -1;
            if (b) return c;
            c++;
        }
    }
};

struct Params { int fsbits, fsmax, bbits; };

inline Params params_for(int bytepix) {
    if (bytepix == 1) return {3, 6, 8};
    if (bytepix == 2) return {4, 14, 16};
    return {5, 25, 32};
}

template <typename T>
long rice_encode_t(const T *a, long nx, unsigned char *out, long outcap,
                   int bytepix) {
    if (nx <= 0) return 0;
    Params P = params_for(bytepix);
    const int nblock = 32;

    long hdr = bytepix;
    if (outcap < hdr) return -1;
    // first pixel raw, big-endian
    uint32_t first = (uint32_t)a[0];
    for (int k = 0; k < bytepix; k++)
        out[k] = (unsigned char)(first >> (8 * (bytepix - 1 - k)));

    BitWriter bw(out + hdr, outcap - hdr);
    // Differences wrap at the pixel width so mapped values fit in bbits
    // (the decoder accumulates mod 2^bbits, so this is lossless).
    const int shift = 32 - P.bbits;
    uint32_t lastpix = (uint32_t)a[0];
    uint32_t diffs[nblock];

    for (long i = 0; i < nx; i += nblock) {
        int thisblock = (int)((nx - i) < nblock ? (nx - i) : nblock);
        double pixelsum = 0.0;
        for (int j = 0; j < thisblock; j++) {
            uint32_t pix = (uint32_t)a[i + j];
            int32_t d = (int32_t)((pix - lastpix) << shift) >> shift;
            lastpix = pix;
            uint32_t m = d >= 0 ? ((uint32_t)d << 1)
                                : ~(((uint32_t)d) << 1);
            if (P.bbits < 32) m &= (1u << P.bbits) - 1u;
            diffs[j] = m;
            pixelsum += (double)m;
        }
        // cfitsio's fs heuristic
        double dpsum = (pixelsum - thisblock / 2.0 - 1.0) / thisblock;
        if (dpsum < 0) dpsum = 0.0;
        uint32_t psum = ((uint32_t)dpsum) >> 1;
        int fs;
        for (fs = 0; psum > 0; fs++) psum >>= 1;

        if (fs == 0 && pixelsum == 0.0) {
            bw.put_bits(0, P.fsbits);
        } else if (fs >= P.fsmax) {
            bw.put_bits((uint32_t)(P.fsmax + 1), P.fsbits);
            for (int j = 0; j < thisblock; j++)
                bw.put_bits(diffs[j], P.bbits);
        } else {
            bw.put_bits((uint32_t)(fs + 1), P.fsbits);
            for (int j = 0; j < thisblock; j++) {
                bw.put_unary(diffs[j] >> fs);
                if (fs > 0) bw.put_bits(diffs[j] & ((1u << fs) - 1u), fs);
                if (bw.overflow) return -1;
            }
        }
        if (bw.overflow) return -1;
    }
    long body = bw.finish();
    return body < 0 ? -1 : hdr + body;
}

template <typename T>
long rice_decode_t(const unsigned char *in, long nin, T *out, long nx,
                   int bytepix) {
    if (nx <= 0) return 0;
    Params P = params_for(bytepix);
    const int nblock = 32;
    if (nin < bytepix) return -1;

    const uint32_t mask = P.bbits < 32 ? (1u << P.bbits) - 1u : 0xFFFFFFFFu;
    uint32_t lastpix = 0;
    for (int k = 0; k < bytepix; k++)
        lastpix = (lastpix << 8) | in[k];

    BitReader br(in + bytepix, nin - bytepix);
    for (long i = 0; i < nx; i += nblock) {
        int thisblock = (int)((nx - i) < nblock ? (nx - i) : nblock);
        int64_t fsv = br.get_bits(P.fsbits);
        if (fsv < 0) return -1;
        int fs = (int)fsv - 1;
        if (fs < 0) {
            for (int j = 0; j < thisblock; j++) out[i + j] = (T)lastpix;
        } else if (fs == P.fsmax) {
            for (int j = 0; j < thisblock; j++) {
                int64_t raw = br.get_bits(P.bbits);
                if (raw < 0) return -1;
                uint32_t m = (uint32_t)raw;
                int32_t d = (m & 1u) ? (int32_t)~(m >> 1)
                                     : (int32_t)(m >> 1);
                lastpix = (uint32_t)((int32_t)lastpix + d) & mask;
                out[i + j] = (T)lastpix;
            }
        } else {
            for (int j = 0; j < thisblock; j++) {
                int64_t top = br.get_unary();
                if (top < 0) return -1;
                uint32_t m = (uint32_t)top << fs;
                if (fs > 0) {
                    int64_t bot = br.get_bits(fs);
                    if (bot < 0) return -1;
                    m |= (uint32_t)bot;
                }
                int32_t d = (m & 1u) ? (int32_t)~(m >> 1)
                                     : (int32_t)(m >> 1);
                lastpix = (uint32_t)((int32_t)lastpix + d) & mask;
                out[i + j] = (T)lastpix;
            }
        }
    }
    return nx;
}

}  // namespace

extern "C" {

long nemo_rice_encode(const void *in, long nx, unsigned char *out,
                      long outcap, int bytepix) {
    if (bytepix == 1)
        return rice_encode_t((const uint8_t *)in, nx, out, outcap, 1);
    if (bytepix == 2)
        return rice_encode_t((const int16_t *)in, nx, out, outcap, 2);
    if (bytepix == 4)
        return rice_encode_t((const int32_t *)in, nx, out, outcap, 4);
    return -2;
}

long nemo_rice_decode(const unsigned char *in, long nin, void *out, long nx,
                      int bytepix) {
    if (bytepix == 1)
        return rice_decode_t(in, nin, (uint8_t *)out, nx, 1);
    if (bytepix == 2)
        return rice_decode_t(in, nin, (int16_t *)out, nx, 2);
    if (bytepix == 4)
        return rice_decode_t(in, nin, (int32_t *)out, nx, 4);
    return -2;
}

}  // extern "C"
