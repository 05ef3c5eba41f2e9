// Whole-image encoders for tile-compressed FITS images with one image row
// per tile: every row of an image in one call, for RICE_1 (the coder of
// ``native/rice.cpp``) and for PLIO_1 (IRAF line lists, the same int16
// words as ``utils/fits._plio_encode``).
//
// Each call writes the rows' streams one after another into ``out`` and
// each row's length into ``lens``; a row the coder refuses (a Rice stream
// longer than the per-row capacity, a PLIO value outside [0, 2^27)) gets
// length -1 and no bytes, and the caller writes it to the gzip column.
// Built as a shared library and called through ctypes.

#include "../native/rice.cpp"

namespace {

// the per-row capacity of ``native.rice_encode``: a stream that does not
// fit is the overflow that sends a row to the gzip column
inline long rice_row_cap(long ncols, int bytepix) {
    return ncols * bytepix + ncols / 2 + 64;
}

template <typename T>
long rice_rows_t(const T *in, long nrows, long ncols, int bytepix,
                 unsigned char *out, long *lens) {
    const long cap = rice_row_cap(ncols, bytepix);
    long pos = 0;
    for (long r = 0; r < nrows; r++) {
        long ln = rice_encode_t(in + r * ncols, ncols, out + pos, cap,
                                bytepix);
        lens[r] = ln < 0 ? -1 : ln;
        if (ln > 0) pos += ln;
    }
    return pos;
}

inline void plio_put_run(int16_t *w, long &k, int64_t op, int64_t n) {
    while (n > 4095) { w[k++] = (int16_t)(op | 4095); n -= 4095; }
    if (n) w[k++] = (int16_t)(op | n);
}

// One row as an IRAF line list: the 7-word header, then per run of equal
// values a set-high op when the value changes (a relative step of at most
// 4095, else the absolute value in two words) and runs of at most 4095
// pixels; zeros are plain skip runs and leave the high value alone.
long plio_row(const int32_t *a, long n, int16_t *w) {
    for (long i = 0; i < n; i++)
        if (a[i] < 0 || a[i] >= (1 << 27)) return -1;
    long k = 7;
    int64_t hi = 1;
    long i = 0;
    while (i < n) {
        int64_t v = a[i];
        long j = i + 1;
        while (j < n && a[j] == v) j++;
        int64_t len = j - i;
        i = j;
        if (v == 0) {
            plio_put_run(w, k, 0, len);
            continue;
        }
        if (v != hi) {
            int64_t d = v - hi;
            if (d > 0 && d <= 4095) {
                w[k++] = (int16_t)((2 << 12) | d);
            } else if (d < 0 && d >= -4095) {
                w[k++] = (int16_t)((3 << 12) | (-d));
            } else {
                w[k++] = (int16_t)((1 << 12) | (v & 0xFFF));
                w[k++] = (int16_t)(v >> 12);
            }
            hi = v;
        }
        plio_put_run(w, k, 4 << 12, len);
    }
    long lllen = k;
    w[0] = 0;
    w[1] = 7;
    w[2] = -100;
    w[3] = (int16_t)(lllen & 0x7FFF);
    w[4] = (int16_t)(lllen >> 15);
    w[5] = 0;
    w[6] = 0;
    return k;
}

}  // namespace

extern "C" {

// ``out`` holds nrows x (ncols*bytepix + ncols/2 + 64) bytes.
long nemo_rice_encode_rows(const void *in, long nrows, long ncols,
                           int bytepix, unsigned char *out, long *lens) {
    if (bytepix == 1)
        return rice_rows_t((const uint8_t *)in, nrows, ncols, 1, out, lens);
    if (bytepix == 2)
        return rice_rows_t((const int16_t *)in, nrows, ncols, 2, out, lens);
    if (bytepix == 4)
        return rice_rows_t((const int32_t *)in, nrows, ncols, 4, out, lens);
    return -2;
}

// ``out`` holds nrows x (3*ncols + 7) words; lengths are in words.
long nemo_plio_encode_rows(const int32_t *in, long nrows, long ncols,
                           int16_t *out, long *lens) {
    long pos = 0;
    for (long r = 0; r < nrows; r++) {
        long ln = plio_row(in + r * ncols, ncols, out + pos);
        lens[r] = ln;
        if (ln > 0) pos += ln;
    }
    return pos;
}

}  // extern "C"
