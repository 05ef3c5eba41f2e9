// Per-cell 3-sigma-clipped RMS of a zero-padded map batch: the noise-map
// statistics of the matched-filter S/N.
//
// Replaces the TPU Pallas kernel nemo_tpu/ops/noise.py:_rms_cell_kernel
// (launched by _grid_rms_cells_pallas).  Same arithmetic, cell by cell:
//   good  = pixel != 0 inside [start, start + len) of the cell window;
//   seed  = count n0, mean and two-pass sigma of the good pixels;
//   10 fixed iterations: m = good & |v| < |mean + 3 sigma|; if m is not
//         empty, mean/sigma <- mean and two-pass sigma of m (else keep);
//   out   = sigma, or 0 when n0 == 0 (empty cell or unused slot, len 0).
// Sums accumulate in the input type, as on the TPU.  The variance stays
// two-pass: a one-pass E[v^2] - mean^2 loses the parity in float32.
//
// Design: one block of 256 threads per (tile, cell).  Each warp takes whole
// rows of the window, so a warp's 32 loads are neighbouring addresses.
// Each of the 11 stages (seed + 10 iterations) is two sweeps over the
// window, each closed by a block reduction (warp shuffles, then the 8 warp
// partials in shared memory, summed in a fixed order: deterministic).
// There is no (8, 128) anchor alignment and no in-window offset: the block
// reads from the window's true start.  Reads outside the padded map count
// as zero (invalid), so a table entry can never read out of bounds.
//
// What bounds it: bytes re-read, not arithmetic.  The window is read 22
// times (11 stages x 2 sweeps); a 240 x 240 float32 window is 230,400 B,
// and a 896 x 1536 float32 tile is 5.5 MB, so the re-reads hit L2 (50 MB),
// not HBM.  A faster version would stage the window in shared memory once
// (230,400 B fits the 232,448 B a block may use in float32; float64 does
// not fit and would need a thread-block cluster's distributed shared
// memory or registers), and fuse the two sweeps of a stage with a
// compensated one-pass update.
//
// Built by nemo_tpu_torch/cuda_build.py with nvcc for sm_90a and loaded
// with ctypes; the entry points below are plain C.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIterations = 10;

// Block-wide sums of (value, count), returned to every thread.  The leading
// __syncthreads() keeps the previous reduction's readers off `sh`.
template <typename T>
__device__ void block_sum2(T& v, int& n, T* shv, int* shn) {
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, o);
    n += __shfl_down_sync(0xffffffffu, n, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    shv[warp] = v;
    shn[warp] = n;
  }
  __syncthreads();
  T tv = T(0);
  int tn = 0;
  for (int w = 0; w < kWarps; ++w) {
    tv += shv[w];
    tn += shn[w];
  }
  v = tv;
  n = tn;
}

template <typename T>
__device__ T block_sum(T v, T* shv) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) shv[warp] = v;
  __syncthreads();
  T tv = T(0);
  for (int w = 0; w < kWarps; ++w) tv += shv[w];
  return tv;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_cells_kernel(const T* __restrict__ padded, const int* __restrict__ sy,
                 const int* __restrict__ sx, const int* __restrict__ ly,
                 const int* __restrict__ lx, int nCells, int PY, int PX,
                 int Wy, int Wx, T* __restrict__ out) {
  __shared__ T shv[kWarps];
  __shared__ int shn[kWarps];
  const int cell = blockIdx.x;
  const int t = cell / nCells;
  const int y0 = sy[cell];
  const int x0 = sx[cell];
  // the cell's extent, clipped to the window and to the map
  const int yb = max(0, -y0);
  const int xb = max(0, -x0);
  const int ye = min(min(ly[cell], Wy), PY - y0);
  const int xe = min(min(lx[cell], Wx), PX - x0);
  const T* base = padded + static_cast<size_t>(t) * PY * PX;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Sweep helpers: every good pixel with |v| < thr (thr = +inf: all good).
#define NEMO_FOR_PIXELS(BODY)                                               \
  for (int r = yb + warp; r < ye; r += kWarps) {                            \
    const T* row = base + static_cast<size_t>(y0 + r) * PX + x0;            \
    for (int c = xb + lane; c < xe; c += 32) {                              \
      const T v = row[c];                                                   \
      BODY                                                                  \
    }                                                                       \
  }

  // seed: n0, mean, two-pass sigma of the good pixels
  T s = T(0);
  int n0 = 0;
  NEMO_FOR_PIXELS(if (v != T(0)) { s += v; ++n0; })
  block_sum2(s, n0, shv, shn);
  T mean = s / static_cast<T>(max(n0, 1));
  T q = T(0);
  NEMO_FOR_PIXELS(if (v != T(0)) { const T d = v - mean; q += d * d; })
  q = block_sum(q, shv);
  T rms = sqrt(q / static_cast<T>(max(n0, 1)));

  for (int it = 0; it < kIterations; ++it) {
    const T thr = fabs(mean + T(3) * rms);
    T sm = T(0);
    int nm = 0;
    NEMO_FOR_PIXELS(if (v != T(0) && fabs(v) < thr) { sm += v; ++nm; })
    block_sum2(sm, nm, shv, shn);
    const T newMean = sm / static_cast<T>(max(nm, 1));
    T qm = T(0);
    NEMO_FOR_PIXELS(if (v != T(0) && fabs(v) < thr) {
      const T d = v - newMean;
      qm += d * d;
    })
    qm = block_sum(qm, shv);
    if (nm > 0) {
      mean = newMean;
      rms = sqrt(qm / static_cast<T>(nm));
    }
  }
#undef NEMO_FOR_PIXELS
  if (threadIdx.x == 0) out[cell] = n0 > 0 ? rms : T(0);
}

template <typename T>
int launch(const void* padded, const void* sy, const void* sx,
           const void* ly, const void* lx, int nT, int nCells, int PY,
           int PX, int Wy, int Wx, void* out, void* stream) {
  const long long blocks = static_cast<long long>(nT) * nCells;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  rms_cells_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(padded), static_cast<const int*>(sy),
      static_cast<const int*>(sx), static_cast<const int*>(ly),
      static_cast<const int*>(lx), nCells, PY, PX, Wy, Wx,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// padded: (nT, PY, PX) contiguous; sy/sx/ly/lx: int32 (nT, nCells), the
// window anchors and effective extents (len + 2 * overlap, 0 = unused
// slot); out: (nT, nCells).  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
int nemo_rms_cells_f32(const void* padded, const void* sy, const void* sx,
                       const void* ly, const void* lx, int nT, int nCells,
                       int PY, int PX, int Wy, int Wx, void* out,
                       void* stream) {
  return launch<float>(padded, sy, sx, ly, lx, nT, nCells, PY, PX, Wy, Wx,
                       out, stream);
}

int nemo_rms_cells_f64(const void* padded, const void* sy, const void* sx,
                       const void* ly, const void* lx, int nT, int nCells,
                       int PY, int PX, int Wy, int Wx, void* out,
                       void* stream) {
  return launch<double>(padded, sy, sx, ly, lx, nT, nCells, PY, PX, Wy, Wx,
                        out, stream);
}

}  // extern "C"
