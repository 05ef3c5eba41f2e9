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
// Reads outside the padded map count as zero (invalid), so a table entry
// can never read out of bounds; there is no (8, 128) anchor alignment.
//
// What bounds it: operations.  Each of the 11 stages (seed + 10 clips) is
// two sweeps over the window, each closed by a block reduction: ~7
// operations per window pixel and stage, while the map itself is read
// once.  Two variants, chosen by the wrapper from the window's bytes:
//
// staged (rms_cells_staged_kernel): one 512-thread block per (tile, cell)
//   copies the cell's clipped extent into shared memory once with cp.async
//   (a 162 x 162 float32 window is 105 KB, two blocks an SM; float64
//   210 KB) and runs its sweeps from there, 16 bytes a load: the
//   sweeps are bound by instruction issue, so a vector load saves three
//   loads and their index arithmetic, and the clip sweeps' mean pass
//   skips the v != 0 test (a zero adds nothing to the sum, and the cell's
//   zero count comes off the count).  Exact shortcut: the clips stop at
//   the first iteration whose threshold equals the last one's (a fixed
//   point: the remaining iterations would repeat it bit for bit).  Each
//   sweep reduces (sum, count) together behind one barrier: warp
//   shuffles, then double-buffered warp partials that every thread sums
//   in the same fixed order (deterministic).  A cell with no good pixel
//   stops after the seed sweep.
//
// streaming (rms_cells_kernel, the first design): one 256-thread block per
//   (tile, cell) re-reads the window from L2 on each of the 22 sweeps, two
//   barriers per reduction.  It serves windows that do not fit a block's
//   shared memory: the whole-map single cell, and float64 windows past
//   232,448 B.
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


// ---- staged variant ---------------------------------------------------------

constexpr int kStagedThreads = 512;
constexpr int kStagedWarps = kStagedThreads / 32;
// the most dynamic shared memory a window may take: the 232,448 B a block
// may use, less a reserve for the static warp partials
constexpr int kStagedMaxWindowBytes = 232448 - 1024;

// 16-byte shared-memory loads: four float or two double values at once.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, int i, float (&v)[4]) {
    const float4 x = reinterpret_cast<const float4*>(p)[i];
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};
template <>
struct Vec<double> {
  static constexpr int n = 2;
  __device__ static void load(const double* p, int i, double (&v)[2]) {
    const double2 x = reinterpret_cast<const double2*>(p)[i];
    v[0] = x.x;
    v[1] = x.y;
  }
};

// One asynchronous copy of a T from device to shared memory (cp.async:
// every copy of a thread is in flight at once, with no register staging).
template <typename T>
__device__ __forceinline__ void copy_async(T* shared, const T* global) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(global), "n"(sizeof(T)));
}

template <typename T>
struct Partials {
  T v[2][kStagedWarps];
  int n[2][kStagedWarps];
};

// Block-wide sums of (value, count), returned to every thread, behind one
// barrier: reduction k writes buffer k % 2, and a thread reaches reduction
// k + 2's writes only after barrier k + 1, which every reader of reduction
// k has passed.
template <typename T>
__device__ void staged_sum2(T& v, int& n, Partials<T>& p, int& parity) {
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, o);
    n += __shfl_down_sync(0xffffffffu, n, o);
  }
  if ((threadIdx.x & 31) == 0) {
    p.v[parity][threadIdx.x >> 5] = v;
    p.n[parity][threadIdx.x >> 5] = n;
  }
  __syncthreads();
  T tv = T(0);
  int tn = 0;
#pragma unroll
  for (int w = 0; w < kStagedWarps; ++w) {
    tv += p.v[parity][w];
    tn += p.n[parity][w];
  }
  v = tv;
  n = tn;
  parity ^= 1;
}

// staged_sum2 for a value alone.
template <typename T>
__device__ void staged_sum(T& v, Partials<T>& p, int& parity) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) p.v[parity][threadIdx.x >> 5] = v;
  __syncthreads();
  T tv = T(0);
#pragma unroll
  for (int w = 0; w < kStagedWarps; ++w) tv += p.v[parity][w];
  v = tv;
  parity ^= 1;
}

template <typename T>
__global__ void __launch_bounds__(kStagedThreads)
rms_cells_staged_kernel(const T* __restrict__ padded,
                        const int* __restrict__ sy, const int* __restrict__ sx,
                        const int* __restrict__ ly, const int* __restrict__ lx,
                        int nCells, int PY, int PX, int Wy, int Wx,
                        T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char staged_raw[];
  T* win = reinterpret_cast<T*>(staged_raw);
  __shared__ Partials<T> part;
  int parity = 0;
  const int cell = blockIdx.x;
  const int t = cell / nCells;
  const int y0 = sy[cell];
  const int x0 = sx[cell];
  const int yb = max(0, -y0);
  const int xb = max(0, -x0);
  const int h = max(0, min(min(ly[cell], Wy), PY - y0) - yb);
  const int w = max(0, min(min(lx[cell], Wx), PX - x0) - xb);
  const int n = h * w;
  const T* base = padded + static_cast<size_t>(t) * PY * PX
      + static_cast<size_t>(y0 + yb) * PX + (x0 + xb);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < h; r += kStagedWarps) {
    const T* row = base + static_cast<size_t>(r) * PX;
    for (int c = lane; c < w; c += 32) copy_async(win + r * w + c, row + c);
  }
  // the window is swept in vectors of V values; zeros (invalid pixels)
  // fill the last one
  constexpr int V = Vec<T>::n;
  const int nv = (n + V - 1) / V;
  if (threadIdx.x < nv * V - n) win[n + threadIdx.x] = T(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Sweep helper: BODY runs on each value v of this thread's vectors.
#define NEMO_FOR_STAGED(BODY)                                           \
  for (int i = threadIdx.x; i < nv; i += kStagedThreads) {              \
    T vals[V];                                                          \
    Vec<T>::load(win, i, vals);                                         \
    _Pragma("unroll") for (int k = 0; k < V; ++k) {                     \
      const T v = vals[k];                                              \
      BODY                                                              \
    }                                                                   \
  }

  // seed: n0, mean, two-pass sigma of the good pixels
  T s = T(0);
  int n0 = 0;
  NEMO_FOR_STAGED(if (v != T(0)) {
    s += v;
    ++n0;
  })
  staged_sum2(s, n0, part, parity);
  if (n0 == 0) {
    if (threadIdx.x == 0) out[cell] = T(0);
    return;
  }
  T mean = s / static_cast<T>(n0);
  T q = T(0);
  NEMO_FOR_STAGED(if (v != T(0)) {
    const T d = v - mean;
    q += d * d;
  })
  staged_sum(q, part, parity);
  // zero values swept, window padding included: the clip sweeps below add
  // a zero value when |0| < thr (an exact no-op on the sum) and take them
  // back out of the count
  const int zeros = nv * V - n0;
  T rms = sqrt(q / static_cast<T>(n0));

  T lastThr = T(0);
  for (int it = 0; it < kIterations; ++it) {
    const T thr = fabs(mean + T(3) * rms);
    // A threshold equal to the last one clips the same set, whose
    // statistics (summed in the same order) are the ones in hand: every
    // later iteration repeats this one, so the result is final.
    if (it > 0 && thr == lastThr) break;
    lastThr = thr;
    T sm = T(0);
    int nm = 0;
    NEMO_FOR_STAGED(if (fabs(v) < thr) {
      sm += v;
      ++nm;
    })
    staged_sum2(sm, nm, part, parity);
    if (T(0) < thr) nm -= zeros;
    const T newMean = sm / static_cast<T>(max(nm, 1));
    T qm = T(0);
    NEMO_FOR_STAGED(if (v != T(0) && fabs(v) < thr) {
      const T d = v - newMean;
      qm += d * d;
    })
    staged_sum(qm, part, parity);
    if (nm > 0) {
      mean = newMean;
      rms = sqrt(qm / static_cast<T>(nm));
    }
  }
#undef NEMO_FOR_STAGED
  if (threadIdx.x == 0) out[cell] = rms;
}

template <typename T>
int launch_staged(const void* padded, const void* sy, const void* sx,
                  const void* ly, const void* lx, int nT, int nCells, int PY,
                  int PX, int Wy, int Wx, void* out, void* stream) {
  const long long window = static_cast<long long>(Wy) * Wx * sizeof(T);
  if (Wy <= 0 || Wx <= 0 || window > kStagedMaxWindowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = window + 16;   // room for the zero-filled tail
  const long long blocks = static_cast<long long>(nT) * nCells;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      rms_cells_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_cells_staged_kernel<T><<<static_cast<unsigned>(blocks), kStagedThreads,
                               static_cast<size_t>(bytes),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(padded), static_cast<const int*>(sy),
      static_cast<const int*>(sx), static_cast<const int*>(ly),
      static_cast<const int*>(lx), nCells, PY, PX, Wy, Wx,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The streaming variant.
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

// The staged variant: the same arguments.  Refuses (cudaErrorInvalidValue)
// a window of more than nemo_rms_cells_staged_max_bytes() bytes.
int nemo_rms_cells_staged_max_bytes(void) { return kStagedMaxWindowBytes; }

int nemo_rms_cells_staged_f32(const void* padded, const void* sy,
                              const void* sx, const void* ly, const void* lx,
                              int nT, int nCells, int PY, int PX, int Wy,
                              int Wx, void* out, void* stream) {
  return launch_staged<float>(padded, sy, sx, ly, lx, nT, nCells, PY, PX, Wy,
                              Wx, out, stream);
}

int nemo_rms_cells_staged_f64(const void* padded, const void* sy,
                              const void* sx, const void* ly, const void* lx,
                              int nT, int nCells, int PY, int PX, int Wy,
                              int Wx, void* out, void* stream) {
  return launch_staged<double>(padded, sy, sx, ly, lx, nT, nCells, PY, PX,
                               Wy, Wx, out, stream);
}

}  // extern "C"
