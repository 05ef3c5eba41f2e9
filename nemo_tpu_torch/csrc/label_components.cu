// 4-connected component labels of a (T, ny, nx) bool mask by a fixed number
// of Jacobi passes of neighbour-label minimisation: the segmentation step of
// on-device detection.
//
// Replaces nemo_tpu/ops/detect.py:label_components (XLA code, not a Pallas
// kernel).  Same function, bit for bit:
//   lab   = mask ? flat index (within the tile) : 2^30;
//   n_iter passes: lab = mask ? min(lab, the 4 neighbours' previous labels)
//                             : 2^30, out-of-map neighbours counting 2^30.
// A component that needs more passes than n_iter splits exactly as in the
// reference (union-find would merge it whole and change the catalog).
//
// What bounds it on this card: bytes.  The work depends on the data and is
// small (significant pixels are a few percent of an S/N map); the least the
// function must move is the uint8 mask read once and the int32 labels
// written once.  The eager torch version sweeps the whole int32 batch six
// times per pass, 128 passes.
//
// Design (temporal blocking): a block owns a kTile x kTile interior plus a
// halo of kHalo pixels, loads labels (or, in the first launch, the mask)
// once into shared memory and runs up to kHalo passes there, double
// buffered; pass p is computed on the region shrunk by p rings, whose
// values are exact, so after kHalo passes the interior is exact and is
// written back.  ceil(n_iter / kHalo) launches replace 128 x 6 sweeps; the
// last runs the remainder.  Exact shortcuts:
//   - mask <=> label < 2^30 holds at every pass, so a block whose haloed
//     region holds no label below 2^30 writes 2^30 and exits;
//   - labels only decrease, so a pass that changes nothing in a block's
//     region makes every later pass of that launch the identity there
//     (the block stops early);
//   - if the first pass of a launch changes nothing anywhere, F(x) = x for
//     the whole batch (the launch is recorded as unchanged in `changed`),
//     so the launch's input and output buffers are equal and final: every
//     later launch returns at once, with no host synchronisation.
//
// Built by nemo_tpu_torch/cuda_build.py with nvcc for sm_90a and loaded
// with ctypes; the entry points below are plain C.

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kTile = 64;                    // interior, both axes
constexpr int kHalo = 16;                    // passes per launch
constexpr int kRegion = kTile + 2 * kHalo;   // 96
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 16;
constexpr int kCols = kRegion / kThreadsX;   // 3 region columns a thread
constexpr int kRows = kRegion / kThreadsY;   // 6 region rows a thread
constexpr size_t kSharedBytes = 2 * kRegion * kRegion * sizeof(int);

static_assert(kRegion % kThreadsX == 0 && kRegion % kThreadsY == 0,
              "the region must split evenly over the threads");

// launch: index of this launch (0 reads the mask, later ones `src`);
// passes: Jacobi passes to run (<= kHalo); changed[launch] is set to 1 when
// the launch's first pass changed a label.
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
label_kernel(const unsigned char* __restrict__ mask,
             const int* __restrict__ src, int* __restrict__ dst,
             int* __restrict__ changed, int launch, int passes, int ny,
             int nx) {
  if (launch >= 2 && changed[launch - 1] == 0) return;   // already final
  extern __shared__ int shared[];
  int* a = shared;
  int* b = shared + kRegion * kRegion;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int y0 = blockIdx.y * kTile - kHalo;
  const int x0 = blockIdx.x * kTile - kHalo;
  const size_t base = static_cast<size_t>(blockIdx.z) * ny * nx;

  int any = 0;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int r = ty + kThreadsY * m;
    const int y = y0 + r;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = tx + kThreadsX * k;
      const int x = x0 + c;
      int v = kBig;
      if (y >= 0 && y < ny && x >= 0 && x < nx) {
        const int i = y * nx + x;
        if (launch == 0) {
          v = mask[base + i] ? i : kBig;
        } else {
          v = src[base + i];
        }
      }
      a[r * kRegion + c] = v;
      any |= v != kBig;
    }
  }

  if (__syncthreads_or(any)) {
    for (int p = 1; p <= passes; ++p) {
      int moved = 0;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int r = ty + kThreadsY * m;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int c = tx + kThreadsX * k;
          if (r >= p && r < kRegion - p && c >= p && c < kRegion - p) {
            const int at = r * kRegion + c;
            int v = a[at];
            if (v != kBig) {
              const int n = min(min(a[at - kRegion], a[at + kRegion]),
                                min(a[at - 1], a[at + 1]));
              if (n < v) {
                v = n;
                moved = 1;
              }
            }
            b[at] = v;
          }
        }
      }
      // one barrier per pass: it also keeps pass p + 1's writes to `a`
      // behind every read of it in pass p
      moved = __syncthreads_or(moved);
      int* t = a;
      a = b;
      b = t;
      if (!moved) break;
      if (p == 1 && tx == 0 && ty == 0) changed[launch] = 1;
    }
  }

#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int r = ty + kThreadsY * m;
    const int y = y0 + r;
    if (r < kHalo || r >= kHalo + kTile || y >= ny) continue;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = tx + kThreadsX * k;
      const int x = x0 + c;
      if (c < kHalo || c >= kHalo + kTile || x >= nx) continue;
      dst[base + static_cast<size_t>(y) * nx + x] = a[r * kRegion + c];
    }
  }
}

}  // namespace

extern "C" {

// Passes each launch runs (the halo width); the wrapper sizes `changed` and
// picks the output buffer from it.
int nemo_label_passes_per_launch(void) { return kHalo; }

// mask: (T, ny, nx) contiguous bool/uint8; buf0, buf1: (T, ny, nx) int32
// scratch, launch j writing buf[j % 2]; changed: int32 (launches,), zeroed
// by the caller, launches = max(1, ceil(n_iter / kHalo)).  The labels end in
// buf[(launches - 1) % 2].  Launches on `stream`, allocates nothing and
// returns the first non-zero cudaGetLastError() (0 = every launch queued).
int nemo_label_components(const void* mask, void* buf0, void* buf1,
                          void* changed, int T, int ny, int nx, int n_iter,
                          void* stream) {
  if (T <= 0 || ny <= 0 || nx <= 0) return static_cast<int>(cudaGetLastError());
  if (n_iter < 0 || static_cast<long long>(ny) * nx >= kBig)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      label_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSharedBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nx + kTile - 1) / kTile, (ny + kTile - 1) / kTile, T);
  const dim3 block(kThreadsX, kThreadsY);
  const int launches = n_iter == 0 ? 1 : (n_iter + kHalo - 1) / kHalo;
  int* bufs[2] = {static_cast<int*>(buf0), static_cast<int*>(buf1)};
  for (int j = 0; j < launches; ++j) {
    const int passes = j == launches - 1 ? n_iter - j * kHalo : kHalo;
    label_kernel<<<grid, block, kSharedBytes,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(mask), bufs[(j + 1) % 2],
        bufs[j % 2], static_cast<int*>(changed), j, passes, ny, nx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
