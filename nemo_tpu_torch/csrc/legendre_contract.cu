// Associated-Legendre contraction on CAR iso-latitude rings, for Hopper.
//
// Replaces nemo_tpu/ops/sht.py:_legendre_contract (an XLA lax.scan of
// lmax+1 dependent steps over (mmax+1) x nrings lanes; the JAX package has no
// Pallas kernel for it).  Two directions, each in float32 and float64:
//
//   synthesis  F[m, r]       = sum_l alm[l, m] lambda_lm(theta_r)
//   analysis   alm[l, m]     = sum_r G[m, r] w_r lambda_lm(theta_r)
//
// lambda_lm is evaluated by the scaled three-term recurrence in l of the
// reference: each (m, ring) lane carries P (this l), Pp (l - 1) and an
// exponent S, seeded at l = m from the wrapper's tables (the seed mantissa
// and exponent are computed there with the plain version's torch
// expressions), and renormalised by hops of min(96, -S) once |P| > 2^48,
// with S never crossing 0.  Every float expression is the reference's, in
// its order, and the library is built with -fmad=false and without
// -ftz / fast math: exp2(S) for S in [-149, -126] is a float32 denormal in
// the plain version too, and `4 l^2 - 1` rounds in float32 above l ~ 2,900
// as it does there.  So synthesis is bitwise equal to the plain version.
//
// What bounds it: issued instructions.  A lane-step (one (m, ring) lane at
// one l) is ~10 float operations, each issued alone under -fmad=false (so
// at most half the published float32 rate; in float64 the half-rate
// float64 pipe), and alm is read once (~0.1 ms of bytes at lmax 6,000).
// A design of one thread a lane (as analysis has) issues about as much
// again per lane-step: four shared loads, the seed test, loop control and
// a hop branch; and with several blocks per m, each repeats the m's
// factor fill.
//
// Synthesis (synthesis_kernel) is designed against that:
//
// * K rings a thread (4 in float32, 2 in float64, by measurement: SynRings
//   below).  A thread runs K (m, ring) lanes of one m from l = m to
//   lmax: the per-l factors are loaded once from shared memory for all K
//   (one 16-byte load in float32), the loop control and the hop branch are
//   paid once, and the K independent recurrence chains interleave.  The
//   lanes with m > l, which the scan evaluates and masks, are never run:
//   that halves the work and changes no value (at l = m + 1, b = 0 and
//   Pp = 0).  The seed step (l = m) is taken before the loop, so the loop
//   has no seed test.
// * Hops are rare (~0.6% of lane-steps at lmax 6,000 on a dec -58 tile),
//   so one warp-uniform branch (__any_sync) an l covers the K lanes of all
//   32 threads, and a warp's K x 32 rings are contiguous (slot k of lane i
//   runs ring 32 k + i of the warp's run): neighbouring rings hop at nearby
//   l, so the branch is taken in ~10% of a warp's steps.  In float64 the
//   hop test runs on the integer side, off the float64 pipe.
// * One block per m takes all of its rings (up to 512 K; further rings
//   take further blocks), so the per-(l, m) factors a_lm, b_lm and alm[l, m]
//   are computed once per m, into shared memory by chunks of SYN_LCHUNK l
//   values, and no lane idles beyond the last warp's tail.  alm is read in
//   place from the (lmax + 1, mmax + 1) arrays (an m's column is strided,
//   but the blocks of neighbouring m read the same rows at about the same
//   time, so the sectors come from L2), so the wrapper packs nothing.
// * The fill is off the l loop's critical path: the chunk buffer is
//   double-buffered, and the next chunk is filled before the current
//   chunk's l loop, so one barrier per chunk remains.  (The alternative, a
//   pre-pass writing the whole a_lm, b_lm triangle to device memory, would
//   cost 144 MB at lmax 6,000 and an allocation per call for no fewer
//   barriers.)  Shared memory is 2 x SYN_LCHUNK x 4 values: 8 KB in
//   float64, so lmax 12,000 needs no more.
// * Blocks are numbered with m in the slow grid dimension, so the scheduler
//   starts the longest lanes (m = 0 runs lmax + 1 steps) first.  Each
//   thread keeps its rings' sums in registers; no lane talks to another.
//
// Analysis (analysis_kernel) is one thread per (m, ring) lane: each l's row
// is summed over the block's rings in a fixed order (a shuffle tree in each
// warp, then the warps in order), and ring chunks beyond one block are
// added launch after launch by the wrapper's `accumulate`.  No atomics: two
// calls are bitwise equal.

#include <cuda_runtime.h>

namespace {

constexpr int LCHUNK = 64;          // analysis: l values a chunk
constexpr int MAX_WARPS = 32;
constexpr int SYN_LCHUNK = 128;     // synthesis: l values a chunk buffer
// synthesis threads a block: at most 512, so that a float64 thread of K = 4
// lanes may hold its 7 K values in registers (128 a thread) without spills
constexpr int SYN_MAX_THREADS = 512;

__device__ __forceinline__ float exp2_(float x) { return exp2f(x); }
__device__ __forceinline__ double exp2_(double x) { return exp2(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }
__device__ __forceinline__ float fmin_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin_(double a, double b) { return fmin(a, b); }

// Offset of (l = m, m) in the m-major packed triangle l = m .. lmax.
__device__ __forceinline__ long long tri_offset(int m, int lmax) {
  return (long long)m * (lmax + 1) - (long long)m * (m - 1) / 2;
}

// a_lm and b_lm of the recurrence, the reference's expressions in its
// order (0 at l = m, where the seed takes over).
template <typename T>
__device__ __forceinline__ void recurrence_factors(int l, int m, T& a, T& b) {
  a = (T)0;
  b = (T)0;
  if (l > m) {
    const T lf = (T)l, mf = (T)m;
    const T den = lf * lf - mf * mf;
    a = sqrt_(((T)4.0 * lf * lf - (T)1.0) / den);
    const T lm1 = lf - (T)1.0;
    b = sqrt_((lm1 * lm1 - mf * mf) / ((T)4.0 * lm1 * lm1 - (T)1.0));
  }
}

// One l's factors in shared memory: a, b, alm re, alm im (one 16-byte load
// in float32, two in float64).
template <typename T> struct Quad;
template <> struct Quad<float> { using type = float4; };
template <> struct Quad<double> {
  struct __align__(16) type { double x, y, z, w; };
};
template <typename T> using quad_t = typename Quad<T>::type;

// Fill entries 0 .. n-1 of one chunk buffer with l = l0 .. l0 + n - 1;
// alm[l, m] is read from the (lmax + 1, ldA) row-major arrays.
template <typename T>
__device__ __forceinline__ void fill_chunk(quad_t<T>* dst, int l0, int n,
                                           int m, const T* __restrict__ almRe,
                                           const T* __restrict__ almIm,
                                           int ldA) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int l = l0 + j;
    T a, b;
    recurrence_factors<T>(l, m, a, b);
    quad_t<T> q;
    q.x = a;
    q.y = b;
    q.z = almRe[(long long)l * ldA + m];
    q.w = almIm[(long long)l * ldA + m];
    dst[j] = q;
  }
}

// |x| > 2^48, the reference's hop test.  In float64 it is taken on the
// integer side, where it costs no slot of the float64 pipe that bounds the
// kernel: for every non-NaN x the bits of |x| order as |x| does.
__device__ __forceinline__ bool above_big(float x) {
  return fabsf(x) > 281474976710656.0f;
}
__device__ __forceinline__ bool above_big(double x) {
  return (__double_as_longlong(x) & 0x7fffffffffffffffLL)
      > 0x42f0000000000000LL;                               // 2^48
}

// The reference's hop of one lane whose new value has passed 2^48: P and
// the previous value scaled by 2^-min(96, -S), S raised by as much.
template <typename T>
__device__ __forceinline__ void hop(T& Pn, T& Pk, T& S, T& scale) {
  const T hop = fmin_((T)96.0, -S);
  const T fac = exp2_(-hop);
  Pn = Pn * fac;
  Pk = Pk * fac;
  S = S + hop;
  scale = exp2_(S);
}

// Synthesis.  ct: (R) cos(theta); seedP, seedS: (nm, R) seed mantissa and
// exponent; almRe/almIm: (lmax + 1, ldA) row-major, m the column;
// FRe/FIm: (nm, R).  Warp w of ring block x runs rings
// ((x * blockDim.x + 32 w) K + 32 k + lane, k < K); rings >= R are dead
// lanes, run and never stored.
template <typename T, int K>
__global__ void __launch_bounds__(SYN_MAX_THREADS)
synthesis_kernel(const T* __restrict__ ct, const T* __restrict__ seedP,
                 const T* __restrict__ seedS, const T* __restrict__ almRe,
                 const T* __restrict__ almIm, T* __restrict__ FRe,
                 T* __restrict__ FIm, int ldA, int R, int lmax) {
  __shared__ quad_t<T> sF[2][SYN_LCHUNK];

  const int m = blockIdx.y;
  const int r0 = (blockIdx.x * blockDim.x + (threadIdx.x & ~31)) * K
      + (threadIdx.x & 31);

  T c[K], P[K], Pp[K], S[K], scale[K], Fre[K], Fim[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = r0 + 32 * k;
    const bool live = r < R;
    const long long lane = (long long)m * R + r;
    c[k] = live ? ct[r] : (T)0;
    P[k] = live ? seedP[lane] : (T)0;                       // the seed
    S[k] = live ? seedS[lane] : (T)0;
    Fre[k] = (T)0;
    Fim[k] = (T)0;
  }

  fill_chunk<T>(sF[0], m, min(SYN_LCHUNK, lmax - m + 1), m, almRe, almIm,
                ldA);
  __syncthreads();

  // l = m: the seed, with the reference's hop test (it never fires: the
  // seed mantissa is within sqrt(2) of 1) and its sum
  {
    const quad_t<T> f = sF[0][0];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T Pk = (T)0;
      scale[k] = exp2_(S[k]);
      if (above_big(P[k])) hop<T>(P[k], Pk, S[k], scale[k]);
      const T lam = P[k] * scale[k];
      Pp[k] = Pk;
      Fre[k] = Fre[k] + f.z * lam;
      Fim[k] = Fim[k] + f.w * lam;
    }
  }

  int buf = 0;
  for (int l0 = m; l0 <= lmax; l0 += SYN_LCHUNK, buf ^= 1) {
    const int n = min(SYN_LCHUNK, lmax - l0 + 1);
    // the next chunk goes into the other buffer, which every thread has
    // finished reading (the barrier ending the previous chunk)
    const int l1 = l0 + SYN_LCHUNK;
    if (l1 <= lmax)
      fill_chunk<T>(sF[buf ^ 1], l1, min(SYN_LCHUNK, lmax - l1 + 1), m,
                    almRe, almIm, ldA);
    const quad_t<T>* cur = sF[buf];
#pragma unroll 4
    for (int j = (l0 == m); j < n; ++j) {
      const quad_t<T> f = cur[j];
      T Pn[K], Pk[K];
      bool grew = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        Pn[k] = f.x * (c[k] * P[k] - f.y * Pp[k]);
        Pk[k] = P[k];
        grew |= above_big(Pn[k]);
      }
      // one warp-uniform branch for the hops of all the warp's lanes
      if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (above_big(Pn[k])) hop<T>(Pn[k], Pk[k], S[k], scale[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T lam = Pn[k] * scale[k];
        Pp[k] = Pk[k];
        P[k] = Pn[k];
        Fre[k] = Fre[k] + f.z * lam;
        Fim[k] = Fim[k] + f.w * lam;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = r0 + 32 * k;
    if (r < R) {
      FRe[(long long)m * R + r] = Fre[k];
      FIm[(long long)m * R + r] = Fim[k];
    }
  }
}

// Analysis.  ct: (ldR) cos(theta); seedP, seedS: (nm, ldR); GRe/GIm: G * w
// (nm, ldR); almRe/almIm: the alm triangle.  This launch covers rings
// r0 .. r0 + R - 1 with one block per m.
template <typename T>
__global__ void __launch_bounds__(1024)
analysis_kernel(const T* __restrict__ ct, const T* __restrict__ seedP,
                const T* __restrict__ seedS, const T* __restrict__ GRe,
                const T* __restrict__ GIm, T* __restrict__ almRe,
                T* __restrict__ almIm, int ldR, int r0, int R, int lmax,
                int accumulate) {
  __shared__ T sA[LCHUNK], sB[LCHUNK];
  __shared__ T sRed[LCHUNK * MAX_WARPS * 2];

  const int m = blockIdx.y;
  const int rl = threadIdx.x;                                // ring in launch
  const bool live = rl < R;
  const long long lane = (long long)m * ldR + r0 + rl;
  const long long tri = tri_offset(m, lmax);
  const T BIG = (T)281474976710656.0;                       // 2^48
  const T HOP = (T)96.0;

  const T c = live ? ct[r0 + rl] : (T)0;
  const T P0 = live ? seedP[lane] : (T)0;
  const T S0 = live ? seedS[lane] : (T)0;
  const T gRe = live ? GRe[lane] : (T)0;
  const T gIm = live ? GIm[lane] : (T)0;
  T P = (T)0, Pp = (T)0, S = (T)0, scale = (T)1;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;

  for (int l0 = m; l0 <= lmax; l0 += LCHUNK) {
    const int n = min(LCHUNK, lmax - l0 + 1);
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      recurrence_factors<T>(l0 + j, m, sA[j], sB[j]);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      T Pn;
      bool newS = false;
      if (l0 + j == m) {
        Pn = P0;
        S = S0;
        newS = true;
      } else {
        Pn = sA[j] * (c * P - sB[j] * Pp);
      }
      T Pk = P;
      if (fabs_(Pn) > BIG) {
        const T hop = fmin_(HOP, -S);
        const T fac = exp2_(-hop);
        Pn = Pn * fac;
        Pk = Pk * fac;
        S = S + hop;
        newS = true;
      }
      if (newS) scale = exp2_(S);
      const T lam = Pn * scale;
      Pp = Pk;
      P = Pn;
      T vRe = lam * gRe, vIm = lam * gIm;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        vRe = vRe + __shfl_down_sync(0xffffffffu, vRe, o);
        vIm = vIm + __shfl_down_sync(0xffffffffu, vIm, o);
      }
      if (wl == 0) {
        sRed[(j * MAX_WARPS + warp) * 2] = vRe;
        sRed[(j * MAX_WARPS + warp) * 2 + 1] = vIm;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < 2 * n; t += blockDim.x) {
      const int j = t >> 1, comp = t & 1;
      T s = sRed[j * MAX_WARPS * 2 + comp];
      for (int w = 1; w < nwarps; ++w)
        s = s + sRed[(j * MAX_WARPS + w) * 2 + comp];
      T* out = comp ? almIm : almRe;
      const long long k = tri + (l0 + j - m);
      out[k] = accumulate ? out[k] + s : s;
    }
    // the next chunk writes sRed only after its first __syncthreads
  }
}

// Rings a thread of the synthesis: 4 in float32, 2 in float64 (chosen by
// measurement; ops/sht.py's synthesis_geometry mirrors it).
template <typename T> struct SynRings;
template <> struct SynRings<float> { static constexpr int K = 4; };
template <> struct SynRings<double> { static constexpr int K = 2; };

template <typename T>
int launch_synthesis(const T* ct, const T* seedP, const T* seedS,
                     const T* almRe, const T* almIm, T* FRe, T* FIm,
                     int ldA, int R, int lmax, int nm, int threads,
                     int blocks, cudaStream_t stream) {
  constexpr int K = SynRings<T>::K;
  if (R <= 0 || nm <= 0) return 0;
  if (threads <= 0 || threads > SYN_MAX_THREADS || threads % 32 != 0
      || nm > 65535 || nm > lmax + 1 || ldA < nm || blocks <= 0
      || (long long)blocks * threads * K < R)
    return (int)cudaErrorInvalidValue;
  dim3 grid(blocks, nm);
  synthesis_kernel<T, K><<<grid, threads, 0, stream>>>(
      ct, seedP, seedS, almRe, almIm, FRe, FIm, ldA, R, lmax);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_analysis(const T* ct, const T* seedP, const T* seedS,
                    const T* GRe, const T* GIm, T* almRe, T* almIm, int ldR,
                    int r0, int R, int lmax, int nm, int threads,
                    int accumulate, cudaStream_t stream) {
  if (R <= 0 || nm <= 0) return 0;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0 || nm > 65535
      || R > threads)
    return (int)cudaErrorInvalidValue;
  dim3 grid(1, nm);
  analysis_kernel<T><<<grid, threads, 0, stream>>>(
      ct, seedP, seedS, GRe, GIm, almRe, almIm, ldR, r0, R, lmax,
      accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nemo_legendre_synthesis_f32(const float* ct, const float* seedP,
                                const float* seedS, const float* almRe,
                                const float* almIm, float* FRe, float* FIm,
                                int ldA, int R, int lmax, int nm,
                                int threads, int blocks,
                                cudaStream_t stream) {
  return launch_synthesis<float>(ct, seedP, seedS, almRe, almIm, FRe, FIm,
                                 ldA, R, lmax, nm, threads, blocks, stream);
}

int nemo_legendre_synthesis_f64(const double* ct, const double* seedP,
                                const double* seedS, const double* almRe,
                                const double* almIm, double* FRe, double* FIm,
                                int ldA, int R, int lmax, int nm,
                                int threads, int blocks,
                                cudaStream_t stream) {
  return launch_synthesis<double>(ct, seedP, seedS, almRe, almIm, FRe, FIm,
                                  ldA, R, lmax, nm, threads, blocks, stream);
}

int nemo_legendre_analysis_f32(const float* ct, const float* seedP,
                               const float* seedS, const float* GRe,
                               const float* GIm, float* almRe, float* almIm,
                               int ldR, int r0, int R, int lmax, int nm,
                               int threads, int accumulate,
                               cudaStream_t stream) {
  return launch_analysis<float>(ct, seedP, seedS, GRe, GIm, almRe, almIm,
                                ldR, r0, R, lmax, nm, threads, accumulate,
                                stream);
}

int nemo_legendre_analysis_f64(const double* ct, const double* seedP,
                               const double* seedS, const double* GRe,
                               const double* GIm, double* almRe,
                               double* almIm, int ldR, int r0, int R,
                               int lmax, int nm, int threads, int accumulate,
                               cudaStream_t stream) {
  return launch_analysis<double>(ct, seedP, seedS, GRe, GIm, almRe, almIm,
                                 ldR, r0, R, lmax, nm, threads, accumulate,
                                 stream);
}

}  // extern "C"
