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
// as it does there.
//
// Design for the card (what bounds it: operations, ~10 a lane and l; the
// alm triangle is read once, 0.04 ms of bytes at lmax 6,000):
//
// * One thread per (m, ring) lane, running l = m .. lmax.  The lanes with
//   m > l, which the scan evaluates and masks, are never run: that halves
//   the work and changes no value (at l = m + 1, b = 0 and Pp = 0).
// * One m per block row.  The per-(l, m) factors a_lm, b_lm (and, in
//   synthesis, alm[l, m], stored m-major as a packed triangle) are computed
//   once per block into shared memory by chunks of LCHUNK l values.
// * Blocks are numbered with m in the slow grid dimension, so the scheduler
//   starts the longest lanes (m = 0 runs lmax + 1 steps) first.
// * Synthesis: each thread keeps its ring's sums in registers; no lane
//   talks to another.  Analysis: each l's row is summed over the block's
//   rings in a fixed order (a shuffle tree in each warp, then the warps in
//   order), and ring chunks beyond one block are added launch after launch
//   by the wrapper's `accumulate`.  No atomics: two calls are bitwise equal.

#include <cuda_runtime.h>

namespace {

constexpr int LCHUNK = 64;
constexpr int MAX_WARPS = 32;

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

// ct: (ldR) cos(theta); seedP, seedS: (nm, ldR) seed mantissa and exponent;
// synthesis: inRe/inIm the alm triangle, outRe/outIm F (nm, ldR);
// analysis: inRe/inIm G * w (nm, ldR), outRe/outIm the alm triangle.
// This launch covers rings r0 .. r0 + R - 1.
template <typename T, bool ADJ>
__global__ void __launch_bounds__(1024)
legendre_kernel(const T* __restrict__ ct, const T* __restrict__ seedP,
                const T* __restrict__ seedS, const T* __restrict__ inRe,
                const T* __restrict__ inIm, T* __restrict__ outRe,
                T* __restrict__ outIm, int ldR, int r0, int R, int lmax,
                int accumulate) {
  __shared__ T sA[LCHUNK], sB[LCHUNK], sRe[ADJ ? 1 : LCHUNK],
      sIm[ADJ ? 1 : LCHUNK];
  __shared__ T sRed[ADJ ? LCHUNK * MAX_WARPS * 2 : 1];

  const int m = blockIdx.y;
  const int rl = blockIdx.x * blockDim.x + threadIdx.x;   // ring in launch
  const bool live = rl < R;
  const long long lane = (long long)m * ldR + r0 + rl;
  const long long tri = tri_offset(m, lmax);
  const T BIG = (T)281474976710656.0;                       // 2^48
  const T HOP = (T)96.0;
  const T mf = (T)m;

  const T c = live ? ct[r0 + rl] : (T)0;
  const T P0 = live ? seedP[lane] : (T)0;
  const T S0 = live ? seedS[lane] : (T)0;
  T gRe = (T)0, gIm = (T)0;
  if (ADJ && live) {
    gRe = inRe[lane];
    gIm = inIm[lane];
  }
  T P = (T)0, Pp = (T)0, S = (T)0, scale = (T)1;
  T Fre = (T)0, Fim = (T)0;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;

  for (int l0 = m; l0 <= lmax; l0 += LCHUNK) {
    const int n = min(LCHUNK, lmax - l0 + 1);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int l = l0 + j;
      const T lf = (T)l;
      T a = (T)0, b = (T)0;
      if (l > m) {
        const T den = lf * lf - mf * mf;
        a = sqrt_(((T)4.0 * lf * lf - (T)1.0) / den);
        const T lm1 = lf - (T)1.0;
        b = sqrt_((lm1 * lm1 - mf * mf) / ((T)4.0 * lm1 * lm1 - (T)1.0));
      }
      sA[j] = a;
      sB[j] = b;
      if (!ADJ) {
        sRe[j] = inRe[tri + (l - m)];
        sIm[j] = inIm[tri + (l - m)];
      }
    }
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
      if (ADJ) {
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
      } else {
        Fre = Fre + sRe[j] * lam;
        Fim = Fim + sIm[j] * lam;
      }
    }
    __syncthreads();
    if (ADJ) {
      for (int t = threadIdx.x; t < 2 * n; t += blockDim.x) {
        const int j = t >> 1, comp = t & 1;
        T s = sRed[j * MAX_WARPS * 2 + comp];
        for (int w = 1; w < nwarps; ++w)
          s = s + sRed[(j * MAX_WARPS + w) * 2 + comp];
        T* out = comp ? outIm : outRe;
        const long long k = tri + (l0 + j - m);
        out[k] = accumulate ? out[k] + s : s;
      }
      // the next chunk writes sRed only after its first __syncthreads
    }
  }
  if (!ADJ && live) {
    outRe[lane] = Fre;
    outIm[lane] = Fim;
  }
}

template <typename T, bool ADJ>
int launch(const T* ct, const T* seedP, const T* seedS, const T* inRe,
           const T* inIm, T* outRe, T* outIm, int ldR, int r0, int R,
           int lmax, int nm, int threads, int accumulate,
           cudaStream_t stream) {
  if (R <= 0 || nm <= 0) return 0;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0 || nm > 65535)
    return (int)cudaErrorInvalidValue;
  const int chunks = (R + threads - 1) / threads;
  if (ADJ && chunks != 1) return (int)cudaErrorInvalidValue;
  dim3 grid(chunks, nm);
  legendre_kernel<T, ADJ><<<grid, threads, 0, stream>>>(
      ct, seedP, seedS, inRe, inIm, outRe, outIm, ldR, r0, R, lmax,
      accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nemo_legendre_synthesis_f32(const float* ct, const float* seedP,
                                const float* seedS, const float* almRe,
                                const float* almIm, float* FRe, float* FIm,
                                int ldR, int r0, int R, int lmax, int nm,
                                int threads, int accumulate,
                                cudaStream_t stream) {
  return launch<float, false>(ct, seedP, seedS, almRe, almIm, FRe, FIm, ldR,
                              r0, R, lmax, nm, threads, accumulate, stream);
}

int nemo_legendre_synthesis_f64(const double* ct, const double* seedP,
                                const double* seedS, const double* almRe,
                                const double* almIm, double* FRe, double* FIm,
                                int ldR, int r0, int R, int lmax, int nm,
                                int threads, int accumulate,
                                cudaStream_t stream) {
  return launch<double, false>(ct, seedP, seedS, almRe, almIm, FRe, FIm, ldR,
                               r0, R, lmax, nm, threads, accumulate, stream);
}

int nemo_legendre_analysis_f32(const float* ct, const float* seedP,
                               const float* seedS, const float* GRe,
                               const float* GIm, float* almRe, float* almIm,
                               int ldR, int r0, int R, int lmax, int nm,
                               int threads, int accumulate,
                               cudaStream_t stream) {
  return launch<float, true>(ct, seedP, seedS, GRe, GIm, almRe, almIm, ldR,
                             r0, R, lmax, nm, threads, accumulate, stream);
}

int nemo_legendre_analysis_f64(const double* ct, const double* seedP,
                               const double* seedS, const double* GRe,
                               const double* GIm, double* almRe,
                               double* almIm, int ldR, int r0, int R,
                               int lmax, int nm, int threads, int accumulate,
                               cudaStream_t stream) {
  return launch<double, true>(ct, seedP, seedS, GRe, GIm, almRe, almIm, ldR,
                              r0, R, lmax, nm, threads, accumulate, stream);
}

}  // extern "C"
