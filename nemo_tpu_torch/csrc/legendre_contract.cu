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
// A design of one thread a lane (PR 7's, in both directions) issues about
// as much again per lane-step: four shared loads, the seed test, loop
// control and a hop branch; and with several blocks per m, each repeats
// the m's factor fill.
//
// Synthesis (synthesis_kernel) is designed against that:
//
// * K rings a thread (4 in float32, 2 in float64, by measurement: Rings
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
// * One block per m takes all of its rings (up to MAX_THREADS K; further
//   rings take further blocks), so the per-(l, m) factors a_lm, b_lm and alm[l, m]
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
// Analysis (analysis_kernel) sums each (l, m) over the rings: the same
// per-lane recurrence, so the same bound, plus a reduction over the rings
// of every row.  PR 7's design (a thread a lane) paid, per lane-step, the
// seed test, a hop branch, loop control and two shared loads, and per warp
// and l a five-level shuffle tree per component (as many instructions as
// the recurrence), then a block-wide sum each chunk.  The design now:
//
// * Synthesis's lanes: K rings a thread (the same Rings), slot k of lane i
//   ring 32 k + i of its warp's run, one block per m from l = m, the seed
//   step peeled, one warp-uniform hop branch an l, the factors filled once
//   per m into a double-buffered chunk by synthesis's fill_chunk.
// * Each thread sums its K rings' lam g in registers (the accumulation
//   lam g + acc as an explicit fused multiply-add; lam itself is the
//   reference's, unfused), into a buffer of ANA_LGROUP l x 2 components.
//   Every ANA_LGROUP l a warp reduce-scatters the buffer (halving stages,
//   the first without selects as half the lanes hold im first, then an
//   exchange: about one shuffle and one add a warp-l and component), so
//   lane i ends with the warp's total of entry i, and the first
//   2 ANA_LGROUP lanes write them to shared memory.  Once a chunk of
//   ANA_LCHUNK l, after the chunk's one barrier, the warps' rows are summed
//   in warp order and written in place into alm[l, m] (a strided write of
//   one value an l and m; the blocks of neighbouring m write the same rows
//   at about the same time).  No float atomics: two calls are bitwise
//   equal.
// * The sums of an l are pinned to their step (pin below): left free, the
//   compiler defers them to the group's end and holds every step's lambda
//   in registers, which leaves issue slots idle.
// * Rings beyond one block (R > K x MAX_THREADS) take further blocks
//   of the same m, each writing its partial rows to its own plane of the
//   output; the wrapper sums the planes in a fixed order.
//
// What bounds the analysis now: issued instructions, as in synthesis, with
// the reduce-scatter's shuffles, adds and selects on top (in float32 about
// 46 instructions a thread per 8 l, ~1.4 a lane-step).  In float64 each
// shuffle and select is two 32-bit instructions, so that kernel is bound
// by issue, not by its float64 pipe.

#include <cuda_runtime.h>

namespace {

constexpr int SYN_LCHUNK = 128;     // synthesis: l values a chunk buffer
constexpr int ANA_LCHUNK = 64;      // analysis: l values a chunk buffer
constexpr int ANA_LGROUP = 8;       // analysis: l values a warp reduction
// reduce_scatter needs 2 ANA_LGROUP entries within a warp's 32 lanes and
// halving stages of a power of two; write_rows a whole number of groups a
// chunk
static_assert(ANA_LGROUP >= 1 && ANA_LGROUP <= 16
              && (ANA_LGROUP & (ANA_LGROUP - 1)) == 0
              && ANA_LCHUNK % ANA_LGROUP == 0,
              "ANA_LGROUP: a power of two of at most 16 dividing ANA_LCHUNK");
// threads a block, both directions: at most 512, so that the analysis's
// rows of a chunk (2 x 16 warps x 2 x ANA_LCHUNK values, 32 KB in float64)
// fit in static shared memory, and a synthesis thread of K = 4 float64
// lanes may hold its 7 K values in registers (128 a thread) without spills
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;

__device__ __forceinline__ float exp2_(float x) { return exp2f(x); }
__device__ __forceinline__ double exp2_(double x) { return exp2(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float fmin_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
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
// alm[l, m] is read from the (lmax + 1, ldA) row-major arrays, or taken
// as 0 where almRe is null (analysis).  Entries with l > lmax are all 0:
// a step with them takes P to 0 and adds nothing.
template <typename T>
__device__ __forceinline__ void fill_chunk(quad_t<T>* dst, int l0, int n,
                                           int m, int lmax,
                                           const T* __restrict__ almRe,
                                           const T* __restrict__ almIm,
                                           int ldA) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int l = l0 + j;
    quad_t<T> q;
    q.x = (T)0;
    q.y = (T)0;
    q.z = (T)0;
    q.w = (T)0;
    if (l <= lmax) {
      recurrence_factors<T>(l, m, q.x, q.y);
      if (almRe != nullptr) {
        q.z = almRe[(long long)l * ldA + m];
        q.w = almIm[(long long)l * ldA + m];
      }
    }
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
__global__ void __launch_bounds__(MAX_THREADS)
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

  fill_chunk<T>(sF[0], m, min(SYN_LCHUNK, lmax - m + 1), m, lmax, almRe,
                almIm, ldA);
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
                    lmax, almRe, almIm, ldA);
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

// An empty asm that claims to change x: the sums of an l are formed at
// their step, not deferred by the compiler to the end of the group, which
// kept every step's lambda live and left issue slots idle.  It changes no
// value.
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)); }
__device__ __forceinline__ void pin(double& x) { asm volatile("" : "+d"(x)); }

// One halving stage of a warp's reduce-scatter over v[0 .. 2H-1]: lanes
// with bit H set keep entries H .. 2H-1 (moved to 0 .. H-1), the others
// 0 .. H-1, each added to its partner's (lane ^ H) copy of the same entry.
template <int H, typename T, int N>
__device__ __forceinline__ void halve(T (&v)[N], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const T send = upper ? v[j] : v[j + H];
    const T keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Halving stages H, H / 2, .., 1.
template <int H, typename T, int N>
__device__ __forceinline__ void halve_all(T (&v)[N], int lane) {
  halve<H>(v, lane);
  if constexpr (H > 1) halve_all<H / 2>(v, lane);
}

// The warp's totals of its E = 2 ANA_LGROUP entries: lane i returns the
// sum over the warp's 32 lanes of entry i % E (E - 1 shuffles and adds in
// the halving stages, then one an exchange across the lanes that hold the
// same entry: about a shuffle and an add a warp-l and component, in a fixed
// order).  v[0 .. ANA_LGROUP - 1] hold the lane's own component of the
// first stage (re where lane & ANA_LGROUP is 0, else im), so that stage
// needs no select.
template <typename T>
__device__ __forceinline__ T reduce_scatter(T (&v)[2 * ANA_LGROUP],
                                            int lane) {
#pragma unroll
  for (int j = 0; j < ANA_LGROUP; ++j)
    v[j] = v[j] + __shfl_xor_sync(0xffffffffu, v[j + ANA_LGROUP],
                                  ANA_LGROUP);
  if constexpr (ANA_LGROUP > 1) halve_all<ANA_LGROUP / 2>(v, lane);
  T x = v[0];
#pragma unroll
  for (int o = 2 * ANA_LGROUP; o < 32; o <<= 1)
    x = x + __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Write one chunk's rows: entry t of every warp's row (t = E g + e, E = 2
// ANA_LGROUP: l = l0 + ANA_LGROUP g + e % ANA_LGROUP, component e /
// ANA_LGROUP) summed in warp order into alm[l, m]; entries with l > lmax
// are skipped.
template <typename T>
__device__ __forceinline__ void write_rows(T (*red)[2 * ANA_LCHUNK],
                                           int nwarps, int l0, int lmax,
                                           int m, int ldA, T* outRe,
                                           T* outIm) {
  for (int t = threadIdx.x; t < 2 * ANA_LCHUNK; t += blockDim.x) {
    const int e = t % (2 * ANA_LGROUP);
    const int l = l0 + t / (2 * ANA_LGROUP) * ANA_LGROUP + e % ANA_LGROUP;
    if (l > lmax) continue;
    T s = red[0][t];
    for (int w = 1; w < nwarps; ++w) s = s + red[w][t];
    (e / ANA_LGROUP ? outIm : outRe)[(long long)l * ldA + m] = s;
  }
}

// Analysis.  ct, w: (R) cos(theta) and ring weights; seedP, seedS: (nm,
// R); GRe/GIm: (>= nm, R) ring coefficients G (the kernel takes G w);
// almRe/almIm: (lmax + 1, ldA) row-major, m the column, rows l >= m
// written; ring block x writes its partial sums at almRe/almIm + x plane.
// Warp w of ring block x runs rings ((x * blockDim.x + 32 w) K + 32 k +
// lane, k < K), as in synthesis; rings >= R are dead lanes (g = 0).
template <typename T, int K>
__global__ void __launch_bounds__(MAX_THREADS)
analysis_kernel(const T* __restrict__ ct, const T* __restrict__ wts,
                const T* __restrict__ seedP, const T* __restrict__ seedS,
                const T* __restrict__ GRe, const T* __restrict__ GIm,
                T* __restrict__ almRe, T* __restrict__ almIm, int ldA,
                long long plane, int R, int lmax) {
  __shared__ quad_t<T> sF[2][ANA_LCHUNK];
  __shared__ T sRed[2][MAX_WARPS][2 * ANA_LCHUNK];
  __shared__ T sSeed[2][MAX_WARPS];

  const int m = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int r0 = (blockIdx.x * blockDim.x + (threadIdx.x & ~31)) * K
      + lane;
  T* outRe = almRe + blockIdx.x * plane;
  T* outIm = almIm + blockIdx.x * plane;

  T c[K], P[K], Pp[K], S[K], scale[K], gRe[K], gIm[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = r0 + 32 * k;
    const bool live = r < R;
    const long long cell = (long long)m * R + r;
    c[k] = live ? ct[r] : (T)0;
    P[k] = live ? seedP[cell] : (T)0;                       // the seed
    S[k] = live ? seedS[cell] : (T)0;
    gRe[k] = live ? GRe[cell] * wts[r] : (T)0;              // G w
    gIm[k] = live ? GIm[cell] * wts[r] : (T)0;
  }

  fill_chunk<T>(sF[0], m + 1, ANA_LCHUNK, m, lmax, (const T*)nullptr,
                (const T*)nullptr, 0);

  // l = m: the seed, with the reference's hop test, summed over the warp
  // by a shuffle tree (once an m)
  {
    T re = (T)0, im = (T)0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T Pk = (T)0;
      scale[k] = exp2_(S[k]);
      if (above_big(P[k])) hop<T>(P[k], Pk, S[k], scale[k]);
      const T lam = P[k] * scale[k];
      Pp[k] = Pk;
      re = k ? fma_(lam, gRe[k], re) : lam * gRe[k];
      im = k ? fma_(lam, gIm[k], im) : lam * gIm[k];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      re = re + __shfl_xor_sync(0xffffffffu, re, o);
      im = im + __shfl_xor_sync(0xffffffffu, im, o);
    }
    if (lane == 0) {
      sSeed[0][warp] = re;
      sSeed[1][warp] = im;
    }
  }
  // from here on, a lane's first component is im where lane & ANA_LGROUP
  // (see reduce_scatter); its partner in the first stage holds re
  if (lane & ANA_LGROUP) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T t = gRe[k];
      gRe[k] = gIm[k];
      gIm[k] = t;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    T s = sSeed[threadIdx.x][0];
    for (int w = 1; w < nwarps; ++w) s = s + sSeed[threadIdx.x][w];
    (threadIdx.x ? outIm : outRe)[(long long)m * ldA + m] = s;
  }

  int buf = 0;
  for (int l0 = m + 1; l0 <= lmax; l0 += ANA_LCHUNK, buf ^= 1) {
    // the next chunk's factors and the previous chunk's rows use the other
    // buffers, which the barrier ending the previous chunk freed and filled
    const int l1 = l0 + ANA_LCHUNK;
    if (l1 <= lmax)
      fill_chunk<T>(sF[buf ^ 1], l1, ANA_LCHUNK, m, lmax, (const T*)nullptr,
                    (const T*)nullptr, 0);
    if (l0 > m + 1)
      write_rows<T>(sRed[buf ^ 1], nwarps, l0 - ANA_LCHUNK, lmax, m, ldA,
                    outRe, outIm);
    const quad_t<T>* cur = sF[buf];
    const int groups = (min(ANA_LCHUNK, lmax - l0 + 1) + ANA_LGROUP - 1)
        / ANA_LGROUP;
    for (int g = 0; g < groups; ++g) {
      T v[2 * ANA_LGROUP];              // the thread's sums: first, second
#pragma unroll
      for (int j = 0; j < ANA_LGROUP; ++j) {
        const quad_t<T> f = cur[g * ANA_LGROUP + j];
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
        T first = (T)0, second = (T)0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const T lam = Pn[k] * scale[k];
          Pp[k] = Pk[k];
          P[k] = Pn[k];
          first = k ? fma_(lam, gRe[k], first) : lam * gRe[k];
          second = k ? fma_(lam, gIm[k], second) : lam * gIm[k];
        }
        pin(first);
        pin(second);
        v[j] = first;
        v[ANA_LGROUP + j] = second;
      }
      const T total = reduce_scatter<T>(v, lane);
      if (lane < 2 * ANA_LGROUP)
        sRed[buf][warp][g * 2 * ANA_LGROUP + lane] = total;
    }
    __syncthreads();
  }
  // the last chunk's rows (its barrier has passed)
  const int chunks = (lmax - m + ANA_LCHUNK - 1) / ANA_LCHUNK;
  if (chunks > 0)
    write_rows<T>(sRed[buf ^ 1], nwarps, m + 1 + (chunks - 1) * ANA_LCHUNK,
                  lmax, m, ldA, outRe, outIm);
}

// Rings a thread, both directions: 4 in float32, 2 in float64 (chosen by
// measurement; ops/sht.py's legendre_geometry mirrors it).
template <typename T> struct Rings;
template <> struct Rings<float> { static constexpr int K = 4; };
template <> struct Rings<double> { static constexpr int K = 2; };

template <typename T>
int launch_synthesis(const T* ct, const T* seedP, const T* seedS,
                     const T* almRe, const T* almIm, T* FRe, T* FIm,
                     int ldA, int R, int lmax, int nm, int threads,
                     int blocks, cudaStream_t stream) {
  constexpr int K = Rings<T>::K;
  if (R <= 0 || nm <= 0) return 0;
  if (threads <= 0 || threads > MAX_THREADS || threads % 32 != 0
      || nm > 65535 || nm > lmax + 1 || ldA < nm || blocks <= 0
      || (long long)blocks * threads * K < R)
    return (int)cudaErrorInvalidValue;
  dim3 grid(blocks, nm);
  synthesis_kernel<T, K><<<grid, threads, 0, stream>>>(
      ct, seedP, seedS, almRe, almIm, FRe, FIm, ldA, R, lmax);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_analysis(const T* ct, const T* wts, const T* seedP,
                    const T* seedS, const T* GRe, const T* GIm, T* almRe,
                    T* almIm, int ldA, int R, int lmax, int nm, int threads,
                    int blocks, long long plane, cudaStream_t stream) {
  constexpr int K = Rings<T>::K;
  if (R <= 0 || nm <= 0) return 0;
  if (threads <= 0 || threads > MAX_THREADS || threads % 32 != 0
      || nm > 65535 || nm > lmax + 1 || ldA < nm || blocks <= 0
      || (long long)blocks * threads * K < R
      || (blocks > 1 && plane < 2LL * (lmax + 1) * ldA))
    return (int)cudaErrorInvalidValue;
  dim3 grid(blocks, nm);
  analysis_kernel<T, K><<<grid, threads, 0, stream>>>(
      ct, wts, seedP, seedS, GRe, GIm, almRe, almIm, ldA, plane, R, lmax);
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

int nemo_legendre_analysis_f32(const float* ct, const float* wts,
                               const float* seedP, const float* seedS,
                               const float* GRe, const float* GIm,
                               float* almRe, float* almIm, int ldA, int R,
                               int lmax, int nm, int threads, int blocks,
                               long long plane, cudaStream_t stream) {
  return launch_analysis<float>(ct, wts, seedP, seedS, GRe, GIm, almRe,
                                almIm, ldA, R, lmax, nm, threads, blocks,
                                plane, stream);
}

int nemo_legendre_analysis_f64(const double* ct, const double* wts,
                               const double* seedP, const double* seedS,
                               const double* GRe, const double* GIm,
                               double* almRe, double* almIm, int ldA, int R,
                               int lmax, int nm, int threads, int blocks,
                               long long plane, cudaStream_t stream) {
  return launch_analysis<double>(ct, wts, seedP, seedS, GRe, GIm, almRe,
                                 almIm, ldA, R, lmax, nm, threads, blocks,
                                 plane, stream);
}

}  // extern "C"
