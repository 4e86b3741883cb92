// The 7-band graphic EQ cascade on Hopper (sm_90a), as two entries.
//
// K6, jb_geq_cascade_quant, replaces jeicyboodsp_tpu/kernels/biquad_pallas.py:
// geq_cascade_pallas_quant (_kernel_quant_impl): the reference's direct-form-I
// cascade with int16 truncate-and-wrap feedback (7Band_GEQ.cpp:279-300),
// bit-exact against the f64 oracle.  The TPU has no f64 and computes it in
// double-single f32; here it is plain f64, every product and sum rounded as
// written (__dmul_rn, __dadd_rn, __dsub_rn; the build passes -fmad=false) in
// the reference's order b2*x2 - a2*y2 + b1*x1 - a1*y1 + b0*x0, then c_short.
// State per stream: (7, 4) int16 = x1, x2, y1, y2 of each band, in and out.
//
// K7, jb_geq_cascade, replaces geq_cascade_pallas (_make_kernel): the linear
// f32 transposed-direct-form-II cascade (the fast engine, no quantization),
// in the TPU kernel's op order, each f32 op rounded as written.
//
// What bounds them is a dependency chain, not bytes or operations.  Each
// stream is a recursion over time, so the only parallelism is across
// streams: one thread per stream, its filter state in registers, time in a
// loop; at 2048 streams that is 64 warps on 132 SMs.  Within one sample the
// seven bands are in series too (band k's input is band k-1's output), so
// the kernels skew the cascade: on step s band k takes sample s - k, which
// band k-1 produced on step s - 1.  The seven band updates of a step are
// then independent and run back to back, and the chain per step is one
// band's self-recursion (y1 -> a1*y1 -> two adds -> c_short for K6), not
// seven.  Each stream's own operations, and so its result, are those of the
// unskewed loop.  The skew fills and drains within each tile, so at a tile's
// end every band has taken the tile's last sample.
//
// Coalescing: one thread per stream of a row-major (B, T) array would read
// addresses T samples apart.  A warp instead stages a (32 streams, 256
// samples) tile in shared memory with row-contiguous loads, runs the cascade
// out of it in place (band 6's output for sample s - 6 overwrites the slot
// band 0 read on step s - 6) and writes the tile back the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cnum.cuh"

namespace {

constexpr int BANDS = 7;
constexpr int LAG = BANDS - 1;  // band 6 runs LAG samples behind band 0
constexpr int SPB = 32;         // streams per block: one warp, one stream per thread
constexpr int TILE = 256;       // samples of each stream per tile

struct QuantCascade {
  using io = int16_t;
  using val = double;
  // row pitch 258 int16 = 129 words: thread t's sample s is in bank (t + s/2) % 32
  static constexpr int PITCH = TILE + 2;
  double c[BANDS][5];  // b0 b1 b2 a1 a2
  double x1[BANDS], x2[BANDS], y1[BANDS], y2[BANDS];

  __device__ __forceinline__ double band(int k, double v) {
    double acc = __dmul_rn(c[k][2], x2[k]);
    acc = __dsub_rn(acc, __dmul_rn(c[k][4], y2[k]));
    acc = __dadd_rn(acc, __dmul_rn(c[k][1], x1[k]));
    acc = __dsub_rn(acc, __dmul_rn(c[k][3], y1[k]));
    acc = __dadd_rn(acc, __dmul_rn(c[k][0], v));
    const double o = (double)c_short(acc);
    x2[k] = x1[k];
    x1[k] = v;
    y2[k] = y1[k];
    y1[k] = o;
    return o;
  }
  static __device__ __forceinline__ double load(int16_t v) { return (double)v; }
  static __device__ __forceinline__ int16_t store(double v) { return (int16_t)(int)v; }
};

struct LinearCascade {
  using io = float;
  using val = float;
  static constexpr int PITCH = TILE + 1;  // thread t's sample s in bank (t + s) % 32
  float c[BANDS][5];  // b0 b1 b2 a1 a2
  float s0[BANDS], s1[BANDS];

  __device__ __forceinline__ float band(int k, float v) {
    const float o = __fadd_rn(__fmul_rn(c[k][0], v), s0[k]);
    s0[k] = __fadd_rn(__fsub_rn(__fmul_rn(c[k][1], v), __fmul_rn(c[k][3], o)), s1[k]);
    s1[k] = __fsub_rn(__fmul_rn(c[k][2], v), __fmul_rn(c[k][4], o));
    return o;
  }
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

// Step s of the skewed cascade over one tile row of L samples.  u[k] is the
// sample band k takes on this step.  EDGE steps (the fill and the drain)
// run only the bands whose sample s - k lies in [0, L).
template <bool EDGE, class C>
__device__ __forceinline__ void skew_step(C& cas, typename C::val* u,
                                          typename C::io* row, int s, int L) {
  if (!EDGE || s < L) u[0] = C::load(row[s]);
#pragma unroll
  for (int k = LAG; k >= 0; --k) {  // descending: band k reads u[k] before band k-1 writes it
    if (!EDGE || (s >= k && s - k < L)) {
      const typename C::val o = cas.band(k, u[k]);
      if (k == LAG) {
        row[s - LAG] = C::store(o);
      } else {
        u[k + 1] = o;
      }
    }
  }
}

// The block's SPB streams through the cascade, one (SPB, TILE) tile at a time.
template <class C>
__device__ __forceinline__ void run_cascade(C& cas, const typename C::io* __restrict__ x,
                                            typename C::io* __restrict__ y, int B,
                                            long long T) {
  using io = typename C::io;
  __shared__ io tile[SPB][C::PITCH];
  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * SPB;
  const int rows = (int)min((long long)SPB, (long long)B - b0);
  typename C::val u[BANDS];
#pragma unroll
  for (int k = 0; k < BANDS; ++k) u[k] = 0;
  for (long long t0 = 0; t0 < T; t0 += TILE) {
    const int L = (int)min((long long)TILE, T - t0);
    for (int r = 0; r < rows; ++r) {
      const io* src = x + (b0 + r) * T + t0;
      for (int s = t; s < L; s += SPB) tile[r][s] = src[s];
    }
    __syncthreads();
    if (t < rows) {
      io* row = tile[t];
      int s = 0;
      for (; s < min(LAG, L); ++s) skew_step<true>(cas, u, row, s, L);
      for (; s < L; ++s) skew_step<false>(cas, u, row, s, L);
      for (; s < L + LAG; ++s) skew_step<true>(cas, u, row, s, L);
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      io* dst = y + (b0 + r) * T + t0;
      for (int s = t; s < L; s += SPB) dst[s] = tile[r][s];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SPB) geq_quant_kernel(const int16_t* __restrict__ x,
                                                       const double* __restrict__ coef,
                                                       const int16_t* __restrict__ st_in,
                                                       int16_t* __restrict__ y,
                                                       int16_t* __restrict__ st_out, int B,
                                                       long long T) {
  QuantCascade cas;
  const long long b = (long long)blockIdx.x * SPB + threadIdx.x;
  const bool live = b < B;
#pragma unroll
  for (int k = 0; k < BANDS; ++k) {
#pragma unroll
    for (int i = 0; i < 5; ++i) cas.c[k][i] = coef[k * 5 + i];
    const int16_t* s = st_in + (live ? (b * BANDS + k) * 4 : 0);
    cas.x1[k] = live ? s[0] : 0.0;
    cas.x2[k] = live ? s[1] : 0.0;
    cas.y1[k] = live ? s[2] : 0.0;
    cas.y2[k] = live ? s[3] : 0.0;
  }
  run_cascade(cas, x, y, B, T);
  if (live) {
#pragma unroll
    for (int k = 0; k < BANDS; ++k) {
      int16_t* s = st_out + (b * BANDS + k) * 4;
      s[0] = QuantCascade::store(cas.x1[k]);
      s[1] = QuantCascade::store(cas.x2[k]);
      s[2] = QuantCascade::store(cas.y1[k]);
      s[3] = QuantCascade::store(cas.y2[k]);
    }
  }
}

__global__ void __launch_bounds__(SPB) geq_linear_kernel(const float* __restrict__ x,
                                                        const float* __restrict__ coef,
                                                        float* __restrict__ y, int B,
                                                        long long T) {
  LinearCascade cas;
#pragma unroll
  for (int k = 0; k < BANDS; ++k) {
#pragma unroll
    for (int i = 0; i < 5; ++i) cas.c[k][i] = coef[k * 5 + i];
    cas.s0[k] = 0.0f;
    cas.s1[k] = 0.0f;
  }
  run_cascade(cas, x, y, B, T);
}

}  // namespace

// K6.  x, y (B, T) int16; coef (7, 5) f64 [b0 b1 b2 a1 a2]; st_in, st_out
// (B, 7, 4) int16.
extern "C" int jb_geq_cascade_quant(const int16_t* x, const double* coef, const int16_t* st_in,
                                    int16_t* y, int16_t* st_out, int B, int T, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  geq_quant_kernel<<<(B + SPB - 1) / SPB, SPB, 0, st>>>(x, coef, st_in, y, st_out, B, T);
  return (int)cudaGetLastError();
}

// K7.  x, y (B, T) f32; coef (7, 5) f32 [b0 b1 b2 a1 a2]; zero initial state.
extern "C" int jb_geq_cascade(const float* x, const float* coef, float* y, int B, int T,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  geq_linear_kernel<<<(B + SPB - 1) / SPB, SPB, 0, st>>>(x, coef, y, B, T);
  return (int)cudaGetLastError();
}
