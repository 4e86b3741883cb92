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
// stream is a recursion over time, so the parallelism is across streams and,
// within one stream, across its seven bands once the cascade is skewed: band
// k's input is band k-1's output, so band k runs some steps behind band k-1
// and the seven band updates of a step are independent.  Each stream's own
// operations, and so its result, are those of the unskewed loop.
//
// K6: the seven bands of a stream on seven lanes.  A group of 8 lanes holds
// one stream, lane k < 7 band k's 5 coefficients and x1, x2, y1, y2 in
// registers (lane 7 idles); a warp holds 4 streams and a block of 4 warps
// 16, so 2048 streams make 512 warps, one per SMSP on 128 of the 132 SMs
// (one thread per stream made 64 warps).  Skew 2: on step s band k takes
// sample s - 2k, whose input band k-1 made on step s - 2; lane k-1 hands its
// output over by __shfl_up_sync within the group as an int one step ahead,
// so the shuffle is off the chain.  What bounds K6 now is one band's step
// chain: y1 -> a1*y1 -> the subtraction -> + b0*x0 -> the truncating
// conversion and the sign extension -> the conversion back to f64, ~65
// cycles by my count, 49,164 steps a call (the fill and drain of 12 steps run
// once per call), at one warp per SMSP with nothing to hide its latency
// behind (profile_recursions.py: ~113 cycles a step at 2048 streams, 116 at
// 16; 4096 streams take 1.13 times as long).  Two
// things sat on that chain and are off it: lane 0's shared-memory load,
// now made a step ahead, and c_short's range compares, which the compiler
// put before a predicated conversion.  A launch checks sum |coef| * 32768 <
// 2^30 for every band (the same in every thread, so the choice is uniform);
// then every acc lies well inside int32 and the conversion alone gives
// c_short's int (FITS; 2.7 ms against 4.3 with the compares on the H100).
// Coefficients that fail the check run with the compares.  A warp issues per
// step 9 f64 operations, 3 conversions and a shuffle, well inside the chain.
// Lane 0 of a group reads its stream's samples from a (16 streams, 256
// steps) shared tile staged with row-contiguous loads, the next tile's loads
// in flight in registers while the current one runs; lane 6 writes its
// output, 12 samples behind, into a second tile, written back the same way.
// Row pitch 258 int16 = 129 words: the 4 rows of a warp sit in 4 banks.
// Ragged B leaves the last groups empty: they run (whole warps take part in
// the shuffles) but neither read nor write device memory.
//
// K7 keeps the one-thread-per-stream layout: one thread per stream, its
// filter state in registers, time in a loop, at 2048 streams 64 warps.  On
// step s band k takes sample s - k, which band k-1 produced on step s - 1,
// and the skew fills and drains within each tile.  Coalescing: a warp stages
// a (32 streams, 256 samples) tile in shared memory with row-contiguous
// loads, runs the cascade out of it in place (band 6's output for sample
// s - 6 overwrites the slot band 0 read on step s - 6) and writes the tile
// back the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cnum.cuh"

namespace {

constexpr int BANDS = 7;
constexpr int TILE = 256;       // samples of each stream per tile

// ---- K6 ---------------------------------------------------------------------

constexpr int QGROUP = 8;                        // lanes per stream: band k on lane k < 7
constexpr int QSKEW = 2;                         // band k runs 2k steps behind band 0
constexpr int QLAG = QSKEW * (BANDS - 1);        // band 6 runs 12 samples behind band 0
constexpr int QTHREADS = 128;                    // 4 warps
constexpr int QROWS = QTHREADS / QGROUP;         // 16 streams per block
constexpr int QPITCH = TILE + 2;                 // 129 words: a warp's 4 rows in 4 banks
constexpr int QPRE = QROWS * TILE / QTHREADS;    // samples each thread stages per tile

// the two staging tiles of a block: band 0's samples in, band 6's out
__shared__ int16_t q_tin[QROWS][QPITCH], q_tout[QROWS][QPITCH];

// one band of the quantized cascade, in the reference's op order.  FITS: the
// launch found sum |coef| * 32768 < 2^30 for every band, so every acc lies
// well inside int32 (|x|, |y| <= 32768) and c_short's range compares, which
// would sit on the chain before the conversion, are left out: the truncating
// conversion alone then gives the same int.
struct QuantBand {
  double b0 = 0, b1 = 0, b2 = 0, a1 = 0, a2 = 0;
  double x1 = 0, x2 = 0, y1 = 0, y2 = 0;

  template <bool FITS>
  __device__ __forceinline__ int step(double v) {
    double acc = __dmul_rn(b2, x2);
    acc = __dsub_rn(acc, __dmul_rn(a2, y2));
    acc = __dadd_rn(acc, __dmul_rn(b1, x1));
    acc = __dsub_rn(acc, __dmul_rn(a1, y1));
    acc = __dadd_rn(acc, __dmul_rn(b0, v));
    const int o = FITS ? (int)(int16_t)(uint16_t)(__double2int_rz(acc) & 0xffff) : c_short(acc);
    x2 = x1;
    x1 = v;
    y2 = y1;
    y1 = (double)o;
    return o;
  }
};

// Steps S0 .. S0 + n - 1 of the skewed cascade, column c = s - S0 of the
// block's tiles: q_tin holds sample s (band 0's), q_tout takes sample
// s - QLAG (band 6's).  nxt is what this lane takes on the next step: lane
// k-1's last output, or for lane 0 the tile's next sample, loaded a step
// ahead so the load is off the chain.  EDGE steps (the fill and the drain)
// run only the bands whose sample lies in [0, T).
template <bool EDGE, bool FITS>
__device__ __forceinline__ void quant_steps(QuantBand& bd, int k, int row, long long S0, int n,
                                            long long T, int& o, int& nxt) {
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    const int v = nxt;
    nxt = __shfl_up_sync(0xffffffffu, o, 1, QGROUP);
    if (k == 0) nxt = q_tin[row][c + 1];  // the pad column after the last
    const long long sk = S0 + c - QSKEW * k;  // the sample band k takes on this step
    if (!EDGE || (k < BANDS && sk >= 0 && sk < T)) {
      o = bd.step<FITS>((double)v);
      if (k == BANDS - 1) q_tout[row][c] = (int16_t)o;
    }
  }
}

template <bool FITS>
__device__ __forceinline__ void quant_tile(QuantBand& bd, int k, int row, long long S0, int n,
                                           long long T, int& o, int& nxt) {
  if (S0 >= QLAG && S0 + n <= T)
    quant_steps<false, FITS>(bd, k, row, S0, n, T, o, nxt);
  else
    quant_steps<true, FITS>(bd, k, row, S0, n, T, o, nxt);
}

__global__ void __launch_bounds__(QTHREADS) geq_quant_kernel(const int16_t* __restrict__ x,
                                                            const double* __restrict__ coef,
                                                            const int16_t* __restrict__ st_in,
                                                            int16_t* __restrict__ y,
                                                            int16_t* __restrict__ st_out,
                                                            int B, long long T) {
  const int tid = threadIdx.x;
  const int k = tid % QGROUP, row = tid / QGROUP;
  const long long b0 = (long long)blockIdx.x * QROWS;
  const int rows = (int)min((long long)QROWS, (long long)B - b0);
  const bool live = row < rows && k < BANDS;
  bool fits = true;  // the same in every thread: the choice of variant is uniform
  for (int j = 0; j < BANDS; ++j) {
    double sum = 0.0;
    for (int i = 0; i < 5; ++i) sum += fabs(coef[j * 5 + i]);
    fits = fits && sum * 32768.0 < 1073741824.0;
  }
  QuantBand bd;
  if (k < BANDS) {
    const double* ck = coef + k * 5;
    bd.b0 = ck[0];
    bd.b1 = ck[1];
    bd.b2 = ck[2];
    bd.a1 = ck[3];
    bd.a2 = ck[4];
  }
  if (live) {
    const int16_t* s = st_in + ((b0 + row) * BANDS + k) * 4;
    bd.x1 = s[0];
    bd.x2 = s[1];
    bd.y1 = s[2];
    bd.y2 = s[3];
  }
  // the block's (16, TILE) input tile at S0, element i of thread tid at row
  // (i * QTHREADS + tid) / TILE: row-contiguous, coalesced
  int16_t pre[QPRE];
  auto load = [&](long long S0) {
#pragma unroll
    for (int i = 0; i < QPRE; ++i) {
      const int idx = i * QTHREADS + tid, r = idx / TILE, c = idx % TILE;
      pre[i] = (r < rows && S0 + c < T) ? x[(b0 + r) * T + S0 + c] : (int16_t)0;
    }
  };
  load(0);
  int o = 0, nxt = 0;
  for (long long S0 = 0; S0 < T + QLAG; S0 += TILE) {
#pragma unroll
    for (int i = 0; i < QPRE; ++i) {
      const int idx = i * QTHREADS + tid;
      q_tin[idx / TILE][idx % TILE] = pre[i];
    }
    __syncthreads();
    if (S0 + TILE < T) load(S0 + TILE);  // in flight while this tile runs
    if (k == 0) nxt = q_tin[row][0];
    const int n = (int)min((long long)TILE, T + QLAG - S0);
    if (fits)
      quant_tile<true>(bd, k, row, S0, n, T, o, nxt);
    else
      quant_tile<false>(bd, k, row, S0, n, T, o, nxt);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < QPRE; ++i) {
      const int idx = i * QTHREADS + tid, r = idx / TILE, c = idx % TILE;
      const long long s = S0 - QLAG + c;
      if (r < rows && c < n && s >= 0 && s < T) y[(b0 + r) * T + s] = q_tout[r][c];
    }
  }
  if (live) {
    int16_t* s = st_out + ((b0 + row) * BANDS + k) * 4;
    s[0] = (int16_t)(int)bd.x1;
    s[1] = (int16_t)(int)bd.x2;
    s[2] = (int16_t)(int)bd.y1;
    s[3] = (int16_t)(int)bd.y2;
  }
}

// ---- K7 ---------------------------------------------------------------------

constexpr int LAG = BANDS - 1;  // band 6 runs LAG samples behind band 0
constexpr int SPB = 32;         // streams per block: one warp, one stream per thread

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
  geq_quant_kernel<<<(B + QROWS - 1) / QROWS, QTHREADS, 0, st>>>(x, coef, st_in, y, st_out, B, T);
  return (int)cudaGetLastError();
}

// K7.  x, y (B, T) f32; coef (7, 5) f32 [b0 b1 b2 a1 a2]; zero initial state.
extern "C" int jb_geq_cascade(const float* x, const float* coef, float* y, int B, int T,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  geq_linear_kernel<<<(B + SPB - 1) / SPB, SPB, 0, st>>>(x, coef, y, B, T);
  return (int)cudaGetLastError();
}
