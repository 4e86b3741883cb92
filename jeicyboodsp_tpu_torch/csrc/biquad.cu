// The 7-band graphic EQ cascade on Hopper (sm_90a), as three entries of one
// lane-per-band kernel.
//
// K6, jb_geq_cascade_quant (f64) and jb_geq_cascade_quant_f32, replaces
// jeicyboodsp_tpu/kernels/biquad_pallas.py:geq_cascade_pallas_quant
// (_kernel_quant_impl): the reference's direct-form-I cascade with int16
// truncate-and-wrap feedback (7Band_GEQ.cpp:279-300).  The TPU has no f64 and
// computes it in double-single f32; here it runs in the coefficients' type,
// f64 (bit-exact against the f64 oracle) or f32 (jeicyboodsp_tpu/ops/geq.py:
// geq_apply's default dtype), every product and sum rounded as written
// (__dmul_rn, __dadd_rn, __dsub_rn or their f32 forms; the build passes
// -fmad=false) in the reference's order b2*x2 - a2*y2 + b1*x1 - a1*y1 +
// b0*x0, then c_short.  State per stream: (7, 4) int16 = x1, x2, y1, y2 of
// each band, in and out.
//
// K7, jb_geq_cascade, replaces geq_cascade_pallas (_make_kernel): the linear
// f32 transposed-direct-form-II cascade (the fast engine, no quantization),
// y = c0*v + s0; s0 = (c1*v - c3*y) + s1; s1 = c2*v - c4*y, in the TPU
// kernel's op order, each f32 op rounded as written, from zero state.
//
// What bounds them is a dependency chain, not bytes or operations.  Each
// stream is a recursion over time, so the parallelism is across streams and,
// within one stream, across its seven bands once the cascade is skewed: band
// k's input is band k-1's output, so band k runs some steps behind band k-1
// and the seven band updates of a step are independent.  Each stream's own
// operations, and so its result, are those of the unskewed loop.
//
// K6 and K7 share the layout (lane_cascade_kernel, one instance per band
// type): the seven bands of a stream on seven lanes.  A group of 8 lanes
// holds one stream, lane k < 7 band k's 5 coefficients and its state in
// registers (lane 7 idles); a warp holds 4 streams and a block of 4 warps
// 16, so 2048 streams make 512 warps, one per SMSP on 128 of the 132 SMs
// (one thread per stream made 64 warps, which K7 had before).  Skew 2: on
// step s band k takes sample s - 2k, whose input band k-1 made on step
// s - 2; lane k-1 hands its output over by __shfl_up_sync within the group
// (an int for K6, a float for K7) one step ahead, so the shuffle is off the
// chain.  Lane 0 of a group takes its stream's samples from a (16 streams,
// 256 steps) shared tile staged with row-contiguous loads, the next tile's
// loads in flight in registers while the current one runs; every lane of the
// group reads the sample, a step ahead, and lane 0 selects it over the
// shuffled value.  Lane 6 writes its output, 12 samples behind, into a
// second tile, written back the same way.  The fill and drain of 12 steps
// run once per call.  Row pitch: 258 int16 = 129 words (K6), 257 floats
// (K7), so the 4 rows of a warp sit in 4 banks; K7's two tiles take 32.9 KB
// of a block.  Ragged B leaves the last groups empty: they run (whole warps
// take part in the shuffles) but neither read nor write device memory.
//
// What bounds K6 now is one band's step chain: y1 -> a1*y1 -> the
// subtraction -> + b0*x0 -> the truncating conversion and the sign extension
// -> the conversion back, ~65 cycles in f64 by my count, 49,164 steps a
// call, at one warp per SMSP with nothing to hide its latency behind
// (timed alone on the H100 at the redesign, as PERF.md's history records:
// ~113 cycles a step at 2048 streams, 116 at 16).
// c_short's range compares are off it: a launch checks sum |coef| * 32768 <
// 2^30 for every band (the same in every thread, so the choice is uniform);
// then every acc lies well inside int32 and the conversion alone gives
// c_short's int (FITS; 2.7 ms against 4.3 with the compares on the H100).
// Coefficients that fail the check run with the compares.  A warp issues per
// step 9 arithmetic operations, 3 conversions and a shuffle, well inside the
// chain.  The f32 instance runs the same chain in f32 operations.
//
// What bounds K7 now is one warp's issue and latency at one warp per SMSP:
// its band chain, s0 -> y -> c3*y -> the subtraction -> + s1, is ~16 cycles
// a step by my count, and a warp issues ~15 instructions a step around it (9
// f32 operations, the shuffle, the tile's read, lane 6's store, the loop);
// timed alone at the redesign, it reads ~54 cycles a step on the H100 (PERF.md's
// history).  Reading the
// tile on every lane and selecting took K7 from ~61 cycles a step (lane 0
// alone reading, its address arithmetic predicated every step) to ~54; a
// skew of 3, which puts the shuffle two steps ahead, read ~72.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cnum.cuh"

namespace {

constexpr int BANDS = 7;
constexpr int TILE = 256;                       // samples of each stream per tile
constexpr int GROUP = 8;                        // lanes per stream: band k on lane k < 7
constexpr int SKEW = 2;                         // band k runs 2k steps behind band 0
constexpr int LAG = SKEW * (BANDS - 1);         // band 6 runs 12 samples behind band 0
constexpr int THREADS = 128;                    // 4 warps
constexpr int ROWS = THREADS / GROUP;           // 16 streams per block
constexpr int PRE = ROWS * TILE / THREADS;      // samples each thread stages per tile

// each operation rounded as written, in f64 or f32
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ int trunc_rz(double v) { return __double2int_rz(v); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ int trunc_rz(float v) { return __float2int_rz(v); }

// K6: one band of the quantized cascade in T (double or float), in the
// reference's op order.  FITS: the launch found sum |coef| * 32768 < 2^30 for
// every band, so every acc lies well inside int32 (|x|, |y| <= 32768) and
// c_short's range compares, which would sit on the chain before the
// conversion, are left out: the truncating conversion alone then gives the
// same int.  Without FITS, c_short takes acc exactly as a double.
template <class T>
struct QuantBand {
  using io = int16_t;  // the tiles' samples
  using hand = int;    // what lane k-1 hands to lane k
  using coef_t = T;
  static constexpr bool QUANT = true;
  static constexpr int PITCH = TILE + 2;  // 129 words: a warp's 4 rows in 4 banks
  T b0 = 0, b1 = 0, b2 = 0, a1 = 0, a2 = 0;
  T x1 = 0, x2 = 0, y1 = 0, y2 = 0;

  __device__ __forceinline__ void set(const T* ck) {
    b0 = ck[0];
    b1 = ck[1];
    b2 = ck[2];
    a1 = ck[3];
    a2 = ck[4];
  }
  __device__ __forceinline__ void load(const int16_t* s) {
    x1 = s[0];
    x2 = s[1];
    y1 = s[2];
    y2 = s[3];
  }
  __device__ __forceinline__ void store(int16_t* s) const {
    s[0] = (int16_t)(int)x1;
    s[1] = (int16_t)(int)x2;
    s[2] = (int16_t)(int)y1;
    s[3] = (int16_t)(int)y2;
  }
  template <bool FITS>
  __device__ __forceinline__ int step(int in) {
    const T v = (T)in;
    T acc = mul_rn(b2, x2);
    acc = sub_rn(acc, mul_rn(a2, y2));
    acc = add_rn(acc, mul_rn(b1, x1));
    acc = sub_rn(acc, mul_rn(a1, y1));
    acc = add_rn(acc, mul_rn(b0, v));
    const int o = FITS ? (int)(int16_t)(uint16_t)(trunc_rz(acc) & 0xffff) : c_short((double)acc);
    x2 = x1;
    x1 = v;
    y2 = y1;
    y1 = (T)o;
    return o;
  }
};

// K7: one band of the linear f32 cascade, zero state, no quantization.
struct LinearBand {
  using io = float;
  using hand = float;
  using coef_t = float;
  static constexpr bool QUANT = false;
  static constexpr int PITCH = TILE + 1;  // 257 words: a warp's 4 rows in 4 banks
  float c0 = 0, c1 = 0, c2 = 0, c3 = 0, c4 = 0;
  float s0 = 0, s1 = 0;

  __device__ __forceinline__ void set(const float* ck) {
    c0 = ck[0];
    c1 = ck[1];
    c2 = ck[2];
    c3 = ck[3];
    c4 = ck[4];
  }
  template <bool FITS>
  __device__ __forceinline__ float step(float v) {
    const float o = __fadd_rn(__fmul_rn(c0, v), s0);
    s0 = __fadd_rn(__fsub_rn(__fmul_rn(c1, v), __fmul_rn(c3, o)), s1);
    s1 = __fsub_rn(__fmul_rn(c2, v), __fmul_rn(c4, o));
    return o;
  }
};

// the two staging tiles of a block: band 0's samples in, band 6's out
template <class Band>
struct Tiles {
  typename Band::io in[ROWS][Band::PITCH], out[ROWS][Band::PITCH];
};

// Steps S0 .. S0 + n - 1 of the skewed cascade, column c = s - S0 of the
// block's tiles: tl.in holds sample s (band 0's), tl.out takes sample
// s - LAG (band 6's).  nxt is what this lane takes on the next step: lane
// k-1's last output, or for lane 0 the tile's next sample, loaded a step
// ahead so the load is off the chain.  Every lane of the group reads it (the
// same address) and lane 0 selects it, so the loop has no predicated address
// arithmetic.  EDGE steps (the fill and the drain) run only the bands whose
// sample lies in [0, T).
template <bool EDGE, bool FITS, class Band>
__device__ __forceinline__ void lane_steps(Band& bd, Tiles<Band>& tl, int k, int row,
                                           long long S0, int n, long long T,
                                           typename Band::hand& o, typename Band::hand& nxt) {
  const typename Band::io* in = tl.in[row];
  typename Band::io* out = tl.out[row];
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    const typename Band::hand v = nxt;
    const typename Band::hand up = __shfl_up_sync(0xffffffffu, o, 1, GROUP);
    const typename Band::hand next = in[c + 1];  // at c = TILE - 1 the pad column
    nxt = k == 0 ? next : up;
    const long long sk = S0 + c - SKEW * k;  // the sample band k takes on this step
    if (!EDGE || (k < BANDS && sk >= 0 && sk < T)) {
      o = bd.template step<FITS>(v);
      if (k == BANDS - 1) out[c] = (typename Band::io)o;
    }
  }
}

template <bool FITS, class Band>
__device__ __forceinline__ void lane_tile(Band& bd, Tiles<Band>& tl, int k, int row,
                                          long long S0, int n, long long T,
                                          typename Band::hand& o, typename Band::hand& nxt) {
  if (S0 >= LAG && S0 + n <= T)
    lane_steps<false, FITS>(bd, tl, k, row, S0, n, T, o, nxt);
  else
    lane_steps<true, FITS>(bd, tl, k, row, S0, n, T, o, nxt);
}

// x, y (B, T) of Band::io; coef (7, 5) [b0 b1 b2 a1 a2] (K7: c0 .. c4); st_in,
// st_out (B, 7, 4) int16 for K6, null for K7 (zero state).
template <class Band>
__global__ void __launch_bounds__(THREADS)
lane_cascade_kernel(const typename Band::io* __restrict__ x,
                    const typename Band::coef_t* __restrict__ coef,
                    const int16_t* __restrict__ st_in, typename Band::io* __restrict__ y,
                    int16_t* __restrict__ st_out, int B, long long T) {
  using io = typename Band::io;
  using hand = typename Band::hand;
  __shared__ Tiles<Band> tl;
  const int tid = threadIdx.x;
  const int k = tid % GROUP, row = tid / GROUP;
  const long long b0 = (long long)blockIdx.x * ROWS;
  const int rows = (int)min((long long)ROWS, (long long)B - b0);
  const bool live = row < rows && k < BANDS;
  bool fits = true;  // the same in every thread: the choice of variant is uniform
  if (Band::QUANT) {
    for (int j = 0; j < BANDS; ++j) {
      double sum = 0.0;
      for (int i = 0; i < 5; ++i) sum += fabs((double)coef[j * 5 + i]);
      fits = fits && sum * 32768.0 < 1073741824.0;
    }
  }
  Band bd;
  if (k < BANDS) bd.set(coef + k * 5);
  if constexpr (Band::QUANT) {
    if (live) bd.load(st_in + ((b0 + row) * BANDS + k) * 4);
  }
  // the block's (16, TILE) input tile at S0, element i of thread tid at row
  // (i * THREADS + tid) / TILE: row-contiguous, coalesced
  io pre[PRE];
  auto load = [&](long long S0) {
#pragma unroll
    for (int i = 0; i < PRE; ++i) {
      const int idx = i * THREADS + tid, r = idx / TILE, c = idx % TILE;
      pre[i] = (r < rows && S0 + c < T) ? x[(b0 + r) * T + S0 + c] : (io)0;
    }
  };
  load(0);
  hand o = 0, nxt = 0;
  for (long long S0 = 0; S0 < T + LAG; S0 += TILE) {
#pragma unroll
    for (int i = 0; i < PRE; ++i) {
      const int idx = i * THREADS + tid;
      tl.in[idx / TILE][idx % TILE] = pre[i];
    }
    __syncthreads();
    if (S0 + TILE < T) load(S0 + TILE);  // in flight while this tile runs
    if (k == 0) nxt = tl.in[row][0];
    const int n = (int)min((long long)TILE, T + LAG - S0);
    if (!Band::QUANT || fits)
      lane_tile<true>(bd, tl, k, row, S0, n, T, o, nxt);
    else
      lane_tile<false>(bd, tl, k, row, S0, n, T, o, nxt);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PRE; ++i) {
      const int idx = i * THREADS + tid, r = idx / TILE, c = idx % TILE;
      const long long s = S0 - LAG + c;
      if (r < rows && c < n && s >= 0 && s < T) y[(b0 + r) * T + s] = tl.out[r][c];
    }
  }
  if constexpr (Band::QUANT) {
    if (live) bd.store(st_out + ((b0 + row) * BANDS + k) * 4);
  }
}

template <class Band>
int launch(const typename Band::io* x, const typename Band::coef_t* coef, const int16_t* st_in,
           typename Band::io* y, int16_t* st_out, int B, int T, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lane_cascade_kernel<Band><<<(B + ROWS - 1) / ROWS, THREADS, 0, st>>>(x, coef, st_in, y, st_out,
                                                                      B, T);
  return (int)cudaGetLastError();
}

}  // namespace

// K6.  x, y (B, T) int16; coef (7, 5) f64 [b0 b1 b2 a1 a2]; st_in, st_out
// (B, 7, 4) int16.
extern "C" int jb_geq_cascade_quant(const int16_t* x, const double* coef, const int16_t* st_in,
                                    int16_t* y, int16_t* st_out, int B, int T, void* stream) {
  return launch<QuantBand<double>>(x, coef, st_in, y, st_out, B, T, stream);
}

// K6 in f32: the same with coef (7, 5) f32, every operation an f32 one.
extern "C" int jb_geq_cascade_quant_f32(const int16_t* x, const float* coef,
                                        const int16_t* st_in, int16_t* y, int16_t* st_out, int B,
                                        int T, void* stream) {
  return launch<QuantBand<float>>(x, coef, st_in, y, st_out, B, T, stream);
}

// K7.  x, y (B, T) f32; coef (7, 5) f32 [b0 b1 b2 a1 a2]; zero initial state.
extern "C" int jb_geq_cascade(const float* x, const float* coef, float* y, int B, int T,
                              void* stream) {
  return launch<LinearBand>(x, coef, nullptr, y, nullptr, B, T, stream);
}
