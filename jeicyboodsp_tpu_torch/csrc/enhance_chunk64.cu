// K15, jb_enhance_chunk64: one chunk of the float64 compat stream
// (ops/enhance.py: enhance_chunk, the generic path in f64; the reference's
// WienerFilter_final.cpp / SpectralSubtraction_final.cpp, block by block)
// in one launch, from the carried state to the new one.  It replaces no TPU
// kernel: the JAX package runs this chunk as plain XLA ops.  It was added
// because on the card the same chain as torch ops is bound by the host: some
// 135 launches and 7 host reads of card values a chunk of two blocks, for
// well under 0.2 ms of device work.
//
// Per row t of the chunk, in order, with the same f64 arithmetic as the
// torch chain:
// - the frame [prev, cur] (prev = the carried prev_block for the first row)
//   times the window (ops' hamming_ref(1024, f64) on this card, passed in);
// - a 1024-point complex forward FFT: five radix-4 Stockham passes in shared
//   memory, twiddles W^k = exp(-2 pi i k / 1024) from a host-built table;
// - the VAD (vad_flags in f64): s = c_short(x * w) on the block's half of the
//   frame, energy = sum(s^2) / 1024 > 700 (an integer sum here: exact in any
//   order, as in f64), ZCR = #{s[i] * x[i+1] < 0} (the last pairs with 0)
//   < 200;
// - the noise scan in the scan's own order: cnt goes on from the carried
//   count, a noise row with cnt >= 2 adds |X| = hypot(re, im) to avg, halves
//   it when cnt >= 3, and latches it at cnt == 10; the row's estimate is the
//   latest latch (or the carried latched);
// - the gain and trig resynthesis, Wiener (v = ns^2 / P, 1 where v >= 1, NaN
//   kept; amp = sqrt(P) (1 - v)) or spectral subtraction (amp = |X| - ns);
//   phase = atan2(im, re), Y = amp (cos, sin);
// - a 1024-point complex inverse FFT (conjugate twiddles), times 1/1024,
//   real part;
// - the OLA with the previous row's tail, gated by the global block index
//   t0 + row (the carried t: written from 2 on, head alone never written),
//   stored through c_short (csrc/cnum.cuh).  A NaN row (a bin exactly 0
//   while the estimate is 0, Wiener) comes out as zeros, as the torch chain
//   writes it.
//
// Bound on this card: the bytes (the blocks, the state, the 8 KB window and
// 16 KB of twiddles in; the rows, the mask and the state out) take
// nanoseconds at 3.35 TB/s, and a row's ~0.12 M f64 operations (two FFTs;
// hypot, sqrt, a division, atan2, cos and sin a bin, each counted as one) as
// many at the card's f64 peak.  The rows depend on each other (the noise
// state, the OLA tail), so the floor is one launch and one SM's chain of
// rows, bound by that SM's f64 pipes: see utils/profiling.py,
// KERNELS["K15"].  The design keeps that chain short:
// - one block of 256 threads, one radix-4 butterfly a thread a pass; thread
//   j's Stockham passes read bins j + 256 r and the last pass writes them, so
//   the forward pass's first loads come from global memory and the inverse
//   pass's first operands from registers: four exchanges through shared
//   memory each way, one barrier each, ping-pong buffers;
// - thread j owns bins j + 256 r (r < 4) through the whole chunk: the noise
//   state (avg, latched) of its bins and its two OLA tail samples stay in
//   registers from row to row, so nothing of the state goes back to memory
//   before the last row;
// - the VAD reuses the frame's products x * w of the block half; its warp
//   sums go to shared memory before the forward passes' barriers and are
//   read after them;
// - the next row's four samples are loaded while the current row runs.
// Everything is f64 throughout; the build's -fmad=false keeps each product
// and sum rounded on its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cnum.cuh"

namespace {

constexpr int BL = 512;           // samples a block
constexpr int NF = 1024;          // frame and FFT size
constexpr int THREADS = NF / 4;   // one radix-4 butterfly a thread a pass
constexpr int WARPS = THREADS / 32;
constexpr int NTW = 3 * (THREADS - 1) + 1;  // twiddles W^k a pass reads: k <= 3 * 255
constexpr int NOISE_FRAMES = 10;
constexpr long long ENERGY_LIMIT = 700LL * NF;  // energy / 1024 > 700
constexpr int ZCR_LIMIT = 200;

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
// a * w, or a * conj(w) for the inverse
template <bool INV>
__device__ __forceinline__ double2 cmul(double2 a, double2 w) {
  return INV ? make_double2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y)
             : make_double2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// one radix-4 Stockham pass over sub-transforms of length NS (1, 4, ..., 256)
// for thread j: its four inputs v (src[j + 256 r], already loaded), twiddled
// by W^(r k 256 / NS), k = j % NS (conjugated for the inverse), through the
// 4-point DFT; the outputs go to dst[(j / NS) 4 NS + k + r NS], or stay in v
// for the last pass (NS = 256), whose outputs are src's positions j + 256 r.
template <bool INV, int NS>
__device__ __forceinline__ void pass(double2 (&v)[4], const double2* tw, double2* dst, int j) {
  const int k = j % NS;
  if (NS > 1) {
#pragma unroll
    for (int r = 1; r < 4; ++r) v[r] = cmul<INV>(v[r], tw[r * k * (THREADS / NS)]);
  }
  const double2 a = cadd(v[0], v[2]), b = csub(v[0], v[2]);
  const double2 c = cadd(v[1], v[3]), d = csub(v[1], v[3]);
  v[0] = cadd(a, c);
  v[2] = csub(a, c);
  // forward: y1 = b - i d, y3 = b + i d; the inverse swaps them
  const double2 bmid = make_double2(b.x + d.y, b.y - d.x);
  const double2 bpid = make_double2(b.x - d.y, b.y + d.x);
  v[1] = INV ? bpid : bmid;
  v[3] = INV ? bmid : bpid;
  if (NS < THREADS) {
    const int base = (j / NS) * 4 * NS + k;
#pragma unroll
    for (int r = 0; r < 4; ++r) dst[base + r * NS] = v[r];
  }
}

__device__ __forceinline__ void load(double2 (&v)[4], const double2* src, int j) {
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = src[j + r * THREADS];
}

// passes 2-5 of a transform whose first pass wrote buf[0]: the result in v
// (thread j's positions j + 256 r); one barrier before each pass
template <bool INV>
__device__ __forceinline__ void passes_2_to_5(double2 (&v)[4], double2 (*buf)[NF],
                                              const double2* tw, int j) {
  __syncthreads();
  load(v, buf[0], j);
  pass<INV, 4>(v, tw, buf[1], j);
  __syncthreads();
  load(v, buf[1], j);
  pass<INV, 16>(v, tw, buf[0], j);
  __syncthreads();
  load(v, buf[0], j);
  pass<INV, 64>(v, tw, buf[1], j);
  __syncthreads();
  load(v, buf[1], j);
  pass<INV, 256>(v, tw, nullptr, j);
}

__global__ void __launch_bounds__(THREADS, 1)
    chunk64_kernel(const int16_t* __restrict__ blocks, int Tc, const double* __restrict__ window,
                   const double2* __restrict__ twiddles, const int* __restrict__ cnt_in,
                   const double* __restrict__ avg_in, const double* __restrict__ lat_in,
                   const int16_t* __restrict__ prev_block_in,
                   const double* __restrict__ prev_tail_in, const int* __restrict__ t_in,
                   int wiener, int16_t* __restrict__ out, uint8_t* __restrict__ mask,
                   int* __restrict__ cnt_out, double* __restrict__ avg_out,
                   double* __restrict__ lat_out, int16_t* __restrict__ prev_block_out,
                   double* __restrict__ prev_tail_out, int* __restrict__ t_out) {
  __shared__ double2 buf[2][NF];
  __shared__ double2 tw[NTW];
  __shared__ long long red_e[WARPS];
  __shared__ int red_z[WARPS];
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;

  for (int i = j; i < NTW; i += THREADS) tw[i] = twiddles[i];  // read after the first barrier
  double w[4], avg[4], lat[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    w[r] = window[j + r * THREADS];
    avg[r] = avg_in[j + r * THREADS];
    lat[r] = lat_in[j + r * THREADS];
  }
  double tail[2] = {prev_tail_in[j], prev_tail_in[j + THREADS]};
  long long cnt = cnt_in[0];
  const long long t0 = t_in[0];
  // the frame's four samples of thread j (positions j + 256 r: prev, prev, cur,
  // cur) and the VAD's right neighbours of the two cur ones
  int x[4] = {prev_block_in[j], prev_block_in[j + THREADS], blocks[j], blocks[j + THREADS]};
  int nb[2] = {blocks[j + 1], j + THREADS + 1 < BL ? blocks[j + THREADS + 1] : 0};

  for (int row = 0; row < Tc; ++row) {
    // the next row's samples, in flight while this one runs
    int nx[2] = {0, 0}, nn[2] = {0, 0};
    if (row + 1 < Tc) {
      const int16_t* nxt = blocks + (size_t)(row + 1) * BL;
      nx[0] = nxt[j];
      nx[1] = nxt[j + THREADS];
      nn[0] = nxt[j + 1];
      nn[1] = j + THREADS + 1 < BL ? nxt[j + THREADS + 1] : 0;
    }

    // forward pass 1 (NS = 1: no twiddles) on the windowed frame, and the VAD
    double2 v[4];
    double p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      p[r] = (double)x[r] * w[r];
      v[r] = make_double2(p[r], 0.0);
    }
    long long e = 0;
    int z = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = c_short(p[2 + h]);
      e += (long long)(s * s);  // |s| <= 32768: s * s fits an int
      z += s * nb[h] < 0 ? 1 : 0;
    }
    for (int o = 16; o > 0; o >>= 1) {
      e += __shfl_xor_sync(0xffffffffu, e, o);
      z += __shfl_xor_sync(0xffffffffu, z, o);
    }
    if (lane == 0) {
      red_e[warp] = e;
      red_z[warp] = z;
    }
    pass<false, 1>(v, tw, buf[0], j);
    passes_2_to_5<false>(v, buf, tw, j);  // v[r] = X[j + 256 r]
    // the VAD's warp sums, behind the barriers of the passes (the next row
    // writes them after the inverse's barriers)
    e = 0;
    z = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      e += red_e[i];
      z += red_z[i];
    }
    const bool speech = e > ENERGY_LIMIT || z < ZCR_LIMIT;

    // the noise scan's step, then the gain and the trig resynthesis of the bins
    cnt = speech ? 0 : cnt + 1;
    const bool run = !speech && cnt >= 2;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const double re = v[r].x, im = v[r].y;
      const double mag = hypot(re, im);
      if (run) {
        avg[r] = avg[r] + mag;
        if (cnt >= 3) avg[r] = avg[r] / 2.0;
        if (cnt == NOISE_FRAMES) lat[r] = avg[r];
      }
      const double ns = lat[r];
      double amp;
      if (wiener) {
        const double P = re * re + im * im;
        double g = ns * ns / P;  // 0/0 -> NaN, k/0 -> inf, as the reference
        if (g >= 1.0) g = 1.0;   // NaN stays NaN
        amp = fabs(sqrt(P)) * (1.0 - g);
      } else {
        amp = mag - ns;
      }
      const double phase = atan2(im, re);
      v[r] = make_double2(amp * cos(phase), amp * sin(phase));
    }

    // the inverse: pass 1 from the registers (thread j holds bins j + 256 r)
    pass<true, 1>(v, tw, buf[0], j);
    passes_2_to_5<true>(v, buf, tw, j);  // v[r] = 1024 y[j + 256 r]

    // OLA: y[j], y[j + 256] with the previous row's tail; this row's tail is
    // y[512 + j], y[768 + j]
    const long long g = t0 + row;
    const bool write = g >= 2;
    const double y0 = v[0].x * (1.0 / NF), y1 = v[1].x * (1.0 / NF);
    int16_t* o = out + (size_t)row * BL;
    o[j] = write ? (int16_t)c_short(y0 + tail[0]) : (int16_t)0;
    o[j + THREADS] = write ? (int16_t)c_short(y1 + tail[1]) : (int16_t)0;
    if (j == 0) mask[row] = write ? 1 : 0;
    tail[0] = v[2].x * (1.0 / NF);
    tail[1] = v[3].x * (1.0 / NF);

    x[0] = x[2];
    x[1] = x[3];
    x[2] = nx[0];
    x[3] = nx[1];
    nb[0] = nn[0];
    nb[1] = nn[1];
  }

  // the new state
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    avg_out[j + r * THREADS] = avg[r];
    lat_out[j + r * THREADS] = lat[r];
  }
  prev_tail_out[j] = tail[0];
  prev_tail_out[j + THREADS] = tail[1];
  prev_block_out[j] = (int16_t)x[0];
  prev_block_out[j + THREADS] = (int16_t)x[1];
  if (j == 0) {
    cnt_out[0] = (int)cnt;
    t_out[0] = (int)((unsigned)t_in[0] + (unsigned)Tc);  // int32 arithmetic, wrapping
  }
}

}  // namespace

// blocks: (Tc, 512) int16, Tc >= 1; window: (1024,) f64; twiddles: (1024, 2)
// f64, W^k as (cos, sin) (the first NTW read); the state in and out with the
// JAX layout: cnt () int32, avg (1024,) f64, latched (1024,) f64, prev_block
// (512,) int16, prev_tail (512,) f64, t () int32; out (Tc, 512) int16; mask
// (Tc,) bytes 0/1 (a torch.bool tensor).  Every pointer 16-byte aligned but
// the int16 and int32 ones.  wiener: 1 Wiener, 0 spectral subtraction.
extern "C" int jb_enhance_chunk64(const int16_t* blocks, int Tc, const double* window,
                                  const double* twiddles, const int* cnt_in, const double* avg_in,
                                  const double* lat_in, const int16_t* prev_block_in,
                                  const double* prev_tail_in, const int* t_in, int wiener,
                                  int16_t* out, uint8_t* mask, int* cnt_out, double* avg_out,
                                  double* lat_out, int16_t* prev_block_out, double* prev_tail_out,
                                  int* t_out, void* stream) {
  if (Tc < 1) return (int)cudaErrorInvalidValue;
  chunk64_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, Tc, window, reinterpret_cast<const double2*>(twiddles), cnt_in, avg_in, lat_in,
      prev_block_in, prev_tail_in, t_in, wiener, out, mask, cnt_out, avg_out, lat_out,
      prev_block_out, prev_tail_out, t_out);
  return (int)cudaGetLastError();
}
