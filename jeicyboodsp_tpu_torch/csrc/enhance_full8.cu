// The enhancement chain of engines mxu8f / mxu8t on Hopper (sm_90a), and
// the noise latch over magnitude planes of engines mxu8 / mxu3.
//
// Replaces the Pallas kernel jeicyboodsp_tpu/kernels/enhance_pallas.py:
// enhance_full8_pallas (_make_full8_kernel and its helpers _fwd8_plane,
// _quant_row_int8, _inv_plane8, _c_short_f32).  Same math, other blocks:
// the TPU kernel walks a sequential grid of 256-row tiles and carries the
// previous row, the noise-latch state and the OLA tail from one step to
// the next; CUDA blocks run in no order, so each carry becomes a separate
// pass here, run one after another on one stream by jb_enhance_full8:
//
//   1. fwd8_kernel     int8-split forward rDFT on the tensor cores -> re,
//                      im planes (the prev row is input row t-1, zeros for
//                      t = 0; enhance_common.cuh, shared with K2)
//   2. nyq_kernel      the Nyquist bin as a true f32 dot -> ren, and the
//                      frame flag nz (whether [x[t-1], x[t]] holds a
//                      nonzero sample: bin_gain's 0/0 rule)
//   3. latch_prefix    per-chunk (L rows) inclusive sums of w_j*|X_j|
//   4. latch_scan      A0_{c+1} = a_c*A0_c + a_c*S_c over the T/L chunks
//   5. gain_quant      ns = p_g*(P[g] + A0[chunk(g)]), gain, two-level
//                      per-row int8 quantization, y512 column
//   6. inv8_kernel     int8 inverse on the tensor cores: u (with the
//                      Nyquist term) and v (enhance_common.cuh, shared with K3)
//   7. ola_kernel      head = u - v, tail = [y512, flip(u + v)[1:]] of row
//                      t-1 (an index permutation), OLA, c_short, mask
//
// jb_noise_latch runs passes 3-4 on given magnitude planes (513 bins: a
// (T, 512) plane and the Nyquist column) and gathers the latched estimate
// of every row.  In the JAX package that latch is XLA glue between two
// kernels (ops/enhance.py:_noise_latch_parts); it is bound by the bytes of
// the planes it reads and writes.
//
// Bound on this card: the int8 dots (16 per output bin forward, 3-5
// inverse, K = 512) -- about 0.1 T int8 MACs at T = 16384 rows.  Both
// run on the tensor cores (mma.sync s8); the planes between passes go
// through device memory.  Keeping the planes on chip is later work.
// Exactness: see enhance_common.cuh.

#include "enhance_common.cuh"

namespace {

constexpr int LATCH_COLS = 128;  // bins (threads) per block of the latch passes

__global__ void nyq_kernel(const int16_t* __restrict__ x,
                           const float* __restrict__ nyq,
                           float* __restrict__ ren, float* __restrict__ nz) {
  __shared__ float red[32];
  int any;
  const float v = nyq_row(x, nyq, blockIdx.x, red, &any);
  if (threadIdx.x == 0) {
    ren[blockIdx.x] = v;
    nz[blockIdx.x] = any ? 1.0f : 0.0f;
  }
}

// 3. inclusive prefix of w_j*m_j within each chunk of L rows, bins k <
// 513.  PLANES: m = a (T, 512) itself, the magnitude plane; else m = |X|
// from re = a and im = b.  Bin 512 is |an| (an: ren, or the Nyquist
// magnitudes).  pfx: (T, 513).
template <bool PLANES>
__global__ void latch_prefix_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    const float* __restrict__ an,
                                    const float* __restrict__ rowpack,
                                    float* __restrict__ pfx, int L) {
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= NB) return;
  float acc = 0.0f;
  for (int j = 0; j < L; ++j) {
    const size_t t = (size_t)blockIdx.x * L + j;
    float m;
    if (k == N) {
      m = fabsf(an[t]);
    } else if (PLANES) {
      m = a[t * N + k];
    } else {
      const float x = a[t * N + k], y = b[t * N + k];
      m = sqrtf(x * x + y * y);
    }
    acc = acc + rowpack[t * RP] * m;
    pfx[t * NB + k] = acc;
  }
}

// 4. chunk-entry states A0 (C, 513): A0_{c+1} = a_c*A0_c + a_c*S_c with
// a_c = p at the chunk's last row (a power of two: exact scalings).
__global__ void latch_scan_kernel(const float* __restrict__ pfx,
                                  const float* __restrict__ rowpack,
                                  float* __restrict__ A0, int C, int L) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= NB) return;
  float A = 0.0f;
  for (int c = 0; c < C; ++c) {
    const size_t last = (size_t)c * L + L - 1;
    A0[(size_t)c * NB + k] = A;
    const float a = rowpack[last * RP + 1];
    A = a * A + a * pfx[last * NB + k];
  }
}

// the latched estimate of row t and bin k: p_g*(P[g] + A0[chunk(g)]), 0
// before the first latch (g < 0)
__device__ __forceinline__ float latched(const float* __restrict__ rowpack,
                                         const float* __restrict__ pfx,
                                         const float* __restrict__ A0, int t,
                                         int k, int L) {
  const float g = rowpack[(size_t)t * RP + 2], pg = rowpack[(size_t)t * RP + 3];
  if (g < 0.0f) return 0.0f;
  const size_t gi = (size_t)g, cg = gi / L;
  return pg * pfx[gi * NB + k] + pg * A0[cg * NB + k];
}

// 5. of jb_noise_latch: the estimate of every row, ns (T, 512) and the
// Nyquist bin nsn (T,), one block of LATCH_COLS bins.
__global__ void latch_gather_kernel(const float* __restrict__ rowpack,
                                    const float* __restrict__ pfx,
                                    const float* __restrict__ A0,
                                    float* __restrict__ ns,
                                    float* __restrict__ nsn, int L) {
  const int t = blockIdx.x, k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k > N) return;
  const float v = latched(rowpack, pfx, A0, t, k, L);
  if (k < N) {
    ns[(size_t)t * N + k] = v;
  } else {
    nsn[t] = v;
  }
}

// 5. of K1: one block of N threads per row.
__global__ void __launch_bounds__(N) gain_quant_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ ren, const float* __restrict__ nz,
    const float* __restrict__ rowpack, const float* __restrict__ pfx,
    const float* __restrict__ A0, const float* __restrict__ y512col,
    int8_t* __restrict__ q8, float* __restrict__ rowsc, int T, int L, int wiener,
    int hq) {
  const int t = blockIdx.x, k = threadIdx.x;
  const float ns = latched(rowpack, pfx, A0, t, k, L);
  const float nsn = latched(rowpack, pfx, A0, t, N, L);
  gain_quant_body(re[(size_t)t * N + k], im[(size_t)t * N + k], ren[t], ns, nsn,
                  nz[t] != 0.0f, y512col, q8, rowsc, T, wiener, hq);
}

__global__ void __launch_bounds__(N) ola_kernel(const float* __restrict__ uv,
                                                const float* __restrict__ rowsc,
                                                int16_t* __restrict__ out, int T,
                                                int emit_all) {
  ola_body(uv, rowsc, out, T, emit_all);
}

}  // namespace

// Launches passes 1-7 on `stream`.  Every buffer is allocated by the caller:
//   re, im (T, 512) f32; ren, nz (T,) f32; pfx (T, 513) f32; A0 (T/L, 513) f32;
//   q8 (6, T, 512) int8; rowsc (T, 8) f32; uv (2, T, 512) f32;
//   out (T, 512) int16.
// T must be a multiple of L and of 8.  Returns cudaGetLastError().
extern "C" int jb_enhance_full8(
    const int16_t* x, const float* rowpack, int T, int L, int wiener, int hq,
    int emit_all, const int8_t* fwd8, const float* fscales, const float* fcrows,
    const float* nyq, const int8_t* back8, const float* bscales,
    const float* bcrows, const float* u_nyq, const float* y512col, float* re,
    float* im, float* ren, float* nz, float* pfx, float* A0, int8_t* q8, float* rowsc,
    float* uv, int16_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = T / L;
  const int kb = (NB + LATCH_COLS - 1) / LATCH_COLS;
  cudaError_t e = launch_fwd8(x, T, fwd8, fscales, fcrows, re, im, nullptr, st);
  if (e != cudaSuccess) return (int)e;
  nyq_kernel<<<T, ROW_THREADS, 0, st>>>(x, nyq, ren, nz);
  latch_prefix_kernel<false><<<dim3(C, kb), LATCH_COLS, 0, st>>>(re, im, ren, rowpack, pfx,
                                                               L);
  latch_scan_kernel<<<kb, LATCH_COLS, 0, st>>>(pfx, rowpack, A0, C, L);
  gain_quant_kernel<<<T, N, 0, st>>>(re, im, ren, nz, rowpack, pfx, A0, y512col,
                                     q8, rowsc, T, L, wiener, hq);
  e = launch_inv8(q8, T, back8, bscales, bcrows, rowsc, u_nyq, uv, hq, st);
  if (e != cudaSuccess) return (int)e;
  ola_kernel<<<T, N, 0, st>>>(uv, rowsc, out, T, emit_all);
  return (int)cudaGetLastError();
}

// The closed-form noise latch over the 513 bins of the magnitude planes
// mag (T, 512) and magn (T,): the latched estimates ns (T, 512) and nsn
// (T,) from the row pack [w, p, g, p[g]] (ops/enhance.py:_latch_rowpack).
// Scratch from the caller: pfx (T, 513), A0 (T/L, 513).  T % L == 0.
extern "C" int jb_noise_latch(const float* mag, const float* magn,
                              const float* rowpack, int T, int L, float* pfx,
                              float* A0, float* ns, float* nsn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = T / L;
  const int kb = (NB + LATCH_COLS - 1) / LATCH_COLS;
  latch_prefix_kernel<true><<<dim3(C, kb), LATCH_COLS, 0, st>>>(mag, nullptr, magn, rowpack,
                                                              pfx, L);
  latch_scan_kernel<<<kb, LATCH_COLS, 0, st>>>(pfx, rowpack, A0, C, L);
  latch_gather_kernel<<<dim3(T, kb), LATCH_COLS, 0, st>>>(rowpack, pfx, A0, ns, nsn, L);
  return (int)cudaGetLastError();
}
