// The fused MFCC chain on Hopper (sm_90a).
//
// K10, jb_mfcc_fused, replaces jeicyboodsp_tpu/kernels/mfcc_pallas.py:
// mfcc_fused_pallas (_kernel): (N, 512) int16 frame halves prev, cur ->
// (N, 12) f32 MFCC features, in two passes:
//   1. mag_kernel  |X| = |[prev, cur] @ (Cf + i Sf)| (N, 512), K = 1024, with
//                  pre-emphasis and the Hamming window folded into the bases
//                  on the host (kernels/mfcc_fused.py: mfcc_consts)
//   2. cep_kernel  per frame: 38 mel channels, logf, 38 x 12 DCT + lifter
//
// What bounds it on this card at N = 16384: pass 1 is 1.72e10 MACs (0.10 ms
// as bf16x3 on tensor cores, 0.51 ms as f32 FMA on CUDA cores) against
// ~38 MB of frames, bases and features (0.011 ms), so it is compute-bound.
// It is K4's GEMM (the same shape), through the tile GEMM of sgemm.cuh in
// plain f32, where the TPU kernel ran bf16x3 because Mosaic has no
// Precision.HIGH.  The bases come with cos and sin columns interleaved in
// runs of 64, so one 128-column tile holds re and im of the same 64 bins and
// each thread forms |X| of its own outputs: only |X| reaches memory (34 MB
// of scratch, read once by pass 2).  A tensor-core form is later work.
//
// Pass 2 is one warp per frame.  The mel matrix has at most two non-zeros
// per row and each channel is a contiguous run of bins, so a lane sums its
// channel's run (the table from mfcc_fused.mel_table) out of the frame's
// |X| row in shared memory; the DCT matrix sits in shared memory too.  The
// TPU kernel's ones-padded mel columns and zero-padded DCT rows were a
// 128-lane layout and have no counterpart.  No fast math: sqrtf and logf are
// IEEE, so a silent frame gives log 0 = -inf channels and NaN features, as
// the oracle does; -fmad=false keeps every product and sum of pass 2 as
// written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sgemm.cuh"

namespace {

constexpr int HALF = 512;     // samples per frame half = bins kept
constexpr int NMEL = 38;      // mel channels
constexpr int NCEP = 12;      // features
constexpr int MELW_MAX = 1024;  // shared room for the mel weights (<= 2 per bin)
constexpr int FPB = 8;        // frames per block of pass 2, one warp each

// [prev | cur] int16 rows as f32, K = 1024; zeros for rows t >= N
struct HalvesA {
  const int16_t* prev;
  const int16_t* cur;
  int N;
  __device__ float4 load(int t, int k) const {
    if (t >= N) return make_float4(0.f, 0.f, 0.f, 0.f);
    const int16_t* p = k < HALF ? prev + (size_t)t * HALF + k : cur + (size_t)t * HALF + (k - HALF);
    const short4 v = *reinterpret_cast<const short4*>(p);
    return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
  }
};

// Pass 1.  Grid (ceil(N/BM), 8): tile y covers bins [64y, 64y + 64), its
// columns 0-63 the cos and 64-127 the sin bases of those bins, so acc[i][j]
// and acc[i][j + 4] are re and im of one bin.
__global__ void __launch_bounds__(GT) mag_kernel(const int16_t* __restrict__ prev,
                                                 const int16_t* __restrict__ cur, int N,
                                                 const float* __restrict__ bases,
                                                 float* __restrict__ mag) {
  const int y = blockIdx.y;
  float acc[8][8];
  sgemm_tile(HalvesA{prev, cur, N}, 2 * HALF, bases, 2 * HALF, y * BN, acc);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bin0 = 64 * y + 4 * tx;
  for (int i = 0; i < 8; ++i) {
    const int t = blockIdx.x * BM + sub(ty, i);
    if (t >= N) continue;
    float m[4];
    for (int j = 0; j < 4; ++j)
      m[j] = sqrtf(__fadd_rn(__fmul_rn(acc[i][j], acc[i][j]),
                             __fmul_rn(acc[i][j + 4], acc[i][j + 4])));
    *reinterpret_cast<float4*>(mag + (size_t)t * HALF + bin0) = make_float4(m[0], m[1], m[2], m[3]);
  }
}

// Pass 2.  runs: (38, 3) int32 lo, hi, offset of each channel's run of
// bins in melw; dct: (38, 12) f32.
__global__ void __launch_bounds__(FPB * 32) cep_kernel(const float* __restrict__ mag, int N,
                                                       const int* __restrict__ runs,
                                                       const float* __restrict__ melw, int n_w,
                                                       const float* __restrict__ dct,
                                                       float* __restrict__ out) {
  __shared__ float w[MELW_MAX];
  __shared__ float D[NMEL * NCEP];
  __shared__ int R[NMEL * 3];
  __shared__ __align__(16) float row[FPB][HALF];
  __shared__ float lm[FPB][NMEL];
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) w[i] = melw[i];
  for (int i = threadIdx.x; i < NMEL * NCEP; i += blockDim.x) D[i] = dct[i];
  for (int i = threadIdx.x; i < NMEL * 3; i += blockDim.x) R[i] = runs[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * FPB + warp;
  if (t >= N) return;  // a whole warp: only __syncwarp below
  const float4* src = reinterpret_cast<const float4*>(mag + (size_t)t * HALF);
  for (int q = lane; q < HALF / 4; q += 32) reinterpret_cast<float4*>(row[warp])[q] = src[q];
  __syncwarp();
  for (int c = lane; c < NMEL; c += 32) {
    const int lo = R[3 * c], hi = R[3 * c + 1], off = R[3 * c + 2] - lo;
    float s = 0.0f;
    for (int i = lo; i < hi; ++i) s = __fadd_rn(s, __fmul_rn(w[off + i], row[warp][i]));
    lm[warp][c] = logf(s);  // log 0 = -inf
  }
  __syncwarp();
  if (lane < NCEP) {
    float s = 0.0f;
    for (int c = 0; c < NMEL; ++c) s = __fadd_rn(s, __fmul_rn(lm[warp][c], D[c * NCEP + lane]));
    out[(size_t)t * NCEP + lane] = s;
  }
}

}  // namespace

// K10.  prev, cur (N, 512) int16, 8-byte aligned; bases (1024, 1024) f32,
// cos and sin columns interleaved in runs of 64; mel_runs (38, 3) int32;
// mel_w (n_w,) f32, n_w <= 1024; dct (38, 12) f32.  Scratch from the caller:
// mag (N, 512) f32; out (N, 12) f32.
extern "C" int jb_mfcc_fused(const int16_t* prev, const int16_t* cur, int N, const float* bases,
                             const int* mel_runs, const float* mel_w, int n_w, const float* dct,
                             float* mag, float* out, void* stream) {
  if (n_w > MELW_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mag_kernel<<<dim3((N + BM - 1) / BM, 8), GT, 0, st>>>(prev, cur, N, bases, mag);
  cep_kernel<<<(N + FPB - 1) / FPB, FPB * 32, 0, st>>>(mag, N, mel_runs, mel_w, n_w, dct, out);
  return (int)cudaGetLastError();
}
