// The fused MFCC chain on Hopper (sm_90a).
//
// K10, jb_mfcc_fused, replaces jeicyboodsp_tpu/kernels/mfcc_pallas.py:
// mfcc_fused_pallas (_kernel): (N, 512) int16 frame halves prev, cur ->
// (N, 12) f32 MFCC features, in one pass, mfcc_kernel: per frame [prev |
// cur], pre-emphasis (p[0] = 0, p[i] = f[i] - 0.96 f[i-1]), the Hamming
// window and the real FFT of rfft1024.cuh, |X| of bins 0..511, 38 mel
// channels, logf, the 38 x 12 DCT-II with the lifter.
//
// The TPU kernel folds pre-emphasis and window into 1024 x 512 bases and
// runs the DFT as dense GEMMs (bf16x3) because its matrix unit was the fast
// unit.  The same function through a real FFT is about 5.5e8 f32 flops at
// N = 16384 (0.008 ms at the 67 TFLOP/s f32 peak) against 34.3 MB of frame
// halves in and features out (0.010 ms at 3.35 TB/s), so bytes bound it.
// What the design does about that: the frame is transformed in shared
// memory and |X| stays there for the mel, log and DCT of the same block;
// only the halves and the (N, 12) features cross device memory.
//
// One warp per frame, RF_FPB warps a block, each walking its frames.  The
// mel matrix has at most two non-zeros per row and each channel is a
// contiguous run of bins, so a lane sums its channel's run (the table from
// mfcc_fused.mel_table) out of the frame's |X| row in shared memory; the
// DCT matrix sits in shared memory too.  The TPU kernel's ones-padded mel columns and zero-padded DCT rows
// were a 128-lane layout and have no counterpart.  No fast math: sqrtf and
// logf are IEEE, so a silent frame (exactly zero bins) gives log 0 = -inf
// channels and NaN features, as the oracle does; -fmad=false keeps every
// product and sum as written.

#include <math.h>

#include "rfft1024.cuh"

namespace {

constexpr int HALF = 512;       // samples per frame half = bins kept
constexpr int NMEL = 38;        // mel channels
constexpr int NCEP = 12;        // features
constexpr int MELW_MAX = 1024;  // shared room for the mel weights (<= 2 per bin)
constexpr float PRE = 0.96f;    // pre-emphasis
static_assert(HALF == RF_H, "one frame is two halves");

// K10's frame source for rfft_frame: frame f is [prev[f] | cur[f]],
// pre-emphasised
struct HalvesFrame {
  const int16_t* prev;
  const int16_t* cur;
  long long f;
  __device__ float at(int i) const {
    return (float)(i < HALF ? prev[f * HALF + i] : cur[f * HALF + (i - HALF)]);
  }
  __device__ void pair(int m, float& a, float& b) const {
    const float x0 = at(2 * m), x1 = at(2 * m + 1);
    a = m == 0 ? 0.0f : x0 - PRE * at(2 * m - 1);
    b = x1 - PRE * x0;
  }
};

// Persistent, as K4's pass 1: a block of RF_FPB warps keeps the constants
// and the mel and DCT tables in shared memory, and each warp takes frames
// f0, f0 + RF_FPB * grid, ...  runs: (38, 3) int32 lo, hi, offset of each
// channel's run of bins in melw; dct: (38, 12) f32; consts as rfft1024.cuh
// lays them out.
__global__ void __launch_bounds__(RF_THREADS, 4) mfcc_kernel(
    const int16_t* __restrict__ prev, const int16_t* __restrict__ cur, int N,
    const float* __restrict__ consts, const int* __restrict__ runs,
    const float* __restrict__ melw, int n_w, const float* __restrict__ dct,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float w[MELW_MAX];
  __shared__ float D[NMEL * NCEP];
  __shared__ int R[NMEL * 3];
  __shared__ float lm[RF_FPB][NMEL];
  for (int i = threadIdx.x; i < RF_CONSTS; i += blockDim.x) smem[i] = consts[i];
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) w[i] = melw[i];
  for (int i = threadIdx.x; i < NMEL * NCEP; i += blockDim.x) D[i] = dct[i];
  for (int i = threadIdx.x; i < NMEL * 3; i += blockDim.x) R[i] = runs[i];
  __syncthreads();
  const int slot = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* row = smem + RF_CONSTS + 2 * slot * RF_PLANE;
  for (long long f = (long long)blockIdx.x * RF_FPB + slot; f < N;
       f += (long long)gridDim.x * RF_FPB) {
    float xr[RF_VPT], xi[RF_VPT];
    rfft_frame(HalvesFrame{prev, cur, f}, smem, row, row + RF_PLANE, lane, xr, xi);
    __syncwarp();  // the frame's Z read before |X| replaces it
#pragma unroll
    for (int q = 0; q < RF_VPT; ++q)
      row[lane + 32 * q] = sqrtf(__fadd_rn(__fmul_rn(xr[q], xr[q]), __fmul_rn(xi[q], xi[q])));
    __syncwarp();
    // the channels widest first (runs of 86 bins down to 3): the six a lane
    // takes second are the narrowest, so the warp waits for 86 + 5 bins
    for (int k = lane; k < NMEL; k += 32) {
      const int c = NMEL - 1 - k;
      const int lo = R[3 * c], hi = R[3 * c + 1], off = R[3 * c + 2] - lo;
      float s = 0.0f;
#pragma unroll 4
      for (int i = lo; i < hi; ++i) s = __fadd_rn(s, __fmul_rn(w[off + i], row[i]));
      lm[slot][c] = logf(s);  // log 0 = -inf
    }
    __syncwarp();
    if (lane < NCEP) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < NMEL; ++c) s = __fadd_rn(s, __fmul_rn(lm[slot][c], D[c * NCEP + lane]));
      out[(size_t)f * NCEP + lane] = s;
    }
    __syncwarp();  // |X| and the channels read before the next frame writes them
  }
}

}  // namespace

// K10.  prev, cur (N, 512) int16; rfft (RF_CONSTS,) f32, rfft1024.cuh's
// constants with the Hamming window; mel_runs (38, 3) int32; mel_w (n_w,)
// f32, n_w <= 1024; dct (38, 12) f32.  Output from the caller: out (N, 12)
// f32.  One launch.
extern "C" int jb_mfcc_fused(const int16_t* prev, const int16_t* cur, int N, const float* rfft,
                             const int* mel_runs, const float* mel_w, int n_w, const float* dct,
                             float* out, void* stream) {
  if (n_w > MELW_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the constants and planes are dynamic; with the mel and DCT tables the
  // block passes 48 KB
  const cudaError_t e =
      cudaFuncSetAttribute(mfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RF_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = rf_grid(mfcc_kernel, RF_SMEM, (N + RF_FPB - 1) / RF_FPB);
  mfcc_kernel<<<grid, RF_THREADS, RF_SMEM, st>>>(prev, cur, N, rfft, mel_runs, mel_w, n_w, dct,
                                                 out);
  return (int)cudaGetLastError();
}
