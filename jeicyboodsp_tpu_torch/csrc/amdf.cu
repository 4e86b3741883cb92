// The AMDF lag search of pitch method 2 on Hopper (sm_90a).
//
// K11, jb_amdf, replaces jeicyboodsp_tpu/kernels/amdf_pallas.py: amdf_pallas
// (_make_kernel): (T, 1024) int16 frames -> (T, 512 - lo) f64
//   amdf[k] = sum_{i < 1024-k} |u_i - u_{i+k}| / (1024 - k),  lo <= k < 512
// (PitchEstimation_method2.cpp:79-95).
//
// Exact: the sums run in int32 (each term <= 65535, at most 1024 terms, so
// no overflow) over the masked range itself, and the quotient is one IEEE
// f64 division, which is bit for bit the oracle's float(int_sum) / (1024 -
// k).  The TPU kernel summed in f32 over the zero-padded frame and restored
// the mask on the host with a suffix-sum GEMM; neither is needed here.
//
// What bounds it on this card at T = 16384, lo = 96: 4.91e9 (u_i, u_{i+k})
// pairs, two int32 operations each (subtract, absolute-add), against 88 MB
// of frames and f64 output (0.026 ms), so it is compute-bound.  Design: one
// block per frame, the frame in shared memory as int32, one thread per lag.
// A warp's lanes read u[i + k] at consecutive k (no bank conflicts) and u[i]
// as a broadcast, so each pair also costs one shared-memory load;
// register-blocking several lags per thread is later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

namespace {

constexpr int PROC = 1024;  // samples per frame
constexpr int KEEP = 512;   // lags searched: [lo, 512)

// Grid T, block 512 - lo threads: thread j computes lag lo + j of frame blockIdx.x.
__global__ void __launch_bounds__(KEEP) amdf_kernel(const int16_t* __restrict__ x, int lo,
                                                    double* __restrict__ out) {
  __shared__ int u[PROC];
  const int16_t* f = x + (size_t)blockIdx.x * PROC;
  for (int i = threadIdx.x; i < PROC; i += blockDim.x) u[i] = f[i];
  __syncthreads();
  const int k = lo + threadIdx.x;
  const int n = PROC - k;
  int s = 0;
#pragma unroll 8
  for (int i = 0; i < n; ++i) s += abs(u[i] - u[i + k]);
  out[(size_t)blockIdx.x * (KEEP - lo) + threadIdx.x] = __ddiv_rn((double)s, (double)n);
}

}  // namespace

// K11.  x (T, 1024) int16; lo a multiple of 8 in [0, 512) (the wrapper
// checks); out (T, 512 - lo) f64.
extern "C" int jb_amdf(const int16_t* x, int T, int lo, double* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  amdf_kernel<<<T, KEEP - lo, 0, st>>>(x, lo, out);
  return (int)cudaGetLastError();
}
