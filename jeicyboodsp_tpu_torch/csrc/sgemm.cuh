// The f32 tile GEMM that K4 (enhance_mxu3.cu: fwd32_kernel, inv32_kernel)
// and K10 (mfcc.cu: mag_kernel) share: plain f32 FMAs on CUDA cores, a
// 128 x 128 output tile per block of 256 threads, 8 x 8 outputs per thread,
// K in steps of 8 through double-buffered shared memory.
//
// The left operand comes from a loader struct A with
//   __device__ float4 load(int t, int k) const;
// which returns 4 consecutive values of row t at column k (k a multiple of
// 4) and zeros for rows past the end, so each kernel reads its own input
// layout (int16 frames, f32 planes) without a copy.  The right operand B is
// (K, ldb) row-major f32, ldb a multiple of 4.
//
// Everything sits in an anonymous namespace, so each file that includes it
// compiles its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int GT = 256;  // threads of a GEMM block: 16 x 16, 8 x 8 outputs each

// the output tile's row (i) or column (j) offset of thread index v (ty or tx)
__device__ __forceinline__ int sub(int v, int i) { return (i < 4 ? 0 : 64) + 4 * v + (i & 3); }

// acc = A[m0:m0+128, :K] @ B[:K, n0:n0+128] for the block's tile, m0 =
// blockIdx.x * BM.  The sums are f32 FMAs in k order (fmaf is exact-rounded;
// -fmad=false does not touch it).  Thread (ty, tx) = (tid / 16, tid % 16)
// holds rows sub(ty, i) and columns sub(tx, j) of the tile in acc[i][j].
template <class A>
__device__ __forceinline__ void sgemm_tile(const A a, int K, const float* __restrict__ B,
                                           int ldb, int n0, float (&acc)[8][8]) {
  __shared__ __align__(16) float As[2][BK][BM + 4];  // transposed: [k][m]; pad: no bank conflicts
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int ar = tid >> 1, ak = (tid & 1) * 4;  // A loads: row, k offset
  const int bk = tid >> 5, bc = (tid & 31) * 4;  // B loads: k row, column
  const int ty = tid >> 4, tx = tid & 15;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra = a.load(m0 + ar, ak);
  float4 rb = *reinterpret_cast<const float4*>(B + (size_t)bk * ldb + n0 + bc);
  As[0][ak + 0][ar] = ra.x;
  As[0][ak + 1][ar] = ra.y;
  As[0][ak + 2][ar] = ra.z;
  As[0][ak + 3][ar] = ra.w;
  *reinterpret_cast<float4*>(&Bs[0][bk][bc]) = rb;
  __syncthreads();

  for (int kt = 0; kt < K; kt += BK) {
    const int cur = (kt / BK) & 1;
    const bool more = kt + BK < K;
    if (more) {  // next tile into registers while this one is multiplied
      ra = a.load(m0 + ar, kt + BK + ak);
      rb = *reinterpret_cast<const float4*>(B + (size_t)(kt + BK + bk) * ldb + n0 + bc);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      As[cur ^ 1][ak + 0][ar] = ra.x;
      As[cur ^ 1][ak + 1][ar] = ra.y;
      As[cur ^ 1][ak + 2][ar] = ra.z;
      As[cur ^ 1][ak + 3][ar] = ra.w;
      *reinterpret_cast<float4*>(&Bs[cur ^ 1][bk][bc]) = rb;
    }
    __syncthreads();
  }
}

}  // namespace
