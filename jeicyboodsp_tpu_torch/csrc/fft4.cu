// K12, jb_fft4: the four-step (Bailey) FFT on Hopper (sm_90a).  Replaces
// jeicyboodsp_tpu/kernels/fft_pallas.py: fft_pallas (_fft_kernel).  For n =
// n1 * n2 (both <= 128) and frames x_f viewed as (n1, n2):
//
//   A_f = W1 @ x_f,  B_f = A_f * tw,  C_f = B_f @ W2^T,  X_f[k2*n1 + k1] = C_f[k1, k2]
//
// complex, unnormalised, in f32 FMAs on CUDA cores (no TF32, no bf16).  Each
// complex product keeps four real sums, combined as the TPU kernel combines
// its four real matmuls: re = Lr.Rr - Li.Ri, im = Lr.Ri + Li.Rr.
//
// The TPU kernel keeps W1, W2, the twiddles and a tile of frames in VMEM.
// At n = 8192 (64 x 128) that is 32 KB of W1, 128 KB of W2, 64 KB of
// twiddles and 64 KB per frame: more than a block's 227 KB of shared memory.
// So K12 is two launches, each one batched complex tile GEMM in which the
// frames line up along one dimension of one large product:
//   1. stage1_kernel  A = W1 @ [x_0 | x_1 | ...]: M = n1, K = n1, N = T*n2
//                     (the right operand's column (f, j2) is x[f, :, j2]);
//                     the twiddle in the epilogue; B to a scratch plane pair;
//   2. stage2_kernel  C = B @ W2^T with B's rows (f, k1) contiguous: M =
//                     T*n1, K = N = n2; the transpose of the TPU wrapper
//                     (fft_pallas.py:159-160) is the epilogue's store index.
// The tile is 4096 complex outputs per block of 256 threads (4 x 4 each);
// its short side is n1 (stage 1) or n2 (stage 2) rounded up to 16, 32, 64
// or 128, so no block computes padding at n = 512 (16 x 32), 1024 or 8192.
// A real input (xi null) skips the two products with the zero plane.
//
// Bound on this card at T = 2041, n = 8192: the function moves 2 planes in
// and 2 out, 268 MB (0.080 ms at 3.35 TB/s); the dense four-step work is
// 6.3 M complex-plane MACs per frame (4 real products per complex one),
// 0.38 ms at the 67 TFLOP/s f32 CUDA-core peak per complex transform; an
// FFT needs 5 n log2 n flops, 0.53 MFLOP per frame.  So this kernel is
// bound by its dense FMAs, about 5x above the bytes; a tensor-core form
// (3xTF32 or bf16x3 tiles) or a radix stage in shared memory is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16 thread tiles of 4 x 4 complex outputs
constexpr int TILE = 4096;    // complex outputs per block: TM x TN
constexpr int TK = 16;        // contraction step through shared memory

// The operands: (re, im) of element (r, c), zeros outside the matrix.
struct Mat {  // a row-major (rows, cols) matrix as two planes; im null: real
  const float* re;
  const float* im;
  long long rows;
  int cols;
  __device__ float2 at(long long r, int c) const {
    if (r >= rows || c >= cols) return make_float2(0.f, 0.f);
    const size_t i = (size_t)r * cols + c;
    return make_float2(re[i], im ? im[i] : 0.f);
  }
};

struct Frames {  // (n1, T*n2): column f*n2 + j2 of row j1 is x[f, j1*n2 + j2]
  const float* re;
  const float* im;
  int n1, n2;
  long long cols;
  __device__ float2 at(long long j1, long long col) const {
    if (j1 >= n1 || col >= cols) return make_float2(0.f, 0.f);
    const long long f = col / n2;
    const size_t i = (size_t)f * n1 * n2 + (size_t)j1 * n2 + (size_t)(col - f * n2);
    return make_float2(re[i], im ? im[i] : 0.f);
  }
};

// acc[i][j] = {Lr.Rr, Li.Ri, Lr.Ri, Li.Rr} of output (m0 + rows(i), c0 +
// cols(j)) over k < K, in k order.  Thread rows 4*rt + i, columns 4*ct + j;
// REAL: the right operand is real, and the two products with its zero
// plane are skipped.
template <int TM, bool REAL, class LA, class RB>
__device__ __forceinline__ void ctile(const LA& A, const RB& B, int K, long long m0,
                                      long long c0, int rt, int ct,
                                      float (&acc)[4][4][4]) {
  constexpr int TN = TILE / TM;
  __shared__ __align__(16) float Ar[TK][TM + 4], Ai[TK][TM + 4];  // [k][m]; pad: fewer conflicts
  __shared__ __align__(16) float Br[TK][TN], Bi[TK][TN];          // [k][c]
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[i][j][p] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TM * TK; e += THREADS) {  // neighbouring threads: neighbouring k
      const int k = e % TK, m = e / TK;
      const float2 v = A.at(m0 + m, k0 + k);
      Ar[k][m] = v.x;
      Ai[k][m] = v.y;
    }
    for (int e = tid; e < TK * TN; e += THREADS) {
      const int c = e % TN, k = e / TN;
      const float2 v = B.at(k0 + k, c0 + c);
      Br[k][c] = v.x;
      Bi[k][c] = v.y;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a4r = *reinterpret_cast<const float4*>(&Ar[kk][4 * rt]);
      const float4 a4i = *reinterpret_cast<const float4*>(&Ai[kk][4 * rt]);
      const float4 b4r = *reinterpret_cast<const float4*>(&Br[kk][4 * ct]);
      const float4 b4i = *reinterpret_cast<const float4*>(&Bi[kk][4 * ct]);
      const float ar[4] = {a4r.x, a4r.y, a4r.z, a4r.w}, ai[4] = {a4i.x, a4i.y, a4i.z, a4i.w};
      const float br[4] = {b4r.x, b4r.y, b4r.z, b4r.w}, bi[4] = {b4i.x, b4i.y, b4i.z, b4i.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j][0] = fmaf(ar[i], br[j], acc[i][j][0]);
          acc[i][j][3] = fmaf(ai[i], br[j], acc[i][j][3]);
          if (!REAL) {
            acc[i][j][1] = fmaf(ai[i], bi[j], acc[i][j][1]);
            acc[i][j][2] = fmaf(ar[i], bi[j], acc[i][j][2]);
          }
        }
    }
    __syncthreads();
  }
}

// The thread's tile: rows 4*rt.., columns 4*ct..; ROWS_FAST puts
// neighbouring threads on neighbouring rows, for a store contiguous along rows.
template <int TM, bool ROWS_FAST>
__device__ __forceinline__ void thread_tile(int* rt, int* ct) {
  constexpr int RT = TM / 4, CT = TILE / TM / 4;  // RT * CT = THREADS
  *rt = ROWS_FAST ? threadIdx.x % RT : threadIdx.x / CT;
  *ct = ROWS_FAST ? threadIdx.x / RT : threadIdx.x % CT;
}

// Stage 1: B[f, k1, j2] = (W1 @ x_f)[k1, j2] * tw[k1, j2].  Grid: ceil(T*n2 / TN).
template <int TM, bool REAL>
__global__ void __launch_bounds__(THREADS) stage1_kernel(Mat W1, Frames X, Mat TW,
                                                         float* __restrict__ sr,
                                                         float* __restrict__ si) {
  constexpr int TN = TILE / TM;
  const long long c0 = (long long)blockIdx.x * TN;
  int rt, ct;
  thread_tile<TM, false>(&rt, &ct);
  float acc[4][4][4];
  ctile<TM, REAL>(W1, X, X.n1, 0, c0, rt, ct, acc);
  const int n1 = X.n1, n2 = X.n2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k1 = 4 * rt + i;
    if (k1 >= n1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long col = c0 + 4 * ct + j;
      if (col >= X.cols) continue;
      const long long f = col / n2;
      const int j2 = (int)(col - f * n2);
      const float ar = acc[i][j][0] - acc[i][j][1];
      const float ai = acc[i][j][2] + acc[i][j][3];
      const float twr = TW.re[k1 * n2 + j2], twi = TW.im[k1 * n2 + j2];
      const size_t o = (size_t)f * n1 * n2 + (size_t)k1 * n2 + j2;
      sr[o] = ar * twr - ai * twi;
      si[o] = ar * twi + ai * twr;
    }
  }
}

// Stage 2: X[f, k2*n1 + k1] = (B_f @ W2^T)[k1, k2], B as (T*n1, n2) rows.
// Grid: ceil(T*n1 / TM).
template <int TM>
__global__ void __launch_bounds__(THREADS) stage2_kernel(Mat B, Mat W2T, int n1,
                                                         float* __restrict__ outr,
                                                         float* __restrict__ outi) {
  const long long m0 = (long long)blockIdx.x * TM;
  int rt, ct;
  thread_tile<TM, true>(&rt, &ct);
  float acc[4][4][4];
  ctile<TM, false>(B, W2T, B.cols, m0, 0, rt, ct, acc);
  const int n2 = B.cols;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + 4 * rt + i;
    if (row >= B.rows) continue;
    const long long f = row / n1;
    const int k1 = (int)(row - f * n1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k2 = 4 * ct + j;
      if (k2 >= n2) continue;
      const size_t o = (size_t)f * n1 * n2 + (size_t)k2 * n1 + k1;
      outr[o] = acc[i][j][0] - acc[i][j][1];
      outi[o] = acc[i][j][2] + acc[i][j][3];
    }
  }
}

int tile_side(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128; }

template <int TM>
void stage1(Mat W1, Frames X, Mat TW, float* sr, float* si, cudaStream_t st) {
  const unsigned grid = (unsigned)((X.cols + TILE / TM - 1) / (TILE / TM));
  if (X.im)
    stage1_kernel<TM, false><<<grid, THREADS, 0, st>>>(W1, X, TW, sr, si);
  else
    stage1_kernel<TM, true><<<grid, THREADS, 0, st>>>(W1, X, TW, sr, si);
}

template <int TM>
void stage2(Mat B, Mat W2T, int n1, float* outr, float* outi, cudaStream_t st) {
  const unsigned grid = (unsigned)((B.rows + TM - 1) / TM);
  stage2_kernel<TM><<<grid, THREADS, 0, st>>>(B, W2T, n1, outr, outi);
}

}  // namespace

// xr, xi: (T, n1*n2) f32 frames (xi null: real input).  consts: f32 w1 re,
// im (n1, n1); w2^T re, im (n2, n2); twiddle re, im (n1, n2).  Scratch from
// the caller: sc (2, T, n).  Outputs outr, outi (T, n) in natural order.
extern "C" int jb_fft4(const float* xr, const float* xi, int T, int n1, int n2,
                       const float* consts, float* sc, float* outr, float* outi,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || n1 < 1 || n1 > 128 || n2 < 1 || n2 > 128) return (int)cudaErrorInvalidValue;
  const size_t a = (size_t)n1 * n1, b = (size_t)n2 * n2, n = (size_t)n1 * n2;
  const Mat W1{consts, consts + a, n1, n1};
  const Mat W2T{consts + 2 * a, consts + 2 * a + b, n2, n2};
  const Mat TW{consts + 2 * a + 2 * b, consts + 2 * a + 2 * b + n, n1, n2};
  const Frames X{xr, xi, n1, n2, (long long)T * n2};
  float *sr = sc, *si = sc + (size_t)T * n;
  switch (tile_side(n1)) {
    case 16: stage1<16>(W1, X, TW, sr, si, st); break;
    case 32: stage1<32>(W1, X, TW, sr, si, st); break;
    case 64: stage1<64>(W1, X, TW, sr, si, st); break;
    default: stage1<128>(W1, X, TW, sr, si, st); break;
  }
  const Mat B{sr, si, (long long)T * n1, n2};
  switch (tile_side(n2)) {  // the tile's columns cover n2: TM = TILE / that
    case 16: stage2<256>(B, W2T, n1, outr, outi, st); break;
    case 32: stage2<128>(B, W2T, n1, outr, outi, st); break;
    case 64: stage2<64>(B, W2T, n1, outr, outi, st); break;
    default: stage2<32>(B, W2T, n1, outr, outi, st); break;
  }
  return (int)cudaGetLastError();
}
