// Engine mxu3 of the enhancement chain on Hopper (sm_90a): the f32 halves
// of the chain around the noise latch, as two entries.
//
// K4, jb_enhance_fwd, replaces jeicyboodsp_tpu/kernels/enhance_pallas.py:
// enhance_fwd_pallas (_fwd_kernel): int16 blocks -> re, im, |X| (T, 512)
// and ren, |ren|, speech flags (T,), in two passes:
//   1. fwd32_kernel   re = [prev, cur] @ WC, im = [prev, cur] @ WS, K = 1024
//                     (the window is folded into the bases; prev = row t-1)
//   2. rowstat_kernel per row: the Nyquist dot, |X|, |ren|, VAD flags
//
// K5, jb_enhance_back_ola3, replaces enhance_back_ola3_pallas
// (_make_back_ola3_kernel): re, im, ren and the latched noise planes ->
// int16 (T, 512), in three passes:
//   1. gain_kernel    gain -> Yre, Yim planes, Yren and the y512 column
//   2. inv32_kernel   u = Yre @ UC512 + Yren*u_nyq, v = Yim @ VS512
//   3. ola_kernel     flip as an index permutation, OLA with row t-1's
//                     tail (the TPU kernel's ctail carry), c_short, mask
// The TPU kernel returns f32 c_short values that its caller casts to int16
// and masks (ops/enhance.py:542-550); those values are exact integers, so
// writing int16 with the mask here gives the same result.
//
// K13, jb_enhance_back, replaces enhance_back_pallas (_make_back_kernel):
// the same inputs -> head = u - v, w2 = u + v (T, 512) and the y512 column
// (T,), with no OLA (its caller assembles it), in three passes: K5's
// gain_kernel and inv32_kernel, then
//   3. split_kernel   head and w2 in place of the (u, v) planes, y512 out
//                     of the row scalars
// Bound at T = 16384: its two GEMMs as bf16x3 on tensor cores 0.052 ms;
// re, im, ns in and head, w2 out are 168 MB, 0.050 ms.
//
// The TPU kernels run their f32 GEMMs as bf16x3 only because Mosaic has no
// Precision.HIGH.  Here they are plain f32 FMA GEMMs on CUDA cores, the tile
// GEMM of sgemm.cuh (shared with K10, mfcc.cu).  Bound on this card at
// T = 16384: K4 is 1.7e10 MACs (0.51 ms at the 67 TFLOP/s f32 CUDA-core
// peak, 0.10 ms as bf16x3 on tensor cores) against ~117 MB (0.035 ms); K5
// half that work.  So both are compute-bound; a tensor-core form (bf16x3 or
// 3xTF32) is later work.

#include "enhance_common.cuh"
#include "sgemm.cuh"

namespace {

// The GEMMs' left operands: 4 consecutive values of row t at column k
// (k a multiple of 4), zeros for rows t >= T.
struct FramesA {  // K4: [prev | cur] int16 rows as f32, K = 1024
  const int16_t* x;
  int T;
  __device__ float4 load(int t, int k) const {
    if (t >= T || (k < N && t == 0)) return make_float4(0.f, 0.f, 0.f, 0.f);
    const int16_t* p = k < N ? x + (size_t)(t - 1) * N + k : x + (size_t)t * N + (k - N);
    // p is 8-byte aligned exactly when x is (k % 4 == 0, rows 1 KB apart):
    // the same branch for every load; a view at an odd offset reads scalars
    if (reinterpret_cast<uintptr_t>(p) % 8)
      return make_float4((float)p[0], (float)p[1], (float)p[2], (float)p[3]);
    const short4 v = *reinterpret_cast<const short4*>(p);
    return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
  }
};

struct PlaneA {  // K5: one (T, 512) f32 plane, K = 512
  const float* a;
  int T;
  __device__ float4 load(int t, int k) const {
    if (t >= T) return make_float4(0.f, 0.f, 0.f, 0.f);
    return *reinterpret_cast<const float4*>(a + (size_t)t * N + k);
  }
};

// K4 pass 1.  Grid (ceil(T/BM), 2N/BN): columns [0, 512) are re, [512,
// 1024) im.
__global__ void __launch_bounds__(GT) fwd32_kernel(const int16_t* __restrict__ x, int T,
                                                   const float* __restrict__ WC,
                                                   const float* __restrict__ WS,
                                                   float* __restrict__ re,
                                                   float* __restrict__ im) {
  const int nb = blockIdx.y * BN, plane = nb / N, n0 = nb % N;
  float acc[8][8];
  sgemm_tile(FramesA{x, T}, 2 * N, plane ? WS : WC, N, n0, acc);
  float* out = plane ? im : re;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int i = 0; i < 8; ++i) {
    const int t = blockIdx.x * BM + sub(ty, i);
    if (t >= T) continue;
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(out + (size_t)t * N + n0 + sub(tx, 4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

__global__ void __launch_bounds__(ROW_THREADS) rowstat_kernel(
    const int16_t* __restrict__ x, const float* __restrict__ nyq,
    const float* __restrict__ w2, const float* __restrict__ re,
    const float* __restrict__ im, float* __restrict__ ren,
    float* __restrict__ mag, float* __restrict__ magn, float* __restrict__ sp) {
  rowstat_body(x, nyq, w2, re, im, ren, mag, magn, sp);
}

// K5 pass 1, one block of N threads per row: Y (2, T, 512) = re*g, im*g;
// rowsc[t]: slot 4 Yren, slot 5 y512 = Yre . ycol[:512] + Yren*ycol[512].
__global__ void __launch_bounds__(N) gain_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ ren, const float* __restrict__ ns,
    const float* __restrict__ nsn, const float* __restrict__ y512col,
    float* __restrict__ Y, float* __restrict__ rowsc, int T, int wiener) {
  __shared__ float red[32];
  const int t = blockIdx.x, k = threadIdx.x;
  const size_t i = (size_t)t * N + k;
  float gk, gn;
  bin_gain(re[i], im[i], ren[t], ns[i], nsn[t], wiener, &gk, &gn);
  const float yre = re[i] * gk;
  Y[i] = yre;
  Y[(size_t)T * N + i] = im[i] * gk;
  const float yren = ren[t] * gn;
  const float y512 = block_reduce<false>(yre * y512col[k], red) + yren * y512col[N];
  if (k == 0) {
    rowsc[(size_t)t * RS + 4] = yren;
    rowsc[(size_t)t * RS + 5] = y512;
  }
}

// K5 pass 2.  Grid (ceil(T/BM), N/BN, 2): plane 0 u, plane 1 v.
__global__ void __launch_bounds__(GT) inv32_kernel(const float* __restrict__ Y, int T,
                                                   const float* __restrict__ UC,
                                                   const float* __restrict__ VS,
                                                   const float* __restrict__ rowsc,
                                                   const float* __restrict__ u_nyq,
                                                   float* __restrict__ uv) {
  const int plane = blockIdx.z, n0 = blockIdx.y * BN;
  const size_t pl = (size_t)T * N;
  float acc[8][8];
  sgemm_tile(PlaneA{Y + plane * pl, T}, N, plane ? VS : UC, N, n0, acc);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int i = 0; i < 8; ++i) {
    const int t = blockIdx.x * BM + sub(ty, i);
    if (t >= T) continue;
    const float yren = rowsc[(size_t)t * RS + 4];
    for (int j = 0; j < 8; ++j) {
      const int s = n0 + sub(tx, j);
      float o = acc[i][j];
      if (plane == 0) o = o + yren * u_nyq[s];
      uv[plane * pl + (size_t)t * N + s] = o;
    }
  }
}

// K13 pass 3, one block of N threads per row: (u, v) -> (u - v, u + v)
// in place, in the TPU kernel's operand order; y512 from rowsc slot 5.
__global__ void __launch_bounds__(N) split_kernel(float* __restrict__ uv,
                                                  const float* __restrict__ rowsc,
                                                  float* __restrict__ y512, int T) {
  const int t = blockIdx.x, k = threadIdx.x;
  const size_t i = (size_t)t * N + k, pl = (size_t)T * N;
  const float u = uv[i], v = uv[pl + i];
  uv[i] = u - v;
  uv[pl + i] = u + v;
  if (k == 0) y512[t] = rowsc[(size_t)t * RS + 5];
}

__global__ void __launch_bounds__(N) ola_kernel(const float* __restrict__ uv,
                                                const float* __restrict__ rowsc,
                                                int16_t* __restrict__ out, int T,
                                                int emit_all) {
  ola_body(uv, rowsc, out, T, emit_all);
}

}  // namespace

// K4.  WC, WS: (1024, 512) f32 window-folded bases.  Outputs from the
// caller: re, im, mag (T, 512) f32; ren, magn, sp (T,) f32.
extern "C" int jb_enhance_fwd(const int16_t* x, int T, const float* WC,
                              const float* WS, const float* nyq, const float* w2,
                              float* re, float* im, float* ren, float* mag,
                              float* magn, float* sp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fwd32_kernel<<<dim3((T + BM - 1) / BM, 2 * N / BN), GT, 0, st>>>(x, T, WC, WS, re, im);
  rowstat_kernel<<<T, ROW_THREADS, 0, st>>>(x, nyq, w2, re, im, ren, mag, magn, sp);
  return (int)cudaGetLastError();
}

// K5.  UC, VS: (512, 512) f32 inverse bases.  Scratch from the caller: Y,
// uv (2, T, 512) f32, rowsc (T, 8) f32; out (T, 512) int16.
extern "C" int jb_enhance_back_ola3(
    const float* re, const float* im, const float* ren, const float* ns,
    const float* nsn, int T, int wiener, int emit_all, const float* UC,
    const float* VS, const float* u_nyq, const float* y512col, float* Y,
    float* rowsc, float* uv, int16_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gain_kernel<<<T, N, 0, st>>>(re, im, ren, ns, nsn, y512col, Y, rowsc, T, wiener);
  inv32_kernel<<<dim3((T + BM - 1) / BM, N / BN, 2), GT, 0, st>>>(Y, T, UC, VS, rowsc,
                                                                  u_nyq, uv);
  ola_kernel<<<T, N, 0, st>>>(uv, rowsc, out, T, emit_all);
  return (int)cudaGetLastError();
}

// K13.  As K5 up to the inverse; outputs from the caller: hw (2, T, 512)
// f32 (head, then w2), y512 (T,) f32; scratch Y (2, T, 512), rowsc (T, 8).
extern "C" int jb_enhance_back(const float* re, const float* im, const float* ren,
                               const float* ns, const float* nsn, int T, int wiener,
                               const float* UC, const float* VS, const float* u_nyq,
                               const float* y512col, float* Y, float* rowsc, float* hw,
                               float* y512, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gain_kernel<<<T, N, 0, st>>>(re, im, ren, ns, nsn, y512col, Y, rowsc, T, wiener);
  inv32_kernel<<<dim3((T + BM - 1) / BM, N / BN, 2), GT, 0, st>>>(Y, T, UC, VS, rowsc,
                                                                  u_nyq, hw);
  split_kernel<<<T, N, 0, st>>>(hw, rowsc, y512, T);
  return (int)cudaGetLastError();
}
