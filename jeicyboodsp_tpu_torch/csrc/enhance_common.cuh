// Device code shared by the enhancement chain's kernels (K1: enhance_full8.cu;
// K2/K3: enhance_mxu8.cu; K4/K5: enhance_mxu3.cu).
//
// Each pass body below is a __device__ function of one thread block; the
// .cu files wrap them in their own __global__ kernels.  The int8 forward
// and inverse passes are whole __global__ kernels here, fwd8_kernel (K1,
// K2) and inv8_kernel (K1, K3), launched through launch_fwd8 and
// launch_inv8.  Everything sits in an anonymous namespace, so every file
// compiles its own copy and the library links without -rdc.
//
// Exactness rules the bodies keep (the files are built with -fmad=false):
// int8 dots accumulate in int32 on the tensor cores and combine as 256*a +
// b in int32; the f32 epilogues keep the JAX package's operand order; rintf
// rounds half to even as jnp.rint; row maxima propagate NaN (max_nan) as
// jnp.max does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int N = 512;        // samples per block = bins per plane
constexpr int NB = N + 1;     // bins with Nyquist, in the latch planes
constexpr int RP = 8;         // row-pack width: w, p, g, p[g], 0...
constexpr int RS = 8;         // row scalars: q_re, q2_re, q_im, q2_im, Yren, y512
constexpr int ROW_THREADS = 256;  // threads of the per-row reduction passes

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;  // NaN in either operand wins
}

// c_short: t = trunc toward zero; NaN or |t| >= 2^31 -> INT32_MIN; low 16 bits.
// The tests read v itself: |v| < 2^31 iff |t| < 2^31 (an f32 of 2^24 or more is an
// integer), and (int)v truncates, so no separate truncf (FRND) takes the conversion
// pipe beside the F2I.
__device__ __forceinline__ int16_t c_short(float v) {
  int i = (isfinite(v) && fabsf(v) < 2147483648.0f) ? (int)v : INT_MIN;
  return (int16_t)(uint16_t)(i & 0xffff);
}

// block-wide reductions over blockDim.x (a multiple of 32, <= 1024)
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? max_nan(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? red[lane] : (MAX ? -INFINITY : 0.0f);
    for (int o = 16; o > 0; o >>= 1) {
      float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = MAX ? max_nan(v, w) : v + w;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Wiener or spectral-subtraction gain of one bin (a, b) and of the
// Nyquist bin rn, from the noise estimates ns, nsn.  A bin at exactly 0
// with its estimate at 0 is 0/0.  In a frame that holds a nonzero sample
// (nz) its gain is 1, so it contributes its 0, the reference's value: the
// reference's float64 spectrum has no exactly-zero bin in such a frame,
// while a quantized or float32 one can.  In an all-zero frame (!nz) it
// stays NaN, as in the reference, and c_short writes the row and the next
// as zeros.  Every other bin's gain is the division's.  (The TPU kernels
// leave every 0/0 NaN.)
__device__ __forceinline__ void bin_gain(float a, float b, float rn, float ns,
                                         float nsn, int wiener, int nz, float* gk,
                                         float* gn) {
  if (wiener) {
    const float P = a * a + b * b;
    const float v = (nz && ns == 0.0f && P == 0.0f) ? 0.0f : ns * ns / P;
    *gk = 1.0f - (v >= 1.0f ? 1.0f : v);
    const float Pn = rn * rn;
    const float vn = (nz && nsn == 0.0f && Pn == 0.0f) ? 0.0f : nsn * nsn / Pn;
    *gn = 1.0f - (vn >= 1.0f ? 1.0f : vn);
  } else {
    const float mag = sqrtf(a * a + b * b);
    *gk = (nz && ns == 0.0f && mag == 0.0f) ? 1.0f : (mag - ns) / mag;
    const float magn = fabsf(rn);
    *gn = (nz && nsn == 0.0f && magn == 0.0f) ? 1.0f : (magn - nsn) / magn;
  }
}

// ---------------------------------------------------------------- the int8 forward pass
// Forward int8 dots on the tensor cores (K1's and K2's forward pass): the
// re (cos bases) and im (sin bases) planes, and |X| = sqrt(re^2 + im^2)
// where the caller asks for it, in (F8_BM x F8_BN) tiles of rows t and
// columns n.  A persistent block of F8_THREADS threads per SM (launch_fwd8)
// owns one column block of both planes and keeps its eight bases' columns,
// 136 KB, in shared memory for all its row tiles; it walks the row tiles
// rg, rg + groups, ..., so one tile's epilogue and the next one's first
// loads overlap.  x must start on a 16-byte boundary (the wrappers copy a
// view that does not).
//
// W: 8 int8 matrices [n][k] (the transposed bases, K-major as the MMA's
// "col" B operand wants them), per plane Wh_p, Wl_p, Wh_c, Wl_c.  The int16
// rows stream in K chunks of F8_KC by cp.async into a ring of F8_STAGES
// stages, F8_STAGES - 1 chunks ahead of the tensor cores and across tile
// bounds: rows t0 - 1 .. t0 + F8_BM - 1 (the tile and its halo row,
// zero-filled outside 0 <= t < T).  The data split x = 256*xh + xl + 128 is
// exact and happens as the fragments are read: xh is the int16's high byte,
// xl its low byte with the top bit flipped (__byte_perm).  The prev-row
// operand of row t is tile row t - t0, the current-row operand tile row
// t - t0 + 1, so both come from the one tile.
//
// mma.sync.m16n8k32 s8 x s8 -> s32.  Per output the 16-dot form has eight
// int32 sums: the prev half ph.Whp, pl.Whp, ph.Wlp, pl.Wlp and the current
// half ch.Whc, cl.Whc, ch.Wlc, cl.Wlc -- the integers of the plain
// version's exact dots.  Each (plane, half) has four warps, each a 32 x 16
// piece with four sums per output, which its 16-byte row reads and 8-byte
// column reads feed twice.  The f32 epilogue keeps its order (zh = 256*a +
// b in int32; v = s1p*zh + s2p*rh, handed from the prev warps to the
// current ones through shared memory; v += s1c*zc; v += s2c*rc; + crow;
// -fmad=false), so it gives the same bits; the tile then leaves shared
// memory in 16-byte stores, with |X| as the plain version computes it.
// Within a k step of 32 the fragment's k slots are permuted alike in both
// operands (thread quad c holds k 8c .. 8c+7), so a thread reads its A row
// as one 16-byte and its B column as one 8-byte shared load; the sum is the
// same.
constexpr int F8_BM = 64, F8_BN = 32, F8_KC = 128, F8_STAGES = 3;
constexpr int F8_THREADS = 512;     // 16 warps: (plane, half) x 2 (rows) x 2 (columns)
constexpr int F8_AROWS = F8_BM + 1; // the tile and its halo row
constexpr int F8_ALD = 2 * F8_KC + 64;  // bytes an int16 row: 80 words, so the two
                                        // rows of a quarter warp's 16-byte reads
                                        // fill the 32 banks once
constexpr int F8_BLD = N + 32;      // bytes a basis column: 136 words, so the four
                                    // columns of a half warp's 8-byte reads do
constexpr int F8_BBYTES = 8 * F8_BN * F8_BLD;    // the resident bases: 139,264 bytes
constexpr int F8_STAGE = F8_AROWS * F8_ALD;      // one chunk of int16 rows
constexpr int F8_EPLD = F8_BN + 8;  // floats an epilogue row: 40 words
constexpr int F8_EPBYTES = 2 * F8_BM * F8_EPLD * 4;  // re and im of a tile
constexpr int F8_SMEM = F8_BBYTES + F8_STAGES * F8_STAGE + F8_EPBYTES;  // 222,144 bytes
constexpr int F8_ACP = F8_AROWS * (2 * F8_KC / 16);  // 16-byte copies of a chunk
constexpr int F8_CBLOCKS = N / F8_BN;                // column blocks

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; nbytes 0 fills zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, int nbytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(nbytes));
}

// one row's 8 int16 samples -> the h and l words of fragment slots (a0, a2)
__device__ __forceinline__ void split8(const unsigned char* p, unsigned* h0, unsigned* h2,
                                       unsigned* l0, unsigned* l2) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  *h0 = __byte_perm(v.x, v.y, 0x7531);
  *h2 = __byte_perm(v.z, v.w, 0x7531);
  *l0 = __byte_perm(v.x, v.y, 0x6420) ^ 0x80808080u;
  *l2 = __byte_perm(v.z, v.w, 0x6420) ^ 0x80808080u;
}

// mag null: no |X| plane
__global__ void __launch_bounds__(F8_THREADS, 1) fwd8_kernel(const int16_t* __restrict__ x,
                                                             int T,
                                                             const int8_t* __restrict__ W,
                                                             const float* __restrict__ scales,
                                                             const float* __restrict__ crows,
                                                             float* __restrict__ re,
                                                             float* __restrict__ im,
                                                             float* __restrict__ mag) {
  extern __shared__ __align__(16) unsigned char f8smem[];
  constexpr int NCK = N / F8_KC;
  unsigned char* bs = f8smem;  // the bases, the ring of row chunks, the epilogue tile
  unsigned char* ring = f8smem + F8_BBYTES;
  float* ep = reinterpret_cast<float*>(ring + F8_STAGES * F8_STAGE);
  const int n0 = (blockIdx.x % F8_CBLOCKS) * F8_BN, rg = blockIdx.x / F8_CBLOCKS;
  const int groups = gridDim.x / F8_CBLOCKS;
  const int tiles = (T + F8_BM - 1) / F8_BM;
  const int mine = rg < tiles ? (tiles - rg + groups - 1) / groups : 0;
  const int Q = mine * NCK;  // this block's chunks, tile after tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;  // the fragment's row group and k quad
  const int plane = warp / 8, half = (warp / 4) % 2;  // half 0: prev rows, Wh_p, Wl_p
  const int rA = (warp % 2) * 32, cB = ((warp / 2) % 2) * 16;  // the warp's piece

  // the bases' columns n0 .. n0 + 31 of both planes, in the first copy group
  for (int i = threadIdx.x; i < 8 * F8_BN * (N / 16); i += F8_THREADS) {
    const int m = i / (F8_BN * (N / 16)), col = (i / (N / 16)) % F8_BN, q = i % (N / 16);
    cp16(bs + (m * F8_BN + col) * F8_BLD + 16 * q,
         W + (size_t)m * N * N + (size_t)(n0 + col) * N + 16 * q, 16);
  }
  // the copies of chunk q (tile q / NCK, K chunk q % NCK); an empty group past the last
  auto fetch = [&](int q) {
    if (q < Q) {
      const int t0 = (rg + (q / NCK) * groups) * F8_BM, k0 = (q % NCK) * F8_KC;
      unsigned char* st = ring + (q % F8_STAGES) * F8_STAGE;
      for (int i = threadIdx.x; i < F8_ACP; i += F8_THREADS) {
        const int r = i / (2 * F8_KC / 16), qq = i % (2 * F8_KC / 16), t = t0 - 1 + r;
        const bool in = t >= 0 && t < T;
        cp16(st + r * F8_ALD + 16 * qq, in ? x + (size_t)t * N + k0 + 8 * qq : x, in ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // this (plane, half)'s bases (Wh, Wl), scales (s1, s2) and epilogue plane
  const int mat = 4 * plane + 2 * half;
  const unsigned char* bh = bs + (mat * F8_BN + cB + g) * F8_BLD + 8 * c;
  const unsigned char* bl = bh + F8_BN * F8_BLD;
  const float* s1 = scales + mat * N;
  const float* s2 = s1 + N;
  float* ept = ep + plane * F8_BM * F8_EPLD;
  int acc[2][2][4][4];  // [m16 piece][n8 piece][h.Wh, l.Wh, h.Wl, l.Wl][fragment]
#pragma unroll
  for (int s = 0; s < F8_STAGES - 1; ++s) fetch(s);
  for (int q = 0; q < Q; ++q) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(F8_STAGES - 2));
    __syncthreads();  // chunk q (and the bases) landed for all; stage (q - 1) % STAGES is free
    fetch(q + F8_STAGES - 1);
    const int ck = q % NCK;
    if (ck == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int d = 0; d < 4; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][d][e] = 0;
    }
    // the prev rows of output row t are tile row t - t0, the current ones one further on
    const unsigned char* st = ring + (q % F8_STAGES) * F8_STAGE + (rA + g + half) * F8_ALD;
#pragma unroll
    for (int ks = 0; ks < F8_KC; ks += 32) {
      unsigned ah[2][4], al[2][4];  // rows g (+8) of each m16 piece, k 8c .. 8c+7
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const unsigned char* a = st + 16 * mt * F8_ALD + 2 * (ks + 8 * c);
        split8(a, &ah[mt][0], &ah[mt][2], &al[mt][0], &al[mt][2]);
        split8(a + 8 * F8_ALD, &ah[mt][1], &ah[mt][3], &al[mt][1], &al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int o = 8 * nt * F8_BLD + ck * F8_KC + ks;
        const uint2 wh = *reinterpret_cast<const uint2*>(bh + o);
        const uint2 wl = *reinterpret_cast<const uint2*>(bl + o);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][nt][0], ah[mt], wh.x, wh.y);
          mma_s8(acc[mt][nt][1], al[mt], wh.x, wh.y);
          mma_s8(acc[mt][nt][2], ah[mt], wl.x, wl.y);
          mma_s8(acc[mt][nt][3], al[mt], wl.x, wl.y);
        }
      }
    }
    if (ck != NCK - 1) continue;
    // the tile's last chunk: the epilogue, while the next tile's chunks load.
    // 1. the prev half leaves v = s1p*zh + s2p*rh in the epilogue tile
    if (!half) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + cB + 8 * nt + 2 * c + e, i = 2 * h + e;
              const int zh = 256 * acc[mt][nt][0][i] + acc[mt][nt][1][i];
              const int rh = 256 * acc[mt][nt][2][i] + acc[mt][nt][3][i];
              v2[e] = s1[n] * (float)zh + s2[n] * (float)rh;
            }
            *reinterpret_cast<float2*>(ept + (rA + 16 * mt + g + 8 * h) * F8_EPLD + cB +
                                       8 * nt + 2 * c) = make_float2(v2[0], v2[1]);
          }
    }
    __syncthreads();
    // 2. the current half adds s1c*zc, then s2c*rc, then crow, in place
    if (half) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* p = reinterpret_cast<float2*>(ept + (rA + 16 * mt + g + 8 * h) * F8_EPLD +
                                                  cB + 8 * nt + 2 * c);
            const float2 vp = *p;
            float v2[2] = {vp.x, vp.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + cB + 8 * nt + 2 * c + e, i = 2 * h + e;
              const int zc = 256 * acc[mt][nt][0][i] + acc[mt][nt][1][i];
              const int rc = 256 * acc[mt][nt][2][i] + acc[mt][nt][3][i];
              float v = v2[e];
              v = v + s1[n] * (float)zc;
              v = v + s2[n] * (float)rc;
              v2[e] = v + crows[plane * N + n];
            }
            *p = make_float2(v2[0], v2[1]);
          }
    }
    __syncthreads();
    // 3. the tile out: re, im (and |X|), four columns a thread
    {
      const int t0 = (rg + (q / NCK) * groups) * F8_BM;
      const int row = threadIdx.x / (F8_BN / 4), col = 4 * (threadIdx.x % (F8_BN / 4));
      const int t = t0 + row;
      if (t < T) {
        const float4 a = *reinterpret_cast<const float4*>(ep + row * F8_EPLD + col);
        const float4 b =
            *reinterpret_cast<const float4*>(ep + (F8_BM + row) * F8_EPLD + col);
        const size_t o = (size_t)t * N + n0 + col;
        *reinterpret_cast<float4*>(re + o) = a;
        *reinterpret_cast<float4*>(im + o) = b;
        if (mag)
          *reinterpret_cast<float4*>(mag + o) =
              make_float4(sqrtf(a.x * a.x + b.x * b.x), sqrtf(a.y * a.y + b.y * b.y),
                          sqrtf(a.z * a.z + b.z * b.z), sqrtf(a.w * a.w + b.w * b.w));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Launch the forward pass on `st`: F8_CBLOCKS column blocks times as many
// row groups as fill the SMs with one block each (at most one group per
// row tile); returns the launch's error.  mag may be null.
inline cudaError_t launch_fwd8(const int16_t* x, int T, const int8_t* W, const float* scales,
                               const float* crows, float* re, float* im, float* mag,
                               cudaStream_t st) {
  if ((uintptr_t)x & 15) return cudaErrorMisalignedAddress;
  cudaError_t e = cudaFuncSetAttribute(fwd8_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, F8_SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = (T + F8_BM - 1) / F8_BM;
  int groups = sms / F8_CBLOCKS;
  groups = groups < 1 ? 1 : groups > tiles ? tiles : groups;
  fwd8_kernel<<<groups * F8_CBLOCKS, F8_THREADS, F8_SMEM, st>>>(x, T, W, scales, crows, re,
                                                                im, mag);
  return cudaGetLastError();
}

// The Nyquist bin of row t, prev . nyq[:512] + cur . nyq[512:], as a true
// f32 dot; one block of ROW_THREADS threads.  Every thread gets the sum,
// and in *nz whether the frame [x[t-1], x[t]] holds a nonzero sample.
__device__ __forceinline__ float nyq_row(const int16_t* __restrict__ x,
                                         const float* __restrict__ nyq, int t,
                                         float* red, int* nz) {
  float sp = 0.0f, sc = 0.0f;
  int any = 0;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    const int p = t > 0 ? x[(size_t)(t - 1) * N + k] : 0;
    const int c = x[(size_t)t * N + k];
    any |= p | c;
    sp = sp + (float)p * nyq[k];
    sc = sc + (float)c * nyq[N + k];
  }
  *nz = __syncthreads_or(any);
  sp = block_reduce<false>(sp, red);
  sc = block_reduce<false>(sc, red);
  return sp + sc;
}

// Per-row epilogue of the forward kernels K2 and K4, one block of
// ROW_THREADS threads per row t: the Nyquist bin ren, |X| = sqrt(re^2 +
// im^2) (re null: K2's forward pass wrote it), |ren|, the frame flag nz (1
// where the frame [x[t-1], x[t]] holds a nonzero sample), and the VAD flag
// with
// the semantics of _vad_rows
// (enhance_pallas.py:57-69): s = c_short(x * w2) (int16 window
// truncation), energy = sum(s^2)/1024 > 700, ZCR = #{s[i]*x[i+1] < 0}
// (the last sample pairs with 0) < 200.  The energy decision does not
// depend on the order of the f32 sum: the terms are non-negative
// integers, so every partial sum below 2^24 is exact, and a sum that
// reaches 2^24 is far above the threshold 716800 in any order.
__device__ __forceinline__ void rowstat_body(const int16_t* __restrict__ x,
                                             const float* __restrict__ nyq,
                                             const float* __restrict__ w2,
                                             const float* __restrict__ re,
                                             const float* __restrict__ im,
                                             float* __restrict__ ren,
                                             float* __restrict__ mag,
                                             float* __restrict__ magn,
                                             float* __restrict__ sp,
                                             float* __restrict__ nz) {
  __shared__ float red[32];
  const int t = blockIdx.x;
  int any;
  const float rn = nyq_row(x, nyq, t, red, &any);
  const int16_t* xr = x + (size_t)t * N;
  float e = 0.0f, z = 0.0f;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    if (re) {
      const size_t i = (size_t)t * N + k;
      const float a = re[i], b = im[i];
      mag[i] = sqrtf(a * a + b * b);
    }
    const float s = (float)c_short((float)xr[k] * w2[k]);
    e = e + s * s;
    const float nx = k + 1 < N ? (float)xr[k + 1] : 0.0f;
    z = z + (s * nx < 0.0f ? 1.0f : 0.0f);
  }
  e = block_reduce<false>(e, red);
  z = block_reduce<false>(z, red);
  if (threadIdx.x == 0) {
    ren[t] = rn;
    magn[t] = fabsf(rn);
    sp[t] = (e * (1.0f / 1024.0f) > 700.0f || z < 200.0f) ? 1.0f : 0.0f;
    nz[t] = any ? 1.0f : 0.0f;
  }
}

// Gain and per-row two-level int8 quantization of row t, one block of N
// threads (thread k = bin k): Y = X*g, Yren = ren*gn (bin_gain, with the
// row's frame flag nz), then Z = rint(Y * 32512/rowmax) = 256h + l + 128
// and (hq) the level-2 residual plane z2; the y512 column.  q8: 6 int8 planes (T, 512): h_re, l_re, z2_re, h_im,
// l_im, z2_im; rowsc[t]: q_re, q2_re, q_im, q2_im, Yren, y512.
__device__ __forceinline__ void gain_quant_body(
    float a, float b, float rn, float ns, float nsn, int nz,
    const float* __restrict__ y512col, int8_t* __restrict__ q8,
    float* __restrict__ rowsc, int T, int wiener, int hq) {
  __shared__ float red[32];
  const int t = blockIdx.x, k = threadIdx.x;
  float gk, gn;
  bin_gain(a, b, rn, ns, nsn, wiener, nz, &gk, &gn);
  const float Y[2] = {a * gk, b * gk};
  const float yren = rn * gn;
  const size_t plane = (size_t)T * N;
  for (int c = 0; c < 2; ++c) {
    const float y = Y[c];
    const float ms = max_nan(block_reduce<true>(fabsf(y), red), 1e-30f);
    const float Z = rintf(y * (32512.0f / ms));
    const float h = floorf(Z * (1.0f / 256.0f));
    const float l = Z - 256.0f * h - 128.0f;
    const float q = ms * (float)(1.0 / 32512.0);
    q8[(3 * c + 0) * plane + (size_t)t * N + k] = (int8_t)__float2int_rn(h);
    q8[(3 * c + 1) * plane + (size_t)t * N + k] = (int8_t)__float2int_rn(l);
    float q2 = 0.0f;
    if (hq) {
      const float R = y - q * Z;
      const float m2 = max_nan(block_reduce<true>(fabsf(R), red), 1e-30f);
      const float Z2 = rintf(R * (127.0f / m2));
      q2 = m2 * (float)(1.0 / 127.0);
      q8[(3 * c + 2) * plane + (size_t)t * N + k] = (int8_t)__float2int_rn(Z2);
    }
    if (k == 0) {
      rowsc[(size_t)t * RS + 2 * c] = q;
      rowsc[(size_t)t * RS + 2 * c + 1] = q2;
    }
  }
  const float y512 = block_reduce<false>(Y[0] * y512col[k], red) + yren * y512col[N];
  if (k == 0) {
    rowsc[(size_t)t * RS + 4] = yren;
    rowsc[(size_t)t * RS + 5] = y512;
  }
}

// ---------------------------------------------------------------- the int8 inverse pass
// Inverse int8 dots on the tensor cores (K1's pass 6 and K3's pass 2):
// plane 0, u = q*(s1U*z + s2U*r + crowU) [+ (q2*s1U)*(z2.Uh)] + Yren*u_nyq,
// from the re quantization; plane 1, v likewise from im with the V bases,
// without the Nyquist term (enhance_pallas.py:_inv_plane8), where z = 256*
// (h.Wh) + l.Wh and r = 256*(h.Wl) + l.Wl in int32.  Turbo (HQ false)
// drops l.Wl and the level-2 plane z2 (enhance_pallas.py:410-413).  q8: 6
// int8 planes (T, 512) h, l, z2 of re, then of im, as gain_quant_body writes
// them; B: 4 int8 matrices [s][k] Uh, Ul, Vh, Vl (K-major, the "col" B
// operand of the MMA); rowsc (T, RS); uv (2, T, 512).
//
// A persistent block of I8_THREADS threads per SM (launch_inv8) owns one
// plane and one block of I8_BN output columns, keeps that column slice of
// its plane's Wh and Wl, 64 KB, in shared memory, and walks the row tiles
// rg, rg + groups, ...  Block b serves row group b / 16 and (plane, column
// block) b % 16, so the 8 column blocks that read the same A rows run side
// by side and their re-reads of those rows hit L2.  The A rows stream in K
// chunks of I8_KC by cp.async into a ring of I8_STAGES stages, across tile
// bounds, rows t >= T zero-filled (T is any multiple of 8 for K3); two
// chunks a tile keep the block's barriers few.  Each of
// the 8 warps owns a 16 x 32 piece of the 64 x 64 tile and all its sums
// (5 per output, 80 int32 registers; 3 in turbo), so no sums cross warps
// and each thread stores its outputs straight from the fragments: a quad's
// four 8-byte stores fill one 32-byte sector of a row.
//
// mma.sync.m16n8k32 s8 x s8 -> s32, not wgmma: its fragments come from
// registers, so the pass keeps fwd8's helpers and k-slot permutation, and
// a 64 x 64 wgmma tile would hold 5 x 32 int32 sums a thread (160
// registers before any operand) and need both operands in wgmma's
// core-matrix layout in shared memory.  The tile's row scalars are loaded
// with its first chunk, so the epilogue does not wait on them.
// The products are exact and every partial sum stays below 2^31 (the bound
// of enhance_pallas.py:402-404), so the sums are the integers of the plain
// version in any order; the f32 epilogue keeps its order (-fmad=false), so
// uv is bit-equal to the plain version on the same q8 and rowsc.
// Within each 64-byte k block the fragments' k slots are permuted alike in
// both operands -- thread quad c holds k 16c .. 16c+15, the first 8 for the
// first k step of 32 and the rest for the second -- so a thread reads its A
// rows and its B columns as 16-byte shared loads that feed two MMAs each.
// Every 16-byte unit u of an A row or B column r sits at unit u ^ 4*(r & 1)
// of its line, so the two rows (columns) of a quarter warp's loads fill the
// 32 banks once, and the cp.async stores too.
constexpr int I8_BM = 64, I8_BN = 64, I8_KC = 256, I8_STAGES = 3;
constexpr int I8_THREADS = 256;              // 8 warps: 4 (rows) x 2 (columns)
constexpr int I8_CBLOCKS = N / I8_BN;        // column blocks per plane
constexpr int I8_KINDS = 2 * I8_CBLOCKS;     // (plane, column block) pairs
constexpr int I8_BBYTES = 2 * I8_BN * N;     // the resident Wh, Wl slice: 65,536 bytes
constexpr int I8_STAGE = 3 * I8_BM * I8_KC;  // h, l, z2 rows of one K chunk
constexpr int I8_SMEM = I8_BBYTES + I8_STAGES * I8_STAGE + 4 * I8_BN * 4;  // 214,016 bytes
static_assert(I8_THREADS == 4 * I8_BN, "one thread per column scalar");

template <bool HQ>
__global__ void __launch_bounds__(I8_THREADS, 1) inv8_kernel(const int8_t* __restrict__ q8,
                                                             int T,
                                                             const int8_t* __restrict__ B,
                                                             const float* __restrict__ scales,
                                                             const float* __restrict__ crows,
                                                             const float* __restrict__ rowsc,
                                                             const float* __restrict__ u_nyq,
                                                             float* __restrict__ uv) {
  constexpr int NM = HQ ? 3 : 2;  // A planes: h, l (, z2)
  constexpr int NS = HQ ? 5 : 3;  // sums: h.Wh, l.Wh, h.Wl (, l.Wl, z2.Wh)
  constexpr int NCK = N / I8_KC;
  extern __shared__ __align__(16) unsigned char i8smem[];
  unsigned char* bs = i8smem;  // Wh, Wl [column][k]; the ring of A chunks; column scalars
  unsigned char* ring = i8smem + I8_BBYTES;
  float* colsc = reinterpret_cast<float*>(ring + I8_STAGES * I8_STAGE);  // s1, s2, crow, u_nyq
  const int kind = blockIdx.x % I8_KINDS, rg = blockIdx.x / I8_KINDS;
  const int plane = kind / I8_CBLOCKS, n0 = (kind % I8_CBLOCKS) * I8_BN;
  const int groups = gridDim.x / I8_KINDS;
  const int tiles = (T + I8_BM - 1) / I8_BM;
  const int mine = rg < tiles ? (tiles - rg + groups - 1) / groups : 0;
  const int Q = mine * NCK;  // this block's chunks, tile after tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;  // the fragment's row group and k quad
  const int rA = (warp >> 1) * 16, cB = (warp & 1) * 32;  // the warp's piece
  const int swz = (g & 1) << 2;  // every row and column this thread reads has g's parity
  const size_t pl = (size_t)T * N;
  const int8_t* A = q8 + 3 * plane * pl;

  // the plane's Wh, Wl columns n0 .. n0 + 63, in the first copy group
  for (int i = threadIdx.x; i < 2 * I8_BN * (N / 16); i += I8_THREADS) {
    const int m = i / (I8_BN * (N / 16)), col = (i / (N / 16)) % I8_BN, u = i % (N / 16);
    cp16(bs + (m * I8_BN + col) * N + 16 * (u ^ ((col & 1) << 2)),
         B + (size_t)(2 * plane + m) * N * N + (size_t)(n0 + col) * N + 16 * u, 16);
  }
  {  // the columns' s1, s2, crow, u_nyq, one a thread
    const int w = threadIdx.x / I8_BN, s = n0 + threadIdx.x % I8_BN;
    colsc[threadIdx.x] = w == 0   ? scales[2 * plane * N + s]
                         : w == 1 ? scales[(2 * plane + 1) * N + s]
                         : w == 2 ? crows[plane * N + s]
                                  : u_nyq[s];
  }
  // the copies of chunk q (tile q / NCK, K chunk q % NCK); an empty group past the last
  auto fetch = [&](int q) {
    if (q < Q) {
      const int t0 = (rg + (q / NCK) * groups) * I8_BM, k0 = (q % NCK) * I8_KC;
      unsigned char* st = ring + (q % I8_STAGES) * I8_STAGE;
      for (int i = threadIdx.x; i < NM * I8_BM * (I8_KC / 16); i += I8_THREADS) {
        const int m = i / (I8_BM * (I8_KC / 16)), r = (i / (I8_KC / 16)) % I8_BM;
        const int u = i % (I8_KC / 16), t = t0 + r;
        const bool in = t < T;
        cp16(st + (m * I8_BM + r) * I8_KC + 16 * (u ^ ((r & 1) << 2)),
             in ? A + m * pl + (size_t)t * N + k0 + 16 * u : A, in ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int acc[NS][4][4];  // [sum][n8 piece][fragment]
  float qs[2], q2[2], yren[2];  // the row scalars of rows g and g + 8 of the tile
#pragma unroll
  for (int s = 0; s < I8_STAGES - 1; ++s) fetch(s);
  for (int q = 0; q < Q; ++q) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(I8_STAGES - 2));
    __syncthreads();  // chunk q (and the bases) landed for all; stage (q - 1) % STAGES is free
    fetch(q + I8_STAGES - 1);
    const int ck = q % NCK;
    const int t0 = (rg + (q / NCK) * groups) * I8_BM;
    if (ck == 0) {
#pragma unroll
      for (int d = 0; d < NS; ++d)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[d][nt][e] = 0;
      // the tile's row scalars, loaded now so that the epilogue finds them
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + rA + g + 8 * hr;
        const float* rs = rowsc + (size_t)(t < T ? t : T - 1) * RS;
        qs[hr] = rs[2 * plane];
        q2[hr] = HQ ? rs[2 * plane + 1] : 0.0f;
        yren[hr] = rs[4];
      }
    }
    const unsigned char* st = ring + (q % I8_STAGES) * I8_STAGE + (rA + g) * I8_KC;
    const unsigned char* bh = bs + (cB + g) * N + 16 * ck * (I8_KC / 16);
#pragma unroll
    for (int kb = 0; kb < I8_KC / 64; ++kb) {
      const int u = 16 * ((4 * kb + c) ^ swz);
      uint4 a[NM][2];  // rows g and g + 8 of each A plane, k 16c .. 16c+15 of the k block
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        a[m][0] = *reinterpret_cast<const uint4*>(st + m * I8_BM * I8_KC + u);
        a[m][1] = *reinterpret_cast<const uint4*>(st + (m * I8_BM + 8) * I8_KC + u);
      }
      uint4 wh[4], wl[4];  // columns g of each n8 piece, the same k
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        wh[nt] = *reinterpret_cast<const uint4*>(bh + 8 * nt * N + u);
        wl[nt] = *reinterpret_cast<const uint4*>(bh + (I8_BN + 8 * nt) * N + u);
      }
      // the two k steps of 32, each over all n8 pieces: an accumulator's
      // next MMA comes 4 * NS MMAs after its last
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned f[NM][4];
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          f[m][0] = j ? a[m][0].z : a[m][0].x;
          f[m][1] = j ? a[m][1].z : a[m][1].x;
          f[m][2] = j ? a[m][0].w : a[m][0].y;
          f[m][3] = j ? a[m][1].w : a[m][1].y;
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned h0 = j ? wh[nt].z : wh[nt].x, h1 = j ? wh[nt].w : wh[nt].y;
          const unsigned l0 = j ? wl[nt].z : wl[nt].x, l1 = j ? wl[nt].w : wl[nt].y;
          mma_s8(acc[0][nt], f[0], h0, h1);
          mma_s8(acc[1][nt], f[1], h0, h1);
          mma_s8(acc[2][nt], f[0], l0, l1);
          if constexpr (HQ) {
            mma_s8(acc[3][nt], f[1], l0, l1);
            mma_s8(acc[4][nt], f[2], h0, h1);
          }
        }
      }
    }
    if (ck != NCK - 1) continue;
    // the tile's last chunk: the epilogue, in the plain version's order, while
    // the next tile's chunks load
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + rA + g + 8 * hr;
      if (t >= T) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float o2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = cB + 8 * nt + 2 * c + e, i = 2 * hr + e;
          const float s1 = colsc[cc], s2 = colsc[I8_BN + cc];
          const int z = 256 * acc[0][nt][i] + acc[1][nt][i];
          int r = 256 * acc[2][nt][i];
          if constexpr (HQ) r = r + acc[3][nt][i];
          float o = s1 * (float)z + s2 * (float)r;
          o = qs[hr] * (o + colsc[2 * I8_BN + cc]);
          if constexpr (HQ) o = o + (q2[hr] * s1) * (float)acc[4][nt][i];
          if (plane == 0) o = o + yren[hr] * colsc[3 * I8_BN + cc];
          o2[e] = o;
        }
        *reinterpret_cast<float2*>(uv + plane * pl + (size_t)t * N + n0 + cB + 8 * nt +
                                   2 * c) = make_float2(o2[0], o2[1]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Launch the inverse pass on `st`: I8_KINDS (plane, column block) pairs
// times as many row groups as fill the SMs with one block each (at most one
// group per row tile); returns the launch's error.
inline cudaError_t launch_inv8(const int8_t* q8, int T, const int8_t* B, const float* scales,
                               const float* crows, const float* rowsc, const float* u_nyq,
                               float* uv, int hq, cudaStream_t st) {
  void (*kern)(const int8_t*, int, const int8_t*, const float*, const float*, const float*,
               const float*, float*) = hq ? inv8_kernel<true> : inv8_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       I8_SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = (T + I8_BM - 1) / I8_BM;
  int groups = sms / I8_KINDS;
  groups = groups < 1 ? 1 : groups > tiles ? tiles : groups;
  kern<<<groups * I8_KINDS, I8_THREADS, I8_SMEM, st>>>(q8, T, B, scales, crows, rowsc, u_nyq,
                                                       uv);
  return cudaGetLastError();
}

// Overlap-add of row t = blockIdx.x, thread j: out[t] = c_short(head[t] +
// tail[t-1]) with head = u - v, tail[0] = y512 (rowsc slot 5), tail[j] =
// (u + v)[512 - j] for j >= 1 -- the TPU kernels' J-matrix lane flip as
// an index permutation.  Rows t < 2 are zero unless emit_all (then row 0
// is 0 and row 1 is its head alone, as the TPU kernels write them).
__device__ __forceinline__ void ola_body(const float* __restrict__ uv,
                                         const float* __restrict__ rowsc,
                                         int16_t* __restrict__ out, int T,
                                         int emit_all) {
  const int t = blockIdx.x, j = threadIdx.x;
  const size_t pl = (size_t)T * N;
  const float head = uv[(size_t)t * N + j] - uv[pl + (size_t)t * N + j];
  float tp = 0.0f;
  if (t > 0) {
    if (j == 0) {
      tp = rowsc[(size_t)(t - 1) * RS + 5];
    } else {
      const size_t i = (size_t)(t - 1) * N + (N - j);
      tp = uv[i] + uv[pl + i];
    }
  }
  const float acc = head + tp * (t >= 2 ? 1.0f : 0.0f);
  int16_t o = c_short(acc * (t >= 1 ? 1.0f : 0.0f));
  if (!emit_all && t < 2) o = 0;  // warm-up rows are not part of the stream
  out[(size_t)t * N + j] = o;
}

}  // namespace
