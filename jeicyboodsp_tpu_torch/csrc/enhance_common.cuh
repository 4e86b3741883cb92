// Device code shared by the enhancement chain's kernels (K1: enhance_full8.cu;
// K2/K3: enhance_mxu8.cu; K4/K5: enhance_mxu3.cu).
//
// Each pass body below is a __device__ function of one thread block; the
// .cu files wrap them in their own __global__ kernels.  The int8 forward
// pass is a whole __global__ kernel here, fwd8_kernel, which K1 and K2
// launch through launch_fwd8.  Everything sits in
// an anonymous namespace, so every file compiles its own copy and the
// library links without -rdc.
//
// Exactness rules the bodies keep (the files are built with -fmad=false):
// int8 dots accumulate in int32 (on the tensor cores in the forward pass,
// __dp4a in the inverse) and combine as 256*a + b in int32; the f32
// epilogues keep the JAX package's operand order; rintf rounds half to
// even as jnp.rint; row maxima propagate NaN (max_nan) as jnp.max does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int N = 512;        // samples per block = bins per plane
constexpr int NB = N + 1;     // bins with Nyquist, in the latch planes
constexpr int KW = N / 4;     // int32 words in one int8 row
constexpr int ROWS = 8;       // rows per block of the int8 inverse pass
constexpr int COLS = 128;     // output columns (threads) per block
constexpr int RP = 8;         // row-pack width: w, p, g, p[g], 0...
constexpr int RS = 8;         // row scalars: q_re, q2_re, q_im, q2_im, Yren, y512
constexpr int ROW_THREADS = 256;  // threads of the per-row reduction passes

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;  // NaN in either operand wins
}

// c_short: trunc toward zero; NaN or |t| >= 2^31 -> INT32_MIN; low 16 bits
__device__ __forceinline__ int16_t c_short(float v) {
  float t = truncf(v);
  int i = (isfinite(t) && fabsf(t) < 2147483648.0f) ? (int)t : INT_MIN;
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
// Nyquist bin rn, from the noise estimates ns, nsn.  0/0 -> NaN, as the
// reference.
__device__ __forceinline__ void bin_gain(float a, float b, float rn, float ns,
                                         float nsn, int wiener, float* gk,
                                         float* gn) {
  if (wiener) {
    const float P = a * a + b * b;
    const float v = ns * ns / P;
    *gk = 1.0f - (v >= 1.0f ? 1.0f : v);
    const float vn = nsn * nsn / (rn * rn);
    *gn = 1.0f - (vn >= 1.0f ? 1.0f : vn);
  } else {
    const float mag = sqrtf(a * a + b * b);
    *gk = (mag - ns) / mag;
    const float magn = fabsf(rn);
    *gn = (magn - nsn) / magn;
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
// half ch.Whc, cl.Whc, ch.Wlc, cl.Wlc -- the same integers as the __dp4a
// pass this replaces.  Each (plane, half) has four warps, each a 32 x 16
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
// f32 dot; one block of ROW_THREADS threads.  Every thread gets the sum.
__device__ __forceinline__ float nyq_row(const int16_t* __restrict__ x,
                                         const float* __restrict__ nyq, int t,
                                         float* red) {
  float sp = 0.0f, sc = 0.0f;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    const float p = t > 0 ? (float)x[(size_t)(t - 1) * N + k] : 0.0f;
    sp = sp + p * nyq[k];
    sc = sc + (float)x[(size_t)t * N + k] * nyq[N + k];
  }
  sp = block_reduce<false>(sp, red);
  sc = block_reduce<false>(sc, red);
  return sp + sc;
}

// Per-row epilogue of the forward kernels K2 and K4, one block of
// ROW_THREADS threads per row t: the Nyquist bin ren, |X| = sqrt(re^2 +
// im^2) (re null: K2's forward pass wrote it), |ren|, and the VAD flag with
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
                                             float* __restrict__ sp) {
  __shared__ float red[32];
  const int t = blockIdx.x;
  const float rn = nyq_row(x, nyq, t, red);
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
  }
}

// Gain and per-row two-level int8 quantization of row t, one block of N
// threads (thread k = bin k): Y = X*g, Yren = ren*gn, then Z = rint(Y *
// 32512/rowmax) = 256h + l + 128 and (hq) the level-2 residual plane z2;
// the y512 column.  q8: 6 int8 planes (T, 512): h_re, l_re, z2_re, h_im,
// l_im, z2_im; rowsc[t]: q_re, q2_re, q_im, q2_im, Yren, y512.
__device__ __forceinline__ void gain_quant_body(
    float a, float b, float rn, float ns, float nsn,
    const float* __restrict__ y512col, int8_t* __restrict__ q8,
    float* __restrict__ rowsc, int T, int wiener, int hq) {
  __shared__ float red[32];
  const int t = blockIdx.x, k = threadIdx.x;
  float gk, gn;
  bin_gain(a, b, rn, ns, nsn, wiener, &gk, &gn);
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

// Inverse int8 dots of one (ROWS x COLS) tile: plane 0 (blockIdx.z) u =
// q*(s1U*z + s2U*r + crowU) [+ (q2*s1U)*z2.Uh] + Yren*u_nyq from the re
// quantization; plane 1 v likewise from im with the V bases.  B: 4 int8
// matrices [s][k]: Uh, Ul, Vh, Vl.  Turbo (hq = 0) drops l.Wl and the
// level-2 plane (enhance_pallas.py:410-413).  uv: (2, T, 512).
__device__ __forceinline__ void inv8_body(const int8_t* __restrict__ q8,
                                          const int* __restrict__ B,
                                          const float* __restrict__ scales,
                                          const float* __restrict__ crows,
                                          const float* __restrict__ rowsc,
                                          const float* __restrict__ u_nyq,
                                          float* __restrict__ uv, int T, int hq) {
  __shared__ int sd[3][ROWS][KW];  // h, l, z2
  const int t0 = blockIdx.x * ROWS;
  const int plane = blockIdx.z;
  const size_t pl = (size_t)T * N;
  const int* q8w = reinterpret_cast<const int*>(q8);
  const int nd = hq ? 3 : 2;
  for (int i = threadIdx.x; i < nd * ROWS * KW; i += blockDim.x) {
    const int d = i / (ROWS * KW), r = (i / KW) % ROWS, w = i % KW;
    sd[d][r][w] = q8w[((3 * plane + d) * pl + (size_t)(t0 + r) * N) / 4 + w];
  }
  __syncthreads();

  const int s = blockIdx.y * COLS + threadIdx.x;
  const size_t mat = (size_t)N * KW;
  const int4* Bp = reinterpret_cast<const int4*>(B + 2 * plane * mat + (size_t)s * KW);
  int acc[ROWS][5];
  for (int r = 0; r < ROWS; ++r)
    for (int d = 0; d < 5; ++d) acc[r][d] = 0;
  for (int w4 = 0; w4 < KW / 4; ++w4) {
    const int4 wh4 = Bp[w4], wl4 = Bp[mat / 4 + w4];
    const int bh[4] = {wh4.x, wh4.y, wh4.z, wh4.w};
    const int bl[4] = {wl4.x, wl4.y, wl4.z, wl4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = 4 * w4 + e;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int h = sd[0][r][w], l = sd[1][r][w];
        acc[r][0] = __dp4a(h, bh[e], acc[r][0]);
        acc[r][1] = __dp4a(l, bh[e], acc[r][1]);
        acc[r][2] = __dp4a(h, bl[e], acc[r][2]);
        if (hq) {
          acc[r][3] = __dp4a(l, bl[e], acc[r][3]);
          acc[r][4] = __dp4a(sd[2][r][w], bh[e], acc[r][4]);
        }
      }
    }
  }
  const float s1 = scales[2 * plane * N + s], s2 = scales[(2 * plane + 1) * N + s];
  const float crow = crows[plane * N + s];
  for (int r = 0; r < ROWS; ++r) {
    const int t = t0 + r;
    const int z = 256 * acc[r][0] + acc[r][1];
    const int rr = 256 * acc[r][2] + acc[r][3];  // acc[r][3] == 0 in turbo
    const float q = rowsc[(size_t)t * RS + 2 * plane];
    float o = s1 * (float)z + s2 * (float)rr;
    o = q * (o + crow);
    if (hq) {
      const float q2 = rowsc[(size_t)t * RS + 2 * plane + 1];
      o = o + (q2 * s1) * (float)acc[r][4];
    }
    if (plane == 0) o = o + rowsc[(size_t)t * RS + 4] * u_nyq[s];
    uv[plane * pl + (size_t)t * N + s] = o;
  }
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
