// Device code shared by the enhancement chain's kernels (K1: enhance_full8.cu;
// K2/K3: enhance_mxu8.cu; K4/K5: enhance_mxu3.cu).
//
// Each pass body below is a __device__ function of one thread block; the
// .cu files wrap them in their own __global__ kernels.  Everything sits in
// an anonymous namespace, so every file compiles its own copy and the
// library links without -rdc.
//
// Exactness rules the bodies keep (the files are built with -fmad=false):
// int8 dots accumulate in int32 and combine as 256*a + b in int32; the f32
// epilogues keep the JAX package's operand order; rintf rounds half to
// even as jnp.rint; row maxima propagate NaN (max_nan) as jnp.max does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int N = 512;        // samples per block = bins per plane
constexpr int NB = N + 1;     // bins with Nyquist, in the latch planes
constexpr int KW = N / 4;     // int32 words in one int8 row
constexpr int ROWS = 8;       // rows per block of the int8 dot passes
constexpr int COLS = 128;     // output columns (threads) per block
constexpr int RP = 8;         // row-pack width: w, p, g, p[g], 0...
constexpr int RS = 8;         // row scalars: q_re, q2_re, q_im, q2_im, Yren, y512
constexpr int ROW_THREADS = 256;  // threads of the per-row reduction passes

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;  // NaN in either operand wins
}

__device__ __forceinline__ int pack4(const int* v) {
  return (v[0] & 0xff) | ((v[1] & 0xff) << 8) | ((v[2] & 0xff) << 16) |
         (int)((unsigned)(v[3] & 0xff) << 24);
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

// Forward int8 dots of one (ROWS x COLS) tile: re (plane 0, cos bases) or
// im (plane 1, sin bases), by blockIdx.z.  Grid (T/ROWS, N/COLS, 2).
// W: 8 int8 matrices [n][k] (transposed bases), per plane Wh_p, Wl_p,
// Wh_c, Wl_c.  Data split x = 256*xh + xl + 128 exactly; the prev row is
// input row t-1 (zeros for t = 0).  Always the 16-dot form: the TPU
// kernels call _fwd8_plane without hq.
__device__ __forceinline__ void fwd8_body(const int16_t* __restrict__ x,
                                          const int* __restrict__ W,
                                          const float* __restrict__ scales,
                                          const float* __restrict__ crows,
                                          float* __restrict__ re,
                                          float* __restrict__ im) {
  __shared__ int sd[4][ROWS][KW];  // ph, pl, ch, cl
  const int t0 = blockIdx.x * ROWS;
  const int plane = blockIdx.z;
  for (int i = threadIdx.x; i < ROWS * KW; i += blockDim.x) {
    const int r = i / KW, w = i % KW, t = t0 + r;
    int ph[4], pl[4], ch[4], cl[4];
    for (int b = 0; b < 4; ++b) {
      const int k = 4 * w + b;
      const int c = x[(size_t)t * N + k];
      const int p = t > 0 ? x[(size_t)(t - 1) * N + k] : 0;
      ch[b] = c >> 8;  // arithmetic shift: floor(c / 256)
      cl[b] = c - 256 * ch[b] - 128;
      ph[b] = p >> 8;
      pl[b] = p - 256 * ph[b] - 128;
    }
    sd[0][r][w] = pack4(ph);
    sd[1][r][w] = pack4(pl);
    sd[2][r][w] = pack4(ch);
    sd[3][r][w] = pack4(cl);
  }
  __syncthreads();

  const int n = blockIdx.y * COLS + threadIdx.x;
  const size_t mat = (size_t)N * KW;
  const int4* Wp = reinterpret_cast<const int4*>(W + 4 * plane * mat + (size_t)n * KW);
  int acc[ROWS][8];
  for (int r = 0; r < ROWS; ++r)
    for (int d = 0; d < 8; ++d) acc[r][d] = 0;
  for (int w4 = 0; w4 < KW / 4; ++w4) {
    const int4 whp = Wp[w4], wlp = Wp[mat / 4 + w4];
    const int4 whc = Wp[2 * mat / 4 + w4], wlc = Wp[3 * mat / 4 + w4];
    const int bhp[4] = {whp.x, whp.y, whp.z, whp.w};
    const int blp[4] = {wlp.x, wlp.y, wlp.z, wlp.w};
    const int bhc[4] = {whc.x, whc.y, whc.z, whc.w};
    const int blc[4] = {wlc.x, wlc.y, wlc.z, wlc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = 4 * w4 + e;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int aph = sd[0][r][w], apl = sd[1][r][w];
        const int ach = sd[2][r][w], acl = sd[3][r][w];
        acc[r][0] = __dp4a(aph, bhp[e], acc[r][0]);
        acc[r][1] = __dp4a(apl, bhp[e], acc[r][1]);
        acc[r][2] = __dp4a(aph, blp[e], acc[r][2]);
        acc[r][3] = __dp4a(apl, blp[e], acc[r][3]);
        acc[r][4] = __dp4a(ach, bhc[e], acc[r][4]);
        acc[r][5] = __dp4a(acl, bhc[e], acc[r][5]);
        acc[r][6] = __dp4a(ach, blc[e], acc[r][6]);
        acc[r][7] = __dp4a(acl, blc[e], acc[r][7]);
      }
    }
  }
  const float* s = scales + 4 * plane * N;
  const float s1p = s[n], s2p = s[N + n], s1c = s[2 * N + n], s2c = s[3 * N + n];
  const float crow = crows[plane * N + n];
  float* out = plane == 0 ? re : im;
  for (int r = 0; r < ROWS; ++r) {
    const int zh = 256 * acc[r][0] + acc[r][1];
    const int rh = 256 * acc[r][2] + acc[r][3];
    const int zc = 256 * acc[r][4] + acc[r][5];
    const int rc = 256 * acc[r][6] + acc[r][7];
    float v = s1p * (float)zh + s2p * (float)rh;
    v = v + s1c * (float)zc;
    v = v + s2c * (float)rc;
    out[(size_t)(t0 + r) * N + n] = v + crow;
  }
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
// im^2), |ren|, and the VAD flag with the semantics of _vad_rows
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
    const size_t i = (size_t)t * N + k;
    const float a = re[i], b = im[i];
    mag[i] = sqrtf(a * a + b * b);
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
