// The enhancement chain of engines mxu8f / mxu8t on Hopper (sm_90a).
//
// Replaces the Pallas kernel jeicyboodsp_tpu/kernels/enhance_pallas.py:
// enhance_full8_pallas (_make_full8_kernel and its helpers _fwd8_plane,
// _quant_row_int8, _inv_plane8, _c_short_f32).  Same math, other blocks:
// the TPU kernel walks a sequential grid of 256-row tiles and carries the
// previous row, the noise-latch state and the OLA tail from one step to
// the next; CUDA blocks run in no order, so each carry becomes a separate
// pass here, run one after another on one stream by jb_enhance_full8:
//
//   1. fwd8_kernel     int8-split forward rDFT -> re, im planes
//                      (the prev row is input row t-1, zeros for t = 0)
//   2. nyq_kernel      the Nyquist bin as a true f32 dot -> ren
//   3. latch_prefix    per-chunk (L rows) inclusive sums of w_j*|X_j|
//   4. latch_scan      A0_{c+1} = a_c*A0_c + a_c*S_c over the T/L chunks
//   5. gain_quant      ns = p_g*(P[g] + A0[chunk(g)]), gain, two-level
//                      per-row int8 quantization, y512 column
//   6. inv8_kernel     int8 inverse: u (with the Nyquist term) and v
//   7. ola_kernel      head = u - v, tail = [y512, flip(u + v)[1:]] of row
//                      t-1 (an index permutation), OLA, c_short, mask
//
// Bound on this card: the int8 dots (16 per output bin forward, 3-5
// inverse, K = 512) -- about 0.1 T int8 MACs at T = 16384 rows -- run
// here as __dp4a on CUDA cores with the data rows in shared memory and the
// bases read through L1; the planes between passes go through device
// memory.  Tensor-core MMA and keeping the planes on chip are later work.
//
// Exactness: every int8 dot accumulates in int32 and combines as
// 256*a + b in int32 (|.| <= 2.139e9 < 2^31, enhance_pallas.py:149-150,
// :403-404).  The f32 epilogues keep the JAX operand order and are built
// with -fmad=false, so no a*b+c is contracted into an FMA.  rintf rounds
// half to even, as jnp.rint.  Row maxima propagate NaN (max_nan), as
// jnp.max does, so the Wiener 0/0 case still ends as c_short(NaN) = 0.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int N = 512;        // samples per block = bins per plane
constexpr int NB = N + 1;     // bins with Nyquist, in the latch planes
constexpr int KW = N / 4;     // int32 words in one int8 row
constexpr int ROWS = 8;       // rows per block of the dot kernels
constexpr int COLS = 128;     // output columns (threads) per block
constexpr int RP = 8;         // row-pack width: w, p, g, p[g], 0...
constexpr int RS = 8;         // row scalars: q_re, q2_re, q_im, q2_im, Yren, y512

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

// 1. forward: re (plane 0, cos bases) or im (plane 1, sin bases).
// W: 8 int8 matrices [n][k] (transposed bases), per plane Wh_p, Wl_p,
// Wh_c, Wl_c.  Data split x = 256*xh + xl + 128 exactly.  The forward is
// always the 16-dot form (the TPU kernel calls _fwd8_plane without hq).
__global__ void fwd8_kernel(const int16_t* __restrict__ x,
                            const int* __restrict__ W,
                            const float* __restrict__ scales,
                            const float* __restrict__ crows,
                            float* __restrict__ re, float* __restrict__ im) {
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

// 2. Nyquist bin: prev . nyq[:512] + cur . nyq[512:], f32.
__global__ void nyq_kernel(const int16_t* __restrict__ x,
                           const float* __restrict__ nyq,
                           float* __restrict__ ren) {
  __shared__ float red[32];
  const int t = blockIdx.x;
  float sp = 0.0f, sc = 0.0f;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    const float p = t > 0 ? (float)x[(size_t)(t - 1) * N + k] : 0.0f;
    sp = sp + p * nyq[k];
    sc = sc + (float)x[(size_t)t * N + k] * nyq[N + k];
  }
  sp = block_reduce<false>(sp, red);
  sc = block_reduce<false>(sc, red);
  if (threadIdx.x == 0) ren[t] = sp + sc;
}

// 3. inclusive prefix of w_j*|X_j| within each chunk of L rows (bin 512 =
// Nyquist |ren|).  pfx: (T, 513).
__global__ void latch_prefix_kernel(const float* __restrict__ re,
                                    const float* __restrict__ im,
                                    const float* __restrict__ ren,
                                    const float* __restrict__ rowpack,
                                    float* __restrict__ pfx, int L) {
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= NB) return;
  float acc = 0.0f;
  for (int j = 0; j < L; ++j) {
    const size_t t = (size_t)blockIdx.x * L + j;
    float m;
    if (k < N) {
      const float a = re[t * N + k], b = im[t * N + k];
      m = sqrtf(a * a + b * b);
    } else {
      m = fabsf(ren[t]);
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

// 5. one block of N threads per row: noise estimate, gain, per-row
// two-level int8 quantization of Yre/Yim, y512 column.
// q8: 6 int8 planes (T, 512): h_re, l_re, z2_re, h_im, l_im, z2_im.
__global__ void gain_quant_kernel(const float* __restrict__ re,
                                  const float* __restrict__ im,
                                  const float* __restrict__ ren,
                                  const float* __restrict__ rowpack,
                                  const float* __restrict__ pfx,
                                  const float* __restrict__ A0,
                                  const float* __restrict__ y512col,
                                  int8_t* __restrict__ q8,
                                  float* __restrict__ rowsc,
                                  int T, int L, int wiener, int hq) {
  __shared__ float red[32];
  const int t = blockIdx.x, k = threadIdx.x;
  const float g = rowpack[(size_t)t * RP + 2], pg = rowpack[(size_t)t * RP + 3];
  float ns = 0.0f, nsn = 0.0f;
  if (g >= 0.0f) {
    const size_t gi = (size_t)g, cg = gi / L;
    ns = pg * pfx[gi * NB + k] + pg * A0[cg * NB + k];
    nsn = pg * pfx[gi * NB + N] + pg * A0[cg * NB + N];
  }
  const float a = re[(size_t)t * N + k], b = im[(size_t)t * N + k];
  const float rn = ren[t];
  float gk, gn;
  if (wiener) {
    const float P = a * a + b * b;
    const float v = ns * ns / P;  // 0/0 -> NaN, as the reference
    gk = 1.0f - (v >= 1.0f ? 1.0f : v);
    const float vn = nsn * nsn / (rn * rn);
    gn = 1.0f - (vn >= 1.0f ? 1.0f : vn);
  } else {
    const float mag = sqrtf(a * a + b * b);
    gk = (mag - ns) / mag;
    const float magn = fabsf(rn);
    gn = (magn - nsn) / magn;
  }
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

// 6. inverse: plane 0 u = q*(s1U*z + s2U*r + crowU) [+ (q2*s1U)*z2.Uh]
// + Yren*u_nyq from the re quantization; plane 1 v likewise from im with
// the V bases.  B: 4 int8 matrices [s][k]: Uh, Ul, Vh, Vl.  Turbo (hq = 0)
// drops l.Wl and the level-2 plane (enhance_pallas.py:410-413).
__global__ void inv8_kernel(const int8_t* __restrict__ q8,
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

// 7. overlap-add: out[t] = c_short(head[t] + tail[t-1]) with
// head = u - v, tail[0] = y512, tail[j] = (u + v)[512 - j] for j >= 1.
__global__ void ola_kernel(const float* __restrict__ uv,
                           const float* __restrict__ rowsc,
                           int16_t* __restrict__ out, int T, int emit_all) {
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

// Launches passes 1-7 on `stream`.  Every buffer is allocated by the caller:
//   re, im (T, 512) f32; ren (T,) f32; pfx (T, 513) f32; A0 (T/L, 513) f32;
//   q8 (6, T, 512) int8; rowsc (T, 8) f32; uv (2, T, 512) f32;
//   out (T, 512) int16.
// T must be a multiple of L and of 8.  Returns cudaGetLastError().
extern "C" int jb_enhance_full8(
    const int16_t* x, const float* rowpack, int T, int L, int wiener, int hq,
    int emit_all, const int8_t* fwd8, const float* fscales, const float* fcrows,
    const float* nyq, const int8_t* back8, const float* bscales,
    const float* bcrows, const float* u_nyq, const float* y512col, float* re,
    float* im, float* ren, float* pfx, float* A0, int8_t* q8, float* rowsc,
    float* uv, int16_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 dots(T / ROWS, N / COLS, 2);
  const int C = T / L;
  const int kb = (NB + COLS - 1) / COLS;
  fwd8_kernel<<<dots, COLS, 0, st>>>(x, reinterpret_cast<const int*>(fwd8),
                                     fscales, fcrows, re, im);
  nyq_kernel<<<T, 256, 0, st>>>(x, nyq, ren);
  latch_prefix_kernel<<<dim3(C, kb), COLS, 0, st>>>(re, im, ren, rowpack, pfx, L);
  latch_scan_kernel<<<kb, COLS, 0, st>>>(pfx, rowpack, A0, C, L);
  gain_quant_kernel<<<T, N, 0, st>>>(re, im, ren, rowpack, pfx, A0, y512col,
                                     q8, rowsc, T, L, wiener, hq);
  inv8_kernel<<<dots, COLS, 0, st>>>(q8, reinterpret_cast<const int*>(back8),
                                     bscales, bcrows, rowsc, u_nyq, uv, T, hq);
  ola_kernel<<<T, N, 0, st>>>(uv, rowsc, out, T, emit_all);
  return (int)cudaGetLastError();
}
