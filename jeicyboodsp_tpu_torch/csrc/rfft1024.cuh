// Shared-memory Stockham FFT device code (K12, fft4.cu) and, on top of it,
// the windowed real FFT of 1024-sample frames that K4 (enhance_mxu3.cu) and
// K10 (mfcc.cu) run: one frame per 32 threads, bins 0..511, nothing but the
// frame and what the caller keeps of the result crossing device memory.
//
// The power-of-two Stockham passes (Govindaraju et al., SC08): for each
// radix R of the plan, with Ns the product of the radices before it, group j
// (0 <= j < n/R) reads v[r] = x[j + r*n/R], multiplies by W_{Ns*R}^{(j mod
// Ns)*r}, takes an R-point DFT in registers (radix-4 butterflies, products
// by +-i as swaps) and writes it to (j/Ns)*Ns*R + (j mod Ns) + r*Ns, in one
// shared buffer per plane, padded by one word every 32 (pad()).  Twiddles
// W_n^e come from two f32 tables built in f64, W_n^(e mod 128) and
// W_n^(128*(e div 128)), as one complex product.  passes_ct takes an IO
// policy for the ends of the plan:
//   __device__ void load(int i, float& re, float& im) const;  // first pass: x[i]
//   __device__ void store(int i, float re, float im) const;   // last pass: X[i]
//   static constexpr bool kInPlace;  // store writes the shared frame the last pass reads
//
// The real FFT of a 1024-sample frame x with window w (rfft_frame) packs
// the frame's own even and odd samples into a 512-point complex transform,
// z[m] = w[2m] x[2m] + i w[2m+1] x[2m+1], runs the Pow2<9> plan (16 values a
// thread, 32 threads a frame, 8 frames a block) and splits the result with
// W = W_1024^k:
//   X[k] = (Z[k] + conj Z[512-k])/2 - (i/2) W (Z[k] - conj Z[512-k]),  k < 512.
// Each frame is its own transform: its rounding errors scale with its own
// size, and an all-zero frame gives exactly zero bins.  The constants
// (RF_CONSTS floats, built in f64 and stored as f32 by the wrappers) are the
// 512-point forward twiddle tables in K12's form, cos and sin of W_1024^k,
// and the window.  Everything sits in an anonymous namespace, so each file
// that includes it compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TWN = 128;           // entries per twiddle table
constexpr int BLOCK_TARGET = 256;  // threads a block aims for when frames are small

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// cos, sin of 2*pi*k/16, k < 8: the R-point butterflies' own twiddles
__constant__ float kC16[8] = {1.0f, 0.92387953f, 0.70710678f, 0.38268343f,
                              0.0f, -0.38268343f, -0.70710678f, -0.92387953f};
__constant__ float kS16[8] = {0.0f, 0.38268343f, 0.70710678f, 0.92387953f,
                              1.0f, 0.92387953f, 0.70710678f, 0.38268343f};

// (xr, xi) *= (c, s)
__device__ __forceinline__ void cmul(float& xr, float& xi, float c, float s) {
  const float r = fmaf(xr, c, -(xi * s));
  xi = fmaf(xr, s, xi * c);
  xr = r;
}

// W_n^e (e < n <= 128*128) from the two shared tables: lo[e mod 128] *
// hi[e div 128]
__device__ __forceinline__ void twiddle(const float* tw, int e, float* c, float* s) {
  *c = tw[e & (TWN - 1)];
  *s = tw[TWN + (e & (TWN - 1))];
  cmul(*c, *s, tw[2 * TWN + (e >> 7)], tw[3 * TWN + (e >> 7)]);
}

// (xr, xi) *= W16^m of the direction, m compile-time after unrolling
template <bool FWD>
__device__ __forceinline__ void w16(float& xr, float& xi, int m) {
  m &= 15;
  if (m == 0) return;
  const float sg = FWD ? -1.0f : 1.0f;
  if (m == 4) {  // sg * i
    const float r = -sg * xi;
    xi = sg * xr;
    xr = r;
    return;
  }
  if (m == 8) {
    xr = -xr;
    xi = -xi;
    return;
  }
  if (m == 12) {  // -sg * i
    const float r = sg * xi;
    xi = -sg * xr;
    xr = r;
    return;
  }
  const float c = m < 8 ? kC16[m] : -kC16[m - 8];
  const float s = sg * (m < 8 ? kS16[m] : -kS16[m - 8]);
  cmul(xr, xi, c, s);
}

// radix-4 butterfly on x[a], x[a+d], x[a+2d], x[a+3d] (natural order out)
template <bool FWD, int R>
__device__ __forceinline__ void bfly4(float (&xr)[R], float (&xi)[R], int a, int d) {
  const float sg = FWD ? -1.0f : 1.0f;
  const float a0r = xr[a] + xr[a + 2 * d], a0i = xi[a] + xi[a + 2 * d];
  const float a1r = xr[a] - xr[a + 2 * d], a1i = xi[a] - xi[a + 2 * d];
  const float a2r = xr[a + d] + xr[a + 3 * d], a2i = xi[a + d] + xi[a + 3 * d];
  const float br = xr[a + d] - xr[a + 3 * d], bi = xi[a + d] - xi[a + 3 * d];
  const float a3r = -sg * bi, a3i = sg * br;  // (x1 - x3) * (sg * i)
  xr[a] = a0r + a2r; xi[a] = a0i + a2i;
  xr[a + 2 * d] = a0r - a2r; xi[a + 2 * d] = a0i - a2i;
  xr[a + d] = a1r + a3r; xi[a + d] = a1i + a3i;
  xr[a + 3 * d] = a1r - a3r; xi[a + 3 * d] = a1i - a3i;
}

// In-register R-point DFT, natural order in and out, R in {2, 4, 8, 16}
template <bool FWD, int R>
__device__ __forceinline__ void dft_ct(float (&xr)[R], float (&xi)[R]) {
  if constexpr (R == 2) {
    const float r = xr[0] - xr[1], i = xi[0] - xi[1];
    xr[0] = xr[0] + xr[1]; xi[0] = xi[0] + xi[1];
    xr[1] = r; xi[1] = i;
  } else if constexpr (R == 4) {
    bfly4<FWD, 4>(xr, xi, 0, 1);
  } else if constexpr (R == 8) {
    // E = DFT4(x0, x2, x4, x6), O = DFT4(x1, x3, x5, x7); X[k] = E[k] + W8^k O[k]
    bfly4<FWD, 8>(xr, xi, 0, 2);
    bfly4<FWD, 8>(xr, xi, 1, 2);
    float yr[8], yi[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float orr = xr[2 * k + 1], oi = xi[2 * k + 1];
      w16<FWD>(orr, oi, 2 * k);
      yr[k] = xr[2 * k] + orr; yi[k] = xi[2 * k] + oi;
      yr[k + 4] = xr[2 * k] - orr; yi[k + 4] = xi[2 * k] - oi;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) { xr[k] = yr[k]; xi[k] = yi[k]; }
  } else {
    // 16 = 4 x 4: x[4 n1 + n2]; inner DFT4 over n1 per n2, twiddle
    // W16^(n2 k1), outer DFT4 over n2; X[k1 + 4 k2] lands in y[4 k2 + k1]
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) bfly4<FWD, 16>(xr, xi, n2, 4);  // now x[4 k1 + n2]
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1)
#pragma unroll
      for (int n2 = 1; n2 < 4; ++n2) w16<FWD>(xr[4 * k1 + n2], xi[4 * k1 + n2], n2 * k1);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) bfly4<FWD, 16>(xr, xi, 4 * k1, 1);  // x[4 k1 + k2]
    float yr[16], yi[16];
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1)
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        yr[k1 + 4 * k2] = xr[4 * k1 + k2];
        yi[k1 + 4 * k2] = xi[4 * k1 + k2];
      }
#pragma unroll
    for (int k = 0; k < 16; ++k) { xr[k] = yr[k]; xi[k] = yi[k]; }
  }
}

// multiply v[r] (r >= 1) by W^r, W = W_n^e1, from the table entries of
// e1, 2 e1, 4 e1, 8 e1 (those below R)
template <int R>
__device__ __forceinline__ void twiddle_ct(const float* tw, int e1, float (&xr)[R],
                                           float (&xi)[R]) {
  float pr[4], pi[4];  // W^1, W^2, W^4, W^8
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if ((1 << b) < R) twiddle(tw, e1 << b, &pr[b], &pi[b]);
#pragma unroll
  for (int r = 1; r < R; ++r) {
    float c = 1.0f, s = 0.0f;
    bool first = true;
#pragma unroll
    for (int b = 3; b >= 0; --b) {
      if (r & (1 << b)) {
        if (first) {
          c = pr[b]; s = pi[b]; first = false;
        } else {
          cmul(c, s, pr[b], pi[b]);
        }
      }
    }
    cmul(xr[r], xi[r], c, s);
  }
}

// ---------------------------------------------------------------- power-of-two n

template <int LOGN> struct Pow2 {
  static constexpr int n = 1 << LOGN;
  static constexpr int vpt = n > 8192 ? 32 : 16;
  static constexpr int nthr = n / vpt;
  static constexpr int fpb = nthr >= BLOCK_TARGET ? 1 : BLOCK_TARGET / nthr;
  static constexpr int threads = fpb * nthr;
};

// The barrier between passes: a frame of one warp (n = 512) waits for its
// own warp only, so the block's frames do not run in lockstep; a larger
// frame waits for the block.
template <int NTHR>
__device__ __forceinline__ void frame_sync() {
  if constexpr (NTHR <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// the passes from Ns = NS on: radix 16 while 16 divides n / NS, then the
// rest.  The first pass (NS = 1, no twiddles) takes the frame from io.load
// and the last one (its outputs land at j + r*NS) hands it to io.store,
// both with neighbouring threads on neighbouring indices; in between the
// frame lives in (sr, si).  Every thread of the frame calls it (of the
// block, where a frame spans more than one warp): it holds barriers.  The
// twiddle table must be visible to the frame's threads before the call.
template <int LOGN, bool FWD, int NS, class IO>
__device__ __forceinline__ void passes_ct(float* sr, float* si, const float* tw, int t,
                                          const IO& io) {
  constexpr int n = Pow2<LOGN>::n, VPT = Pow2<LOGN>::vpt, NTHR = Pow2<LOGN>::nthr;
  constexpr int R = (n / NS) >= 16 ? 16 : n / NS;
  constexpr int G = VPT / R, STRIDE = n / R, STEP = n / (NS * R);
  constexpr bool FIRST = NS == 1, LAST = NS * R == n;
  float xr[G][R], xi[G][R];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = t + g * NTHR;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (FIRST) {
        io.load(j + r * STRIDE, xr[g][r], xi[g][r]);
      } else {
        const int i = pad(j + r * STRIDE);
        xr[g][r] = sr[i];
        xi[g][r] = si[i];
      }
    }
    if constexpr (NS > 1) twiddle_ct<R>(tw, (j & (NS - 1)) * STEP, xr[g], xi[g]);
  }
  if constexpr (!FIRST && (!LAST || IO::kInPlace)) frame_sync<NTHR>();  // every read before the writes
#pragma unroll
  for (int g = 0; g < G; ++g) {
    dft_ct<FWD, R>(xr[g], xi[g]);
    const int j = t + g * NTHR;
    const int base = (j / NS) * NS * R + (j & (NS - 1));  // NS a power of two: shifts
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (LAST) {
        io.store(base + r * NS, xr[g][r], xi[g][r]);
      } else {
        const int i = pad(base + r * NS);
        sr[i] = xr[g][r];
        si[i] = xi[g][r];
      }
    }
  }
  if constexpr (!LAST) {
    frame_sync<NTHR>();
    passes_ct<LOGN, FWD, NS * R>(sr, si, tw, t, io);
  }
}

// ---------------------------------------------------------------- real FFT of 1024-sample frames

constexpr int RF_N = 1024;                      // samples of a frame
constexpr int RF_H = RF_N / 2;                  // points of the packed transform = bins kept
using RfPlan = Pow2<9>;                         // 16 values a thread, 32 threads a frame
constexpr int RF_VPT = RfPlan::vpt, RF_FPB = RfPlan::fpb, RF_THREADS = RfPlan::threads;
constexpr int RF_PLANE = RF_H + RF_H / 32 + 1;  // padded floats of one plane of a frame
// the constants: twiddle tables (4 TWN), cos and sin of W_1024^k (k < 512), the window
constexpr int RF_SPLIT = 4 * TWN, RF_WIN = RF_SPLIT + 2 * RF_H, RF_CONSTS = RF_WIN + RF_N;
// dynamic shared memory of a block: the constants, then two planes per frame
constexpr int RF_SMEM = (RF_CONSTS + 2 * RF_FPB * RF_PLANE) * (int)sizeof(float);
static_assert(RfPlan::nthr == 32 && RF_VPT == 16, "a frame is one warp of 16 values a thread");

// rfft_frame's IO: the first pass takes z[m] from the frame source's samples
// 2m, 2m+1 (Src::pair) times the window; the last pass writes Z to the
// frame's shared planes
template <class Src>
struct RfIO {
  Src src;
  const float* win;
  float* sr;
  float* si;
  static constexpr bool kInPlace = true;
  __device__ void load(int m, float& re, float& im) const {
    float a, b;
    src.pair(m, a, b);
    const float2 w = *reinterpret_cast<const float2*>(win + 2 * m);
    re = a * w.x;
    im = b * w.y;
  }
  __device__ void store(int i, float re, float im) const {
    sr[pad(i)] = re;
    si[pad(i)] = im;
  }
};

// The windowed real FFT of one frame by the 32 threads of one warp (t = the
// lane), with the constants in shared memory at c: bin k = t + 32 q lands
// in (xr[q], xi[q]).  Src gives the frame's samples:
//   __device__ void pair(int m, float& a, float& b) const;  // x[2m], x[2m+1]
// The warp's barriers are its own; the planes (sr, si) hold Z on return,
// and the caller waits for its warp (__syncwarp) before it writes them.
template <class Src>
__device__ __forceinline__ void rfft_frame(const Src& src, const float* c, float* sr, float* si,
                                           int t, float (&xr)[RF_VPT], float (&xi)[RF_VPT]) {
  passes_ct<9, true, 1>(sr, si, c, t, RfIO<Src>{src, c + RF_WIN, sr, si});
  __syncwarp();  // Z[k] and Z[512 - k] lie with different lanes
  const float* wc = c + RF_SPLIT;
  const float* ws = wc + RF_H;
#pragma unroll
  for (int q = 0; q < RF_VPT; ++q) {
    const int k = t + 32 * q, a = pad(k), b = pad((RF_H - k) & (RF_H - 1));
    const float ar = sr[a], ai = si[a], br = sr[b], bi = si[b];
    // Z[k] + conj Z[512-k] = 2 E[k], Z[k] - conj Z[512-k] = 2i O[k]; X = E + W O
    const float er = ar + br, ei = ai - bi, dr = ar - br, di = ai + bi;
    const float wr = wc[k], wi = ws[k];
    xr[q] = 0.5f * (er + (wr * di + wi * dr));
    xi[q] = 0.5f * (ei - (wr * dr - wi * di));
  }
}

// Blocks of a persistent launch of kernel (RF_THREADS threads, smem bytes
// of dynamic shared memory): as many as the card holds at once, at most
// groups.  Each warp then walks the frames f0, f0 + 8 * grid, ...
template <class Kernel>
int rf_grid(Kernel kernel, int smem, long long groups) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, RF_THREADS, smem);
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(groups < full ? groups : full);
}

}  // namespace
