// K12, jb_fft4: batched unnormalised DFT of (T, n) f32 frames on Hopper
// (sm_90a), in shared memory.  Replaces jeicyboodsp_tpu/kernels/fft_pallas.py:
// fft_pallas (_fft_kernel), which evaluates the dense four-step (Bailey)
// form on the TPU's matrix unit: for n = n1 * n2, A = W1 @ x, B = A * tw,
// C = B @ W2^T, X[k2*n1 + k1] = C[k1, k2] -- 12.6 MFLOP per 8192-point frame.
//
// Here one launch does the whole transform and nothing but the frames and
// the result crosses device memory.  Each frame lives in dynamic shared
// memory (split re/im f32, 64 KB at n = 8192, 128 KB at n = 16384; several
// frames share a block where n is small).  The transform is a mixed-radix
// Stockham autosort FFT (Govindaraju et al., SC08): for each radix R of the
// plan, with Ns the product of the radices before it, group j (0 <= j <
// n/R) reads v[r] = x[j + r*n/R], multiplies by W_{Ns*R}^{(j mod Ns)*r},
// takes an R-point DFT and writes it to (j/Ns)*Ns*R + (j mod Ns) + r*Ns.
// Input and output are in natural order, so the four-step's transpose
// disappears and the device-memory reads and writes stay contiguous.
//
// - Power-of-two radices (2, 4, 8, 16) run as radix-4 butterflies in
//   registers (multiplications by +-i are swaps); a thread holds VPT values,
//   so every read of a pass completes before a barrier and every write
//   after it: one shared buffer, in place.  An odd prime factor (n = 96,
//   384) takes a dense R-point DFT per output, read from shared memory.
// - Twiddles W_n^e come from two tables built in f64 and stored as f32 per
//   (n, direction) -- W_n^(e mod 128) and W_n^(128*(e div 128)), 2 KB in
//   shared memory -- as one complex product; a group's W^r from the entries
//   of W, W^2, W^4 and W^8 and at most three products (about 4 f32 ulp).
// - Shared indices are padded by one word every 32 (i + i/32), so the
//   strided writes of the first passes spread over the banks.
// - n = 512 to 16384, powers of two (the port's paths: 512, 1024, 8192),
//   take a plan fixed at compile time (radix 16 passes, then one of 2, 4,
//   8): every index is a shift or a mask, and the first and last passes read
//   and write device memory directly.  Other n take the plan at run time.
//
// Bound on this card at T = 2041, n = 8192: 2 planes in and 2 out, 268 MB,
// 0.080 ms at 3.35 TB/s; the FFT's 5 n log2 n flops are 1.1e9, 0.016 ms at
// the 67 TFLOP/s f32 peak.  So the bytes bound it.  Sums run in another
// order than the four-step's, so K12 is held within 1e-5 of max |X| of its
// plain version (kernels/fft_four_step.py:fft_four_step), not bit-equal.

// The power-of-two device code (butterflies, twiddles, the compile-time
// passes passes_ct with this file's Rows as their IO policy) lives in
// rfft1024.cuh, which K4 and K10 share.

#include "rfft1024.cuh"

namespace {

constexpr int MAX_PASSES = 16;

// ---------------------------------------------------------------- power-of-two n

// passes_ct's IO policy (rfft1024.cuh): the frame's global rows, read by
// the first pass and written by the last.
struct Rows {
  const float* xr;
  const float* xi;  // null: real input
  float* outr;
  float* outi;
  bool live;        // false for the slots past the last frame
  static constexpr bool kInPlace = false;
  __device__ void load(int i, float& re, float& im) const {
    re = live ? xr[i] : 0.0f;
    im = live && xi ? xi[i] : 0.0f;
  }
  __device__ void store(int i, float re, float im) const {
    if (live) {
      outr[i] = re;
      outi[i] = im;
    }
  }
};

template <int LOGN, bool FWD>
__global__ void __launch_bounds__(Pow2<LOGN>::threads, Pow2<LOGN>::vpt <= 16 ? 2 : 1)
fft_pow2_kernel(const float* __restrict__ xr, const float* __restrict__ xi, int T,
                const float* __restrict__ consts, float* __restrict__ outr,
                float* __restrict__ outi) {
  using P = Pow2<LOGN>;
  extern __shared__ float smem[];
  constexpr int n = P::n, fs = n + n / 32 + 1;
  float* tw = smem;  // lo re, lo im, hi re, hi im
  const int slot = threadIdx.x / P::nthr, t = threadIdx.x % P::nthr;
  float* sr = smem + 4 * TWN + 2 * slot * fs;
  float* si = sr + fs;
  const long long f = (long long)blockIdx.x * P::fpb + slot;
  for (int i = threadIdx.x; i < 4 * TWN; i += blockDim.x) tw[i] = consts[i];
  if constexpr (P::nthr <= 32) __syncthreads();  // the passes' barriers are the warp's own
  const size_t row = (size_t)f * n;
  const Rows io{xr + row, xi ? xi + row : nullptr, outr + row, outi + row, f < T};
  passes_ct<LOGN, FWD, 1>(sr, si, tw, t, io);  // else the table is read after the first barrier
}

template <int LOGN, bool FWD>
int launch_pow2(const float* xr, const float* xi, int T, const float* consts, float* outr,
                float* outi, cudaStream_t st) {
  using P = Pow2<LOGN>;
  const int smem = (4 * TWN + 2 * P::fpb * (P::n + P::n / 32 + 1)) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fft_pow2_kernel<LOGN, FWD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((T + P::fpb - 1) / P::fpb);
  fft_pow2_kernel<LOGN, FWD><<<grid, P::threads, smem, st>>>(xr, xi, T, consts, outr, outi);
  return (int)cudaGetLastError();
}

template <int LOGN>
int launch_pow2(const float* xr, const float* xi, int T, const float* consts, float* outr,
                float* outi, int forward, cudaStream_t st) {
  return forward ? launch_pow2<LOGN, true>(xr, xi, T, consts, outr, outi, st)
                 : launch_pow2<LOGN, false>(xr, xi, T, consts, outr, outi, st);
}

// ---------------------------------------------------------------- any n

struct Plan {
  int n, vpt, nthr, fpb, npass;  // points, values per thread, threads per frame, frames per block
  int radix[MAX_PASSES];
};

// One Stockham pass of power-of-two radix R over the frame at (sr, si);
// thread t of the frame takes groups t + g*nthr, g < VPT/R.  The
// power-of-two radices come first in the plan, so Ns is a power of two.
template <int R, int VPT, bool FWD>
__device__ __forceinline__ void radix_pass(float* sr, float* si, const float* tw,
                                           const Plan& p, int Ns, int t) {
  constexpr int G = VPT / R;
  const int stride = p.n / R, step = p.n / (Ns * R);
  float xr[G][R], xi[G][R];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = t + g * p.nthr;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = pad(j + r * stride);
      xr[g][r] = sr[i];
      xi[g][r] = si[i];
    }
    if (Ns > 1) twiddle_ct<R>(tw, (j & (Ns - 1)) * step, xr[g], xi[g]);
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    dft_ct<FWD, R>(xr[g], xi[g]);
    const int j = t + g * p.nthr;
    const int base = (j / Ns) * Ns * R + (j & (Ns - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = pad(base + r * Ns);
      sr[i] = xr[g][r];
      si[i] = xi[g][r];
    }
  }
  __syncthreads();
}

// One pass of odd radix R as a dense DFT per output: output position q (=
// base(j) + r*Ns) sums R inputs x[j + m*n/R] * W_n^(k*m*n/(Ns*R) + (m*r mod
// R)*n/R).  Thread t holds its VPT outputs t + i*nthr across the barrier.
template <int VPT>
__device__ __forceinline__ void dense_pass(float* sr, float* si, const float* tw,
                                           const Plan& p, int R, int Ns, int t) {
  const int n = p.n, stride = n / R, step = n / (Ns * R);
  float yr[VPT], yi[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int q = t + v * p.nthr;
    const int r = (q / Ns) % R, k = q % Ns, j = (q / (Ns * R)) * Ns + k;
    float ar = 0.0f, ai = 0.0f;
    for (int m = 0; m < R; ++m) {
      const int i = pad(j + m * stride);
      float xr = sr[i], xi = si[i], c, s;
      twiddle(tw, (k * m * step + ((m * r) % R) * stride) % n, &c, &s);
      cmul(xr, xi, c, s);
      ar = ar + xr;
      ai = ai + xi;
    }
    yr[v] = ar;
    yi[v] = ai;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int i = pad(t + v * p.nthr);
    sr[i] = yr[v];
    si[i] = yi[v];
  }
  __syncthreads();
}

template <int VPT, bool FWD>
__global__ void __launch_bounds__(VPT >= 16 ? 512 : 1024)
fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi, int T,
           const float* __restrict__ consts, float* __restrict__ outr,
           float* __restrict__ outi, Plan p) {
  extern __shared__ float smem[];
  const int n = p.n, fs = pad(n) + 1;  // padded floats per frame plane
  float* tw = smem;                     // lo re, lo im, hi re, hi im
  const int slot = threadIdx.x / p.nthr, t = threadIdx.x % p.nthr;
  float* sr = smem + 4 * TWN + 2 * slot * fs;
  float* si = sr + fs;
  const long long f = (long long)blockIdx.x * p.fpb + slot;
  const bool live = f < T;
  const size_t row = (size_t)f * n;
  for (int i = threadIdx.x; i < 4 * TWN; i += blockDim.x) tw[i] = consts[i];
  if (live) {
    for (int i = t; i < n; i += p.nthr) {
      sr[pad(i)] = xr[row + i];
      si[pad(i)] = xi ? xi[row + i] : 0.0f;
    }
  }
  __syncthreads();
  int Ns = 1;
  for (int s = 0; s < p.npass; ++s) {
    const int R = p.radix[s];
    switch (R) {
      case 2: if constexpr (VPT >= 2) radix_pass<2, VPT, FWD>(sr, si, tw, p, Ns, t); break;
      case 4: if constexpr (VPT >= 4) radix_pass<4, VPT, FWD>(sr, si, tw, p, Ns, t); break;
      case 8: if constexpr (VPT >= 8) radix_pass<8, VPT, FWD>(sr, si, tw, p, Ns, t); break;
      case 16: if constexpr (VPT >= 16) radix_pass<16, VPT, FWD>(sr, si, tw, p, Ns, t); break;
      default: dense_pass<VPT>(sr, si, tw, p, R, Ns, t); break;
    }
    Ns *= R;
  }
  if (live) {
    for (int i = t; i < n; i += p.nthr) {
      outr[row + i] = sr[pad(i)];
      outi[row + i] = si[pad(i)];
    }
  }
}

// The plan of n: values per thread VPT (the power-of-two part of n, at most
// 16, or 32 where 16 would need more than 512 threads a frame), then the
// radices: power-of-two ones (largest first, each dividing VPT), then the
// odd prime factors.  Returns false if a frame would need more than 1024
// threads.
bool make_plan(int n, Plan* p) {
  int a = 1;
  while (n % (2 * a) == 0) a *= 2;
  int vpt = a < 16 ? a : 16;
  if (n / vpt > 512 && a >= 32) vpt = 32;
  if (n / vpt > 1024) return false;
  p->n = n;
  p->vpt = vpt;
  p->nthr = n / vpt;
  p->fpb = p->nthr >= BLOCK_TARGET ? 1 : BLOCK_TARGET / p->nthr;
  p->npass = 0;
  const int rmax = vpt < 16 ? vpt : 16;
  for (int rest = a; rest > 1;) {
    int r = rmax;
    while (rest % r) r /= 2;
    p->radix[p->npass++] = r;
    rest /= r;
  }
  int m = n / a;
  for (int q = 3; m > 1; q += 2) {
    while (m % q == 0) {
      if (p->npass == MAX_PASSES) return false;
      p->radix[p->npass++] = q;
      m /= q;
    }
  }
  return true;
}

template <int VPT, bool FWD>
int launch(const float* xr, const float* xi, int T, const float* consts, float* outr,
           float* outi, const Plan& p, cudaStream_t st) {
  const int fs = p.n + (p.n >> 5) + 1;
  const size_t smem = (4 * TWN + (size_t)2 * p.fpb * fs) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fft_kernel<VPT, FWD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((T + p.fpb - 1) / p.fpb);
  fft_kernel<VPT, FWD><<<grid, p.fpb * p.nthr, smem, st>>>(xr, xi, T, consts, outr, outi, p);
  return (int)cudaGetLastError();
}

template <int VPT>
int launch(const float* xr, const float* xi, int T, const float* consts, float* outr,
           float* outi, const Plan& p, int forward, cudaStream_t st) {
  return forward ? launch<VPT, true>(xr, xi, T, consts, outr, outi, p, st)
                 : launch<VPT, false>(xr, xi, T, consts, outr, outi, p, st);
}

}  // namespace

// xr, xi: (T, n) f32 frames (xi null: real input).  consts: the f32
// twiddle tables of (n, direction), W_n^e for e < 128 and W_n^(128 h) for
// h < 128, re then im each: 512 floats.  Outputs outr, outi (T, n) in
// natural order.  One launch; returns cudaErrorInvalidValue for an n the
// plan cannot take (more than 1024 threads a frame: an odd n past 1024).
extern "C" int jb_fft4(const float* xr, const float* xi, int T, int n, int forward,
                       const float* consts, float* outr, float* outi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || n < 2 || n > TWN * TWN) return (int)cudaErrorInvalidValue;
  switch (n) {  // the power-of-two sizes from 512 up: compile-time plans
    case 512: return launch_pow2<9>(xr, xi, T, consts, outr, outi, forward, st);
    case 1024: return launch_pow2<10>(xr, xi, T, consts, outr, outi, forward, st);
    case 2048: return launch_pow2<11>(xr, xi, T, consts, outr, outi, forward, st);
    case 4096: return launch_pow2<12>(xr, xi, T, consts, outr, outi, forward, st);
    case 8192: return launch_pow2<13>(xr, xi, T, consts, outr, outi, forward, st);
    case 16384: return launch_pow2<14>(xr, xi, T, consts, outr, outi, forward, st);
    default: break;
  }
  Plan p;
  if (!make_plan(n, &p)) return (int)cudaErrorInvalidValue;
  switch (p.vpt) {
    case 1: return launch<1>(xr, xi, T, consts, outr, outi, p, forward, st);
    case 2: return launch<2>(xr, xi, T, consts, outr, outi, p, forward, st);
    case 4: return launch<4>(xr, xi, T, consts, outr, outi, p, forward, st);
    case 8: return launch<8>(xr, xi, T, consts, outr, outi, p, forward, st);
    case 16: return launch<16>(xr, xi, T, consts, outr, outi, p, forward, st);
    default: return launch<32>(xr, xi, T, consts, outr, outi, p, forward, st);
  }
}
