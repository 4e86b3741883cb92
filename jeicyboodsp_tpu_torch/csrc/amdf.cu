// The AMDF lag search of pitch method 2 on Hopper (sm_90a).
//
// K11, jb_amdf, replaces jeicyboodsp_tpu/kernels/amdf_pallas.py: amdf_pallas
// (_make_kernel): (T, 1024) int16 frames -> (T, 512 - lo) f64
//   amdf[k] = sum_{i < 1024-k} |u_i - u_{i+k}| / (1024 - k),  lo <= k < 512
// (PitchEstimation_method2.cpp:79-95).
//
// Exact, in int32: with n = 1024 - k and P the frame's prefix sums,
//   sum_{i<n} |u_i - u_{i+k}| = P[n] + (P[1024] - P[k]) - 2 sum_{i<n} min(u_i, u_{i+k}),
// since |a - b| = a + b - 2 min(a, b).  Every term is an integer below 2^26 in
// magnitude, so the sum is exact, and the quotient is one IEEE f64 division,
// which is bit for bit the oracle's float(int_sum) / (1024 - k).  The TPU
// kernel summed in f32 over the whole zero-padded frame and rounded once the
// sums passed 2^24.
//
// What bounds it on this card at T = 16384, lo = 96: 4.91e9 (u_i, u_{i+k})
// pairs against 88 MB of frames and f64 output (0.026 ms), so its
// instructions.  Hopper's DPX min on packed int16 (__vmins2, one
// VIMNMX.S16x2) takes the min of two pairs, and one IDP2A (__dp2a_lo against
// the bytes (1, 1)) adds both halves into an int32 sum: two instructions for
// two pairs, one a pair, where f32 needs two a pair (d = a - b, then s += |d|)
// and int32 three (IADD, IABS, IADD on the INT32 pipe, 64 lanes a clock per
// SM).  The min runs on the ALU pipe and the dot on the FMA pipe, so the two
// overlap; the bound is one instruction a pair at 128 lanes a clock per SM.
//
// Design:
// - Register-blocked lags: a thread owns a lag group of R = 8 lags k0..k0+7
//   and walks i in chunks of 8 samples (4 words): it holds a = u[i0, i0+8)
//   and b = u[i0+k0, i0+k0+16) as packed words and adds the 64 pairs'
//   minima into acc[r].  Even lags pair whole words; odd lags pair a with
//   b's words shifted by one sample (one PRMT each, shared by 4 lags).  The
//   next chunk's b starts where this one's second half does, so a chunk
//   costs two 16-byte shared loads for 32 VIMNMX and 32 IDP2A.
// - The ragged triangle: a group's chunks run to i0 + 8 = 1024 - k0; in the
//   last one the pairs with j + r >= 8 read the 32767s staged past the
//   frame, whose min is a[j]; those r terms are taken off acc[r] right after
//   the loop, from a still in registers.
// - The prefix sums: after staging, a thread per (frame, 32 samples) sums its
//   samples and, after a barrier, writes their running sums from the sum of
//   the segments before it; the array skips a slot every 32 entries, so a
//   warp's 32 segments write 32 banks.
// - Load balance: group g sums c_g = 128 - k0/8 chunks (116 down to 65 at
//   lo = 96).  A thread owns groups g and G-1-g, whose chunks add up to the
//   same 193 - lo/8 for every thread, so no lane of a warp waits on another.
// - Bank conflicts: a block stages FRAMES = 16 frames; lane f of a warp
//   takes frame f and the warp's two halves take two neighbouring groups,
//   so the 8 lanes of each quarter warp read the same offsets of 8 frames.
//   A frame's stride of 524 words (131 16-byte units, odd) puts those 8
//   reads in 8 different bank groups.
// - Alignment: a block reads its 16 frames as 16-byte vectors when the input
//   starts on a 16-byte boundary, else as int16 scalars.
// - The f64 output (62% of the bytes): each thread writes its 8 lags of a
//   group as four 16-byte stores, a whole 64-byte run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PROC = 1024;  // samples per frame
constexpr int KEEP = 512;   // lags searched: [lo, 512)
constexpr int R = 8;        // lags per group = samples per chunk
constexpr int FRAMES = 16;  // frames per block
constexpr int WORDS = PROC / 2;        // packed int16 pairs per frame
constexpr int WSTRIDE = WORDS + 12;    // words per staged frame: the frame, 8 of 32767s, 4 of padding
constexpr int SEG = 32;                // samples per prefix-sum segment
constexpr int SEGS = PROC / SEG;
constexpr int PSTRIDE = PROC + 1 + PROC / SEG + 3;  // prefix sums per frame, a slot skipped every 32
constexpr int SMEM = (FRAMES * (WSTRIDE + PSTRIDE) + FRAMES * SEGS) * 4;
constexpr unsigned PAD = 0x7fff7fffu;  // two samples of 32767: min(a, 32767) = a
static_assert((WSTRIDE / 4) % 2 == 1, "8 frames' same offsets must fall in 8 bank groups");
static_assert(PSTRIDE % 4 == 0, "each frame's arrays start on a 16-byte boundary");

__device__ __forceinline__ int pidx(int n) { return n + (n >> 5); }  // P[n]'s slot

__device__ __forceinline__ int lo16(unsigned w) { return (int)(int16_t)(w & 0xffffu); }
__device__ __forceinline__ int hi16(unsigned w) { return (int)(int16_t)(w >> 16); }

// the 8 int16 samples p[0..8) as 4 packed words: one 16-byte load when VEC, else eight 2-byte loads
template <bool VEC>
__device__ __forceinline__ uint4 load8(const int16_t* p) {
  if (VEC) return *reinterpret_cast<const uint4*>(p);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = (uint16_t)p[2 * i] | ((unsigned)(uint16_t)p[2 * i + 1] << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The R lags k0..k0+R-1 of the staged frame: u its words, P its prefix sums;
// out[r] = AMDF at lag k0 + r.
__device__ __forceinline__ void lag_group(const unsigned* u, const int* P, int k0, double* out) {
  const int c = (PROC - k0) / R;  // chunks; the last one holds the triangle
  unsigned a[4], b[8], o[7];
  {
    const uint4 t = *reinterpret_cast<const uint4*>(u + k0 / 2);
    b[0] = t.x, b[1] = t.y, b[2] = t.z, b[3] = t.w;
  }
  int acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;
#pragma unroll 2
  for (int q = 0; q < c; ++q) {
    uint4 t = *reinterpret_cast<const uint4*>(u + 4 * q);
    a[0] = t.x, a[1] = t.y, a[2] = t.z, a[3] = t.w;
    t = *reinterpret_cast<const uint4*>(u + 4 * q + k0 / 2 + 4);
    b[4] = t.x, b[5] = t.y, b[6] = t.z, b[7] = t.w;
#pragma unroll
    for (int w = 0; w < 7; ++w) o[w] = __byte_perm(b[w], b[w + 1], 0x5432);  // samples 2w+1, 2w+2
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        acc[r] = __dp2a_lo((int)__vmins2(a[m], (r & 1) ? o[(r - 1) / 2 + m] : b[r / 2 + m]),
                           0x0101, acc[r]);
#pragma unroll
    for (int w = 0; w < 4; ++w) b[w] = b[w + 4];
  }
  // the triangle: lag r's last r pairs added min(a[j], 32767) = a[j] for j >= R - r
  int t = 0;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    const int j = R - r;
    t += (j & 1) ? hi16(a[j / 2]) : lo16(a[j / 2]);
    acc[r] -= t;
  }
  const int total = P[pidx(PROC)];
  double q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = k0 + r;
    const int s = P[pidx(PROC - k)] + (total - P[pidx(k)]) - 2 * acc[r];
    q[r] = __ddiv_rn((double)s, (double)(PROC - k));
  }
#pragma unroll
  for (int r = 0; r < R; r += 2) reinterpret_cast<double2*>(out)[r / 2] = make_double2(q[r], q[r + 1]);
}

// Grid ceil(T / FRAMES), block FRAMES * ceil(G / 2) threads with G = (512 - lo) / R
// lag groups, SMEM bytes of dynamic shared memory.  Thread (f, p) = (threadIdx.x %
// FRAMES, threadIdx.x / FRAMES) sums groups p and G - 1 - p of frame f.
template <bool VEC>
__global__ void __launch_bounds__(FRAMES * 32, 2) amdf_kernel(const int16_t* __restrict__ x,
                                                              int T, int lo,
                                                              double* __restrict__ out) {
  extern __shared__ uint4 smem[];
  unsigned* uw = reinterpret_cast<unsigned*>(smem);  // FRAMES x WSTRIDE words
  int* P = reinterpret_cast<int*>(uw + FRAMES * WSTRIDE);  // FRAMES x PSTRIDE
  int* seg = P + FRAMES * PSTRIDE;                          // FRAMES x SEGS segment sums
  const int f0 = blockIdx.x * FRAMES;
  const int nf = min(FRAMES, T - f0);
  for (int e = threadIdx.x; e < FRAMES * (PROC / 8); e += blockDim.x) {
    const int f = e / (PROC / 8), c = e % (PROC / 8);
    const uint4 w = f < nf ? load8<VEC>(x + (size_t)(f0 + f) * PROC + 8 * c) : make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(uw + f * WSTRIDE)[c] = w;
  }
  if (threadIdx.x < FRAMES) {  // the 32767s the last chunk's b reads past the frame
    uint4* d = reinterpret_cast<uint4*>(uw + threadIdx.x * WSTRIDE + WORDS);
    d[0] = d[1] = make_uint4(PAD, PAD, PAD, PAD);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < FRAMES * SEGS; e += blockDim.x) {  // segment sums
    const unsigned* w = uw + (e / SEGS) * WSTRIDE + (e % SEGS) * (SEG / 2);
    int s = 0;
#pragma unroll
    for (int m = 0; m < SEG / 2; ++m) s = __dp2a_lo((int)w[m], 0x0101, s);
    seg[e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < FRAMES * SEGS; e += blockDim.x) {  // running sums
    const int f = e / SEGS, l = e % SEGS;
    const unsigned* w = uw + f * WSTRIDE + l * (SEG / 2);
    int* Pf = P + f * PSTRIDE;
    int run = 0;
    for (int i = 0; i < l; ++i) run += seg[f * SEGS + i];
    if (l == 0) Pf[pidx(0)] = 0;
#pragma unroll
    for (int m = 0; m < SEG / 2; ++m) {
      run += lo16(w[m]);
      Pf[pidx(SEG * l + 2 * m + 1)] = run;
      run += hi16(w[m]);
      Pf[pidx(SEG * l + 2 * m + 2)] = run;
    }
  }
  __syncthreads();
  const int f = threadIdx.x % FRAMES, p = threadIdx.x / FRAMES;
  if (f >= nf) return;
  const unsigned* uf = uw + f * WSTRIDE;
  const int* Pf = P + f * PSTRIDE;
  double* of = out + (size_t)(f0 + f) * (KEEP - lo);
  const int G = (KEEP - lo) / R;
  lag_group(uf, Pf, lo + R * p, of + R * p);
  const int p2 = G - 1 - p;
  if (p2 > p) lag_group(uf, Pf, lo + R * p2, of + R * p2);
}

template <bool VEC>
cudaError_t launch(const int16_t* x, int T, int lo, double* out, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(amdf_kernel<VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const int G = (KEEP - lo) / R;
  amdf_kernel<VEC><<<(T + FRAMES - 1) / FRAMES, FRAMES * ((G + 1) / 2), SMEM, st>>>(x, T, lo,
                                                                                   out);
  return cudaGetLastError();
}

}  // namespace

// K11.  x (T, 1024) int16, T >= 1; lo a multiple of 8 in [0, 512) (the
// wrapper checks); out (T, 512 - lo) f64.
extern "C" int jb_amdf(const int16_t* x, int T, int lo, double* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0) return (int)launch<true>(x, T, lo, out, st);
  return (int)launch<false>(x, T, lo, out, st);
}
