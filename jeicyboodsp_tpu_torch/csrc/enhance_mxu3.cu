// Engine mxu3 of the enhancement chain on Hopper (sm_90a): the f32 halves
// of the chain around the noise latch, as two entries.
//
// K4, jb_enhance_fwd, replaces jeicyboodsp_tpu/kernels/enhance_pallas.py:
// enhance_fwd_pallas (_fwd_kernel): int16 blocks -> re, im, |X| (T, 512)
// and ren, |ren|, speech flags (T,), in two passes:
//   1. rfft_fwd_kernel  per frame [x[t-1] | x[t]] (x[-1] = 0) the windowed
//                       real FFT of rfft1024.cuh: re, im and |X| of bins
//                       0..511 from its split
//   2. rowstat_kernel   per row: the Nyquist dot, |ren|, VAD flags and the
//                       frame flags of bin_gain's 0/0 rule (it reads only
//                       the blocks: re == nullptr)
// The TPU kernel computes the window-folded DFT as dense GEMMs ([prev, cur]
// @ WC, @ WS, K = 1024) because its matrix unit was the fast unit.  The same
// function as a real FFT is about 5.5e8 f32 flops at T = 16384 (0.008 ms at
// the 67 TFLOP/s f32 peak) against 121.8 MB of blocks in and planes out
// (0.036 ms at 3.35 TB/s), so bytes bound it.  What the design does about
// that: each frame is transformed in shared memory and only the blocks (each
// int16 row about once: a block's consecutive frames share their rows) and
// the three planes cross device memory.  The flags stay in rowstat_kernel,
// whose sums the plain version's flags are held against bit for bit.
//
// K5, jb_enhance_back_ola3, replaces enhance_back_ola3_pallas
// (_make_back_ola3_kernel): re, im, ren and the latched noise planes ->
// int16 (T, 512), in two passes:
//   1. x3_kernel<BackOp>  the gain on the way in, u = Yre @ UC512 +
//                     Yren*u_nyq and v = Yim @ VS512 on the tensor cores
//                     (3xTF32, tf32x3.cuh), head = u - v and w2 = u + v out,
//                     and the y512 column
//   2. ola_hw_kernel  flip as an index permutation, OLA with row t-1's
//                     tail (the TPU kernel's ctail carry), c_short, mask
// The TPU kernel returns f32 c_short values that its caller casts to int16
// and masks (ops/enhance.py:542-550); those values are exact integers, so
// writing int16 with the mask here gives the same result.
//
// K13, jb_enhance_back, replaces enhance_back_pallas (_make_back_kernel):
// the same inputs -> head = u - v, w2 = u + v (T, 512) and the y512 column
// (T,), with no OLA (its caller assembles it): K5's pass 1 alone.
//
// Bound of K5's and K13's pass 1 at T = 16384: the two 512 x 512 GEMMs are
// 8.59e9 MACs, 0.104 ms as 3xTF32 at the 495 TFLOP/s TF32 peak (0.052 ms
// as bf16x3 at 989); re, im, ns in and head, w2 out are 168 MB, 0.050 ms.
// So the pass is bound by the tensor cores.  What the design does about it:
// Y = (re, im) * gain is computed as the chunks land in shared memory and
// never goes to device memory; head and w2 come out of the GEMM's epilogue
// (no pass re-reads u and v); A's TF32 halves are made once a block, as
// the spectra land, B's once on the host (the back32 constant).

#include "enhance_common.cuh"
#include "rfft1024.cuh"
#include "tf32x3.cuh"

namespace {

// K4's frame source for rfft_frame: frame t is [x[t-1] | x[t]] of the int16
// blocks, x[-1] = 0
struct BlockFrame {
  const int16_t* x;
  long long t;
  __device__ void pair(int m, float& a, float& b) const {
    const bool prev = m < N / 2;
    if (prev && t == 0) {
      a = b = 0.0f;
      return;
    }
    const int16_t* p = x + (size_t)(prev ? t - 1 : t) * N + (2 * m - (prev ? 0 : N));
    // p is 4-byte aligned exactly when x is (2m even, rows 1 KB apart): the
    // same branch for every load; a view at an odd 2-byte offset reads scalars
    if (reinterpret_cast<uintptr_t>(x) & 3) {
      a = (float)p[0];
      b = (float)p[1];
      return;
    }
    const short2 v = *reinterpret_cast<const short2*>(p);
    a = (float)v.x;
    b = (float)v.y;
  }
};

// K4 pass 1, persistent: a block of RF_FPB warps keeps the constants (as
// rfft1024.cuh lays them out, with the f32 Hamming window) in shared
// memory, and each warp transforms frames f0, f0 + RF_FPB * grid, ...
static_assert(RF_SMEM <= 48 * 1024, "K4 launches without raising its shared-memory limit");
__global__ void __launch_bounds__(RF_THREADS, 3) rfft_fwd_kernel(
    const int16_t* __restrict__ x, int T, const float* __restrict__ consts,
    float* __restrict__ re, float* __restrict__ im, float* __restrict__ mag) {
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < RF_CONSTS; i += blockDim.x) smem[i] = consts[i];
  __syncthreads();
  const int slot = threadIdx.x / 32, t = threadIdx.x % 32;
  float* sr = smem + RF_CONSTS + 2 * slot * RF_PLANE;
  for (long long f = (long long)blockIdx.x * RF_FPB + slot; f < T;
       f += (long long)gridDim.x * RF_FPB) {
    float xr[RF_VPT], xi[RF_VPT];
    rfft_frame(BlockFrame{x, f}, smem, sr, sr + RF_PLANE, t, xr, xi);
#pragma unroll
    for (int q = 0; q < RF_VPT; ++q) {
      const size_t o = (size_t)f * N + t + 32 * q;
      re[o] = xr[q];
      im[o] = xi[q];
      mag[o] = sqrtf(xr[q] * xr[q] + xi[q] * xi[q]);
    }
    __syncwarp();  // the split's reads of the planes before the next frame writes them
  }
}

__global__ void __launch_bounds__(ROW_THREADS) rowstat_kernel(
    const int16_t* __restrict__ x, const float* __restrict__ nyq,
    const float* __restrict__ w2, const float* __restrict__ re,
    const float* __restrict__ im, float* __restrict__ ren,
    float* __restrict__ mag, float* __restrict__ magn, float* __restrict__ sp,
    float* __restrict__ nz) {
  rowstat_body(x, nyq, w2, re, im, ren, mag, magn, sp, nz);
}

// bin_gain's gk (its 0/0 rule with the frame flag nz included) with the
// division as div.full.f32 and the square root as sqrt.approx.f32: each
// within 2 ulp of the IEEE result, 0/0 NaN, x/0 infinite and sqrt(0) 0 as
// there, and without the IEEE forms' slow-path branches, which serialised
// the chunks' preparation
__device__ __forceinline__ float div_full(float x, float y) {
  float r;
  asm("div.full.f32 %0, %1, %2;\n" : "=f"(r) : "f"(x), "f"(y));
  return r;
}
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float bin_gain_full(float a, float b, float ns, int wiener,
                                               int nz) {
  if (wiener) {
    const float P = a * a + b * b;
    const float v = (nz && ns == 0.0f && P == 0.0f) ? 0.0f : div_full(ns * ns, P);
    return 1.0f - (v >= 1.0f ? 1.0f : v);
  }
  const float mag = sqrt_approx(a * a + b * b);
  return (nz && ns == 0.0f && mag == 0.0f) ? 1.0f : div_full(mag - ns, mag);
}

// The Nyquist bin's Y: ren * gn (bin_gain's gn; its other operands fold)
__device__ __forceinline__ float nyq_y(float rn, float nsn, int wiener, int nz) {
  float gk, gn;
  bin_gain(1.0f, 0.0f, rn, 0.0f, nsn, wiener, nz, &gk, &gn);
  return rn * gn;
}

// K5 and K13 pass 1: the x3_kernel policy (tf32x3.cuh).  Raw chunks: the
// re, im and ns rows; prepare turns them into the TF32 halves of Yre = re*g
// and Yim = im*g (g as bin_gain, but for the last 2 ulp of its division
// and square root; rows t >= T zero; the frame flags nz as K4 wrote them),
// and the blocks of column block 0,
// which see every k of their rows, sum y512 = Yre . ycol[:512] + Yren*ycol[512] on the way; the
// epilogue adds Yren*u_nyq to u and writes head = u - v, w2 = u + v.
struct BackOp {
  static constexpr int NP = 2, NA = 3, K = N, NCOLS = N, UNITS = 2;
  int T;
  CUtensorMap amap[NA];  // re, im, ns (T, 512)
  CUtensorMap bmap;      // back32: TF32 halves of UC512, VS512 transposed, (2048, 512) [s][k]
  const float *ren, *nsn, *nz, *u_nyq, *ycol;
  float* hw;    // (2, T, 512): head, then w2
  float* y512;  // (T,)
  int wiener;
  __device__ int frame_nz(int t) const { return nz[t] != 0.0f; }
  struct State {
    float y[2];  // y512 partial sums of this thread's two rows
  };

  // part j: unit u = tid % 4 of row tid / 4 + 64 j
  __device__ void prepare(State& s, unsigned char* st, int t0, int ck, int n0, int j) const {
    const int u = threadIdx.x & 3, r = (threadIdx.x >> 2) + 64 * j, t = t0 + r;
    unsigned char* pr = st + x3_off(r, u);
    const float4 a4 = *reinterpret_cast<const float4*>(pr);
    const float4 b4 = *reinterpret_cast<const float4*>(pr + X3_APLANE);
    const float4 n4 = *reinterpret_cast<const float4*>(pr + 2 * X3_APLANE);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
    const float n[4] = {n4.x, n4.y, n4.z, n4.w};
    float ya[4], yb[4];
    const int f = t < T && frame_nz(t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float gk = bin_gain_full(a[e], b[e], n[e], wiener, f);
      ya[e] = t < T ? a[e] * gk : 0.0f;
      yb[e] = t < T ? b[e] * gk : 0.0f;
    }
    // Yre's and Yim's TF32 halves: hi over re and im, lo over ns and the 4th plane
    float4 hi, lo;
    x3_split4(make_float4(ya[0], ya[1], ya[2], ya[3]), &hi, &lo);
    *reinterpret_cast<float4*>(pr) = hi;
    *reinterpret_cast<float4*>(pr + 2 * X3_APLANE) = lo;
    x3_split4(make_float4(yb[0], yb[1], yb[2], yb[3]), &hi, &lo);
    *reinterpret_cast<float4*>(pr + X3_APLANE) = hi;
    *reinterpret_cast<float4*>(pr + 3 * X3_APLANE) = lo;
    if (n0 != 0) return;  // y512: the blocks of column block 0 see every k of their rows
    const float4 c = *reinterpret_cast<const float4*>(ycol + ck * X3_KC + 4 * u);
    const float yc[4] = {c.x, c.y, c.z, c.w};
    float y = ck == 0 ? 0.0f : s.y[j];
#pragma unroll
    for (int e = 0; e < 4; ++e) y = y + ya[e] * yc[e];
    s.y[j] = y;
  }

  // after the tile's last chunk: each row's y512 from its four quarters (lanes 4i .. 4i + 3)
  __device__ void prepared(State& s, int t0, int ck, int n0) const {
    if (n0 != 0 || ck != K / X3_KC - 1) return;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = s.y[j];
      v = v + __shfl_xor_sync(0xffffffffu, v, 1);
      v = v + __shfl_xor_sync(0xffffffffu, v, 2);
      const int t = t0 + (threadIdx.x >> 2) + 64 * j;
      if ((threadIdx.x & 3) == 0 && t < T)
        y512[t] = v + nyq_y(ren[t], nsn[t], wiener, frame_nz(t)) * ycol[N];
    }
  }

  __device__ void epilogue(State&, const float (&acc)[2][64], int t0, int n0) const {
    const size_t pl = (size_t)T * N;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // this thread's two rows
      const int t = t0 + x3_row(2 * hr);
      if (t >= T) continue;
      const float yren = nyq_y(ren[t], nsn[t], wiener, frame_nz(t));
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int s = n0 + x3_col(j, 0);
        const float2 un = *reinterpret_cast<const float2*>(u_nyq + s);
        const float uu[2] = {acc[0][4 * j + 2 * hr] + yren * un.x,
                             acc[0][4 * j + 2 * hr + 1] + yren * un.y};
        const float vv[2] = {acc[1][4 * j + 2 * hr], acc[1][4 * j + 2 * hr + 1]};
        const size_t o = (size_t)t * N + s;
        *reinterpret_cast<float2*>(hw + o) = make_float2(uu[0] - vv[0], uu[1] - vv[1]);
        *reinterpret_cast<float2*>(hw + pl + o) = make_float2(uu[0] + vv[0], uu[1] + vv[1]);
      }
    }
  }
};

// K5 pass 2: ola_body (enhance_common.cuh) on head and w2 instead of u and
// v -- the same values, so the same output: out[t] = c_short(head[t] +
// tail[t-1]), tail[0] = y512, tail[j] = w2[512 - j] for j >= 1.  A block
// of N threads takes OLA_ROWS rows, so each thread has that many
// independent loads in flight.
constexpr int OLA_ROWS = 8;
__global__ void __launch_bounds__(N) ola_hw_kernel(const float* __restrict__ hw,
                                                   const float* __restrict__ y512,
                                                   int16_t* __restrict__ out, int T,
                                                   int emit_all) {
  const int j = threadIdx.x;
  const size_t pl = (size_t)T * N;
  float head[OLA_ROWS], tp[OLA_ROWS];
#pragma unroll
  for (int i = 0; i < OLA_ROWS; ++i) {
    const int t = blockIdx.x * OLA_ROWS + i;
    head[i] = t < T ? hw[(size_t)t * N + j] : 0.0f;
    tp[i] = 0.0f;
    if (t > 0 && t < T) tp[i] = j == 0 ? y512[t - 1] : hw[pl + (size_t)(t - 1) * N + (N - j)];
  }
#pragma unroll
  for (int i = 0; i < OLA_ROWS; ++i) {
    const int t = blockIdx.x * OLA_ROWS + i;
    if (t >= T) break;
    const float acc = head[i] + tp[i] * (t >= 2 ? 1.0f : 0.0f);
    int16_t o = c_short(acc * (t >= 1 ? 1.0f : 0.0f));
    if (!emit_all && t < 2) o = 0;  // warm-up rows are not part of the stream
    out[(size_t)t * N + j] = o;
  }
}

// K5's and K13's pass 1 on `st`: the policy with its TMA maps, then the launch
cudaError_t launch_back(const float* re, const float* im, const float* ren, const float* ns,
                        const float* nsn, const float* nz, int T, int wiener,
                        const float* back32, const float* u_nyq, const float* y512col,
                        float* hw, float* y512, cudaStream_t st) {
  BackOp op;
  op.T = T, op.ren = ren, op.nsn = nsn, op.nz = nz, op.u_nyq = u_nyq, op.ycol = y512col;
  op.hw = hw, op.y512 = y512, op.wiener = wiener;
  const float* planes[3] = {re, im, ns};
  for (int m = 0; m < 3; ++m) {
    const cudaError_t e = x3_map(&op.amap[m], planes[m], T, N);
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = x3_map(&op.bmap, back32, 4 * N, N);
  return e != cudaSuccess ? e : x3_launch(op, st);
}

}  // namespace

// K4.  rfft: (RF_CONSTS,) f32, rfft1024.cuh's constants with the Hamming
// window.  Outputs from the caller: re, im, mag (T, 512) f32; ren, magn, sp
// (T,) f32; nz (T,) f32, the frame flags.
extern "C" int jb_enhance_fwd(const int16_t* x, int T, const float* rfft, const float* nyq,
                              const float* w2, float* re, float* im, float* ren, float* mag,
                              float* magn, float* sp, float* nz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = rf_grid(rfft_fwd_kernel, RF_SMEM, (T + RF_FPB - 1) / RF_FPB);
  rfft_fwd_kernel<<<grid, RF_THREADS, RF_SMEM, st>>>(x, T, rfft, re, im, mag);
  rowstat_kernel<<<T, ROW_THREADS, 0, st>>>(x, nyq, w2, nullptr, nullptr, ren, mag, magn, sp,
                                            nz);
  return (int)cudaGetLastError();
}

// K5.  back32: (4, 512, 512) f32, the TF32 halves hi, lo of UC512, then of
// VS512, each transposed, [s][k].  nz (T,) f32: K4's frame flags.
// Scratch from the caller: hw (2, T, 512) f32, y512 (T,) f32; out (T, 512) int16.
extern "C" int jb_enhance_back_ola3(
    const float* re, const float* im, const float* ren, const float* ns,
    const float* nsn, const float* nz, int T, int wiener, int emit_all, const float* back32,
    const float* u_nyq, const float* y512col, float* hw, float* y512, int16_t* out,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      launch_back(re, im, ren, ns, nsn, nz, T, wiener, back32, u_nyq, y512col, hw, y512, st);
  if (e != cudaSuccess) return (int)e;
  ola_hw_kernel<<<(T + OLA_ROWS - 1) / OLA_ROWS, N, 0, st>>>(hw, y512, out, T, emit_all);
  return (int)cudaGetLastError();
}

// K13.  As K5's pass 1; outputs from the caller: hw (2, T, 512) f32 (head,
// then w2), y512 (T,) f32.
extern "C" int jb_enhance_back(const float* re, const float* im, const float* ren,
                               const float* ns, const float* nsn, const float* nz, int T,
                               int wiener, const float* back32, const float* u_nyq,
                               const float* y512col, float* hw, float* y512, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch_back(re, im, ren, ns, nsn, nz, T, wiener, back32, u_nyq, y512col, hw, y512,
                          st);
}
