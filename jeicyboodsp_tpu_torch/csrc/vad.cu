// K14, jb_vad_flags: the VAD of WienerFilter_final.cpp:261-296 on Hopper
// (sm_90a), one read of the int16 blocks.  Replaces jeicyboodsp_tpu/kernels/
// enhance_pallas.py: vad_flags_pallas (_vad_kernel, _vad_rows): per row,
// s = c_short(x * w2) (the reference's int16 window truncation), energy =
// sum(s^2) / 1024 > 700, ZCR = #{s[i] * x[i+1] < 0} (the last sample pairs
// with 0) < 200; speech when either holds.
//
// A warp takes a row at a time: lane l holds samples [8l, 8l + 8) and [256 +
// 8l, 264 + 8l), two 16-byte loads, so a warp reads its row's 1 KB in two
// coalesced requests; the neighbour of each chunk's last sample comes from
// the next lane by a shuffle.  The energy is summed as an integer in 64 bits
// (s^2 reaches 2^30, 512 of them 2^39) and the crossings as integers, so
// the flags do not depend on the order of the sums: they equal the f32
// plain version's, whose partial sums are exact below 2^24 and, once they
// pass it, far above the threshold 716800 = 700 * 1024.
//
// Bound on this card at T = 16384: 16.8 MB of int16 in and 16 KB of flags
// out, 0.005 ms at 3.35 TB/s; a row costs 512 float multiplies and
// conversions, far below the card's rates.  So the kernel is bound by its
// bytes and by how many of them are in flight.  Its design:
// - a grid-stride loop over rows: VAD_BLOCKS_PER_SM blocks of VAD_WARPS
//   warps per SM, one wave, and warp w takes rows w, w + W, ... (W warps);
// - each lane reads its 16 window values once, as four 16-byte loads, and
//   keeps them in registers for all its rows;
// - a warp starts the next row's two 16-byte loads before it reduces the
//   current row, so two rows per warp are in flight.
// Rows are 1 KB apart, so they are all 16-byte aligned when the first is;
// a tensor that starts elsewhere (a view at an odd offset) gets the variant
// that reads the same samples, and the window, as scalars.

#include "enhance_common.cuh"

namespace {

constexpr int VAD_WARPS = 8;          // warps per block of 256 threads
constexpr int VAD_BLOCKS_PER_SM = 4;  // blocks per SM: 32 warps, at most 64 registers a thread
constexpr long long ENERGY_LIMIT = 700LL * 1024;

// the 8 int16 samples p[0..8), in order: one 16-byte load when VEC (p
// 16-byte aligned), else eight 2-byte loads
template <bool VEC>
__device__ __forceinline__ void load8(const int16_t* p, int (&v)[8]) {
  if (VEC) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = (int)(int16_t)(u[i] & 0xffffu);
      v[2 * i + 1] = (int)(int16_t)(u[i] >> 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = p[i];
  }
}

// the 8 floats p[0..8): two 16-byte loads when VEC, else eight 4-byte loads
template <bool VEC>
__device__ __forceinline__ void load8f(const float* p, float (&v)[8]) {
  if (VEC) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = p[i];
  }
}

// lane's two 8-sample chunks of row t
template <bool VEC>
__device__ __forceinline__ void load_row(const int16_t* x, int t, int lane, int (&v)[2][8]) {
  const int16_t* row = x + (size_t)t * N;
  load8<VEC>(row + 8 * lane, v[0]);
  load8<VEC>(row + 256 + 8 * lane, v[1]);
}

template <bool VEC>
__global__ void __launch_bounds__(32 * VAD_WARPS, VAD_BLOCKS_PER_SM)
    vad_kernel(const int16_t* __restrict__ x, const float* __restrict__ w2, int T,
               uint8_t* __restrict__ flags) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * VAD_WARPS;
  int t = blockIdx.x * VAD_WARPS + (threadIdx.x >> 5);  // the warp's row
  if (t >= T) return;  // the whole warp
  float w[2][8];
  load8f<VEC>(w2 + 8 * lane, w[0]);
  load8f<VEC>(w2 + 256 + 8 * lane, w[1]);
  int v[2][8];
  load_row<VEC>(x, t, lane, v);
  const unsigned all = 0xffffffffu;
  for (; t < T; t += stride) {
    int nv[2][8];
    if (t + stride < T) load_row<VEC>(x, t + stride, lane, nv);  // in flight while v reduces
    // the sample after each chunk: the next lane's first one; after lane 31's
    // first chunk sample 256 (lane 0's second chunk), after its second none
    const int down0 = __shfl_down_sync(all, v[0][0], 1);
    const int down1 = __shfl_down_sync(all, v[1][0], 1);
    const int first1 = __shfl_sync(all, v[1][0], 0);
    const int after[2] = {lane < 31 ? down0 : first1, lane < 31 ? down1 : 0};
    long long e = 0;
    int z = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = c_short((float)v[h][i] * w[h][i]);
        const int nx = i < 7 ? v[h][i + 1] : after[h];
        e += (long long)(s * s);  // |s| <= 32768: s*s fits an int
        z += s * nx < 0 ? 1 : 0;  // so does s*nx
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      e += __shfl_xor_sync(all, e, o);
      z += __shfl_xor_sync(all, z, o);
    }
    if (lane == 0) flags[t] = (e > ENERGY_LIMIT || z < 200) ? 1 : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i) v[h][i] = nv[h][i];
  }
}

}  // namespace

// x: (T, 512) int16, contiguous, T >= 1; w2: (512,) f32 window half; flags:
// (T,) bytes 0/1 (a torch.bool tensor).
extern "C" int jb_vad_flags(const int16_t* x, const float* w2, int T, uint8_t* flags,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static int sm_count[64];  // per device, read once: a call's host time is most of its time
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  int sms = sm_count[dev];
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sm_count[dev] = sms;
  }
  const int rows = (T + VAD_WARPS - 1) / VAD_WARPS;  // blocks that give every warp a row
  const int grid = rows < sms * VAD_BLOCKS_PER_SM ? rows : sms * VAD_BLOCKS_PER_SM;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w2)) % 16 == 0)
    vad_kernel<true><<<grid, 32 * VAD_WARPS, 0, st>>>(x, w2, T, flags);
  else
    vad_kernel<false><<<grid, 32 * VAD_WARPS, 0, st>>>(x, w2, T, flags);
  return (int)cudaGetLastError();
}
