// Engine mxu8 of the enhancement chain on Hopper (sm_90a): the two halves
// of the chain around the noise latch, as two entries.
//
// K2, jb_enhance_fwd_int8, replaces jeicyboodsp_tpu/kernels/
// enhance_pallas.py:enhance_fwd_int8_pallas (_fwd8_kernel): int16 blocks ->
// re, im, |X| (T, 512) and ren, |ren|, speech flags (T,), in two passes:
//   1. fwd8_kernel    the 16 int8 dots per bin on the tensor cores and |X|
//                     (K1's forward pass, enhance_common.cuh)
//   2. rowstat_kernel per row: the Nyquist dot, |ren|, VAD flags and the
//                     frame flags of bin_gain's 0/0 rule
// The TPU kernel's carried prev row (cprev) is a halo read of row t-1.
//
// K3, jb_enhance_back_ola8, replaces enhance_back_ola8_pallas
// (_make_back_ola8_kernel): re, im, ren and the latched noise planes ->
// int16 (T, 512), in three passes:
//   1. gain_quant_kernel  gain, two-level per-row int8 quantization, y512
//   2. inv8_kernel        the int8 inverse u, v on the tensor cores (K1's
//                         inverse pass, enhance_common.cuh)
//   3. ola_kernel         flip as an index permutation, OLA with row t-1's
//                         tail (the TPU kernel's ctail carry), c_short, the
//                         t < 2 mask
//
// Bound on this card at T = 16384: K2 does 16 int8 dots of (T, 512) x
// (512, 512), 6.9e10 MACs (0.069 ms at the int8 tensor-core peak), and
// moves ~117 MB; K3 (hq) 10 dots, 4.3e10 MACs (0.043 ms) against ~118 MB
// (0.035 ms).  Both run their dots as mma.sync s8 on the tensor cores.

#include "enhance_common.cuh"

namespace {

__global__ void __launch_bounds__(ROW_THREADS) rowstat_kernel(
    const int16_t* __restrict__ x, const float* __restrict__ nyq,
    const float* __restrict__ w2, const float* __restrict__ re,
    const float* __restrict__ im, float* __restrict__ ren,
    float* __restrict__ mag, float* __restrict__ magn, float* __restrict__ sp,
    float* __restrict__ nz) {
  rowstat_body(x, nyq, w2, re, im, ren, mag, magn, sp, nz);
}

// one block of N threads per row; the noise estimate comes in as planes,
// the frame flags as K2 wrote them
__global__ void __launch_bounds__(N) gain_quant_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ ren, const float* __restrict__ ns,
    const float* __restrict__ nsn, const float* __restrict__ nz,
    const float* __restrict__ y512col, int8_t* __restrict__ q8,
    float* __restrict__ rowsc, int T, int wiener, int hq) {
  const size_t i = (size_t)blockIdx.x * N + threadIdx.x;
  gain_quant_body(re[i], im[i], ren[blockIdx.x], ns[i], nsn[blockIdx.x],
                  nz[blockIdx.x] != 0.0f, y512col, q8, rowsc, T, wiener, hq);
}

__global__ void __launch_bounds__(N) ola_kernel(const float* __restrict__ uv,
                                                const float* __restrict__ rowsc,
                                                int16_t* __restrict__ out, int T,
                                                int emit_all) {
  ola_body(uv, rowsc, out, T, emit_all);
}

}  // namespace

// K2.  Outputs from the caller: re, im, mag (T, 512) f32; ren, magn, sp
// (T,) f32; nz (T,) f32, the frame flags.  T must be a multiple of 8.
// Returns cudaGetLastError().
extern "C" int jb_enhance_fwd_int8(const int16_t* x, int T, const int8_t* fwd8,
                                   const float* fscales, const float* fcrows,
                                   const float* nyq, const float* w2, float* re,
                                   float* im, float* ren, float* mag,
                                   float* magn, float* sp, float* nz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_fwd8(x, T, fwd8, fscales, fcrows, re, im, mag, st);
  if (e != cudaSuccess) return (int)e;
  rowstat_kernel<<<T, ROW_THREADS, 0, st>>>(x, nyq, w2, nullptr, nullptr, ren, mag, magn, sp,
                                            nz);
  return (int)cudaGetLastError();
}

// K3.  ns (T, 512) and nsn (T,) are the latched noise estimates, nz (T,)
// K2's frame flags.  Scratch
// from the caller: q8 (6, T, 512) int8, rowsc (T, 8) f32, uv (2, T, 512)
// f32; out (T, 512) int16.  T must be a multiple of 8.
extern "C" int jb_enhance_back_ola8(
    const float* re, const float* im, const float* ren, const float* ns,
    const float* nsn, const float* nz, int T, int wiener, int hq, int emit_all,
    const int8_t* back8, const float* bscales, const float* bcrows,
    const float* u_nyq, const float* y512col, int8_t* q8, float* rowsc,
    float* uv, int16_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gain_quant_kernel<<<T, N, 0, st>>>(re, im, ren, ns, nsn, nz, y512col, q8, rowsc, T,
                                     wiener, hq);
  const cudaError_t e = launch_inv8(q8, T, back8, bscales, bcrows, rowsc, u_nyq, uv, hq, st);
  if (e != cudaSuccess) return (int)e;
  ola_kernel<<<T, N, 0, st>>>(uv, rowsc, out, T, emit_all);
  return (int)cudaGetLastError();
}
