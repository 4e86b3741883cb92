// An f32 GEMM tile on Hopper's tensor cores as 3xTF32: wgmma m64n128k8
// TF32 with a hi/lo split of each operand and three products per step,
// lo(a)*hi(b) + hi(a)*lo(b) + hi(a)*hi(b), which keeps about 2^-22 of each
// product where one TF32 product keeps 2^-11.
//
// x3_kernel<P> computes, for NP planes p at once, acc_p = A_p @ B_p over the
// rows t of a (BM x BN) tile, where the policy P supplies the left operands
// and consumes the sums:
//   P::bmap  a TMA map (x3_map) of the TF32 halves (x3_split, made once on
//            the host) of the NP right operands B_p transposed, stacked hi_0,
//            lo_0, hi_1, ...: (2 * NP * NCOLS) rows [column] of K floats [k].
// The left operands are not read from a plane in device memory: TMA brings
// the policy's NA raw planes (P::amap[m], (T, K) f32 each), and P::prepare
// turns each landed K chunk into the TF32 halves of the NP planes A_p in
// shared memory, so a kernel can compute its operand on the way in (K5/K13:
// the gain applied to the spectra).  The sums then go to P::epilogue in
// registers.
//
// The policy P (a struct passed by value to the kernel):
//   static constexpr int NP, NA, K, NCOLS, UNITS;  // planes, raw planes, depth,
//                                                  // columns, prepare's parts
//   int T;  CUtensorMap amap[NA], bmap;
//   struct State;  // per-thread state carried from chunk to chunk
//   __device__ void prepare(State&, unsigned char* st, int t0, int ck, int n0, int j) const;
//       part j < UNITS of this thread's share: raw plane m of chunk ck (rows
//       t0 .. t0 + BM - 1, rows >= T zero) lies at st + m * X3_APLANE, unit u
//       of row r at byte x3_off(r, u); A_p's hi half (x3_split) must end at
//       st + p * X3_APLANE, its lo half at st + (NP + p) * X3_APLANE, in the
//       same layout; called after the chunk landed
//   __device__ void prepared(State&, int t0, int ck, int n0) const;
//       after all parts; every thread of the block calls it
//   __device__ void epilogue(State&, const float (&acc)[NP][64], int t0, int n0) const;
//       acc[p][4 j + e] is row t0 + x3_row(e), column n0 + x3_col(j, e) of
//       plane p, for this thread
//
// Tile and pipeline.  A block of two warpgroups owns a BM x BN = 128 x 128
// tile of all NP planes; warpgroup w its rows 64 w .. 64 w + 63, one
// m64n128 wgmma tile a plane (NP x 64 f32 sums a thread).  A persistent
// block per SM (x3_launch) owns one column block and walks the row tiles
// rg, rg + groups, ...; the NCOLS / BN column blocks of a row tile run side
// by side, so their reads of the same raw rows hit L2.  K chunks of KC = 16
// arrive by TMA (one 2-D copy a plane, completion counted on the stage's
// mbarrier) in a ring of STAGES = 3 stages of 64 KB across tile bounds, one
// chunk ahead of the one being prepared; one block barrier a chunk.  TMA's
// 64-byte swizzle puts each 16-byte unit u of a 64-byte row r at unit u ^
// ((r >> 1) & 3) (x3_off), the layout wgmma reads by descriptor.  Both
// operands come as TF32 halves (cvt.rna): A split by the policy once a
// block, as it lands; B split once, on the host.  Chunk q + 1 is prepared
// while the wgmma of chunk q run: each plane's six wgmma (two k steps of
// three products) start from zero, and while they run the threads do that
// plane's share of the next chunk's preparation; then the chunk's sums
// join the running sums by one f32 add each.  The tensor cores' own f32
// accumulation truncates: all 192 MMAs of an output chained on one
// accumulator drifted to about the 1e-5 of the row max that K13 is held
// to on the H100, several times the error of the chunked sums.  (mma.sync
// with the same pipeline stayed slower than cuBLAS's f32 GEMM on the
// H100: its TF32 MMAs issue at a fraction of wgmma's rate and ran in
// series with the preparation; per-thread 16-byte cp.async copies left
// each chunk waiting on their latency, which TMA's one copy a plane does
// not.)
//
// Everything sits in an anonymous namespace, so each file that includes it
// compiles its own copy.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace {

constexpr int X3_BM = 128, X3_BN = 128, X3_KC = 16, X3_STAGES = 3;
constexpr int X3_THREADS = 256;                 // 8 warps: 2 (rows) x 4 (columns)
constexpr int X3_APLANE = X3_BM * X3_KC * 4;    // bytes of one f32 A plane of a chunk
constexpr int X3_BPLANE = X3_BN * X3_KC * 4;    // bytes of one B half of a chunk
static_assert(X3_BM == X3_BN, "one TMA box (KC x 128) for A and B");

// byte offset of 16-byte unit u (k 4u .. 4u + 3 of the chunk) of row r
__device__ __forceinline__ int x3_off(int r, int u) {
  return r * (4 * X3_KC) + 16 * (u ^ ((r >> 1) & 3));
}

// the tile row and column of a thread's sum 4 j + e of a plane: warpgroup
// threadIdx.x / 128 owns rows 64 wg .. 64 wg + 63, all BN columns
__device__ __forceinline__ int x3_row(int e) {
  return ((threadIdx.x >> 7) * 4 + ((threadIdx.x >> 5) & 3)) * 16 + ((threadIdx.x & 31) >> 2) +
         8 * (e >> 1);
}
__device__ __forceinline__ int x3_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

__device__ __forceinline__ unsigned x3_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned x3_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (|x| 2^-22 at most): hi = rna(x), lo = rna(x - hi) (x - hi is exact)
__device__ __forceinline__ void x3_split(float x, float* hi, float* lo) {
  *hi = __uint_as_float(x3_tf32(x));
  *lo = __uint_as_float(x3_tf32(x - *hi));
}
__device__ __forceinline__ void x3_split4(float4 x, float4* hi, float4* lo) {
  x3_split(x.x, &hi->x, &lo->x);
  x3_split(x.y, &hi->y, &lo->y);
  x3_split(x.z, &hi->z, &lo->z);
  x3_split(x.w, &hi->w, &lo->w);
}

// a shared-memory matrix descriptor of a 64-row group of K-major rows of
// 64 bytes with the 64-byte swizzle: 8-row core groups 512 bytes apart (the
// leading offset is not used in this layout); p on a 512-byte swizzle
// period, plus 32 bytes for the second k step of 8
__device__ __forceinline__ uint64_t x3_desc(const void* p) {
  return (uint64_t)((x3_smem(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

// d (64 f32 a thread) = A (64 x 8) @ B (8 x 128) [+ d if acc]: one wgmma
// of the warpgroup, operands from shared memory by descriptor
__device__ __forceinline__ void x3_wgmma(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// the stage's mbarrier: expect `bytes` more, then one arrival (this thread)
__device__ __forceinline__ void x3_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(x3_smem(bar)),
               "r"(bytes)
               : "memory");
}

// a (KC x 128) box of a 2-D f32 map at (k0, row0) -> dst, counted on bar
__device__ __forceinline__ void x3_tma(void* dst, const CUtensorMap* map, int k0, int row0,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(x3_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(x3_smem(bar))
      : "memory");
}

__device__ __forceinline__ void x3_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n}\n" ::"r"(x3_smem(bar)),
      "r"(parity)
      : "memory");
}

template <class P>
__host__ __device__ constexpr int x3_stage_bytes() { return 2 * P::NP * (X3_APLANE + X3_BPLANE); }
template <class P>
__host__ __device__ constexpr int x3_smem_bytes() { return X3_STAGES * x3_stage_bytes<P>() + 64; }

template <class P>
__global__ void __launch_bounds__(X3_THREADS, 1) x3_kernel(const __grid_constant__ P p) {
  constexpr int NP = P::NP, NCK = P::K / X3_KC, CB = P::NCOLS / X3_BN, KS = X3_KC / 8;
  constexpr int A_BYTES = 2 * NP * X3_APLANE, STAGE = x3_stage_bytes<P>();
  constexpr unsigned CHUNK_BYTES = P::NA * X3_APLANE + 2 * NP * X3_BPLANE;  // TMA's, a chunk
  static_assert(P::K % X3_KC == 0 && P::NCOLS % X3_BN == 0, "whole chunks and column blocks");
  static_assert(P::NA <= 2 * NP, "the raw planes fit the A region");
  // TMA's 64-byte swizzle repeats every 512 bytes: the ring starts on 1024
  extern __shared__ __align__(1024) unsigned char x3smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(x3smem + X3_STAGES * STAGE);  // one a stage
  const int cb = blockIdx.x % CB, rg = blockIdx.x / CB, n0 = cb * X3_BN;
  const int groups = gridDim.x / CB;
  const int tiles = (p.T + X3_BM - 1) / X3_BM;
  const int mine = rg < tiles ? (tiles - rg + groups - 1) / groups : 0;
  const int Q = mine * NCK;  // this block's chunks, tile after tile
  const int tid = threadIdx.x;
  typename P::State ps{};
  auto tile0 = [&](int q) { return (rg + (q / NCK) * groups) * X3_BM; };
  auto stage = [&](int q) { return x3smem + (q % X3_STAGES) * STAGE; };

  // thread 0 asks for chunk q: the raw A planes, then the hi and lo column
  // slices of each B_p
  auto fetch = [&](int q) {
    if (tid != 0 || q >= Q) return;
    unsigned char* st = stage(q);
    uint64_t* bar = bars + q % X3_STAGES;
    const int k0 = (q % NCK) * X3_KC, t0 = tile0(q);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the generic writes
    x3_expect(bar, CHUNK_BYTES);
#pragma unroll
    for (int m = 0; m < P::NA; ++m) x3_tma(st + m * X3_APLANE, &p.amap[m], k0, t0, bar);
#pragma unroll
    for (int m = 0; m < 2 * NP; ++m)
      x3_tma(st + A_BYTES + m * X3_BPLANE, &p.bmap, k0, m * P::NCOLS + n0, bar);
  };
  constexpr int PARTS = P::UNITS;  // the preparation's parts, split between the planes' wgmma
  auto prep = [&](int q, int i) { p.prepare(ps, stage(q), tile0(q), q % NCK, n0, i); };

  if (tid == 0) {
    for (int s = 0; s < X3_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(x3_smem(bars + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float acc[NP][64];
#pragma unroll
  for (int s = 0; s < X3_STAGES - 1; ++s) fetch(s);
  if (Q > 0) {
    x3_wait(bars, 0);
#pragma unroll
    for (int i = 0; i < PARTS; ++i) prep(0, i);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    p.prepared(ps, tile0(0), 0, n0);
  }
  const unsigned char* arow = x3smem + (tid >> 7) * 64 * 4 * X3_KC;  // this warpgroup's A rows
  float part[64] = {};  // a chunk's sums of one plane
  for (int q = 0; q < Q; ++q) {
    if (q + 1 < Q) x3_wait(bars + (q + 1) % X3_STAGES, ((q + 1) / X3_STAGES) & 1);
    __syncthreads();  // chunk q prepared by all; chunk q - 1's stage free
    fetch(q + X3_STAGES - 1);
    const bool next = q + 1 < Q;
    const int ck = q % NCK;
    if (ck == 0) {
#pragma unroll
      for (int pl = 0; pl < NP; ++pl)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[pl][e] = 0.0f;
    }
    const int so = (q % X3_STAGES) * STAGE;
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      const unsigned char* ah = arow + so + pl * X3_APLANE;
      const unsigned char* al = ah + NP * X3_APLANE;
      const unsigned char* bh = x3smem + so + A_BYTES + 2 * pl * X3_BPLANE;
      const unsigned char* bl = bh + X3_BPLANE;
      // the chunk's sums from zero, the small products first
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        x3_wgmma(part, x3_desc(al + 32 * kk), x3_desc(bh + 32 * kk), kk);
        x3_wgmma(part, x3_desc(ah + 32 * kk), x3_desc(bl + 32 * kk), 1);
        x3_wgmma(part, x3_desc(ah + 32 * kk), x3_desc(bh + 32 * kk), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // this plane's share of chunk q + 1's preparation, while the tensor cores run
      if (next) {
#pragma unroll
        for (int i = pl * PARTS / NP; i < (pl + 1) * PARTS / NP; ++i) prep(q + 1, i);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[pl][e] = acc[pl][e] + part[e];  // one IEEE add
    }
    if (next) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmma reads
      p.prepared(ps, tile0(q + 1), (q + 1) % NCK, n0);
    }
    if (ck == NCK - 1) p.epilogue(ps, acc, tile0(q), n0);
  }
}

// A TMA map of a row-major (rows, cols) f32 matrix, in boxes of KC columns
// x 128 rows with the 64-byte swizzle (x3_off's layout); rows past the end
// read as zero.  base: 16-byte aligned, cols a multiple of 4.
inline cudaError_t x3_map(CUtensorMap* map, const float* base, int rows, int cols) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {X3_KC, X3_BM}, step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch x3_kernel<P> on `st`: NCOLS / BN column blocks times as many row
// groups as fill the SMs with one block each (at most one group per row
// tile); returns the launch's error.
template <class P>
inline cudaError_t x3_launch(const P& p, cudaStream_t st) {
  constexpr int CB = P::NCOLS / X3_BN, SMEM = x3_smem_bytes<P>();
  cudaError_t e = cudaFuncSetAttribute(x3_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = (p.T + X3_BM - 1) / X3_BM;
  int groups = sms / CB;
  groups = groups < 1 ? 1 : groups > tiles ? tiles : groups;
  x3_kernel<P><<<groups * CB, X3_THREADS, SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
