// The tensor-core building blocks of the fused MoE kernels for Hopper
// (sm_90a), shared by moe_gemm.cu (K6a) and moe_bwd.cu (K6b, K6c): the
// tile constants, the operand and stage loaders, one stage's `wgmma`
// products, the multi-stage mainloop, the stages' barriers, the
// empty-tile test, the bf16 pair loads and stores of the epilogues and
// the host's 3-d tensor map. A block is WG consumer warpgroups (64 tile
// rows each, 128 * WG threads, WG = 2 unless a kernel says otherwise)
// that all issue the copies: no producer warp. The Hopper primitives
// under them (mbarriers, TMA, cp.async, the swizzled slice loader, the
// wgmma wrappers and descriptors) are sm90.cuh's.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace moe_tc {

using namespace sm90;

constexpr int NT = 256;                       // two consumer warpgroups
constexpr int BM = 128;                       // output tile rows
constexpr int BN = 128;                       // output tile columns
constexpr int BK = 64;                        // depth of one stage
constexpr int SLICE = BM * BK * 2;            // A's slice of a stage, bytes
// a stage: A's slice (64 rows a warpgroup), then B's [BK x n]
__host__ __device__ constexpr int stage_bytes(int n, int wg = 2) {
  return 64 * wg * BK * 2 + n * BK * 2;
}
// a ring of s stages, with the slack to align it to 1024 bytes
__host__ __device__ constexpr int smem_bytes(int s, int n, int wg = 2) {
  return s * stage_bytes(n, wg) + 1024;
}

static_assert(BM == 128 && BK == 64, "the slice layouts");
static_assert(stage_bytes(BN) == SLICE + BN * BK * 2, "a stage");

// one operand's slice of a stage, WD wide: K-major [WD rows mn0..][BK
// k0..], or MN-major [BK rows k0..][WD columns mn0..] as WD / 64 chunks
// of [BK][64]; by TMA (thread 0 issues, completing on bar; a K-major map's
// box is [WD][64], an MN-major one's [BK][64]) or by every thread's
// cp.async (NTH threads a block)
template <bool MN, int WD, int NTH = NT>
__device__ __forceinline__ void load_operand(uint32_t dst, const Rows& o,
                                             int mn0, int k0, uint32_t bar) {
  if (o.map != nullptr) {
    if (threadIdx.x == 0) {
      if (MN) {
#pragma unroll
        for (int j = 0; j < WD / 64; ++j)
          tma_load(dst + j * (BK * 128), o.map, bar, mn0 + 64 * j, k0, o.e);
      } else {
        tma_load(dst, o.map, bar, k0, mn0, o.e);
      }
    }
  } else if (MN) {
    load_slice<BK, WD, NTH>(dst, o, k0, mn0);
  } else {
    load_slice<WD, BK, NTH>(dst, o, mn0, k0);
  }
}

// one stage: A's slice then B's; thread 0 first tells the stage's barrier
// how many bytes its TMA copies bring
template <int N, bool AMN, bool BMN, int WG = 2>
__device__ __forceinline__ void load_stage(uint32_t st, uint32_t bar,
                                           const Rows& a, const Rows& b,
                                           int m0, int n0, int k0) {
  constexpr int A = 64 * WG * BK * 2;
  const uint32_t bytes = (a.map != nullptr ? A : 0) +
                         (b.map != nullptr ? N * BK * 2 : 0);
  if (bytes != 0 && threadIdx.x == 0) bar_expect(bar, bytes);
  load_operand<AMN, 64 * WG, 128 * WG>(st, a, m0, k0, bar);
  load_operand<BMN, N, 128 * WG>(st + A, b, n0, k0, bar);
}

// the warpgroup's 64 rows of the tile: acc += A @ B over one stage
template <int N, bool AMN, bool BMN, int WG = 2>
__device__ __forceinline__ void mma_stage(float (&acc)[N / 2], uint32_t st,
                                          int wg) {
  constexpr int A = 64 * WG * BK * 2;
#pragma unroll
  for (int k = 0; k < BK / 16; ++k) {
    // MN-major: 16 k rows of 128 bytes further; the warpgroup's 64 m are
    // chunk wg. K-major: 32 bytes further; its rows start 64 rows down.
    const uint64_t da =
        AMN ? desc(st + wg * (BK * 128) + k * 2048, BK * 128, 1024)
            : desc(st + wg * (64 * 128) + k * 32, 16, 1024);
    const uint64_t db = BMN ? desc(st + A + k * 2048, BK * 128, 1024)
                            : desc(st + A + k * 32, 16, 1024);
    wgmma<AMN ? 1 : 0, BMN ? 1 : 0>(acc, da, db);
  }
}

// acc += A[tile rows m0.., k] @ B[k, tile columns n0..] over the depth
// chunks k_of(0) .. k_of(nk - 1), through a ring of S stages at ring
// (barriers at bars, their parities in phase): copies run S - 1 - W
// stages ahead and W groups of products stay in flight while the next
// stage's copies are issued; each warpgroup multiplies its 64 rows
template <int S, int W, int N, bool AMN, bool BMN, typename KOf, int WG = 2>
__device__ __forceinline__ void mainloop(float (&acc)[N / 2], uint32_t ring,
                                         uint32_t bars, uint32_t& phase,
                                         const Rows& a, const Rows& b,
                                         int m0, int n0, int nk, KOf k_of) {
  constexpr int D = S - 1 - W;
  constexpr int STAGE = stage_bytes(N, WG);
  static_assert(D >= 1, "a stage to copy into");
  const int wg = threadIdx.x / 128;
  const bool tma = a.map != nullptr || b.map != nullptr;
#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < nk) load_stage<N, AMN, BMN, WG>(ring + s * STAGE, bars + 8 * s,
                                            a, b, m0, n0, k_of(s));
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    cp_async_wait<D - 1>();
    fence_proxy_async();
    if (tma) {
      bar_wait(bars + 8 * s, (phase >> s) & 1u);
      phase ^= 1u << s;
    }
    // stage kt landed; the stage copied next was read by products that
    // every warpgroup has waited for
    __syncthreads();
    const int nx = kt + D;
    if (nx < nk) load_stage<N, AMN, BMN, WG>(ring + (nx % S) * STAGE,
                                             bars + 8 * (nx % S), a, b, m0,
                                             n0, k_of(nx));
    cp_async_commit();
    fence_acc(acc);
    wgmma_fence();
    mma_stage<N, AMN, BMN, WG>(acc, ring + s * STAGE, wg);
    wgmma_commit();
    wgmma_wait<W>();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next product
}

// the stages' barriers, one arrival (thread 0's) each
template <int S>
__device__ __forceinline__ uint32_t init_bars(uint64_t* mem) {
  const uint32_t bars = smem_u32(mem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) bar_init(bars + 8 * s);
    bar_init_fence();
  }
  __syncthreads();
  return bars;
}

struct Linear {
  __device__ __forceinline__ int operator()(int kt) const { return kt * BK; }
};

// true when any of the tile's `rows` capacity rows won a slot
__device__ __forceinline__ bool tile_any(const int* tok, int r0, int C,
                                         int rows = BM) {
  const int r = r0 + threadIdx.x;
  const bool mine = threadIdx.x < rows && r < C && tok[r] >= 0;
  return __syncthreads_or(mine) != 0;
}

// two neighbouring bf16 inputs (n, n + 1) of one row as float32, zeros
// past N
__device__ __forceinline__ float2 load2(const bf16* row, int n, int N) {
  if (n + 1 < N && (N % 2) == 0)
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + n));
  return make_float2(n < N ? __bfloat162float(row[n]) : 0.f,
                     n + 1 < N ? __bfloat162float(row[n + 1]) : 0.f);
}

// two neighbouring bf16 outputs (n, n + 1) of one row, where they exist
__device__ __forceinline__ void store2(bf16* row, int n, int N, float a,
                                       float b) {
  if (n + 1 < N && (N % 2) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(a, b);
  } else {
    if (n < N) row[n] = __float2bfloat16(a);
    if (n + 1 < N) row[n + 1] = __float2bfloat16(b);
  }
}

template <typename K>
cudaError_t allow_smem(K* kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// a TMA map of a bf16 [E, rows, cols] tensor in [box_rows][64] boxes in
// the 128-byte swizzle. *use is 0 where TMA cannot take the tensor (rows
// not a multiple of 16 bytes, or an unaligned base): the kernel then
// copies it with cp.async.
inline cudaError_t tma_map(CUtensorMap* map, int* use, const bf16* base,
                           int E, int rows, int cols, int box_rows) {
  memset(map, 0, sizeof(*map));
  *use = (cols % 8) == 0 && (reinterpret_cast<uintptr_t>(base) % 16) == 0;
  if (!*use) return cudaSuccess;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace moe_tc
