// The backward of the fused MoE expert block for Hopper (sm_90a): K6b
// (`dkt_moe_bwd_dx`) and K6c (`dkt_moe_bwd_dw1`). For each expert e and
// capacity row r, with tok = src_tok[e*C + r] (-1: no slot won the row,
// whose gathered rows are zeros):
//   K6b  gy     = g[tok] * row_gate[e*C + r]
//        rowdot = <h[e, r] @ w2[e] + b2[e], g[tok]>           (float32)
//        dz     = act'(x[tok] @ w1[e] + b1[e]) * dh,
//                 dh = row_gate[e*C + r] * (g[tok] @ w2[e]^T)
//        dxr    = dz @ w1[e]^T
//   K6c  dw1[e] = sum over r of x[tok]^T @ dz[e, r]           (float32)
// with float32 sums; dxr, dz and gy are written in the input dtype (bf16
// or float32), rowdot and dw1 in float32.
//
// Replaces the TPU kernels distkeras_tpu/ops/moe_kernels.py `_bwd_dx`
// (pl.pallas_call at :297, body `_bwd_dx_kernel` :225) and `_bwd_dw1`
// (pl.pallas_call at :353, body `_bwd_dw1_kernel` :310). As there, the
// combine's transpose is a gather by the inverted dispatch plan, and the
// pre-activation is recomputed rather than kept from the forward.
//
// Bound on this card: at the training shape (C = 2048 rows per expert,
// d 1024, H 2048) the operations: K6b's four products of 2*C*d*H each
// per expert, K6c's one, at the bf16 tensor-core peak (989 TFLOP/s).
//
// bf16 inputs (namespace tc): every product is `wgmma` (m64n128k16, or
// m64n64k16 in pass 3) with bf16 operands from shared memory in the
// 128-byte swizzle and float32 accumulators in registers. A block of 256
// threads (two warpgroups, 64 rows each) owns a 128 x 128 output tile
// (128 x 64 in pass 3, whose two accumulators must fit two blocks an SM)
// and runs `mainloop`: a ring of 3 (pass 3: 4) stages of 64-deep operand
// slices, each stage's completion an mbarrier (TMA) plus a
// `cp.async.wait_group` and one block barrier, the copies two stages
// ahead of the products. Contiguous operands (w1[e], w2[e], h[e], dz[e])
// come in by TMA from 3-d tensor maps built on the host (`tma_map`,
// passed as __grid_constant__ parameters); gathered token rows (x[tok],
// g[tok]) by 16-byte `cp.async` copies by row index into the same
// swizzled layout. A -1 row, a row past the end and the ragged tail of a
// width are zeros (TMA's out-of-bounds fill, cp.async's source size 0);
// an operand whose rows are not a multiple of 16 bytes comes in by
// cp.async, or element by element where its width is not a multiple of 8
// (the TMA choice is compiled in per kernel instantiation). No operand is
// copied transposed: dh's w2[e], dxr's w1[e] and K6c's gathered x are
// read through wgmma's transpose bit (MN-major slices). The row gate is
// applied in pass 3's epilogue, so dh's operand is the bf16 g row itself
// (the same sum; the plain version multiplies first). dxr is taken from
// the bf16 dz that pass 3 writes: no float32 dz round trip (the plain
// version keeps the float32 dz; at the training shape the two dxr are
// 3.7e-3 apart relative to its largest value). K6b runs as four
// launches: (1) per (row tile, d tile) y = h @ w2 + b2, gy and the tile's
// partial row dots (the row's four threads add their columns by shuffles
// in lane order); (2) the partials added in tile order; (3) per (row
// tile, 64 H columns) z and dh and dz; (4) dxr. A row tile whose rows
// are all -1 skips its products and writes exact zeros. K6c is one pass
// per (expert, d tile, H tile) with its float32 accumulator in
// registers for the whole K loop: a block first lists the 64-row depth
// chunks of its expert that hold a filled row and runs the K loop over
// those only (the plan fills a prefix, so the loop ends at the fill).
// The mainloop, its loaders and barriers, the epilogues' bf16 pair
// loads and stores and the host's tensor maps are moe_tc.cuh's, shared
// with K6a (moe_gemm.cu); the Hopper primitives under them (mbarriers,
// TMA, cp.async, the swizzled slice loader, the wgmma wrappers and
// descriptors) are sm90.cuh's, shared with the flash kernels.
//
// float32 inputs (namespace simt) keep the CUDA-core FMA passes: 64 x
// 64 tiles, float32 operands staged in shared memory, a 4 x 4
// accumulator a thread. TF32 tensor cores would break the float32
// gradient checks at 1e-4; bf16 is the training dtype.
//
// No float atomics: the same inputs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "moe_tc.cuh"

namespace {

// --- float32 inputs: FMAs on the CUDA cores -------------------------------
namespace simt {

constexpr int NT = 256;             // threads per block
constexpr int BM = 64;              // output tile rows
constexpr int BN = 64;              // output tile columns
constexpr int BK = 16;              // depth staged at a time
constexpr int TM = 4;               // rows per thread
constexpr int TN = 4;               // columns per thread
constexpr int SP = 68;              // staged row stride, 16-byte aligned

static_assert((BM / TM) * (BN / TN) == NT, "one thread per 4x4 sub-tile");

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// the derivative of the activation: 0 linear, 1 relu, 2 gelu (tanh
// form, jax.nn.gelu's default), 3 silu
__device__ __forceinline__ float act_grad(float z, int act) {
  switch (act) {
    case 1:
      return z > 0.f ? 1.f : 0.f;
    case 2: {
      const float c = 0.7978845608028654f;
      const float z2 = z * z;
      const float t = tanhf(c * (z + 0.044715f * z2 * z));
      return 0.5f * (1.f + t) +
             0.5f * z * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * z2);
    }
    case 3: {
      const float s = 1.f / (1.f + expf(-z));
      return s * (1.f + z * (1.f - s));
    }
    default:
      return 1.f;
  }
}

// --- operand loaders: each fills a [BK][SP] float32 slice of the tile ----

// A[m][k] = rows[m] >= 0 ? src[rows[m] * ld + k] * scale[m] : 0, rows and
// scales of the tile's BM rows held in shared memory (scale may be null);
// neighbouring threads read neighbouring k of one row
template <typename T>
struct RowsA {
  const T* src;
  const int* rows;
  const float* scale;
  int ld, K;
  __device__ __forceinline__ void load(float (*s)[SP], int k0) const {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int m = i / BK;
      const int k = i - m * BK;
      const int row = rows[m];
      float v = 0.f;
      if (row >= 0 && k0 + k < K) {
        v = to_f(src[(size_t)row * ld + k0 + k]);
        if (scale != nullptr) v *= scale[m];
      }
      s[k][m] = v;
    }
  }
};

// A[m][k] = tok[k] >= 0 ? src[tok[k] * ld + m0 + m] : 0 (the gathered
// rows transposed: m runs over their columns), tok in global memory;
// neighbouring threads read neighbouring columns of one row
template <typename T>
struct GatheredColsA {
  const T* src;
  const int* tok;
  int ld, M, K, m0;
  __device__ __forceinline__ void load(float (*s)[SP], int k0) const {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int k = i / BM;
      const int m = i - k * BM;
      float v = 0.f;
      if (k0 + k < K && m0 + m < M) {
        const int t = tok[k0 + k];
        if (t >= 0) v = to_f(src[(size_t)t * ld + m0 + m]);
      }
      s[k][m] = v;
    }
  }
};

// B[k][n] = src[k * ld + n0 + n]: a row-major [K, N] matrix
template <typename T>
struct RowMajorB {
  const T* src;
  int ld, K, N, n0;
  __device__ __forceinline__ void load(float (*s)[SP], int k0) const {
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int k = i / BN;
      const int n = i - k * BN;
      float v = 0.f;
      if (k0 + k < K && n0 + n < N)
        v = to_f(src[(size_t)(k0 + k) * ld + n0 + n]);
      s[k][n] = v;
    }
  }
};

// B[k][n] = src[(n0 + n) * ld + k]: a row-major [N, K] matrix read as its
// transpose
template <typename T>
struct TransposedB {
  const T* src;
  int ld, K, N, n0;
  __device__ __forceinline__ void load(float (*s)[SP], int k0) const {
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int n = i / BK;
      const int k = i - n * BK;
      float v = 0.f;
      if (k0 + k < K && n0 + n < N)
        v = to_f(src[(size_t)(n0 + n) * ld + k0 + k]);
      s[k][n] = v;
    }
  }
};

// acc += A[BM, K] @ B[K, BN]; the thread (ty, tx) owns rows ty*4.. and
// columns tx*4.. of the tile
template <typename LA, typename LB>
__device__ __forceinline__ void gemm_tile(float (&acc)[TM][TN], const LA& la,
                                          const LB& lb, int K,
                                          float (*as)[SP], float (*bs)[SP]) {
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  for (int k0 = 0; k0 < K; k0 += BK) {
    la.load(as, k0);
    lb.load(bs, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// the tile's token ids and row gates into shared memory; true when any
// row of the tile won a slot
__device__ __forceinline__ bool tile_rows(const int* src_tok,
                                          const float* row_gate, int e,
                                          int r0, int C, int* toks,
                                          float* gates) {
  const int tid = threadIdx.x;
  bool mine = false;
  if (tid < BM) {
    const int r = r0 + tid;
    const int t = r < C ? src_tok[(size_t)e * C + r] : -1;
    toks[tid] = t;
    if (gates != nullptr)
      gates[tid] = (r < C && row_gate != nullptr)
                       ? row_gate[(size_t)e * C + r] : 0.f;
    mine = t >= 0;
  }
  return __syncthreads_or(mine) != 0;
}

// pass 1, grid (ceil(d / BN), ceil(C / BM), E): gy, and per d tile the
// partial row dots <h @ w2[e] + b2[e], g> into part [d tiles, E*C]
template <typename T>
__global__ void __launch_bounds__(NT)
    rowdot_gy_kernel(const T* __restrict__ g, const int* __restrict__ src_tok,
                     const float* __restrict__ row_gate,
                     const T* __restrict__ w2, const T* __restrict__ b2,
                     const T* __restrict__ h, T* __restrict__ gy,
                     float* __restrict__ part, int d, int H, int E, int C) {
  __shared__ __align__(16) float as[BK][SP];
  __shared__ __align__(16) float bs[BK][SP];
  __shared__ int toks[BM];
  __shared__ int hrows[BM];
  __shared__ float gates[BM];
  __shared__ float red[BM][BN / TN];
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const bool any = tile_rows(src_tok, row_gate, e, r0, C, toks, gates);
  float acc[TM][TN];
  zero(acc);
  if (any) {
    if (threadIdx.x < BM)
      hrows[threadIdx.x] =
          toks[threadIdx.x] >= 0 ? e * C + r0 + threadIdx.x : -1;
    __syncthreads();
    gemm_tile(acc, RowsA<T>{h, hrows, nullptr, H, H},
              RowMajorB<T>{w2 + (size_t)e * H * d, d, H, d, n0}, H, as, bs);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = ty * TM + i;
    const int r = r0 + m;
    const int t = toks[m];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (r < C && n < d) {
        const float gv = t >= 0 ? to_f(g[(size_t)t * d + n]) : 0.f;
        dot += (acc[i][j] + to_f(b2[(size_t)e * d + n])) * gv;
        gy[((size_t)e * C + r) * d + n] = from_f<T>(gv * gates[m]);
      }
    }
    red[m][tx] = dot;
  }
  __syncthreads();
  if (threadIdx.x < BM && r0 + threadIdx.x < C) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < BN / TN; ++c) s += red[threadIdx.x][c];
    part[(size_t)blockIdx.x * E * C + (size_t)e * C + r0 + threadIdx.x] = s;
  }
}

// pass 2: the d tiles' partial row dots added in tile order
__global__ void rowdot_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ rowdot, int rows,
                                  int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += part[(size_t)t * rows + i];
  rowdot[i] = s;
}

// pass 3, grid (ceil(H / BN), ceil(C / BM), E): z = x @ w1[e] + b1[e] and
// dh = gy @ w2[e]^T (gy in float32, from g and the row gate), dz =
// act'(z) * dh
template <typename T>
__global__ void __launch_bounds__(NT)
    dz_kernel(const T* __restrict__ x, const T* __restrict__ g,
              const int* __restrict__ src_tok,
              const float* __restrict__ row_gate, const T* __restrict__ w1,
              const T* __restrict__ b1, const T* __restrict__ w2,
              T* __restrict__ dz, int d, int H, int C, int act) {
  __shared__ __align__(16) float as[BK][SP];
  __shared__ __align__(16) float bs[BK][SP];
  __shared__ int toks[BM];
  __shared__ float gates[BM];
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const bool any = tile_rows(src_tok, row_gate, e, r0, C, toks, gates);
  float accz[TM][TN], acch[TM][TN];
  zero(accz);
  zero(acch);
  if (any) {
    gemm_tile(accz, RowsA<T>{x, toks, nullptr, d, d},
              RowMajorB<T>{w1 + (size_t)e * d * H, H, d, H, n0}, d, as, bs);
    gemm_tile(acch, RowsA<T>{g, toks, gates, d, d},
              TransposedB<T>{w2 + (size_t)e * H * d, d, d, H, n0}, d, as,
              bs);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (r < C && n < H) {
        // a row no slot won has dh = 0, so its dz is an exact 0
        const float v =
            any ? act_grad(accz[i][j] + to_f(b1[(size_t)e * H + n]), act) *
                      acch[i][j]
                : 0.f;
        dz[((size_t)e * C + r) * H + n] = from_f<T>(v);
      }
    }
  }
}

// pass 4, grid (ceil(d / BN), ceil(C / BM), E): dxr = dz @ w1[e]^T
template <typename T>
__global__ void __launch_bounds__(NT)
    dxr_kernel(const T* __restrict__ dz, const int* __restrict__ src_tok,
               const T* __restrict__ w1, T* __restrict__ dxr, int d, int H,
               int C) {
  __shared__ __align__(16) float as[BK][SP];
  __shared__ __align__(16) float bs[BK][SP];
  __shared__ int toks[BM];
  __shared__ int rows[BM];
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const bool any = tile_rows(src_tok, nullptr, e, r0, C, toks, nullptr);
  float acc[TM][TN];
  zero(acc);
  if (any) {
    if (threadIdx.x < BM)
      rows[threadIdx.x] =
          toks[threadIdx.x] >= 0 ? e * C + r0 + threadIdx.x : -1;
    __syncthreads();
    gemm_tile(acc, RowsA<T>{dz, rows, nullptr, H, H},
              TransposedB<T>{w1 + (size_t)e * d * H, H, H, d, n0}, H, as,
              bs);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (r < C && n < d)
        dxr[((size_t)e * C + r) * d + n] = from_f<T>(acc[i][j]);
    }
  }
}

// K6c, grid (ceil(H / BN), ceil(d / BM), E): dw1[e] tile = sum over the
// C capacity rows of x[tok]^T @ dz[e]
template <typename T>
__global__ void __launch_bounds__(NT)
    dw1_kernel(const T* __restrict__ x, const T* __restrict__ dz,
               const int* __restrict__ src_tok, float* __restrict__ dw1,
               int d, int H, int C) {
  __shared__ __align__(16) float as[BK][SP];
  __shared__ __align__(16) float bs[BK][SP];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  float acc[TM][TN];
  zero(acc);
  gemm_tile(acc, GatheredColsA<T>{x, src_tok + (size_t)e * C, d, d, C, m0},
            RowMajorB<T>{dz + (size_t)e * C * H, H, C, H, n0}, C, as, bs);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (m < d && n < H) dw1[((size_t)e * d + m) * H + n] = acc[i][j];
    }
  }
}

}  // namespace simt

// --- bf16 inputs: wgmma on the tensor cores --------------------------------
namespace tc {

using namespace moe_tc;

constexpr int BN3 = 64;                       // pass 3's (two products)

// the depth chunks a block's list keeps (K6c: those with a filled row)
struct Listed {
  const int* chunks;
  __device__ __forceinline__ int operator()(int kt) const {
    return chunks[kt] * BK;
  }
};

// ring stages of passes 1 and 4 and of K6c (no product group left in
// flight), and of pass 3 (one group in flight); every kernel runs two
// blocks an SM
constexpr int RING2 = 3;
constexpr int RING3 = 4;

// pass 1, grid (ceil(d / BN), ceil(C / BM), E): y = h[e] @ w2[e] + b2[e],
// gy = g[tok] * row_gate, and per d tile the partial row dots <y, g[tok]>
// into part [d tiles, E*C]
template <bool TMA_H, bool TMA_W2>
__global__ void __launch_bounds__(NT, 2)
    rowdot_gy_kernel(const __grid_constant__ CUtensorMap mh,
                     const __grid_constant__ CUtensorMap mw2,
                     const bf16* __restrict__ g,
                     const int* __restrict__ src_tok,
                     const float* __restrict__ row_gate,
                     const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                     const bf16* __restrict__ h, bf16* __restrict__ gy,
                     float* __restrict__ part, int d, int H, int E, int C) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[RING2];
  const uint32_t ring = ring_base(smem);
  const uint32_t bars = init_bars<RING2>(bar_mem);
  uint32_t phase = 0;
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int* tok = src_tok + (size_t)e * C;
  float acc[64];
  zero(acc);
  if (tile_any(tok, r0, C))
    mainloop<RING2, 0, BN, false, true>(
        acc, ring, bars, phase,
        rows_of(h + (size_t)e * C * H, nullptr, H, C, TMA_H ? &mh : nullptr,
                e),
        rows_of(w2 + (size_t)e * H * d, nullptr, d, H,
                TMA_W2 ? &mw2 : nullptr, e),
        r0, n0, (H + BK - 1) / BK, Linear{});
  const bf16* bias = b2 + (size_t)e * d;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + acc_row(2 * half);
    const int t = r < C ? tok[r] : -1;
    const float gate = r < C ? row_gate[(size_t)e * C + r] : 0.f;
    float dot = 0.f;
    if (r < C) {
#pragma unroll
      for (int i = 2 * half; i < 64; i += 4) {
        // columns past d: acc, bias and g are zeros there
        const int n = n0 + acc_col(i);
        const float2 gv = t >= 0 ? load2(g + (size_t)t * d, n, d)
                                 : make_float2(0.f, 0.f);
        const float2 bv = load2(bias, n, d);
        dot += (acc[i] + bv.x) * gv.x;
        dot += (acc[i + 1] + bv.y) * gv.y;
        store2(gy + ((size_t)e * C + r) * d, n, d, gv.x * gate, gv.y * gate);
      }
    }
    // the row's four threads hold its 128 columns: add them in lane order
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    if ((threadIdx.x % 4) == 0 && r < C)
      part[(size_t)blockIdx.x * E * C + (size_t)e * C + r] = dot;
  }
}

// pass 3, grid (ceil(H / BN3), ceil(C / BM), E): z = x[tok] @ w1[e] +
// b1[e], dh = row_gate * (g[tok] @ w2[e]^T), dz = act'(z) * dh; the
// narrower tile keeps its two accumulators within two blocks an SM
template <bool TMA_W1, bool TMA_W2>
__global__ void __launch_bounds__(NT, 2)
    dz_kernel(const __grid_constant__ CUtensorMap mw1,
              const __grid_constant__ CUtensorMap mw2,
              const bf16* __restrict__ x,
              const bf16* __restrict__ g,
              const int* __restrict__ src_tok,
              const float* __restrict__ row_gate,
              const bf16* __restrict__ w1, const bf16* __restrict__ b1,
              const bf16* __restrict__ w2, bf16* __restrict__ dz, int d,
              int H, int C, int act) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[RING3];
  const uint32_t ring = ring_base(smem);
  const uint32_t bars = init_bars<RING3>(bar_mem);
  uint32_t phase = 0;
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN3;
  const int* tok = src_tok + (size_t)e * C;
  float accz[BN3 / 2], acch[BN3 / 2];
  zero(accz);
  zero(acch);
  const bool any = tile_any(tok, r0, C);
  if (any) {
    const int nk = (d + BK - 1) / BK;
    mainloop<RING3, 1, BN3, false, true>(
        accz, ring, bars, phase, rows_of(x, tok, d, C),
        rows_of(w1 + (size_t)e * d * H, nullptr, H, d,
                TMA_W1 ? &mw1 : nullptr, e),
        r0, n0, nk, Linear{});
    // w2[e] read through the transpose: its rows are dh's columns
    mainloop<RING3, 1, BN3, false, false>(
        acch, ring, bars, phase, rows_of(g, tok, d, C),
        rows_of(w2 + (size_t)e * H * d, nullptr, d, H,
                TMA_W2 ? &mw2 : nullptr, e),
        r0, n0, nk, Linear{});
  }
  const bf16* bias = b1 + (size_t)e * H;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + acc_row(2 * half);
    if (r >= C) continue;
    const float gate = row_gate[(size_t)e * C + r];
    bf16* out = dz + ((size_t)e * C + r) * H;
#pragma unroll
    for (int i = 2 * half; i < BN3 / 2; i += 4) {
      const int n = n0 + acc_col(i);
      const float2 bv = load2(bias, n, H);
      const float zb[2] = {accz[i] + bv.x, accz[i + 1] + bv.y};
      float v[2];
#pragma unroll
      for (int b = 0; b < 2; ++b)
        // a row no slot won has dh = 0, so its dz is an exact 0
        v[b] = any ? simt::act_grad(zb[b], act) * (gate * acch[i + b]) : 0.f;
      store2(out, n, H, v[0], v[1]);
    }
  }
}

// pass 4, grid (ceil(d / BN), ceil(C / BM), E): dxr = dz @ w1[e]^T from
// the bf16 dz pass 3 wrote, w1[e] read through the transpose
template <bool TMA_DZ, bool TMA_W1>
// with both operands copied by every thread (an H that is not a multiple
// of 8) the copy state does not fit 128 registers: one block an SM
__global__ void __launch_bounds__(NT, TMA_DZ || TMA_W1 ? 2 : 1)
    dxr_kernel(const __grid_constant__ CUtensorMap mdz,
               const __grid_constant__ CUtensorMap mw1,
               const bf16* __restrict__ dz,
               const int* __restrict__ src_tok,
               const bf16* __restrict__ w1, bf16* __restrict__ dxr, int d,
               int H, int C) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[RING2];
  const uint32_t ring = ring_base(smem);
  const uint32_t bars = init_bars<RING2>(bar_mem);
  uint32_t phase = 0;
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[64];
  zero(acc);
  if (tile_any(src_tok + (size_t)e * C, r0, C))
    mainloop<RING2, 0, BN, false, false>(
        acc, ring, bars, phase,
        rows_of(dz + (size_t)e * C * H, nullptr, H, C,
                TMA_DZ ? &mdz : nullptr, e),
        rows_of(w1 + (size_t)e * d * H, nullptr, H, d,
                TMA_W1 ? &mw1 : nullptr, e),
        r0, n0, (H + BK - 1) / BK, Linear{});
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + acc_row(2 * half);
    if (r >= C) continue;
    bf16* out = dxr + ((size_t)e * C + r) * d;
#pragma unroll
    for (int i = 2 * half; i < 64; i += 4)
      store2(out, n0 + acc_col(i), d, acc[i], acc[i + 1]);
  }
}

// K6c, grid (ceil(H / BN), ceil(d / BM), E): dw1[e] tile = x[tok]^T @
// dz[e] over the expert's depth chunks of BK capacity rows that hold a
// filled row (a chunk whose rows are all -1 adds nothing and is skipped)
template <bool TMA_DZ>
__global__ void __launch_bounds__(NT, 2)
    dw1_kernel(const __grid_constant__ CUtensorMap mdz,
               const bf16* __restrict__ x, const bf16* __restrict__ dz,
               const int* __restrict__ src_tok, float* __restrict__ dw1,
               int d, int H, int C) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[RING2];
  __shared__ int nk;
  const uint32_t ring = ring_base(smem);
  const uint32_t bars = init_bars<RING2>(bar_mem);
  uint32_t phase = 0;
  int* chunks = reinterpret_cast<int*>(smem + (ring - smem_u32(smem)) +
                                       RING2 * stage_bytes(BN));
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int* tok = src_tok + (size_t)e * C;
  const int nch = (C + BK - 1) / BK;
  const int lane = threadIdx.x % 32;
  for (int ch = threadIdx.x / 32; ch < nch; ch += NT / 32) {
    bool filled = false;
    for (int r = ch * BK + lane; r < min(C, ch * BK + BK); r += 32)
      filled |= tok[r] >= 0;
    filled = __any_sync(0xffffffffu, filled);
    if (lane == 0) chunks[ch] = filled ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int ch = 0; ch < nch; ++ch)
      if (chunks[ch]) chunks[n++] = ch;
    nk = n;
  }
  __syncthreads();
  float acc[64];
  zero(acc);
  // A = the gathered x rows [BK capacity rows][BM of d], read transposed;
  // B = dz[e] rows [BK][BN of H]
  mainloop<RING2, 0, BN, true, true>(
      acc, ring, bars, phase, rows_of(x, tok, d, C),
      rows_of(dz + (size_t)e * C * H, nullptr, H, C,
              TMA_DZ ? &mdz : nullptr, e),
      m0, n0, nk, Listed{chunks});
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int m = m0 + acc_row(i);
    const int n = n0 + acc_col(i);
    if (m >= d) continue;
    float* out = dw1 + ((size_t)e * d + m) * H;
    if (n + 1 < H && (H % 2) == 0) {
      *reinterpret_cast<float2*>(out + n) = make_float2(acc[i], acc[i + 1]);
    } else {
      if (n < H) out[n] = acc[i];
      if (n + 1 < H) out[n + 1] = acc[i + 1];
    }
  }
}

// the instantiation of a kernel for two TMA flags
template <typename K>
K* pick(bool a, bool b, K* tt, K* tf, K* ft, K* ff) {
  return a ? (b ? tt : tf) : (b ? ft : ff);
}

}  // namespace tc

bool grid_ok(long long x, long long y, long long z) {
  return x <= 2147483647LL && y <= 65535 && z <= 65535;
}

// float32 inputs: the CUDA-core passes
cudaError_t bwd_dx_f32(const float* x, const float* g, const int* src_tok,
                       const float* row_gate, const float* w1,
                       const float* b1, const float* w2, const float* b2,
                       const float* h, float* dxr, float* dz, float* gy,
                       float* rowdot, float* part, int d, int H, int E,
                       int C, int act, cudaStream_t st) {
  using namespace simt;
  const int rtiles = (C + BM - 1) / BM;
  const int dtiles = (d + BN - 1) / BN;
  const int htiles = (H + BN - 1) / BN;
  if (!grid_ok(dtiles, rtiles, E) || !grid_ok(htiles, rtiles, E))
    return cudaErrorInvalidConfiguration;
  rowdot_gy_kernel<float><<<dim3(dtiles, rtiles, E), NT, 0, st>>>(
      g, src_tok, row_gate, w2, b2, h, gy, part, d, H, E, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = E * C;
  rowdot_sum_kernel<<<(rows + 255) / 256, 256, 0, st>>>(part, rowdot, rows,
                                                        dtiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dz_kernel<float><<<dim3(htiles, rtiles, E), NT, 0, st>>>(
      x, g, src_tok, row_gate, w1, b1, w2, dz, d, H, C, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dxr_kernel<float><<<dim3(dtiles, rtiles, E), NT, 0, st>>>(
      dz, src_tok, w1, dxr, d, H, C);
  return cudaGetLastError();
}

// bf16 inputs: the tensor-core passes
cudaError_t bwd_dx_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                        const int* src_tok, const float* row_gate,
                        const __nv_bfloat16* w1, const __nv_bfloat16* b1,
                        const __nv_bfloat16* w2, const __nv_bfloat16* b2,
                        const __nv_bfloat16* h, __nv_bfloat16* dxr,
                        __nv_bfloat16* dz, __nv_bfloat16* gy, float* rowdot,
                        float* part, int d, int H, int E, int C, int act,
                        cudaStream_t st) {
  using namespace tc;
  const int rtiles = (C + BM - 1) / BM;
  const int dtiles = (d + BN - 1) / BN;
  const int htiles = (H + BN3 - 1) / BN3;
  if (!grid_ok(dtiles, rtiles, E) || !grid_ok(htiles, rtiles, E))
    return cudaErrorInvalidConfiguration;
  // boxes of [rows][64]: 128 rows for the K-major A and pass 4's w1, 64
  // (BK, or pass 3's 64-wide B) for the rest; w2's one map serves pass
  // 1 (MN-major) and pass 3 (K-major)
  CUtensorMap mh, mdz, mw1k, mw1n, mw2;
  int th, tdz, tw1k, tw1n, tw2;
  static_assert(BN3 == BK, "w2's one map");
  cudaError_t err = tma_map(&mh, &th, h, E, C, H, BM);
  if (err == cudaSuccess) err = tma_map(&mdz, &tdz, dz, E, C, H, BM);
  if (err == cudaSuccess) err = tma_map(&mw1k, &tw1k, w1, E, d, H, BN);
  if (err == cudaSuccess) err = tma_map(&mw1n, &tw1n, w1, E, d, H, BK);
  if (err == cudaSuccess) err = tma_map(&mw2, &tw2, w2, E, H, d, BK);
  const int smem = smem_bytes(RING2, BN);
  const int smem3 = smem_bytes(RING3, BN3);
  // the TMA paths are compiled in or out (a dead copy path costs
  // registers)
  auto* k1 = pick(th, tw2, rowdot_gy_kernel<true, true>,
                  rowdot_gy_kernel<true, false>,
                  rowdot_gy_kernel<false, true>,
                  rowdot_gy_kernel<false, false>);
  auto* k3 = pick(tw1n, tw2, dz_kernel<true, true>, dz_kernel<true, false>,
                  dz_kernel<false, true>, dz_kernel<false, false>);
  auto* k4 = pick(tdz, tw1k, dxr_kernel<true, true>, dxr_kernel<true, false>,
                  dxr_kernel<false, true>, dxr_kernel<false, false>);
  if (err == cudaSuccess) err = allow_smem(k1, smem);
  if (err == cudaSuccess) err = allow_smem(k3, smem3);
  if (err == cudaSuccess) err = allow_smem(k4, smem);
  if (err != cudaSuccess) return err;
  k1<<<dim3(dtiles, rtiles, E), NT, smem, st>>>(
      mh, mw2, g, src_tok, row_gate, w2, b2, h, gy, part, d, H, E, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = E * C;
  simt::rowdot_sum_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      part, rowdot, rows, dtiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k3<<<dim3(htiles, rtiles, E), NT, smem3, st>>>(
      mw1n, mw2, x, g, src_tok, row_gate, w1, b1, w2, dz, d, H, C, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k4<<<dim3(dtiles, rtiles, E), NT, smem, st>>>(mdz, mw1k, dz, src_tok, w1,
                                                dxr, d, H, C);
  return cudaGetLastError();
}

}  // namespace

// x, g [N, d]; src_tok [E*C] int32; row_gate [E*C] float32; w1 [E, d, H];
// b1 [E, H]; w2 [E, H, d]; b2 [E, d]; h [E, C, H] -> dxr [E, C, d], dz
// [E, C, H], gy [E, C, d] in x's dtype, rowdot [E*C] float32. Workspace
// part: float32 [ceil(d / 64), E*C] or more rows (the bf16 kernels'
// 128-wide d tiles fill ceil(d / 128) of them).
extern "C" int dkt_moe_bwd_dx(const void* x, const void* g,
                              const void* src_tok, const void* row_gate,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* h, void* dxr,
                              void* dz, void* gy, void* rowdot, void* part,
                              int x_bf16, int N, int d, int H, int E, int C,
                              int act, void* stream) {
  (void)N;
  if (act < 0 || act > 3 || d < 1 || H < 1 || E < 1 || C < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tok = static_cast<const int*>(src_tok);
  const float* rg = static_cast<const float*>(row_gate);
  float* rd = static_cast<float*>(rowdot);
  float* pt = static_cast<float*>(part);
  if (x_bf16) {
    using B = __nv_bfloat16;
    return bwd_dx_bf16(
        static_cast<const B*>(x), static_cast<const B*>(g), tok, rg,
        static_cast<const B*>(w1), static_cast<const B*>(b1),
        static_cast<const B*>(w2), static_cast<const B*>(b2),
        static_cast<const B*>(h), static_cast<B*>(dxr), static_cast<B*>(dz),
        static_cast<B*>(gy), rd, pt, d, H, E, C, act, st);
  }
  return bwd_dx_f32(
      static_cast<const float*>(x), static_cast<const float*>(g), tok, rg,
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(h), static_cast<float*>(dxr),
      static_cast<float*>(dz), static_cast<float*>(gy), rd, pt, d, H, E, C,
      act, st);
}

// x [N, d]; dz [E, C, H] in x's dtype; src_tok [E*C] int32 -> dw1
// [E, d, H] float32
extern "C" int dkt_moe_bwd_dw1(const void* x, const void* dz,
                               const void* src_tok, void* dw1, int x_bf16,
                               int N, int d, int H, int E, int C,
                               void* stream) {
  (void)N;
  if (d < 1 || H < 1 || E < 1 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tok = static_cast<const int*>(src_tok);
  float* out = static_cast<float*>(dw1);
  if (x_bf16) {
    using namespace tc;
    const int mtiles = (d + BM - 1) / BM;
    const int ntiles = (H + BN - 1) / BN;
    if (!grid_ok(ntiles, mtiles, E)) return cudaErrorInvalidConfiguration;
    const long long bytes =
        smem_bytes(RING2, BN) + 4LL * ((C + BK - 1) / BK);
    if (bytes > 232448) return cudaErrorInvalidValue;
    const bf16* dzp = static_cast<const bf16*>(dz);
    CUtensorMap mdz;
    int tdz;
    cudaError_t err = tma_map(&mdz, &tdz, dzp, E, C, H, BK);
    auto* k = tdz ? dw1_kernel<true> : dw1_kernel<false>;
    if (err == cudaSuccess) err = allow_smem(k, (int)bytes);
    if (err != cudaSuccess) return err;
    k<<<dim3(ntiles, mtiles, E), NT, (int)bytes, st>>>(
        mdz, static_cast<const bf16*>(x), dzp, tok, out, d, H, C);
    return cudaGetLastError();
  }
  using namespace simt;
  const int mtiles = (d + BM - 1) / BM;
  const int ntiles = (H + BN - 1) / BN;
  if (!grid_ok(ntiles, mtiles, E)) return cudaErrorInvalidConfiguration;
  dw1_kernel<float><<<dim3(ntiles, mtiles, E), NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dz), tok, out,
      d, H, C);
  return cudaGetLastError();
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
