// Weight-only quantized matmul (K5) for Hopper (sm_90a): out[M, N] =
// (x[M, K] @ q[K, N]) * scale[N] in float32, with int8 weights or with
// int4 weights nibble-packed along K.
//
// Replaces the TPU kernel distkeras_tpu/ops/quant_matmul.py
// `quant_matmul` (pl.pallas_call at :282, body `_kernel` :212): products
// summed in float32 and the per-column scale applied once after the K sum.
// The packed variant takes a [K/2, N] byte matrix whose byte row r holds
// logical row r in its low nibble and row r + K/2 in its high nibble; the
// projection layout and the output-projection layout ([h, e, d] seen as
// [h*e, d]) are the same 2-D byte matrix, so one kernel serves both.
//
// Bound on this card: at decode shapes (M <= 72) the weight bytes, K*N
// (K*N/2 packed), at 3.35 TB/s; 2*M*K*N operations stay below the card's
// operations-per-byte balance.
//
// Design:
//   * a block owns 128 output columns, one tile of activation rows and a
//     chunk of the weight's byte rows (the K split, grid y). It streams
//     its weight rows (and the matching activation columns) through a
//     ring of STAGES shared-memory stages filled with 16-byte cp.async,
//     up to 36 KB of weight in flight a block; the split plan
//     (ops/quant_matmul.py `split_plan`) sizes the grid from the shapes
//     and the SM count;
//   * no I2F: the bytes become floats by the byte-permute of dequant.cuh
//     (modelled for every int8 and int4 value in
//     tests/test_torch_conversion.py);
//   * route 0 (float32 activations, and bf16 at small M): CUDA-core FMAs,
//     a thread owning 8 columns of 4 rows a stage for every row of its
//     activation tile (1, 2, 4 or 8 rows; grid z walks the rest);
//   * route 1 (bf16 activations at larger M): mma.sync.m16n8k16 bf16 ->
//     float32 on the dequantized tile (the integers are exact in bf16, so
//     the products are exact and only the order of the sum differs). A
//     warp owns 32 columns and every 16-row tile of up to 80 rows for half
//     of each stage's k; a thread's B fragment for its four 8-column tiles
//     comes from one 32-bit load per byte row (column 4g + i of the warp's
//     32 is n-index g of tile i), and int4 takes k in the order (8 low
//     nibbles, 8 high nibbles) of 8 byte rows, the activations staged in
//     the same order;
//   * one launch: the K splits of a column tile form one thread-block
//     cluster (at most 8, grid y). Each block leaves its unscaled partial
//     tile in its own shared memory; after a cluster barrier block r adds
//     slice r of the tile over the cluster's blocks in split order
//     (distributed shared memory), scales it and writes it out. The same
//     inputs give the same bits, with no float atomics and no workspace:
//     a per-tile counter and float32 partials in device memory took 3.3
//     of a 5.9 us w1 M4 launch (PERF.md);
//   * ragged N, or a weight or activation off a 16-byte boundary, fills
//     the same ring with plain loads (VEC false).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"
#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::smem_u32;

constexpr int NT = 256;
constexpr int BN = 128;              // output columns a block owns
constexpr int WROW = BN + 16;        // shared bytes per staged weight row
constexpr int STAGES = 4;
constexpr int MAX_SPLIT = 8;         // K splits: one portable cluster
constexpr int SR = 64;               // byte rows a route-0 stage holds
constexpr int KS = 64;               // logical k a route-1 stage holds
constexpr int XST = KS + 8;          // route 1: bf16 per staged x row
constexpr int COLS = 8;              // route 0: columns a thread owns
constexpr int TPR = BN / COLS;       // route 0: threads per weight row
constexpr int RL = NT / TPR;         // route 0: row lanes

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// weight byte rows [row0, row0 + rows) x the block's 128 columns into a
// stage of `rows` rows WROW bytes apart; rows at or past r_end and
// columns past N are zeros
template <bool VEC>
__device__ __forceinline__ void issue_w(uint8_t* dst, const int8_t* q,
                                        int row0, int rows, int r_end,
                                        int n0, int N, int tid) {
  constexpr int PIECES = BN / 16;
  for (int i = tid; i < rows * PIECES; i += NT) {
    const int rr = i / PIECES, c = (i % PIECES) * 16;
    const int r = row0 + rr, n = n0 + c;
    uint8_t* d = dst + rr * WROW + c;
    if (VEC) {
      const bool ok = r < r_end && n < N;
      cp_async16(smem_u32(d), ok ? q + (size_t)r * N + n : q, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        d[e] = (r < r_end && n + e < N)
                   ? static_cast<uint8_t>(q[(size_t)r * N + n + e])
                   : 0;
    }
  }
}

// one 16-byte piece (16 / sizeof(XT) elements) of activation row m from
// element k0 on, zeros past M or past k_end (k_end on a piece boundary
// when VEC)
template <bool VEC, typename XT>
__device__ __forceinline__ void issue_x(XT* d, const XT* x, int m, int M,
                                        int K, int k0, int k_end) {
  constexpr int E = 16 / sizeof(XT);
  if (VEC) {
    const bool ok = m < M && k0 < k_end;
    cp_async16(smem_u32(d), ok ? x + (size_t)m * K + k0 : x, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      d[e] = (m < M && k0 + e < k_end) ? x[(size_t)m * K + k0 + e]
                                       : XT(0.f);
  }
}

// the ring: stages issued STAGES - 1 ahead of the one being computed
template <typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int nst, Issue issue,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nst) issue(s + STAGES - 1);
    cp_async_commit();
    compute(s % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// the block's [rows][BN] result tile, in shared memory, to the output:
// scaled when K is not split; else the split's partial, added over the
// cluster's blocks (the K splits of this column tile) in split order, each
// block a slice of the tile
__device__ __forceinline__ void finish(float* tile, int m0, int rows, int M,
                                       int N, const float* scale,
                                       float* out) {
  const int n0 = blockIdx.x * BN;
  const int ks = gridDim.y;
  if (ks == 1) {
    for (int i = threadIdx.x; i < rows * BN; i += NT) {
      const int m = m0 + i / BN, n = n0 + i % BN;
      if (m < M && n < N) out[(size_t)m * N + n] = tile[i] * scale[n];
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (rows * BN + ks - 1) / ks;
  const int r = cluster.block_rank();
  const int end = min(rows * BN, (r + 1) * per);
  for (int i = r * per + threadIdx.x; i < end; i += NT) {
    float v[MAX_SPLIT];
#pragma unroll
    for (int y = 0; y < MAX_SPLIT; ++y)
      v[y] = y < ks ? cluster.map_shared_rank(tile, y)[i] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int y = 1; y < MAX_SPLIT; ++y)
      if (y < ks) sum += v[y];
    const int m = m0 + i / BN, n = n0 + i % BN;
    if (m < M && n < N) out[(size_t)m * N + n] = sum * scale[n];
  }
  cluster.sync();   // no block leaves while its tile is read
}

// eight weight values (two words) as floats: int8, or the low (HI false)
// or high nibbles of int4 bytes
template <bool INT4, bool HI>
__device__ __forceinline__ void unpack8(uint2 w, float (&f)[8]) {
  float a[4], b[4];
  if (INT4) {
    dq::int4x4<HI>(w.x, a);
    dq::int4x4<HI>(w.y, b);
  } else {
    dq::int8x4(w.x, a);
    dq::int8x4(w.y, b);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = a[j];
    f[4 + j] = b[j];
  }
}

// --- route 0: CUDA-core FMAs -------------------------------------------------

template <int MT, bool INT4, bool VEC, typename XT>
__global__ void __launch_bounds__(NT)
    qmm_fma(const XT* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, float* __restrict__ out, int M,
            int K, int N, int kchunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int PLANES = INT4 ? 2 : 1;
  constexpr int XS = MT * PLANES * SR;            // x elements a stage
  constexpr int XBYTES = (XS * (int)sizeof(XT) + 15) / 16 * 16;
  constexpr int STAGE = SR * WROW + XBYTES;
  constexpr int XE = 16 / sizeof(XT);             // elements a piece
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.z * MT;
  const int half = K / 2;
  const int k_rows = INT4 ? half : K;
  const int r_begin = blockIdx.y * kchunk;
  const int r_end = min(k_rows, r_begin + kchunk);
  const int nst = (r_end - r_begin + SR - 1) / SR;

  auto issue = [&](int s) {
    uint8_t* st = smem + (s % STAGES) * STAGE;
    const int row0 = r_begin + s * SR;
    issue_w<VEC>(st, q, row0, SR, r_end, n0, N, tid);
    XT* xs = reinterpret_cast<XT*>(st + SR * WROW);
    // x[m][plane * half + row0 + k] -> xs[(m * PLANES + plane) * SR + k]
    for (int i = tid; i < XS / XE; i += NT) {
      const int k = (i * XE) % SR, mp = (i * XE) / SR;
      const int m = mp / PLANES, plane = mp % PLANES;
      issue_x<VEC>(xs + i * XE, x, m0 + m, M, K,
                   plane * half + row0 + k, plane * half + r_end);
    }
  };

  const int c = tid % TPR, rl = tid / TPR;
  float acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = 0.f;

  auto compute = [&](int b) {
    const uint8_t* st = smem + b * STAGE;
    const XT* xs = reinterpret_cast<const XT*>(st + SR * WROW);
#pragma unroll
    for (int i = 0; i < SR / RL; ++i) {
      const int rr = rl + i * RL;
      const uint2 w =
          *reinterpret_cast<const uint2*>(st + rr * WROW + c * COLS);
      float lo[COLS];
      unpack8<INT4, false>(w, lo);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = to_f(xs[m * PLANES * SR + rr]);
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[m][j] = fmaf(xv, lo[j], acc[m][j]);
      }
      if (INT4) {
        float hi[COLS];
        unpack8<true, true>(w, hi);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = to_f(xs[(m * PLANES + 1) * SR + rr]);
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            acc[m][j] = fmaf(xv, hi[j], acc[m][j]);
        }
      }
    }
  };

  pipeline(nst, issue, compute);

  // the 16 row lanes' sums: lanes 16 apart by shuffle, then the 8 warps
  // in warp order through the (now idle) ring
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
  float* red = reinterpret_cast<float*>(smem);     // [8][MT][BN]
  const int warp = tid >> 5;
  if ((tid & 31) < 16) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        red[(warp * MT + m) * BN + c * COLS + j] = acc[m][j];
  }
  __syncthreads();
  float* tile = red + (NT / 32) * MT * BN;            // [MT][BN]
  for (int i = tid; i < MT * BN; i += NT) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) v += red[w * MT * BN + i];
    tile[i] = v;
  }
  __syncthreads();
  finish(tile, m0, MT, M, N, scale, out);
}

// --- route 1: tensor cores (bf16 activations) --------------------------------

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MI, bool INT4, bool VEC>
__global__ void __launch_bounds__(NT)
    qmm_tc(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, float* __restrict__ out, int M,
           int K, int N, int kchunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int ROWS = 16 * MI;                 // activation rows a block
  constexpr int RSB = INT4 ? KS / 2 : KS;       // byte rows a stage
  constexpr int WBYTES = RSB * WROW;
  constexpr int STAGE = WBYTES + ROWS * XST * 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cg = warp & 3, kp = warp >> 2;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.z * ROWS;
  const int half = K / 2;
  const int k_rows = INT4 ? half : K;
  const int r_begin = blockIdx.y * kchunk;
  const int r_end = min(k_rows, r_begin + kchunk);
  const int nst = (r_end - r_begin + RSB - 1) / RSB;

  auto issue = [&](int s) {
    uint8_t* st = smem + (s % STAGES) * STAGE;
    const int row0 = r_begin + s * RSB;
    issue_w<VEC>(st, q, row0, RSB, r_end, n0, N, tid);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + WBYTES);
    // piece p (8 k) of row m: int8 k = row0 + 8p; int4 the 16-k group
    // p / 2 of 8 byte rows, low nibbles' x (p even) then high nibbles'
    for (int i = tid; i < ROWS * 8; i += NT) {
      const int m = i / 8, p = i % 8;
      const int k0 = INT4 ? (p & 1) * half + row0 + 8 * (p >> 1)
                          : row0 + 8 * p;
      const int k_end = INT4 ? (p & 1) * half + r_end : r_end;
      issue_x<VEC>(xs + m * XST + 8 * p, x, m0 + m, M, K, k0, k_end);
    }
  };

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][i][e] = 0.f;

  auto compute = [&](int b) {
    const uint8_t* st = smem + b * STAGE;
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(st + WBYTES);
    const uint8_t* wc = st + cg * 32 + 4 * g;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int jg = kp + 2 * jj;               // this warp's 16-k groups
      uint32_t bf[4][2];
      if (INT4) {
        const int r = 8 * jg + 2 * t;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wc + r * WROW);
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(wc + (r + 1) * WROW);
        float l0[4], l1[4], h0[4], h1[4];
        dq::int4x4<false>(w0, l0);
        dq::int4x4<false>(w1, l1);
        dq::int4x4<true>(w0, h0);
        dq::int4x4<true>(w1, h1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bf[i][0] = dq::bf16x2_exact(l0[i], l1[i]);
          bf[i][1] = dq::bf16x2_exact(h0[i], h1[i]);
        }
      } else {
        const int r = 16 * jg + 2 * t;
        float f0[4], f1[4], f8[4], f9[4];
        dq::int8x4(*reinterpret_cast<const uint32_t*>(wc + r * WROW), f0);
        dq::int8x4(*reinterpret_cast<const uint32_t*>(wc + (r + 1) * WROW),
                   f1);
        dq::int8x4(*reinterpret_cast<const uint32_t*>(wc + (r + 8) * WROW),
                   f8);
        dq::int8x4(*reinterpret_cast<const uint32_t*>(wc + (r + 9) * WROW),
                   f9);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bf[i][0] = dq::bf16x2_exact(f0[i], f1[i]);
          bf[i][1] = dq::bf16x2_exact(f8[i], f9[i]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint32_t* xr = xs + (16 * mi + g) * (XST / 2) + 8 * jg + t;
        const uint32_t a[4] = {xr[0], xr[8 * (XST / 2)], xr[4],
                               xr[8 * (XST / 2) + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) mma16816(acc[mi][i], a, bf[i][0], bf[i][1]);
      }
    }
  };

  pipeline(nst, issue, compute);

  // the two k halves: warps 4-7 hand theirs to warps 0-3 through the ring
  float* red = reinterpret_cast<float*>(smem);  // [4][32][MI * 16]
  constexpr int PER = MI * 16;
  if (kp == 1) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(cg * 32 + lane) * PER + (mi * 4 + i) * 4 + e] = acc[mi][i][e];
  }
  __syncthreads();
  if (kp == 0) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][i][e] +=
              red[(cg * 32 + lane) * PER + (mi * 4 + i) * 4 + e];
  }
  __syncthreads();
  float* tile = red;                                  // [ROWS][BN]
  if (kp == 0) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // c0, c1: row g, n-index 2t, 2t + 1; c2, c3: row g + 8
          const int row = 16 * mi + g + 8 * (e >> 1);
          const int nn = 2 * t + (e & 1);
          tile[row * BN + cg * 32 + 4 * nn + i] = acc[mi][i][e];
        }
  }
  __syncthreads();
  finish(tile, m0, ROWS, M, N, scale, out);
}

// --- launch ------------------------------------------------------------------

// a launch whose K splits (grid y) form one cluster
template <typename... Params, typename... Args>
cudaError_t start(void (*kern)(Params...), dim3 grid, size_t smem,
                  cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = grid.y > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MT, bool INT4, typename XT>
cudaError_t launch_fma(const XT* x, const int8_t* q, const float* scale,
                       float* out, int M, int K, int N, int ksplit,
                       int kchunk, bool vec, cudaStream_t st) {
  constexpr int PLANES = INT4 ? 2 : 1;
  const size_t smem =
      STAGES * (size_t)(SR * WROW +
                        (MT * PLANES * SR * sizeof(XT) + 15) / 16 * 16);
  const dim3 grid((N + BN - 1) / BN, ksplit, (M + MT - 1) / MT);
  return start(vec ? qmm_fma<MT, INT4, true, XT> : qmm_fma<MT, INT4, false, XT>,
               grid, smem, st, x, q, scale, out, M, K, N, kchunk);
}

template <int MI, bool INT4>
cudaError_t launch_tc(const __nv_bfloat16* x, const int8_t* q,
                      const float* scale, float* out, int M, int K, int N,
                      int ksplit, int kchunk, bool vec, cudaStream_t st) {
  constexpr int RSB = INT4 ? KS / 2 : KS;
  const size_t smem = STAGES * (size_t)(RSB * WROW + 16 * MI * XST * 2);
  const dim3 grid((N + BN - 1) / BN, ksplit, (M + 16 * MI - 1) / (16 * MI));
  return start(vec ? qmm_tc<MI, INT4, true> : qmm_tc<MI, INT4, false>, grid,
               smem, st, x, q, scale, out, M, K, N, kchunk);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool INT4>
int dispatch(const void* x, int x_bf16, const void* q, const void* scale,
             void* out, int M, int K, int N, int route, int tile, int ksplit,
             int kchunk, void* stream) {
  if ((INT4 && (K % 2)) || ksplit < 1 || ksplit > MAX_SPLIT)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  const int esize = x_bf16 ? 2 : 4;
  const bool vec = N % 16 == 0 && aligned16(q) && aligned16(x) &&
                   ((size_t)K * esize) % 16 == 0 &&
                   (!INT4 || ((size_t)(K / 2) * esize) % 16 == 0);
  if (route == 1) {
    if (!x_bf16) return cudaErrorInvalidValue;
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    switch (tile) {
#define DKT_TC(MI)                                                          \
  case MI:                                                                  \
    return launch_tc<MI, INT4>(xp, qp, sp, op, M, K, N, ksplit, kchunk,     \
                               vec, st);
      DKT_TC(1) DKT_TC(2) DKT_TC(3) DKT_TC(4) DKT_TC(5)
#undef DKT_TC
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (route != 0) return cudaErrorInvalidValue;
#define DKT_FMA(MT, XT)                                                     \
  case MT:                                                                  \
    return launch_fma<MT, INT4, XT>(static_cast<const XT*>(x), qp, sp, op,  \
                                    M, K, N, ksplit, kchunk, vec, st);
  if (x_bf16) {
    switch (tile) {
      DKT_FMA(1, __nv_bfloat16) DKT_FMA(2, __nv_bfloat16)
      DKT_FMA(4, __nv_bfloat16) DKT_FMA(8, __nv_bfloat16)
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch (tile) {
    DKT_FMA(1, float) DKT_FMA(2, float) DKT_FMA(4, float) DKT_FMA(8, float)
    default:
      return cudaErrorInvalidValue;
  }
#undef DKT_FMA
}

}  // namespace

// int8 weights [K, N]. route 0: CUDA cores, `tile` activation rows a block
// (1, 2, 4, 8); route 1: tensor cores (bf16 x), `tile` 16-row tiles a
// block (1-5); ksplit (1-8) chunks of kchunk byte rows, one cluster.
extern "C" int dkt_quant_matmul_q8(const void* x, int x_bf16, const void* q,
                                   const void* scale, void* out, int M,
                                   int K, int N, int route, int tile,
                                   int ksplit, int kchunk, void* stream) {
  return dispatch<false>(x, x_bf16, q, scale, out, M, K, N, route, tile,
                         ksplit, kchunk, stream);
}

// int4 weights nibble-packed along K: [K/2, N] bytes
extern "C" int dkt_quant_matmul_q4(const void* x, int x_bf16, const void* q,
                                   const void* scale, void* out, int M,
                                   int K, int N, int route, int tile,
                                   int ksplit, int kchunk, void* stream) {
  return dispatch<true>(x, x_bf16, q, scale, out, M, K, N, route, tile,
                        ksplit, kchunk, stream);
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
