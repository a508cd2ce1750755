// MoE expert up-projection with the token gather fused in (K6a) for
// Hopper (sm_90a): for each expert e and capacity row r,
//   tok = src_tok[e*C + r]; x_row = tok >= 0 ? x[tok] : 0
//   h[e, r, :] = act(x_row @ w1[e] + b1[e])
// with float32 products, sums, bias and activation, written [E, C, H] in
// the input dtype (bf16 or float32). A row no slot won is act(b1[e]).
//
// Replaces the TPU kernel distkeras_tpu/ops/moe_kernels.py
// `_gather_gemm1` (pl.pallas_call at :214, body `_fwd_kernel` :178,
// the row gather `_gather_tile` :136): the [E*C, d] dispatch buffer of
// the XLA path never exists; token rows are read straight from the
// [N, d] residual stream by the inverted dispatch plan.
//
// Bound on this card: at decode, verify and tree shapes (C = N <= 72)
// and a 256-token prefill chunk, reading w1 of the experts reached once
// (E*d*H elements) at 3.35 TB/s (0.0076-0.0110 ms at d 1024, H 2048);
// at a 2048-token prefill (C = 640) the bytes and the 2*filled*d*H
// operations at the bf16 tensor-core peak (989 TFLOP/s) about tie
// (0.0175 ms); at the training shape (N 8192, C 2048) the operations
// (0.069 ms).
//
// bf16 inputs (namespace tc): the product is `wgmma` m64n128k16 with
// bf16 operands from shared memory in the 128-byte swizzle and the
// float32 accumulator in registers for the whole K loop over d. A block
// of WG consumer warpgroups (64 capacity rows each) owns a (64*WG) x 128
// output tile of one expert; grid (H tiles, C tiles, E). moe_tc.cuh's
// `mainloop` (shared with K6b's pass 3, which computes this product)
// runs a ring of stages of 64-deep slices: the gathered token rows
// x[tok] come in K-major by 16-byte cp.async into the swizzle (a -1
// row, a row past C and the ragged tail of d zero-filled), w1[e] comes
// in MN-major by TMA from a 3-d map and is read through wgmma's
// transpose bit (an H or base off 16 bytes: cp.async, or element by
// element; the TMA choice is compiled in per instantiation). A row tile
// with no filled row runs no product. The epilogue goes through the
// ring, which the mainloop leaves free: the accumulator is written to a
// float32 tile there (so its registers are dead before the activation,
// which keeps two warpgroups within 128 registers a thread unspilled),
// then each thread takes 8 neighbouring columns of a row at a time,
// adds b1[e], applies the activation in float32 and writes them as one
// 16-byte bf16 store. A row no slot won is act(0 + b1[e]) from the same
// code, in a filled tile or an empty one. Two warpgroups a block
// (128-row tiles, 3 stages of 32 KB, two blocks an SM; one where w1
// cannot come by TMA); one warpgroup a block (64-row tiles, 4 stages of
// 24 KB, three stages of w1 in flight) at C <= 64 (decode, verify, an
// expert of a small batch), where the grid has as many blocks either
// way, streaming w1 is the bound, and a 128-row tile would multiply
// twice the zero rows. The wrapper picks WG from the capacity alone.
//
// float32 inputs (namespace simt, the CUDA-core kernel, kept because
// TF32 would break the float32 checks at 1e-4; bf16 is the serving and
// training dtype): a block of 256 threads owns one expert, a tile of RT
// capacity rows (1, 2, 4 or 8) and 256 output columns. The tile's token
// ids are loaded once; a tile whose rows are all -1 reads no weight
// (its rows are act(b1)). The tile's x rows are gathered into shared
// memory, 64 d-rows at a time, as float32. Each thread owns 8
// neighbouring columns and reads them with two 16-byte loads per w1
// row, so a warp reads 1024 contiguous bytes of a row; the 8 warps stride over
// the d rows, four rows per step with their loads issued first. The
// warps' partial sums are added in shared memory in a fixed order. Where
// the grid is too small for 132 SMs, d is split across blocks (grid y):
// each split writes its unbiased partial to a float32 workspace and a
// second kernel adds the splits in order, adds the bias and applies the
// activation.
//
// No float atomics: the same inputs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moe_tc.cuh"

namespace {

// 0 linear, 1 relu, 2 gelu (tanh form, jax.nn.gelu's default), 3 silu
__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case 1:
      return fmaxf(z, 0.f);
    case 2: {
      const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
      return 0.5f * z * (1.f + tanhf(u));
    }
    case 3:
      return z / (1.f + expf(-z));
    default:
      return z;
  }
}

// --- float32 inputs: FMAs on the CUDA cores -------------------------------
namespace simt {

constexpr int NT = 256;
constexpr int COLS = 8;             // columns per thread
constexpr int BN = 32 * COLS;       // columns per block
constexpr int RG = NT / 32;         // row groups (warps)
constexpr int UNR = 4;              // w1 rows a warp loads per step
constexpr int XSUB = 64;            // d rows of x staged at a time

// the 8 weights of one w1 row at columns [n0, n0 + 8)
template <bool VEC>
__device__ __forceinline__ void load_row(const float* row, int n0, int H,
                                         float (&w)[COLS]) {
  if (VEC) {
    if (n0 < H) {
      const float4 a = *reinterpret_cast<const float4*>(row + n0);
      const float4 b = *reinterpret_cast<const float4*>(row + n0 + 4);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j) w[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j) w[j] = (n0 + j < H) ? row[n0 + j] : 0.f;
  }
}

// grid (ceil(H / BN), ksplit, E * ceil(C / RT))
template <int RT, bool VEC>
__global__ void __launch_bounds__(NT)
    gg1_kernel(const float* __restrict__ x, const int* __restrict__ src_tok,
               const float* __restrict__ w1, const float* __restrict__ b1,
               float* __restrict__ out, float* __restrict__ part, int d,
               int H, int E, int C, int act, int kchunk) {
  __shared__ int toks[RT];
  __shared__ float xs[RT * XSUB];
  __shared__ float red[RG * BN];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rg = tid >> 5;
  const int rtiles = (C + RT - 1) / RT;
  const int e = blockIdx.z / rtiles;
  const int r0 = (blockIdx.z - e * rtiles) * RT;
  const int c0 = blockIdx.x * BN;
  const int n0 = c0 + lane * COLS;
  if (tid < RT)
    toks[tid] = (r0 + tid < C) ? src_tok[(size_t)e * C + r0 + tid] : -1;
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int m = 0; m < RT; ++m) any |= toks[m] >= 0;
  if (!any) {
    // no token in the tile: with the d split the combine writes act(b1)
    // for these rows; unsplit, this block does
    if (gridDim.y == 1) {
      for (int i = tid; i < RT * BN; i += NT) {
        const int m = i / BN;
        const int n = c0 + (i - m * BN);
        if (r0 + m < C && n < H)
          out[((size_t)e * C + r0 + m) * H + n] =
              activate(b1[(size_t)e * H + n], act);
      }
    }
    return;
  }

  const float* wbase = w1 + (size_t)e * d * H;
  const int r_begin = blockIdx.y * kchunk;
  const int r_end = min(d, r_begin + kchunk);
  float acc[RT][COLS];
#pragma unroll
  for (int m = 0; m < RT; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = 0.f;

  for (int s0 = r_begin; s0 < r_end; s0 += XSUB) {
    const int s_len = min(XSUB, r_end - s0);
    // the gather: neighbouring threads read neighbouring d of one row
    for (int i = tid; i < RT * XSUB; i += NT) {
      const int m = i / XSUB;
      const int rr = i - m * XSUB;
      const int tok = toks[m];
      float v = 0.f;
      if (tok >= 0 && rr < s_len) v = x[(size_t)tok * d + s0 + rr];
      xs[i] = v;
    }
    __syncthreads();
    for (int rr = rg * UNR; rr < s_len; rr += RG * UNR) {
      float w[UNR][COLS];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        if (rr + u < s_len) {
          load_row<VEC>(wbase + (size_t)(s0 + rr + u) * H, n0, H, w[u]);
        } else {
#pragma unroll
          for (int j = 0; j < COLS; ++j) w[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
#pragma unroll
        for (int m = 0; m < RT; ++m) {
          const float xv = xs[m * XSUB + rr + u];
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            acc[m][j] = fmaf(xv, w[u][j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }

  // the 8 row groups' partials, added in row-group order
#pragma unroll
  for (int m = 0; m < RT; ++m) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) red[rg * BN + lane * COLS + j] = acc[m][j];
    __syncthreads();
    const int row = r0 + m;
    for (int c = tid; c < BN; c += NT) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < RG; ++g) s += red[g * BN + c];
      const int n = c0 + c;
      if (n < H && row < C) {
        if (gridDim.y == 1)
          out[((size_t)e * C + row) * H + n] =
              activate(s + b1[(size_t)e * H + n], act);
        else
          part[((size_t)blockIdx.y * E * C + (size_t)e * C + row) * H + n] =
              s;
      }
    }
    __syncthreads();
  }
}

// the d splits added in split order, then the bias and the activation;
// a row no slot won reads no partial and is act(b1)
__global__ void gg1_combine(const float* __restrict__ part,
                            const int* __restrict__ src_tok,
                            const float* __restrict__ b1,
                            float* __restrict__ out, int H, int C, int rows,
                            int ksplit, int act) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)rows * H;
  if (i >= total) return;
  const size_t row = i / H;
  const size_t n = i - row * H;
  const size_t e = row / C;
  float s = 0.f;
  if (src_tok[row] >= 0)
    for (int y = 0; y < ksplit; ++y) s += part[(size_t)y * total + i];
  out[i] = activate(s + b1[e * H + n], act);
}

template <int RT>
cudaError_t launch(const float* x, const int* src_tok, const float* w1,
                   const float* b1, float* out, float* part, int d, int H,
                   int E, int C, int act, int ksplit, int kchunk,
                   cudaStream_t st) {
  const int rtiles = (C + RT - 1) / RT;
  if ((long long)E * rtiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((H + BN - 1) / BN, ksplit, E * rtiles);
  const bool vec = (H % COLS == 0) &&
                   (reinterpret_cast<uintptr_t>(w1) % 16 == 0);
  if (vec)
    gg1_kernel<RT, true><<<grid, NT, 0, st>>>(
        x, src_tok, w1, b1, out, part, d, H, E, C, act, kchunk);
  else
    gg1_kernel<RT, false><<<grid, NT, 0, st>>>(
        x, src_tok, w1, b1, out, part, d, H, E, C, act, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const int rows = E * C;
  const size_t total = (size_t)rows * H;
  gg1_combine<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, src_tok, b1, out, H, C, rows, ksplit, act);
  return cudaGetLastError();
}

cudaError_t dispatch_rt(int rt, const void* x, const void* src_tok,
                        const void* w1, const void* b1, void* out, void* part,
                        int d, int H, int E, int C, int act, int ksplit,
                        int kchunk, cudaStream_t st) {
  const float* xp = static_cast<const float*>(x);
  const int* tp = static_cast<const int*>(src_tok);
  const float* wp = static_cast<const float*>(w1);
  const float* bp = static_cast<const float*>(b1);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  switch (rt) {
    case 1:
      return launch<1>(xp, tp, wp, bp, op, pp, d, H, E, C, act, ksplit,
                         kchunk, st);
    case 2:
      return launch<2>(xp, tp, wp, bp, op, pp, d, H, E, C, act, ksplit,
                         kchunk, st);
    case 4:
      return launch<4>(xp, tp, wp, bp, op, pp, d, H, E, C, act, ksplit,
                         kchunk, st);
    case 8:
      return launch<8>(xp, tp, wp, bp, op, pp, d, H, E, C, act, ksplit,
                         kchunk, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// --- bf16 inputs: wgmma on the tensor cores --------------------------------
namespace tc {

using namespace moe_tc;

// ring stages: a two-warpgroup block (two an SM) copies two stages ahead,
// a one-warpgroup block three
constexpr int RING2 = 3;
constexpr int RING1 = 4;
// the epilogue's float32 tile in the ring, rows LDS floats apart: the
// accumulator's float2 writes of a half-warp meet 32 distinct banks
constexpr int LDS = BN + 8;
static_assert(128 * LDS * 4 <= smem_bytes(RING2, BN) - 1024,
              "the staged tile fits the two-warpgroup ring");
static_assert(64 * LDS * 4 <= smem_bytes(RING1, BN, 1) - 1024,
              "the staged tile fits the one-warpgroup ring");

// grid (ceil(H / BN), ceil(C / (64 * WG)), E): h[e] tile = act(x[tok] @
// w1[e] + b1[e]), w1[e] read through the transpose (MN-major slices)
template <int WG, bool TMA_W1>
// with both operands copied by every thread, two warpgroups' copy state
// does not fit 128 registers a thread: one block an SM
__global__ void __launch_bounds__(128 * WG, WG == 1 || TMA_W1 ? 2 : 1)
    gemm1_kernel(const __grid_constant__ CUtensorMap mw1,
                 const bf16* __restrict__ x, const int* __restrict__ src_tok,
                 const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                 bf16* __restrict__ out, int d, int H, int C, int act) {
  constexpr int S = WG == 2 ? RING2 : RING1;
  constexpr int NTH = 128 * WG;
  constexpr int ROWS = 64 * WG;
  constexpr int CH = BN / 8;  // 8-column chunks of a tile row
  static_assert(NTH % CH == 0, "a thread keeps its chunk column");
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[S];
  const uint32_t ring = ring_base(smem);
  const uint32_t bars = init_bars<S>(bar_mem);
  uint32_t phase = 0;
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * ROWS;
  const int n0 = blockIdx.x * BN;
  const int* tok = src_tok + (size_t)e * C;
  {
    float acc[BN / 2];
    zero(acc);
    if (tile_any(tok, r0, C, ROWS))
      mainloop<S, 0, BN, false, true, Linear, WG>(
          acc, ring, bars, phase, rows_of(x, tok, d, C),
          rows_of(w1 + (size_t)e * d * H, nullptr, H, d,
                  TMA_W1 ? &mw1 : nullptr, e),
          r0, n0, (d + BK - 1) / BK, Linear{});
    // the accumulator into the ring, which the mainloop left free (a row
    // no slot won, and every row of a tile with none, holds zeros)
    float* tile = reinterpret_cast<float*>(smem + (ring - smem_u32(smem)));
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2)
      *reinterpret_cast<float2*>(tile + acc_row(i) * LDS + acc_col(i)) =
          make_float2(acc[i], acc[i + 1]);
  }
  __syncthreads();
  // bias, activation and the bf16 store, 8 neighbouring columns a thread
  // at a time (one 16-byte store where the row allows it)
  const float* tile =
      reinterpret_cast<const float*>(smem + (ring - smem_u32(smem)));
  const int c8 = (threadIdx.x % CH) * 8;
  const int n = n0 + c8;
  const bf16* bias = b1 + (size_t)e * H + n;
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bv[j] = n + j < H ? __bfloat162float(bias[j]) : 0.f;
  const bool vec = (H % 8) == 0 && n + 8 <= H;
  for (int q = threadIdx.x; q < ROWS * CH; q += NTH) {
    const int r = q / CH;
    if (r0 + r >= C) break;
    const float4 lo = *reinterpret_cast<const float4*>(tile + r * LDS + c8);
    const float4 hi =
        *reinterpret_cast<const float4*>(tile + r * LDS + c8 + 4);
    const float z[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = activate(z[j] + bv[j], act);
    bf16* dst = out + ((size_t)e * C + r0 + r) * H + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n + j < H) dst[j] = __float2bfloat16(v[j]);
    }
  }
}

cudaError_t launch(int wg, const bf16* x, const int* src_tok,
                   const bf16* w1, const bf16* b1, bf16* out, int d, int H,
                   int E, int C, int act, cudaStream_t st) {
  const int rtiles = (C + 64 * wg - 1) / (64 * wg);
  if (rtiles > 65535 || E > 65535) return cudaErrorInvalidConfiguration;
  // w1[e] MN-major: [BK rows][64 columns] boxes
  CUtensorMap mw1;
  int tw1;
  cudaError_t err = tma_map(&mw1, &tw1, w1, E, d, H, BK);
  if (err != cudaSuccess) return err;
  // the TMA path is compiled in or out (a dead copy path costs registers)
  auto* k = wg == 2 ? (tw1 ? gemm1_kernel<2, true> : gemm1_kernel<2, false>)
                    : (tw1 ? gemm1_kernel<1, true> : gemm1_kernel<1, false>);
  const int smem = wg == 2 ? smem_bytes(RING2, BN) : smem_bytes(RING1, BN, 1);
  err = allow_smem(k, smem);
  if (err != cudaSuccess) return err;
  k<<<dim3((H + BN - 1) / BN, rtiles, E), 128 * wg, smem, st>>>(
      mw1, x, src_tok, w1, b1, out, d, H, C, act);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x [N, d], src_tok [E*C] int32, w1 [E, d, H], b1 [E, H] -> out [E, C, H].
// wg: 1 or 2, the tensor-core kernel with that many warpgroups a block
// (bf16); 0, the CUDA-core kernel (float32) with rt capacity rows a block
// and d cut into ksplit chunks of kchunk rows (part: a float32 [ksplit,
// E*C, H] workspace when ksplit > 1)
extern "C" int dkt_moe_gather_gemm1(const void* x, int x_bf16,
                                    const void* src_tok, const void* w1,
                                    const void* b1, void* out, void* part,
                                    int N, int d, int H, int E, int C,
                                    int act, int wg, int rt, int ksplit,
                                    int kchunk, void* stream) {
  (void)N;
  if (act < 0 || act > 3 || d < 1 || H < 1 || E < 1 || C < 1 || wg < 0 ||
      wg > 2 || (wg > 0) != (x_bf16 != 0) ||
      (wg == 0 && (ksplit < 1 || kchunk < 1)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wg > 0) {
    using B = __nv_bfloat16;
    return tc::launch(wg, static_cast<const B*>(x),
                      static_cast<const int*>(src_tok),
                      static_cast<const B*>(w1), static_cast<const B*>(b1),
                      static_cast<B*>(out), d, H, E, C, act, st);
  }
  return simt::dispatch_rt(rt, x, src_tok, w1, b1, out, part, d, H, E, C,
                           act, ksplit, kchunk, st);
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
