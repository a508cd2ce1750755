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
// Bound on this card: at decode and verify shapes (C = N <= 72) and a
// 256-token prefill chunk, reading w1 once (E*d*H elements) at 3.35
// TB/s; at a 2048-token prefill (C = 640) the 2*E*C*d*H operations at
// the bf16 tensor-core peak.
//
// Design (simple and right first; FMAs, no tensor cores): a block of
// 256 threads owns one expert, a tile of RT capacity rows (1, 2, 4 or
// 8) and 256 output columns. The tile's token ids are loaded once; a
// tile whose rows are all -1 reads no weight (its rows are act(b1)).
// The tile's x rows are gathered from x into shared memory, 64 d-rows at
// a time, as float32. Each thread owns 8 neighbouring columns and reads
// them with one 16-byte load per w1 row (bf16; two for float32), so a
// warp reads 512 contiguous bytes of a row; the 8 warps stride over the
// d rows, four rows per step with their loads issued first. The warps'
// partial sums are added in shared memory in a fixed order. At decode
// the grid is too small for 132 SMs (8 experts x 8 column tiles), so d
// is split across blocks (grid y): each split writes its unbiased
// partial to a float32 workspace and a second kernel adds the splits in
// order, adds the bias and applies the activation. No float atomics:
// the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int COLS = 8;             // columns per thread
constexpr int BN = 32 * COLS;       // columns per block
constexpr int RG = NT / 32;         // row groups (warps)
constexpr int UNR = 4;              // w1 rows a warp loads per step
constexpr int XSUB = 64;            // d rows of x staged at a time

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// the 8 weights of one w1 row at columns [n0, n0 + 8), as float32
template <bool VEC>
__device__ __forceinline__ void load_row(const __nv_bfloat16* row, int n0,
                                         int H, float (&w)[COLS]) {
  if (VEC) {
    if (n0 < H) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + n0);
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < COLS; ++j) w[j] = __bfloat162float(b[j]);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j) w[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      w[j] = (n0 + j < H) ? __bfloat162float(row[n0 + j]) : 0.f;
  }
}

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
template <int RT, bool VEC, typename XT>
__global__ void __launch_bounds__(NT)
    gg1_kernel(const XT* __restrict__ x, const int* __restrict__ src_tok,
               const XT* __restrict__ w1, const XT* __restrict__ b1,
               XT* __restrict__ out, float* __restrict__ part, int d, int H,
               int E, int C, int act, int kchunk) {
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
              from_f<XT>(activate(to_f(b1[(size_t)e * H + n]), act));
      }
    }
    return;
  }

  const XT* wbase = w1 + (size_t)e * d * H;
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
      if (tok >= 0 && rr < s_len) v = to_f(x[(size_t)tok * d + s0 + rr]);
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
          out[((size_t)e * C + row) * H + n] = from_f<XT>(
              activate(s + to_f(b1[(size_t)e * H + n]), act));
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
template <typename XT>
__global__ void gg1_combine(const float* __restrict__ part,
                            const int* __restrict__ src_tok,
                            const XT* __restrict__ b1, XT* __restrict__ out,
                            int H, int C, int rows, int ksplit, int act) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)rows * H;
  if (i >= total) return;
  const size_t row = i / H;
  const size_t n = i - row * H;
  const size_t e = row / C;
  float s = 0.f;
  if (src_tok[row] >= 0)
    for (int y = 0; y < ksplit; ++y) s += part[(size_t)y * total + i];
  out[i] = from_f<XT>(activate(s + to_f(b1[e * H + n]), act));
}

template <int RT, typename XT>
cudaError_t launch(const XT* x, const int* src_tok, const XT* w1,
                   const XT* b1, XT* out, float* part, int d, int H, int E,
                   int C, int act, int ksplit, int kchunk, cudaStream_t st) {
  const int rtiles = (C + RT - 1) / RT;
  if ((long long)E * rtiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((H + BN - 1) / BN, ksplit, E * rtiles);
  const bool vec = (H % COLS == 0) &&
                   (reinterpret_cast<uintptr_t>(w1) % 16 == 0);
  if (vec)
    gg1_kernel<RT, true, XT><<<grid, NT, 0, st>>>(
        x, src_tok, w1, b1, out, part, d, H, E, C, act, kchunk);
  else
    gg1_kernel<RT, false, XT><<<grid, NT, 0, st>>>(
        x, src_tok, w1, b1, out, part, d, H, E, C, act, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const int rows = E * C;
  const size_t total = (size_t)rows * H;
  gg1_combine<XT><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, src_tok, b1, out, H, C, rows, ksplit, act);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_rt(int rt, const void* x, const void* src_tok,
                        const void* w1, const void* b1, void* out, void* part,
                        int d, int H, int E, int C, int act, int ksplit,
                        int kchunk, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const int* tp = static_cast<const int*>(src_tok);
  const XT* wp = static_cast<const XT*>(w1);
  const XT* bp = static_cast<const XT*>(b1);
  XT* op = static_cast<XT*>(out);
  float* pp = static_cast<float*>(part);
  switch (rt) {
    case 1:
      return launch<1, XT>(xp, tp, wp, bp, op, pp, d, H, E, C, act, ksplit,
                           kchunk, st);
    case 2:
      return launch<2, XT>(xp, tp, wp, bp, op, pp, d, H, E, C, act, ksplit,
                           kchunk, st);
    case 4:
      return launch<4, XT>(xp, tp, wp, bp, op, pp, d, H, E, C, act, ksplit,
                           kchunk, st);
    case 8:
      return launch<8, XT>(xp, tp, wp, bp, op, pp, d, H, E, C, act, ksplit,
                           kchunk, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [N, d], src_tok [E*C] int32, w1 [E, d, H], b1 [E, H] -> out [E, C, H];
// part: a float32 [ksplit, E*C, H] workspace when ksplit > 1
extern "C" int dkt_moe_gather_gemm1(const void* x, int x_bf16,
                                    const void* src_tok, const void* w1,
                                    const void* b1, void* out, void* part,
                                    int N, int d, int H, int E, int C,
                                    int act, int rt, int ksplit, int kchunk,
                                    void* stream) {
  (void)N;
  if (ksplit < 1 || kchunk < 1 || act < 0 || act > 3)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch_rt<__nv_bfloat16>(rt, x, src_tok, w1, b1, out, part, d,
                                      H, E, C, act, ksplit, kchunk, st);
  return dispatch_rt<float>(rt, x, src_tok, w1, b1, out, part, d, H, E, C,
                            act, ksplit, kchunk, st);
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
