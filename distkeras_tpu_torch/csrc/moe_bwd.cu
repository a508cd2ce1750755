// The backward of the fused MoE expert block for Hopper (sm_90a): K6b
// (`dkt_moe_bwd_dx`) and K6c (`dkt_moe_bwd_dw1`). For each expert e and
// capacity row r, with tok = src_tok[e*C + r] (-1: no slot won the row,
// whose gathered rows are zeros):
//   K6b  gy     = g[tok] * row_gate[e*C + r]                  (float32)
//        rowdot = <h[e, r] @ w2[e] + b2[e], g[tok]>           (float32)
//        dz     = act'(x[tok] @ w1[e] + b1[e]) * (gy @ w2[e]^T)
//        dxr    = dz @ w1[e]^T        (from the float32 dz)
//   K6c  dw1[e] = sum over r of x[tok]^T @ dz[e, r]           (float32)
// with float32 products and sums; dxr, dz and gy are written in the
// input dtype (bf16 or float32), rowdot and dw1 in float32.
//
// Replaces the TPU kernels distkeras_tpu/ops/moe_kernels.py `_bwd_dx`
// (pl.pallas_call at :297, body `_bwd_dx_kernel` :225) and `_bwd_dw1`
// (pl.pallas_call at :353, body `_bwd_dw1_kernel` :310). As there, the
// combine's transpose is a gather by the inverted dispatch plan, and the
// pre-activation is recomputed rather than kept from the forward.
//
// Bound on this card: at the training shape (C = 2048 rows per expert,
// d 1024, H 2048) the operations: K6b's four products of 2*C*d*H each
// per expert, K6c's one, at the bf16 tensor-core peak.
//
// Design (simple and right first; FMAs on CUDA cores, no tensor cores):
// every product is one tiled loop, `gemm_tile`: a block of 256 threads
// owns a 64 x 64 output tile, stages 16-deep slices of both operands in
// shared memory as float32 (the loaders gather token rows by src_tok,
// scale them by the row gate or read a matrix transposed, so no operand
// is ever copied into a dispatch buffer or a transpose) and each thread
// keeps a 4 x 4 float32 accumulator. K6b's outputs need full sums over d
// (rowdot, dz) and over H (dxr), so it runs as passes over one stream:
// (1) per (expert, row tile, d tile) the y = h @ w2 + b2 tile, gy, and
// the tile's partial row dots; (2) the partials added in tile order;
// (3) per (expert, row tile, H tile) the z and dh tiles from two loops
// over d, and dz (float32 kept for (4) when the dtype is bf16);
// (4) per (expert, row tile, d tile) dxr from the float32 dz. K6c is one
// pass per (expert, d tile, H tile) over all capacity rows. A row tile
// whose rows are all -1 skips its products and writes exact zeros. No
// float atomics: the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int BM = 64;              // output tile rows
constexpr int BN = 64;              // output tile columns
constexpr int BK = 16;              // depth staged at a time
constexpr int TM = 4;               // rows per thread
constexpr int TN = 4;               // columns per thread
constexpr int SP = 68;              // staged row stride, 16-byte aligned

static_assert((BM / TM) * (BN / TN) == NT, "one thread per 4x4 sub-tile");

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
// act'(z) * dh; dzf (the float32 dz) when the output dtype is not
// float32
template <typename T>
__global__ void __launch_bounds__(NT)
    dz_kernel(const T* __restrict__ x, const T* __restrict__ g,
              const int* __restrict__ src_tok,
              const float* __restrict__ row_gate, const T* __restrict__ w1,
              const T* __restrict__ b1, const T* __restrict__ w2,
              T* __restrict__ dz, float* __restrict__ dzf, int d, int H,
              int C, int act) {
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
        const size_t o = ((size_t)e * C + r) * H + n;
        dz[o] = from_f<T>(v);
        if (dzf != nullptr) dzf[o] = v;
      }
    }
  }
}

// pass 4, grid (ceil(d / BN), ceil(C / BM), E): dxr = dz @ w1[e]^T from
// the float32 dz
template <typename T>
__global__ void __launch_bounds__(NT)
    dxr_kernel(const float* __restrict__ dzf, const int* __restrict__ src_tok,
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
    gemm_tile(acc, RowsA<float>{dzf, rows, nullptr, H, H},
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

bool grid_ok(long long x, long long y, long long z) {
  return x <= 2147483647LL && y <= 65535 && z <= 65535;
}

template <typename T>
cudaError_t bwd_dx(const void* x, const void* g, const int* src_tok,
                   const float* row_gate, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* h, void* dxr,
                   void* dz, void* gy, float* rowdot, float* dzf,
                   float* part, int d, int H, int E, int C, int act,
                   cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const T* w1p = static_cast<const T*>(w1);
  const T* w2p = static_cast<const T*>(w2);
  const int rtiles = (C + BM - 1) / BM;
  const int dtiles = (d + BN - 1) / BN;
  const int htiles = (H + BN - 1) / BN;
  if (!grid_ok(dtiles, rtiles, E) || !grid_ok(htiles, rtiles, E))
    return cudaErrorInvalidConfiguration;
  rowdot_gy_kernel<T><<<dim3(dtiles, rtiles, E), NT, 0, st>>>(
      gp, src_tok, row_gate, w2p, static_cast<const T*>(b2),
      static_cast<const T*>(h), static_cast<T*>(gy), part, d, H, E, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = E * C;
  rowdot_sum_kernel<<<(rows + 255) / 256, 256, 0, st>>>(part, rowdot, rows,
                                                        dtiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a float32 dz is its own float32 copy
  float* dzf_out = (sizeof(T) == 4) ? nullptr : dzf;
  dz_kernel<T><<<dim3(htiles, rtiles, E), NT, 0, st>>>(
      xp, gp, src_tok, row_gate, w1p, static_cast<const T*>(b1), w2p,
      static_cast<T*>(dz), dzf_out, d, H, C, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* dz32 = (sizeof(T) == 4) ? static_cast<const float*>(dz) : dzf;
  dxr_kernel<T><<<dim3(dtiles, rtiles, E), NT, 0, st>>>(
      dz32, src_tok, w1p, static_cast<T*>(dxr), d, H, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dw1(const void* x, const void* dz, const int* src_tok,
                    float* dw1, int d, int H, int E, int C,
                    cudaStream_t st) {
  const int mtiles = (d + BM - 1) / BM;
  const int ntiles = (H + BN - 1) / BN;
  if (!grid_ok(ntiles, mtiles, E)) return cudaErrorInvalidConfiguration;
  dw1_kernel<T><<<dim3(ntiles, mtiles, E), NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dz), src_tok, dw1, d,
      H, C);
  return cudaGetLastError();
}

}  // namespace

// x, g [N, d]; src_tok [E*C] int32; row_gate [E*C] float32; w1 [E, d, H];
// b1 [E, H]; w2 [E, H, d]; b2 [E, d]; h [E, C, H] -> dxr [E, C, d], dz
// [E, C, H], gy [E, C, d] in x's dtype, rowdot [E*C] float32. Workspaces:
// dzf, a float32 [E, C, H] (unused for float32 inputs), and part, a
// float32 [ceil(d / 64), E*C].
extern "C" int dkt_moe_bwd_dx(const void* x, const void* g,
                              const void* src_tok, const void* row_gate,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* h, void* dxr,
                              void* dz, void* gy, void* rowdot, void* dzf,
                              void* part, int x_bf16, int N, int d, int H,
                              int E, int C, int act, void* stream) {
  (void)N;
  if (act < 0 || act > 3 || d < 1 || H < 1 || E < 1 || C < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tok = static_cast<const int*>(src_tok);
  const float* rg = static_cast<const float*>(row_gate);
  float* rd = static_cast<float*>(rowdot);
  float* zf = static_cast<float*>(dzf);
  float* pt = static_cast<float*>(part);
  if (x_bf16)
    return bwd_dx<__nv_bfloat16>(x, g, tok, rg, w1, b1, w2, b2, h, dxr, dz,
                                 gy, rd, zf, pt, d, H, E, C, act, st);
  return bwd_dx<float>(x, g, tok, rg, w1, b1, w2, b2, h, dxr, dz, gy, rd, zf,
                       pt, d, H, E, C, act, st);
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
  if (x_bf16)
    return bwd_dw1<__nv_bfloat16>(x, dz, tok, out, d, H, E, C, st);
  return bwd_dw1<float>(x, dz, tok, out, d, H, E, C, st);
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
