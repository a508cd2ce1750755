// Weight-only quantized matmul (K5) for Hopper (sm_90a): out[M, N] =
// (x[M, K] @ q[K, N]) * scale[N] in float32, with int8 weights or with
// int4 weights nibble-packed along K.
//
// Replaces the TPU kernel distkeras_tpu/ops/quant_matmul.py
// `quant_matmul` (pl.pallas_call at :282, body `_kernel` :212): x (bf16
// or float32) is read as float32, each integer weight converted to
// float32, products accumulated in float32, and the per-column scale
// applied once after the K loop. The packed variant takes a [K/2, N]
// byte matrix whose byte row r holds logical row r in its low nibble and
// row r + K/2 in its high nibble; the projection layout and the
// output-projection layout ([h, e, d] seen as [h*e, d]) are the same
// 2-D byte matrix, so one kernel serves both.
//
// Bound on this card: at decode shapes (M <= 72) the weight bytes, K*N
// (K*N/2 packed), at 3.35 TB/s; 2*M*K*N operations stay far below the
// card's operations-per-byte balance.
//
// Design (simple and right first): a block of 256 threads owns 512
// output columns and a chunk of the weight's byte rows. Each thread
// owns 16 neighbouring columns and reads them with one 16-byte load per
// row, so a warp reads 512 contiguous bytes of one row; the 8 warps
// stride over the chunk's rows. The activation rows of the block's
// M-tile (1, 2, 4 or 8 rows; grid z walks the rest) are staged in
// shared memory 64 byte rows at a time; in the int4 variant a byte
// feeds x[m][r] and x[m][r + K/2] from two staged planes, so the unpack
// costs no extra loads. The warps' partial sums are added in shared
// memory in a fixed order. N = 1024 gives only two column blocks, too
// few for 132 SMs, so K is split across blocks (grid y): each split
// writes its unscaled partial to a workspace and a second kernel adds
// the splits in order and scales, so the same inputs give the same bits
// (no float atomics). Ragged N, or a weight not on a 16-byte boundary,
// takes byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int COLS = 16;            // columns per thread (one 16-byte load)
constexpr int BN = 32 * COLS;       // columns per block
constexpr int RG = NT / 32;         // row groups (warps)
constexpr int XSUB = 64;            // byte rows of x staged at a time

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the 16 weight bytes of one row at columns [n0, n0 + 16)
template <bool VEC>
__device__ __forceinline__ void load_row(const int8_t* row, int n0, int N,
                                         int8_t (&w)[COLS]) {
  if (VEC) {
    if (n0 < N) {
      const int4 v = *reinterpret_cast<const int4*>(row + n0);
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < COLS; ++j) w[j] = b[j];
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j) w[j] = 0;
    }
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j) w[j] = (n0 + j < N) ? row[n0 + j] : 0;
  }
}

template <int MT, bool INT4, bool VEC, typename XT>
__global__ void __launch_bounds__(NT)
    qmm_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, float* __restrict__ out,
               float* __restrict__ part, int M, int K, int N, int kchunk) {
  __shared__ float xs[(INT4 ? 2 : 1) * MT * XSUB];
  __shared__ float red[RG * BN];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rg = tid >> 5;
  const int n0 = blockIdx.x * BN + lane * COLS;
  const int m0 = blockIdx.z * MT;
  const int half = K / 2;
  const int krows = INT4 ? half : K;
  const int r_begin = blockIdx.y * kchunk;
  const int r_end = min(krows, r_begin + kchunk);

  float acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = 0.f;

  for (int s0 = r_begin; s0 < r_end; s0 += XSUB) {
    const int s_len = min(XSUB, r_end - s0);
    for (int i = tid; i < MT * XSUB; i += NT) {
      const int mm = i / XSUB;
      const int rr = i - mm * XSUB;
      float v = 0.f, vh = 0.f;
      if (m0 + mm < M && rr < s_len) {
        const XT* xr = x + (size_t)(m0 + mm) * K + s0 + rr;
        v = to_f(xr[0]);
        if (INT4) vh = to_f(xr[half]);
      }
      xs[i] = v;
      if (INT4) xs[MT * XSUB + i] = vh;
    }
    __syncthreads();
    for (int rr = rg; rr < s_len; rr += RG) {
      int8_t w[COLS];
      load_row<VEC>(q + (size_t)(s0 + rr) * N, n0, N, w);
      if (INT4) {
        float lo[COLS], hi[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const unsigned u = static_cast<uint8_t>(w[j]);
          lo[j] = static_cast<float>(static_cast<int>(u << 28) >> 28);
          hi[j] = static_cast<float>(static_cast<int>(u << 24) >> 28);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xl = xs[m * XSUB + rr];
          const float xh = xs[MT * XSUB + m * XSUB + rr];
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            acc[m][j] = fmaf(xl, lo[j], acc[m][j]);
            acc[m][j] = fmaf(xh, hi[j], acc[m][j]);
          }
        }
      } else {
        float wf[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) wf[j] = static_cast<float>(w[j]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m * XSUB + rr];
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }

  // the 8 row groups' partials, added in row-group order
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) red[rg * BN + lane * COLS + j] = acc[m][j];
    __syncthreads();
    const int mm = m0 + m;
    for (int c = tid; c < BN; c += NT) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < RG; ++g) s += red[g * BN + c];
      const int n = blockIdx.x * BN + c;
      if (n < N && mm < M) {
        if (gridDim.y == 1)
          out[(size_t)mm * N + n] = s * scale[n];
        else
          part[((size_t)blockIdx.y * M + mm) * N + n] = s;
      }
    }
    __syncthreads();
  }
}

// the K splits added in split order, then scaled
__global__ void qmm_combine(const float* __restrict__ part,
                            const float* __restrict__ scale,
                            float* __restrict__ out, int M, int N,
                            int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int y = 0; y < ksplit; ++y) s += part[(size_t)y * total + i];
  out[i] = s * scale[i % N];
}

template <int MT, bool INT4, typename XT>
cudaError_t launch(const XT* x, const int8_t* q, const float* scale,
                   float* out, float* part, int M, int K, int N, int ksplit,
                   int kchunk, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, ksplit, (M + MT - 1) / MT);
  const bool vec = (N % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  if (vec)
    qmm_kernel<MT, INT4, true, XT><<<grid, NT, 0, st>>>(
        x, q, scale, out, part, M, K, N, kchunk);
  else
    qmm_kernel<MT, INT4, false, XT><<<grid, NT, 0, st>>>(
        x, q, scale, out, part, M, K, N, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const size_t total = (size_t)M * N;
  qmm_combine<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, scale, out, M, N, ksplit);
  return cudaGetLastError();
}

template <bool INT4, typename XT>
cudaError_t dispatch_mt(int mt, const void* x, const void* q,
                        const void* scale, void* out, void* part, int M,
                        int K, int N, int ksplit, int kchunk,
                        cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  switch (mt) {
    case 1:
      return launch<1, INT4, XT>(xp, qp, sp, op, pp, M, K, N, ksplit,
                                 kchunk, st);
    case 2:
      return launch<2, INT4, XT>(xp, qp, sp, op, pp, M, K, N, ksplit,
                                 kchunk, st);
    case 4:
      return launch<4, INT4, XT>(xp, qp, sp, op, pp, M, K, N, ksplit,
                                 kchunk, st);
    case 8:
      return launch<8, INT4, XT>(xp, qp, sp, op, pp, M, K, N, ksplit,
                                 kchunk, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool INT4>
int dispatch(const void* x, int x_bf16, const void* q, const void* scale,
             void* out, void* part, int M, int K, int N, int mt, int ksplit,
             int kchunk, void* stream) {
  if (INT4 && (K % 2)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch_mt<INT4, __nv_bfloat16>(mt, x, q, scale, out, part, M,
                                            K, N, ksplit, kchunk, st);
  return dispatch_mt<INT4, float>(mt, x, q, scale, out, part, M, K, N,
                                  ksplit, kchunk, st);
}

}  // namespace

// int8 weights [K, N]
extern "C" int dkt_quant_matmul_q8(const void* x, int x_bf16, const void* q,
                                   const void* scale, void* out, void* part,
                                   int M, int K, int N, int mt, int ksplit,
                                   int kchunk, void* stream) {
  return dispatch<false>(x, x_bf16, q, scale, out, part, M, K, N, mt, ksplit,
                         kchunk, stream);
}

// int4 weights nibble-packed along K: [K/2, N] bytes
extern "C" int dkt_quant_matmul_q4(const void* x, int x_bf16, const void* q,
                                   const void* scale, void* out, void* part,
                                   int M, int K, int N, int mt, int ksplit,
                                   int kchunk, void* stream) {
  return dispatch<true>(x, x_bf16, q, scale, out, part, M, K, N, mt, ksplit,
                        kchunk, stream);
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
