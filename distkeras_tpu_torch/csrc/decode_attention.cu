// One-step decode attention over the slab KV cache for Hopper (sm_90a):
// float32 / bfloat16 caches, and int8 caches with per-token float32 scale
// planes. Queries float32, output float32.
//
// Replaces the TPU kernel distkeras_tpu/ops/decode_attention.py
// `decode_attention` (pl.pallas_call at :233, body `_kernel` :92): the
// G query heads sharing one kv head score against that head's cache
// positions [lo, t] (lo = t - window + 1 with a sliding window, else 0),
// online softmax, value mix. GQA is native: the G rows share each staged
// K/V tile, nothing is expanded. The cache is read in place through its
// row and position strides (the port's [B, Hkv, L, D] slab viewed as
// [B*Hkv, L, D]).
//
// Numerics, as the plain version (ops/decode_attention.py) has them:
// q * scale in float32, rounded to the cache dtype for a float cache
// (int8 contracts in float32); scores in float32; for int8 the score is
// multiplied by k_scale[pos] AFTER the D contraction; l accumulates the
// UNSCALED probabilities, which are then multiplied by v_scale[pos]
// (int8) or rounded to the cache dtype (float) before the value sum;
// out = acc / l with the l == 0 -> 1 guard.
//
// Bound on this card: the bytes of K and V over [lo, t] (plus q, out and
// the scales) at 3.35 TB/s; a step does 4*G*D operations per position,
// far below the card's operations-per-byte balance.
//
// Design (flash-decoding; simple and right first): the TPU kernel walked
// the context in order on one core. Here the valid positions are cut
// into `nsplit` chunks (whole 64-position tiles) and one block of 128
// threads owns one (row = b*Hkv + h, chunk): it stages each tile of K and
// V into shared memory as float32 with 16-byte loads (8 bf16, 4 float32
// or 16 int8 per load, four in flight per thread), scores the G rows
// against it with scalar FMAs, folds the tile into a per-row online
// softmax (m, l, acc in shared memory) and writes its partial (m, l,
// unnormalised acc) to a workspace. A second kernel merges the partials
// of each row through their log-sum-exps: M = max m_i, L = sum l_i
// e^(m_i - M), out = sum acc_i e^(m_i - M) / L. With one chunk the first
// kernel writes the output itself. The split keeps rows * nsplit blocks
// in flight (the host picks nsplit for ~4 blocks per SM), where one block
// per row would leave most of the 132 SMs idle at decode batch sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int NWARP = NT / 32;
constexpr int TILE = 64;                     // positions staged per step
constexpr int LOADS_IN_FLIGHT = 4;
constexpr size_t kSmemLimit = 200 * 1024;    // of the 227 KB a block may use
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

// rounding of q and of the probabilities to the cache dtype: a no-op for
// float32 and for int8 (whose products run in float32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

size_t smem_bytes(int G, int D, bool quant) {
  const size_t floats = (size_t)G * D            // Qs
                        + (size_t)TILE * (D + 1) // Ks
                        + (size_t)TILE * D       // Vs
                        + (size_t)G * (TILE + 1) // Ss
                        + (size_t)G * D          // Acc
                        + 3 * (size_t)G          // Ms, Ls, As
                        + (quant ? 2 * (size_t)TILE : 0);
  return 4 * floats;
}

template <typename T, int D, bool QUANT>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, float* __restrict__ o,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int BH, int G,
                    long long s_row, long long s_pos, long long ss_row,
                    long long ss_pos, int lo, int hi, int chunk,
                    float scale) {
  extern __shared__ float sm[];
  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int NV = TILE * D / VEC;         // loads per tile per operand
  float* Qs = sm;                            // [G][D]
  float* Ks = Qs + G * D;                    // [TILE][D+1]
  float* Vs = Ks + TILE * (D + 1);           // [TILE][D]
  float* Ss = Vs + TILE * D;                 // [G][TILE+1]
  float* Acc = Ss + G * (TILE + 1);          // [G][D]
  float* Ms = Acc + G * D;                   // [G]
  float* Ls = Ms + G;                        // [G]
  float* As = Ls + G;                        // [G]
  float* KSc = As + G;                       // [TILE] (int8 only)
  float* VSc = KSc + TILE;                   // [TILE]

  const int split = blockIdx.x, row = blockIdx.y, nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = lo + split * chunk;
  const int p1 = min(p0 + chunk, hi + 1);    // exclusive
  const T* kr = k + (long long)row * s_row;
  const T* vr = v + (long long)row * s_row;

  for (int i = tid; i < G * D; i += NT) {
    Qs[i] = round_to<T>(q[(long long)row * G * D + i] * scale);
    Acc[i] = 0.f;
  }
  for (int r = tid; r < G; r += NT) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }

  for (int c0 = p0; c0 < p1; c0 += TILE) {
    const int n = min(TILE, p1 - c0);
    __syncthreads();  // the previous tile's readers are done
    for (int base = tid; base < NV; base += NT * LOADS_IN_FLIGHT) {
      uint4 kx[LOADS_IN_FLIGHT], vx[LOADS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < LOADS_IN_FLIGHT; ++u) {
        kx[u] = make_uint4(0u, 0u, 0u, 0u);
        vx[u] = kx[u];
        const int i = base + u * NT;
        const int j = i * VEC / D;
        if (i < NV && j < n) {
          const long long off = (long long)(c0 + j) * s_pos + i * VEC % D;
          kx[u] = *reinterpret_cast<const uint4*>(kr + off);
          vx[u] = *reinterpret_cast<const uint4*>(vr + off);
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS_IN_FLIGHT; ++u) {
        const int i = base + u * NT;
        if (i < NV) {
          const int j = i * VEC / D, d = i * VEC % D;
          const T* ke = reinterpret_cast<const T*>(&kx[u]);
          const T* ve = reinterpret_cast<const T*>(&vx[u]);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            Ks[j * (D + 1) + d + e] = to_f<T>(ke[e]);
            Vs[j * D + d + e] = to_f<T>(ve[e]);
          }
        }
      }
    }
    if (QUANT) {
      for (int j = tid; j < TILE; j += NT) {
        const bool live = j < n;
        const long long off = (long long)row * ss_row +
                              (long long)(c0 + j) * ss_pos;
        KSc[j] = live ? ks[off] : 0.f;
        VSc[j] = live ? vs[off] : 0.f;
      }
    }
    __syncthreads();
    // scores of the G rows against the tile (positions past n masked)
    for (int i = tid; i < G * TILE; i += NT) {
      const int r = i / TILE, j = i % TILE;
      float x = kNegInf;
      if (j < n) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          dot = fmaf(Qs[r * D + d], Ks[j * (D + 1) + d], dot);
        x = QUANT ? dot * KSc[j] : dot;
      }
      Ss[r * (TILE + 1) + j] = x;
    }
    __syncthreads();
    // online softmax, one warp per row: l from the unscaled p, then p
    // times v_scale (int8) or rounded to the cache dtype (float)
    for (int r = warp; r < G; r += NWARP) {
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32)
        mx = fmaxf(mx, Ss[r * (TILE + 1) + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < TILE; j += 32) {
        float p = 0.f;
        if (j < n) p = expf(Ss[r * (TILE + 1) + j] - m_new);
        sum += p;
        Ss[r * (TILE + 1) + j] = QUANT ? p * VSc[j] : round_to<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        Ls[r] = Ls[r] * alpha + sum;
        Ms[r] = m_new;
        As[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += NT) {
      const int r = i / D, d = i % D;
      float a = Acc[i] * As[r];
      const float* pr = Ss + r * (TILE + 1);
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], Vs[j * D + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();
  if (nsplit == 1) {
    for (int i = tid; i < G * D; i += NT) {
      const float l = Ls[i / D];
      o[(long long)row * G * D + i] = Acc[i] / (l == 0.f ? 1.f : l);
    }
    return;
  }
  const long long prow = (long long)split * BH + row;
  for (int i = tid; i < G * D; i += NT) part_acc[prow * G * D + i] = Acc[i];
  for (int r = tid; r < G; r += NT) {
    part_m[prow * G + r] = Ms[r];
    part_l[prow * G + r] = Ls[r];
  }
}

// merge the partials of one (row, query head) per block, D threads
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      float* __restrict__ o, int rows,
                                      int nsplit, int D) {
  const int rg = blockIdx.x, d = threadIdx.x;
  float M = kNegInf;
  for (int s = 0; s < nsplit; ++s)
    M = fmaxf(M, part_m[(long long)s * rows + rg]);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long i = (long long)s * rows + rg;
    const float w = expf(part_m[i] - M);
    L = fmaf(part_l[i], w, L);
    acc = fmaf(part_acc[i * D + d], w, acc);
  }
  o[(long long)rg * D + d] = acc / (L == 0.f ? 1.f : L);
}

template <typename T, int D, bool QUANT>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const float* ks, const float* vs, float* o,
                   float* part_acc, float* part_ml, int BH, int G,
                   long long s_row, long long s_pos, long long ss_row,
                   long long ss_pos, int lo, int hi, int chunk, int nsplit,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, D, QUANT);
  if (smem > kSmemLimit || nsplit < 1 || chunk < 1 || hi < lo)
    return cudaErrorInvalidValue;
  auto kern = decode_split_kernel<T, D, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  float* part_m = part_ml;
  float* part_l = part_ml + (size_t)nsplit * BH * G;
  dim3 grid(nsplit, BH);
  kern<<<grid, NT, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, o,
      part_acc, part_m, part_l, BH, G, s_row, s_pos, ss_row, ss_pos, lo, hi,
      chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  decode_combine_kernel<<<BH * G, D, 0, stream>>>(part_acc, part_m, part_l,
                                                  o, BH * G, nsplit, D);
  return cudaGetLastError();
}

template <typename T, bool QUANT>
cudaError_t dispatch_d(int D, const float* q, const void* k, const void* v,
                       const float* ks, const float* vs, float* o,
                       float* part_acc, float* part_ml, int BH, int G,
                       long long s_row, long long s_pos, long long ss_row,
                       long long ss_pos, int lo, int hi, int chunk,
                       int nsplit, float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32, QUANT>(q, k, v, ks, vs, o, part_acc, part_ml, BH,
                                  G, s_row, s_pos, ss_row, ss_pos, lo, hi,
                                  chunk, nsplit, scale, st);
    case 64:
      return launch<T, 64, QUANT>(q, k, v, ks, vs, o, part_acc, part_ml, BH,
                                  G, s_row, s_pos, ss_row, ss_pos, lo, hi,
                                  chunk, nsplit, scale, st);
    case 128:
      return launch<T, 128, QUANT>(q, k, v, ks, vs, o, part_acc, part_ml,
                                   BH, G, s_row, s_pos, ss_row, ss_pos, lo,
                                   hi, chunk, nsplit, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 (dtype 0) or bfloat16 (dtype 1) cache
extern "C" int dkt_decode_attention(const void* q, const void* k,
                                    const void* v, void* o, void* part_acc,
                                    void* part_ml, int dtype, int BH, int G,
                                    int D, long long s_row, long long s_pos,
                                    int lo, int hi, int chunk, int nsplit,
                                    float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(o);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, false>(D, qf, k, v, nullptr, nullptr, of, pa,
                                    pml, BH, G, s_row, s_pos, 0, 0, lo, hi,
                                    chunk, nsplit, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, false>(D, qf, k, v, nullptr, nullptr,
                                            of, pa, pml, BH, G, s_row, s_pos,
                                            0, 0, lo, hi, chunk, nsplit,
                                            scale, st);
  return cudaErrorInvalidValue;
}

// int8 cache with float32 per-token scale planes
extern "C" int dkt_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, void* o, void* part_acc, void* part_ml, int BH, int G,
    int D, long long s_row, long long s_pos, long long ss_row,
    long long ss_pos, int lo, int hi, int chunk, int nsplit, float scale,
    void* stream) {
  return dispatch_d<int8_t, true>(
      D, static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<float*>(o),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), BH, G,
      s_row, s_pos, ss_row, ss_pos, lo, hi, chunk, nsplit, scale,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
