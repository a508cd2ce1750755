// Flash-attention forward for Hopper (sm_90a), float32 or bfloat16.
//
// Replaces the TPU kernel distkeras_tpu/ops/flash_attention.py
// `_flash_forward` (pl.pallas_call at :321, body `_fwd_kernel` :125) on
// the serving path: one-pass prompt prefill and both passes of chunked
// prefill. Returns out (q's dtype) and the row log-sum-exp (float32).
//
// Bound on this card: 4*B*H*Sq*Sk*D operations (about half of that when
// causal) at 989 TFLOP/s bf16, against q/k/v/out bytes at 3.35 TB/s; at
// the prefill shapes (Sq = Sk >= 256, D = 64) the operations bound it.
//
// Design (a simple kernel that is right first; wgmma/TMA come later):
//   * one block of 128 threads per (batch*head, 64-row query block);
//     a loop inside the block walks 64-key blocks, the online-softmax
//     state (m, l, acc) stays in registers the whole sweep, so the score
//     matrix never reaches device memory;
//   * thread t owns query row t/2 and every other key column / head-dim
//     column (interleaved, so the two threads of a row read neighbouring
//     shared-memory banks); the row max and sum combine across the pair
//     with one shuffle;
//   * causal blocks above the diagonal and blocks wholly older than a
//     sliding window are never loaded; inside a block the causal edge,
//     the window edge (k_pos > q_pos - window) and the ragged key tail
//     (k_pos < Sk) are masked with the finite NEG_INF, so a fully
//     masked row gives lse ~ NEG_INF and never NaN;
//   * packed sequences (`_fwd_kernel` :188-189): with segment ids each
//     key tile's ids are loaded into shared memory beside K and
//     `qseg[r] == kseg[j]` is ANDed into the element mask. Segments only
//     remove pairs, so every tile skip above stays; no tile is skipped
//     for its ids. A row whose first visited tiles are wholly masked
//     carries m = NEG_INF with alpha = 1 through them (each masked
//     element adds exp(0) to l and its V row to acc, all finite); the
//     first admitted key raises m to a real score and its alpha =
//     exp(NEG_INF - m) is exactly 0, which clears that residue. With no
//     ids (null pointers) every id reads 0, so the mask is unchanged;
//   * scores accumulate in float32 from the stored dtype; probabilities
//     are rounded to V's dtype before the P.V product (as `_fwd_kernel`
//     :203-205 does); the l == 0 guard makes an empty row output 0.
//   * grouped queries (H = G * Hkv) read their shared K/V head directly.
// The MMA-free inner loops are shared-memory bound: making this kernel
// fast (tensor cores through wgmma, TMA-fed tiles) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per step
constexpr int NT = 128;  // threads per block
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;  // element strides; head_dim is contiguous
};

template <int D>
constexpr int smem_floats() {
  return BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1) + BN;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int G, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal, int window,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 long long seg_b) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = BN + 1;
  float* Qs = smem;            // [BM][DP]
  float* Ks = Qs + BM * DP;    // [BN][DP]
  float* Vs = Ks + BN * DP;    // [BN][D]
  float* Ps = Vs + BN * D;     // [BM][PP]
  int* Kseg = reinterpret_cast<int*>(Ps + BM * PP);  // [BN] key ids

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / G;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int qpos = q0 + r;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int* ksb = kseg ? kseg + b * seg_b : nullptr;
  const int rseg = (qseg && qpos < Sq) ? qseg[b * seg_b + qpos] : 0;

  for (int i = tid; i < BM * D; i += NT) {
    const int rr = i / D, dd = i % D;
    const int p = q0 + rr;
    Qs[rr * DP + dd] = p < Sq ? to_f<T>(qb[p * qs.s + dd]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;

  const int q_last = min(q0 + BM, Sq) - 1;
  int kb_end = (Sk + BN - 1) / BN;
  if (causal) kb_end = min(kb_end, q_last / BN + 1);
  int kb_begin = 0;
  if (window > 0) kb_begin = max(0, q0 - window + 1) / BN;

  for (int kblk = kb_begin; kblk < kb_end; ++kblk) {
    const int k0 = kblk * BN;
    __syncthreads();  // the previous step's readers are done
    for (int i = tid; i < BN * D; i += NT) {
      const int jj = i / D, dd = i % D;
      const int p = k0 + jj;
      const bool in = p < Sk;
      Ks[jj * DP + dd] = in ? to_f<T>(kb[p * ks.s + dd]) : 0.f;
      Vs[jj * D + dd] = in ? to_f<T>(vb[p * vs.s + dd]) : 0.f;
    }
    for (int i = tid; i < BN; i += NT)
      Kseg[i] = (ksb && k0 + i < Sk) ? ksb[k0 + i] : 0;
    __syncthreads();

    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float qd = Qs[r * DP + dd];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        s[i] = fmaf(qd, Ks[(2 * i + half) * DP + dd], s[i]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int kp = k0 + 2 * i + half;
      bool ok = kp < Sk;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      ok = ok && Kseg[2 * i + half] == rseg;
      const float x = ok ? s[i] * scale : kNegInf;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const float p = expf(s[i] - m_new);
      rs += p;
      Ps[r * PP + 2 * i + half] = to_f<T>(from_f<T>(p));
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
    m = m_new;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] *= alpha;
    __syncthreads();  // the partner's half of the P row is written
    for (int j = 0; j < BN; ++j) {
      const float p = Ps[r * PP + j];
#pragma unroll
      for (int c = 0; c < D / 2; ++c)
        acc[c] = fmaf(p, Vs[j * D + 2 * c + half], acc[c]);
    }
  }

  if (qpos < Sq) {
    const float ls = (l == 0.f) ? 1.f : l;
    T* ob = o + b * os.b + h * os.h + qpos * os.s;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) ob[2 * c + half] = from_f<T>(acc[c] / ls);
    if (half == 0) lse[(long long)bh * Sq + qpos] = m + logf(ls);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int G, int Sq, int Sk,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, int window, const int* qseg,
                   const int* kseg, long long seg_b, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, G, Sq, Sk, qs,
      ks, vs, os, scale, causal, window, qseg, kseg, seg_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int H, int G, int Sq,
                       int Sk, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, int causal, int window,
                       const int* qseg, const int* kseg, long long seg_b,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, G, Sq, Sk, qs, ks, vs, os,
                           scale, causal, window, qseg, kseg, seg_b, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, G, Sq, Sk, qs, ks, vs, os,
                           scale, causal, window, qseg, kseg, seg_b, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, G, Sq, Sk, qs, ks, vs,
                            os, scale, causal, window, qseg, kseg, seg_b,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dkt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int dtype, int B, int H,
                             int G, int Sq, int Sk, int D, long long qsb,
                             long long qss, long long qsh, long long ksb,
                             long long kss, long long ksh, long long vsb,
                             long long vss, long long vsh, long long osb,
                             long long oss, long long osh, float scale,
                             int causal, int window, const int* qseg,
                             const int* kseg, long long seg_b,
                             void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, lse, B, H, G, Sq, Sk, qs, ks, vs,
                             os, scale, causal, window, qseg, kseg, seg_b,
                             st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, G, Sq, Sk, qs,
                                     ks, vs, os, scale, causal, window, qseg,
                                     kseg, seg_b, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
