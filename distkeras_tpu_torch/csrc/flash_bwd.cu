// Flash-attention backward for Hopper (sm_90a), float32 or bfloat16: two
// kernels, dq and dk/dv, recomputing the probabilities from the forward's
// row log-sum-exp so the score matrix never reaches device memory.
//
// Replaces the TPU kernels of distkeras_tpu/ops/flash_attention.py
// `_flash_backward_pallas` :515 on the training path:
//   * K1dq  (pl.pallas_call at :585, body `_bwd_dq_kernel` :349)
//       dq = scale * dS.K,  dS = P o (dO.V^T - delta),  P = exp(s - lse);
//   * K1dkv (pl.pallas_call at :619, body `_bwd_dkv_kernel` :440)
//       dv = P^T.dO,  dk = scale * dS^T.Q.
// delta = rowsum(dO o O) comes in from the wrapper (a float32 torch
// reduction, as the JAX package computes it outside its kernels, :537).
//
// Bound on this card: with P = B*H*Sq*Sk*D admitted pairs (about half of
// that when causal), dq does 6P operations (three products) and dk/dv 8P
// (four products) at 989 TFLOP/s bf16, against the bytes of q, k, v, dO,
// lse, delta and the outputs at 3.35 TB/s; at the training shape
// (B4 H16 S2048 D64) the operations bound both.
//
// Design (a simple kernel that is right first; wgmma/TMA, and a split
// over keys for dq, come later):
//   * dq: one block of 128 threads per (batch*head, 64-row query block);
//     its Q and dO tiles stay in shared memory while a loop inside the
//     block walks 64-key blocks. Thread t owns query row t/2 and every
//     other key column / head-dim column (interleaved, as in
//     flash_fwd.cu), so S and dP need no cross-thread reduction; the
//     dS tile goes through shared memory to the dS.K product.
//   * dk/dv: one block per (batch*kv head, 64-key block); its K and V
//     tiles stay in shared memory while it walks the G query heads of
//     its group and, for each, the query blocks from the causal diagonal
//     to the end (or to the sliding window's reach). Thread t owns key
//     row t/2. Summing the group inside the block needs no atomics and
//     equals the gradient of the JAX package's jnp.repeat of K/V.
//   * masks as `_bwd_dq_kernel._mask` :377-389: causal q_pos >= k_pos,
//     window k_pos > q_pos - window, ragged tail k_pos < Sk, with the
//     finite NEG_INF; query rows past Sq contribute exactly zero (never
//     exp of garbage), so no NaN can arise from padding.
//   * packed sequences (`_mask` :386-387 and :480-481): with segment ids
//     `admitted()` also requires qseg == kseg. The dq kernel loads each
//     key tile's ids into shared memory beside K; the dk/dv kernel reads
//     its key's id once and loads the q-side ids of every query block it
//     visits (they change per query block, not per key block). Each
//     thread folds its row's 32 comparisons for the tile into one 32-bit
//     mask before the unrolled loop, so the loop gains one register and
//     no memory access. A masked pair has P = exp(NEG_INF - lse) = 0
//     exactly, so a key no query of its segment sees gets exactly zero
//     gradient. No tile is skipped for its ids. The kernels are
//     templated on SEG: without ids (SEG = false, null pointers) the
//     mask folds away and the code is that of the kernels before ids.
//   * rounding points of the Pallas kernels: dS is rounded to K's dtype
//     before dS.K and to Q's dtype before dS^T.Q, P to dO's dtype before
//     P^T.dO; every product accumulates in float32; scale is applied to
//     the float32 accumulator once at the end.
//   * grouped queries (H = G * Hkv) read their shared K/V head directly.
// The MMA-free inner loops are shared-memory bound, like flash_fwd.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // query rows per tile
constexpr int BN = 64;   // keys per tile
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

// x rounded to T's precision, kept as a float
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

struct Strides {
  long long b, s, h;  // element strides; head_dim is contiguous
};

__device__ __forceinline__ bool admitted(int qp, int kp, int Sk, int causal,
                                         int window, bool same_segment) {
  bool ok = kp < Sk && same_segment;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// rows [r0, r0 + n) of a [S, D] slice (row stride `rs`) into a padded
// float tile; rows past `limit` read as zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int n,
                                          int limit) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < n * D; i += NT) {
    const int rr = i / D, dd = i % D;
    const int p = r0 + rr;
    dst[rr * DP + dd] = p < limit ? to_f<T>(src[p * rs + dd]) : 0.f;
  }
}

// bit i: does this thread's row share its id with the tile's row 2i+half
template <int N>
__device__ __forceinline__ unsigned same_mask(const int* ids, int id,
                                              int half) {
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) m |= unsigned(ids[2 * i + half] == id) << i;
  return m;
}

template <int D>
constexpr int dq_smem_floats() {
  return (2 * BM + 2 * BN) * (D + 1) + BM * (BN + 1) + BN;
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int G, int Sq, int Sk, Strides qs, Strides ks,
                    Strides vs, Strides gs, Strides dqs, float scale,
                    int causal, int window, const int* __restrict__ qseg,
                    const int* __restrict__ kseg, long long seg_b) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = BN + 1;
  float* Qs = smem;            // [BM][DP]
  float* Gs = Qs + BM * DP;    // [BM][DP] dO
  float* Ks = Gs + BM * DP;    // [BN][DP]
  float* Vs = Ks + BN * DP;    // [BN][DP]
  float* Ss = Vs + BN * DP;    // [BM][PP] dS, rounded to K's dtype
  int* Kseg = reinterpret_cast<int*>(Ss + BM * PP);  // [BN] key ids

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / G;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int qpos = q0 + r;
  const bool qvalid = qpos < Sq;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  load_tile<T, D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BM, Sq);
  load_tile<T, D>(Gs, dout + b * gs.b + h * gs.h, gs.s, q0, BM, Sq);
  const long long row = (long long)bh * Sq + qpos;
  const float row_lse = qvalid ? lse[row] : 0.f;
  const float row_delta = qvalid ? delta[row] : 0.f;
  const int rseg = (SEG && qvalid) ? qseg[b * seg_b + qpos] : 0;

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
    __syncthreads();  // the previous step's readers of Ks/Vs/Ss are done
    load_tile<T, D>(Ks, kb, ks.s, k0, BN, Sk);
    load_tile<T, D>(Vs, vb, vs.s, k0, BN, Sk);
    if (SEG) {
      for (int i = tid; i < BN; i += NT)
        Kseg[i] = k0 + i < Sk ? kseg[b * seg_b + k0 + i] : 0;
    }
    __syncthreads();
    const unsigned same = SEG ? same_mask<BN>(Kseg, rseg, half) : ~0u;

    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float qd = Qs[r * DP + dd];
      const float gd = Gs[r * DP + dd];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int j = 2 * i + half;
        s[i] = fmaf(qd, Ks[j * DP + dd], s[i]);
        dp[i] = fmaf(gd, Vs[j * DP + dd], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int j = 2 * i + half;
      float ds = 0.f;
      if (qvalid) {
        const float x =
            admitted(qpos, k0 + j, Sk, causal, window, (same >> i) & 1u)
                ? s[i] * scale
                : kNegInf;
        ds = expf(x - row_lse) * (dp[i] - row_delta);
      }
      Ss[r * PP + j] = round_to<T>(ds);
    }
    __syncthreads();  // the partner's half of the dS row is written
    for (int j = 0; j < BN; ++j) {
      const float d = Ss[r * PP + j];
#pragma unroll
      for (int c = 0; c < D / 2; ++c)
        acc[c] = fmaf(d, Ks[j * DP + 2 * c + half], acc[c]);
    }
  }

  if (qvalid) {
    T* ob = dq + b * dqs.b + h * dqs.h + qpos * dqs.s;
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      ob[2 * c + half] = from_f<T>(acc[c] * scale);
  }
}

template <int D>
constexpr int dkv_smem_floats() {
  return (2 * BN + 2 * BM) * (D + 1) + 2 * BN * (BM + 1) + 3 * BM;
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int G, int Sq, int Sk,
                     Strides qs, Strides ks, Strides vs, Strides gs,
                     Strides dks, Strides dvs, float scale, int causal,
                     int window, const int* __restrict__ qseg,
                     const int* __restrict__ kseg, long long seg_b) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = BM + 1;
  float* Ks = smem;            // [BN][DP]
  float* Vs = Ks + BN * DP;    // [BN][DP]
  float* Qs = Vs + BN * DP;    // [BM][DP]
  float* Gs = Qs + BM * DP;    // [BM][DP] dO
  float* Ps = Gs + BM * DP;    // [BN][PP] P^T, rounded to dO's dtype
  float* Ss = Ps + BN * PP;    // [BN][PP] dS^T, rounded to Q's dtype
  float* Ls = Ss + BN * PP;    // [BM] lse
  float* Es = Ls + BM;         // [BM] delta
  int* Qseg = reinterpret_cast<int*>(Es + BM);  // [BM] query ids

  const int Hkv = H / G;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int k0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;  // this thread's key row
  const int kpos = k0 + r;
  const int rseg = (SEG && kpos < Sk) ? kseg[b * seg_b + kpos] : 0;

  load_tile<T, D>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BN, Sk);
  load_tile<T, D>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BN, Sk);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  // query blocks that can see a key of this block: from the causal
  // diagonal on, up to the sliding window's reach
  const int k_last = min(k0 + BN, Sk) - 1;
  const int qb_begin = causal ? k0 / BM : 0;
  int qb_end = (Sq + BM - 1) / BM;
  if (window > 0) qb_end = min(qb_end, (k_last + window - 1) / BM + 1);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long bh = (long long)b * H + h;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* gb = dout + b * gs.b + h * gs.h;
    for (int qblk = qb_begin; qblk < qb_end; ++qblk) {
      const int q0 = qblk * BM;
      __syncthreads();  // the previous step's readers are done
      load_tile<T, D>(Qs, qb, qs.s, q0, BM, Sq);
      load_tile<T, D>(Gs, gb, gs.s, q0, BM, Sq);
      for (int i = tid; i < BM; i += NT) {
        const bool in = q0 + i < Sq;
        Ls[i] = in ? lse[bh * Sq + q0 + i] : 0.f;
        Es[i] = in ? delta[bh * Sq + q0 + i] : 0.f;
        if (SEG) Qseg[i] = in ? qseg[b * seg_b + q0 + i] : 0;
      }
      __syncthreads();
      const unsigned same = SEG ? same_mask<BM>(Qseg, rseg, half) : ~0u;

      float s[BM / 2], dp[BM / 2];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) s[i] = dp[i] = 0.f;
      for (int dd = 0; dd < D; ++dd) {
        const float kd = Ks[r * DP + dd];
        const float vd = Vs[r * DP + dd];
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) {
          const int qi = 2 * i + half;
          s[i] = fmaf(Qs[qi * DP + dd], kd, s[i]);
          dp[i] = fmaf(Gs[qi * DP + dd], vd, dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) {
        const int qi = 2 * i + half;
        const int qp = q0 + qi;
        float p = 0.f, ds = 0.f;
        if (qp < Sq) {
          const float x =
              admitted(qp, kpos, Sk, causal, window, (same >> i) & 1u)
                  ? s[i] * scale
                  : kNegInf;
          p = expf(x - Ls[qi]);
          ds = p * (dp[i] - Es[qi]);
        }
        Ps[r * PP + qi] = round_to<T>(p);
        Ss[r * PP + qi] = round_to<T>(ds);
      }
      __syncthreads();  // the partner's half of the P / dS rows is written
      for (int qi = 0; qi < BM; ++qi) {
        const float p = Ps[r * PP + qi];
        const float d = Ss[r * PP + qi];
#pragma unroll
        for (int c = 0; c < D / 2; ++c) {
          dv_acc[c] = fmaf(p, Gs[qi * DP + 2 * c + half], dv_acc[c]);
          dk_acc[c] = fmaf(d, Qs[qi * DP + 2 * c + half], dk_acc[c]);
        }
      }
    }
  }

  if (kpos < Sk) {
    T* kout = dk + b * dks.b + hk * dks.h + kpos * dks.s;
    T* vout = dv + b * dvs.b + hk * dvs.h + kpos * dvs.s;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) {
      kout[2 * c + half] = from_f<T>(dk_acc[c] * scale);
      vout[2 * c + half] = from_f<T>(dv_acc[c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, G, Sq, Sk;
  Strides qs, ks, vs, gs, dqs, dks, dvs;
  float scale;
  int causal, window;
  const int *qseg, *kseg;
  long long seg_b;
  cudaStream_t stream;
};

template <typename T, int D, bool SEG>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = sizeof(float) * dq_smem_floats<D>();
  auto kern = flash_bwd_dq_kernel<T, D, SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BM - 1) / BM, a.B * a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.H, a.G, a.Sq, a.Sk, a.qs, a.ks, a.vs,
      a.gs, a.dqs, a.scale, a.causal, a.window, a.qseg, a.kseg, a.seg_b);
  return cudaGetLastError();
}

template <typename T, int D, bool SEG>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = sizeof(float) * dkv_smem_floats<D>();
  auto kern = flash_bwd_dkv_kernel<T, D, SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + BN - 1) / BN, a.B * (a.H / a.G));
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.G, a.Sq,
      a.Sk, a.qs, a.ks, a.vs, a.gs, a.dks, a.dvs, a.scale, a.causal,
      a.window, a.qseg, a.kseg, a.seg_b);
  return cudaGetLastError();
}

template <bool DQ, typename T, bool SEG>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 32:
      return DQ ? launch_dq<T, 32, SEG>(a) : launch_dkv<T, 32, SEG>(a);
    case 64:
      return DQ ? launch_dq<T, 64, SEG>(a) : launch_dkv<T, 64, SEG>(a);
    case 128:
      return DQ ? launch_dq<T, 128, SEG>(a) : launch_dkv<T, 128, SEG>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool DQ, bool SEG>
cudaError_t dispatch_t(int dtype, int D, const Args& a) {
  if (dtype == 0) return dispatch_d<DQ, float, SEG>(D, a);
  if (dtype == 1) return dispatch_d<DQ, __nv_bfloat16, SEG>(D, a);
  return cudaErrorInvalidValue;
}

template <bool DQ>
cudaError_t dispatch(int dtype, int D, const Args& a) {
  if (a.qseg != nullptr && a.kseg != nullptr)
    return dispatch_t<DQ, true>(dtype, D, a);
  return dispatch_t<DQ, false>(dtype, D, a);
}

}  // namespace

extern "C" int dkt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int dtype, int B, int H,
    int G, int Sq, int Sk, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long gsb,
    long long gss, long long gsh, long long dqsb, long long dqss,
    long long dqsh, float scale, int causal, int window, const int* qseg,
    const int* kseg, long long seg_b, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq;
  a.B = B; a.H = H; a.G = G; a.Sq = Sq; a.Sk = Sk;
  a.qs = {qsb, qss, qsh}; a.ks = {ksb, kss, ksh}; a.vs = {vsb, vss, vsh};
  a.gs = {gsb, gss, gsh}; a.dqs = {dqsb, dqss, dqsh};
  a.scale = scale; a.causal = causal; a.window = window;
  a.qseg = qseg; a.kseg = kseg; a.seg_b = seg_b;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(dtype, D, a);
}

extern "C" int dkt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int dtype,
    int B, int H, int G, int Sq, int Sk, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long gsb,
    long long gss, long long gsh, long long dksb, long long dkss,
    long long dksh, long long dvsb, long long dvss, long long dvsh,
    float scale, int causal, int window, const int* qseg, const int* kseg,
    long long seg_b, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.G = G; a.Sq = Sq; a.Sk = Sk;
  a.qs = {qsb, qss, qsh}; a.ks = {ksb, kss, ksh}; a.vs = {vsb, vss, vsh};
  a.gs = {gsb, gss, gsh}; a.dks = {dksb, dkss, dksh};
  a.dvs = {dvsb, dvss, dvsh};
  a.scale = scale; a.causal = causal; a.window = window;
  a.qseg = qseg; a.kseg = kseg; a.seg_b = seg_b;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(dtype, D, a);
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
