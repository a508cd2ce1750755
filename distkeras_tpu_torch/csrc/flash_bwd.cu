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
// (B4 H16 S2048 D64) the operations bound both. Only the tensor cores
// come near that rate, and each score needs an exp and a few float32
// operations beside its products, so the design keeps the products on
// wgmma and the per-score work in registers.
//
// bf16 at D = 64 and 128 (namespace tc):
//   * dq: one block per (batch*head, 128 query rows): two consumer
//     warpgroups of 64 rows and one producer warp. The producer brings
//     the block's Q and dO tiles once, then keeps a ring of 3 stages of
//     (K, V) 64-key tiles filled, from the window's first key block to
//     the causal diagonal (an mbarrier per stage that the copies
//     complete, and one that the consumers' warps release). Per key
//     tile, each warpgroup issues S = Q.K^T and dP = dO.V^T by wgmma
//     (both operands K-major, as stored; one commit group each), forms
//     P = exp(S*scale - lse) in registers while dP is still being
//     multiplied, then dS = P o (dP - delta), rounds dS to bf16 in
//     wgmma's A-fragment layout (the m64nNk16 accumulator converts
//     element for element) and adds dS.K by wgmma with A from registers
//     and the same K tile read MN-major through the transpose bit. The
//     float32 dq accumulator stays in registers; the epilogue scales it
//     once and writes bf16. The longest causal walks are scheduled first.
//   * dk/dv: one block per (batch*kv head, 128 key rows), the key rows
//     as wgmma's M. K and V come in once; the ring carries (Q, dO)
//     64-row tiles with their lse / delta (and ids) rows over the G
//     query heads of the group and, for each, the query blocks from the
//     causal diagonal to the window's reach. Per tile S^T = K.Q^T and
//     dP^T = V.dO^T by wgmma, P^T in registers, dV += P^T.dO issued
//     while dS^T = P^T o (dP^T - delta) is formed, then dK += dS^T.Q,
//     both with A from registers and B (dO, Q) read MN-major. The
//     group's sum stays in the block: no atomics. Nine warps leave 168
//     registers a thread, which two dk/dv warpgroups fill at D = 64:
//     at D = 128, with ids and without TMA a block runs one warpgroup
//     (64 key rows).
//   * copies: a 4-d TMA map per operand (head_dim, positions, heads,
//     batch, with the wrapper's strides: both layouts), boxes of [rows]
//     [64] in the 128-byte swizzle, TMA's zero fill past the end. Where
//     a base or stride is not a multiple of 16 bytes the producer warp
//     copies the same layout element by element (compiled per
//     instantiation: TMA or not).
//   * the exp is 2^(S * scale*log2(e) - lse*log2(e)): one FFMA and one
//     ex2.approx a score. The SFU's 16 exps a cycle an SM and the tensor
//     cores then bound a tile about equally.
//   * masks cost only where they cut: a tile wholly inside the causal /
//     window band (no ids, no ragged tail) skips the mask; a warpgroup
//     skips a tile its rows cannot see at all (its P is exactly 0).
//   * the same rounding points as the Pallas kernels, which are exactly
//     wgmma's bf16 operands: S and dP from the bf16 inputs with float32
//     accumulation, dS rounded to bf16 before dS.K and dS^T.Q, P before
//     P^T.dO, scale on the float32 accumulator at the end. A masked pair
//     has P = 2^((NEG_INF - lse)*log2(e)) = 0 exactly, and the masked and
//     mask-free tiles compute an admitted pair with the same
//     instructions, so all-equal ids give bitwise the result of no ids.
//     The products are summed in a fixed order: the same inputs give the
//     same bits.
//   * the price of no atomics: dq's kernel recomputes S and dP, so the
//     pair does seven products where a kernel that adds dq atomically
//     does five.
//
// float32, and bf16 at D = 8, 12, 16 and 32 (namespace simt), keep the
// CUDA-core kernels: TF32 would break the float32 gradient checks at 1e-4.
//   * dq: one block of 128 threads per (batch*head, 64-row query block);
//     its Q and dO tiles stay in shared memory while a loop inside the
//     block walks 64-key blocks. Thread t owns query row t/2 and every
//     other key column / head-dim column (interleaved, as in
//     flash_fwd.cu), so S and dP need no cross-thread reduction; the
//     dS tile goes through shared memory to the dS.K product.
//   * dk/dv: one block per (batch*kv head, 64-key block), walking the G
//     query heads of its group as above; thread t owns key row t/2.
//   * ids: each thread folds its row's 32 comparisons for the tile into
//     one 32-bit mask before the unrolled loop.
//
// Both: masks as `_bwd_dq_kernel._mask` :377-389 (causal q_pos >= k_pos,
// window k_pos > q_pos - window, ragged tail k_pos < Sk, with the finite
// NEG_INF) and, with packed-sequence ids, qseg == kseg (`_mask` :386-387
// and :480-481); query rows past Sq contribute exactly zero; no tile is
// skipped for its ids; grouped queries (H = G * Hkv) read their shared
// K/V head directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

using sm90::Strides;

__device__ __forceinline__ bool admitted(int qp, int kp, int Sk, int causal,
                                         int window, bool same_segment) {
  bool ok = kp < Sk && same_segment;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
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

// --- float32, and bf16 at D <= 32: FMAs on the CUDA cores ------------------
namespace simt {


constexpr int BM = 64;   // query rows per tile
constexpr int BN = 64;   // keys per tile
constexpr int NT = 128;  // threads per block

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


}  // namespace simt

// --- bf16 at D = 64 and 128: wgmma on the tensor cores ---------------------
namespace tc {

using namespace sm90;

constexpr int BN = 64;      // keys a dq stage
constexpr int BQ = 64;      // query rows a dk/dv stage
constexpr int STAGES = 3;   // the ring of either kernel

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU: one instruction (2 ulp; a result below 2^-126 flushes
// to 0, far below P's bf16 rounding)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// consumer warpgroups (64 rows each) of a block. Nine warps leave a
// thread 168 registers; a dk/dv warpgroup holds two D-wide accumulators
// beside its two score tiles, so only the plain D = 64 walk fits two
// warpgroups: at D = 128, with ids (the mask's reads) and without TMA
// (the copy loop) the second warpgroup would spill, and a block runs one
// (five warps: 255 registers).
constexpr int DQ_WGS = 2;
template <int D, bool TMA, bool SEG>
__host__ __device__ constexpr int dkv_wgs() {
  return D == 64 && TMA && !SEG ? 2 : 1;
}
// the consumers and one producer warp
__host__ __device__ constexpr int threads(int wgs) {
  return 128 * wgs + 32;
}

struct Params {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int H, G, Sq, Sk;
  Strides qs, ks, vs, gs, dqs, dks, dvs;
  float scale;
  int causal, window;
  const int *qseg, *kseg;
  long long seg_b;
  int hfirst;  // bit i (0 q, 1 k, 2 v, 3 dout): map i's second dim is heads
};

// dq: S (in sc) -> P = exp(S * scale - lse) (in sc) for this thread's two
// query rows (j = 0: the accumulator's row, 1: eight rows down) and the
// stage's keys k0.., as 2^(S * scale*log2(e) - lse*log2(e)) (nl2 = -lse *
// log2(e), sl2 = scale * log2(e)): one FFMA and one ex2 a score. A masked
// pair, and a row past Sq (whose lse reads 0), gets exp(NEG_INF - lse) =
// 0; a pair the mask admits takes the same two instructions with or
// without the mask.
template <bool MASK, bool SEG>
__device__ __forceinline__ void dq_probs(float (&sc)[BN / 2],
                                         const int* kseg, int k0,
                                         const int (&qpos)[2],
                                         const float (&lse)[2],
                                         const float (&nl2)[2], float sl2,
                                         const int (&seg)[2],
                                         const Params& p) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int j = (i % 4) / 2;
    float x = __fmaf_rn(sc[i], sl2, nl2[j]);
    if (MASK) {
      const int col = acc_col(i);
      if (!(qpos[j] < p.Sq &&
            admitted(qpos[j], k0 + col, p.Sk, p.causal, p.window,
                     !SEG || kseg[col] == seg[j])))
        x = __fmul_rn(__fsub_rn(kNegInf, lse[j]), kLog2e);
    }
    sc[i] = ex2(x);
  }
}

// dk/dv: S^T (in sc) -> P^T (in sc) for this thread's two key rows and
// the stage's queries q0.. (their lse and ids in shared memory), as in
// dq_probs; a query past Sq reads lse 0 and gets P = 0
template <bool MASK, bool SEG>
__device__ __forceinline__ void dkv_probs(float (&sc)[BQ / 2],
                                          const float* ls, const int* qseg,
                                          int q0, float sl2,
                                          const int (&kpos)[2],
                                          const int (&seg)[2],
                                          const Params& p) {
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) {
    const int j = (i % 4) / 2;
    const int col = acc_col(i);
    float x = __fmaf_rn(sc[i], sl2, __fmul_rn(ls[col], -kLog2e));
    if (MASK) {
      const int qp = q0 + col;
      if (!(qp < p.Sq && admitted(qp, kpos[j], p.Sk, p.causal, p.window,
                                  !SEG || qseg[col] == seg[j])))
        x = __fmul_rn(__fsub_rn(kNegInf, ls[col]), kLog2e);
    }
    sc[i] = ex2(x);
  }
}

// grid (ceil(Sq / 128), B*H)
template <int D, bool SEG, bool TMA>
__global__ void __launch_bounds__(threads(DQ_WGS), 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mg,
                        const Params p) {
  constexpr int R = 64 * DQ_WGS;       // query rows of the block
  constexpr int TQ = R * D * 2;        // bytes of the Q (or dO) tile
  constexpr int TK = BN * D * 2;       // of a stage's K (or V) tile
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[2 * STAGES + 1];
  const uint32_t base = ring_base(smem);
  const uint32_t Qs = base, Gs = base + TQ, ring = base + 2 * TQ;
  int* kseg_s = reinterpret_cast<int*>(smem + (base - smem_u32(smem)) +
                                       2 * TQ + STAGES * 2 * TK);
  const uint32_t full = init_bars<STAGES, DQ_WGS>(bar_mem);
  const uint32_t empty = full + 8 * STAGES, once = full + 16 * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;  // longest walks first
  const int q_last = min(q0 + R, p.Sq) - 1;
  int kb_end = (p.Sk + BN - 1) / BN;
  if (p.causal) kb_end = min(kb_end, q_last / BN + 1);
  const int kb_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BN : 0;
  const int n = kb_end - kb_begin;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 4 * DQ_WGS) {  // the producer
    begin_stage<TMA>(once, 2 * TQ, lane);
    load_rows<R, D, TMA>(Qs, &mq, p.hfirst & 1, p.q, p.qs, p.Sq, b, h, q0,
                         once, lane);
    load_rows<R, D, TMA>(Gs, &mg, p.hfirst & 8, p.dout, p.gs, p.Sq, b, h,
                         q0, once, lane);
    end_stage<TMA>(once, lane);
    for (int t = 0; t < n; ++t) {
      const int s = t % STAGES;
      bar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
      const int k0 = (kb_begin + t) * BN;
      if (SEG) {
        for (int i = lane; i < BN; i += 32)
          kseg_s[s * BN + i] =
              k0 + i < p.Sk ? p.kseg[b * p.seg_b + k0 + i] : 0;
      }
      begin_stage<TMA>(full + 8 * s, 2 * TK, lane);
      const uint32_t st = ring + s * 2 * TK;
      load_rows<BN, D, TMA>(st, &mk, p.hfirst & 2, p.k, p.ks, p.Sk, b, hk,
                            k0, full + 8 * s, lane);
      load_rows<BN, D, TMA>(st + TK, &mv, p.hfirst & 4, p.v, p.vs, p.Sk, b,
                            hk, k0, full + 8 * s, lane);
      end_stage<TMA>(full + 8 * s, lane);
    }
    return;
  }

  // a consumer warpgroup: query rows qa .. qa + 63
  const int wg = warp / 4;
  const int qa = q0 + 64 * wg;
  int qpos[2], seg[2];
  float lse[2], delta[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    qpos[j] = q0 + acc_row(2 * j);
    const bool in = qpos[j] < p.Sq;
    const long long row = (long long)bh * p.Sq + qpos[j];
    lse[j] = in ? p.lse[row] : 0.f;
    delta[j] = in ? p.delta[row] : 0.f;
    seg[j] = (SEG && in) ? p.qseg[b * p.seg_b + qpos[j]] : 0;
  }
  float acc[D / 2];
  zero(acc);
  const float sl2 = __fmul_rn(p.scale, kLog2e);
  const float nl2[2] = {__fmul_rn(lse[0], -kLog2e),
                        __fmul_rn(lse[1], -kLog2e)};
  bar_wait(once, 0);
  for (int t = 0; t < n; ++t) {
    const int s = t % STAGES;
    const int k0 = (kb_begin + t) * BN;
    const uint32_t Ks = ring + s * 2 * TK, Vs = Ks + TK;
    bar_wait(full + 8 * s, (t / STAGES) & 1);
    // no pair of the warpgroup's rows and the tile's keys is admitted
    const bool skip = qa >= p.Sq || (p.causal && k0 > qa + 63) ||
                      (p.window > 0 && k0 + BN - 1 <= qa - p.window);
    if (!skip) {
      // S = Q.K^T and dP = dO.V^T, one commit group each: P is formed
      // while dP is still being multiplied
      float sc[BN / 2], dp[BN / 2];
      zero(sc);
      zero(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma<0, 0>(sc, desc(Qs + (kk / 4) * (R * 128) + wg * (64 * 128) +
                                 (kk % 4) * 32, 16, 1024),
                    desc(Ks + (kk / 4) * (BN * 128) + (kk % 4) * 32, 16,
                         1024));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma<0, 0>(dp, desc(Gs + (kk / 4) * (R * 128) + wg * (64 * 128) +
                                 (kk % 4) * 32, 16, 1024),
                    desc(Vs + (kk / 4) * (BN * 128) + (kk % 4) * 32, 16,
                         1024));
      wgmma_commit();
      wgmma_wait<1>();  // S
      fence_acc(sc);
      // every pair admitted: the tile lies inside the band, no ids
      const bool inside = !SEG && qa + 63 < p.Sq && k0 + BN <= p.Sk &&
                          (!p.causal || k0 + BN - 1 <= qa) &&
                          (p.window <= 0 || k0 > qa + 63 - p.window);
      if (inside)
        dq_probs<false, SEG>(sc, kseg_s + s * BN, k0, qpos, lse, nl2, sl2,
                             seg, p);
      else
        dq_probs<true, SEG>(sc, kseg_s + s * BN, k0, qpos, lse, nl2, sl2,
                            seg, p);
      wgmma_wait<0>();  // dP
      fence_acc(dp);
      // dS = P o (dP - delta), rounded to bf16 as the A operand of dS.K
      uint32_t a[BN / 16][4];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        sc[i] = __fmul_rn(sc[i], __fsub_rn(dp[i], delta[(i % 4) / 2]));
      acc_to_a<BN>(sc, a);
      wgmma_fence();
      // dq += dS.K: K's rows are the depth, read through the transpose
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<1>(acc, a[kk], desc(Ks + kk * 2048, BN * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_regs(a);
    }
    release(empty + 8 * s, lane);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (qpos[j] >= p.Sq) continue;
    bf16* out = p.dq + b * p.dqs.b + h * p.dqs.h + qpos[j] * p.dqs.s;
#pragma unroll
    for (int i = 2 * j; i < D / 2; i += 4)
      *reinterpret_cast<uint32_t*>(out + acc_col(i)) =
          pack_bf16(acc[i] * p.scale, acc[i + 1] * p.scale);
  }
}

// grid (ceil(Sk / (64 * dkv_wgs)), B*Hkv)
template <int D, bool SEG, bool TMA>
__global__ void __launch_bounds__(threads(dkv_wgs<D, TMA, SEG>()), 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mg,
                         const Params p) {
  constexpr int WGS = dkv_wgs<D, TMA, SEG>();
  constexpr int R = 64 * WGS;          // key rows of the block
  constexpr int TK = R * D * 2;        // bytes of the K (or V) tile
  constexpr int TQ = BQ * D * 2;       // of a stage's Q (or dO) tile
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[2 * STAGES + 1];
  const uint32_t base = ring_base(smem);
  const uint32_t Ks = base, Vs = base + TK, ring = base + 2 * TK;
  // per stage: lse [BQ], delta [BQ]; then per stage the query ids [BQ]
  float* rows = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) +
                                         2 * TK + STAGES * 2 * TQ);
  int* qseg_s = reinterpret_cast<int*>(rows + STAGES * 2 * BQ);
  const uint32_t full = init_bars<STAGES, WGS>(bar_mem);
  const uint32_t empty = full + 8 * STAGES, once = full + 16 * STAGES;

  const int Hkv = p.H / p.G;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int k0 = blockIdx.x * R;
  // query blocks that can see a key of this block: from the causal
  // diagonal on, up to the sliding window's reach
  const int k_last = min(k0 + R, p.Sk) - 1;
  const int qb_begin = p.causal ? k0 / BQ : 0;
  int qb_end = (p.Sq + BQ - 1) / BQ;
  if (p.window > 0) qb_end = min(qb_end, (k_last + p.window - 1) / BQ + 1);
  const int nq = max(qb_end - qb_begin, 0);
  const int n = p.G * nq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 4 * WGS) {  // the producer
    begin_stage<TMA>(once, 2 * TK, lane);
    load_rows<R, D, TMA>(Ks, &mk, p.hfirst & 2, p.k, p.ks, p.Sk, b, hk, k0,
                         once, lane);
    load_rows<R, D, TMA>(Vs, &mv, p.hfirst & 4, p.v, p.vs, p.Sk, b, hk, k0,
                         once, lane);
    end_stage<TMA>(once, lane);
    for (int t = 0; t < n; ++t) {
      const int s = t % STAGES;
      bar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
      const int h = hk * p.G + t / nq;
      const int q0 = (qb_begin + t % nq) * BQ;
      const long long bh = (long long)b * p.H + h;
      float* ls = rows + s * 2 * BQ;
      for (int i = lane; i < BQ; i += 32) {
        const bool in = q0 + i < p.Sq;
        ls[i] = in ? p.lse[bh * p.Sq + q0 + i] : 0.f;
        ls[BQ + i] = in ? p.delta[bh * p.Sq + q0 + i] : 0.f;
        if (SEG) qseg_s[s * BQ + i] = in ? p.qseg[b * p.seg_b + q0 + i] : 0;
      }
      begin_stage<TMA>(full + 8 * s, 2 * TQ, lane);
      const uint32_t st = ring + s * 2 * TQ;
      load_rows<BQ, D, TMA>(st, &mq, p.hfirst & 1, p.q, p.qs, p.Sq, b, h,
                            q0, full + 8 * s, lane);
      load_rows<BQ, D, TMA>(st + TQ, &mg, p.hfirst & 8, p.dout, p.gs, p.Sq,
                            b, h, q0, full + 8 * s, lane);
      end_stage<TMA>(full + 8 * s, lane);
    }
    return;
  }

  // a consumer warpgroup: key rows ka .. ka + 63
  const int wg = warp / 4;
  const int ka = k0 + 64 * wg;
  int kpos[2], seg[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    kpos[j] = k0 + acc_row(2 * j);
    seg[j] = (SEG && kpos[j] < p.Sk) ? p.kseg[b * p.seg_b + kpos[j]] : 0;
  }
  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  const float sl2 = __fmul_rn(p.scale, kLog2e);
  bar_wait(once, 0);
  for (int t = 0; t < n; ++t) {
    const int s = t % STAGES;
    const int q0 = (qb_begin + t % nq) * BQ;
    const uint32_t Qs = ring + s * 2 * TQ, Gs = Qs + TQ;
    bar_wait(full + 8 * s, (t / STAGES) & 1);
    // no pair of the tile's queries and the warpgroup's keys is admitted
    const bool skip = ka >= p.Sk || (p.causal && q0 + BQ - 1 < ka) ||
                      (p.window > 0 && ka + 63 <= q0 - p.window);
    if (!skip) {
      // S^T = K.Q^T and dP^T = V.dO^T, one commit group each
      float sc[BQ / 2], dp[BQ / 2];
      zero(sc);
      zero(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma<0, 0>(sc, desc(Ks + (kk / 4) * (R * 128) + wg * (64 * 128) +
                                 (kk % 4) * 32, 16, 1024),
                    desc(Qs + (kk / 4) * (BQ * 128) + (kk % 4) * 32, 16,
                         1024));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma<0, 0>(dp, desc(Vs + (kk / 4) * (R * 128) + wg * (64 * 128) +
                                 (kk % 4) * 32, 16, 1024),
                    desc(Gs + (kk / 4) * (BQ * 128) + (kk % 4) * 32, 16,
                         1024));
      wgmma_commit();
      wgmma_wait<1>();  // S^T
      fence_acc(sc);
      // every pair admitted: the tile lies inside the band, no ids
      const bool inside = !SEG && q0 + BQ <= p.Sq && ka + 64 <= p.Sk &&
                          (!p.causal || q0 >= ka + 63) &&
                          (p.window <= 0 || ka > q0 + BQ - 1 - p.window);
      const float* ls = rows + s * 2 * BQ;
      if (inside)
        dkv_probs<false, SEG>(sc, ls, qseg_s + s * BQ, q0, sl2, kpos, seg,
                              p);
      else
        dkv_probs<true, SEG>(sc, ls, qseg_s + s * BQ, q0, sl2, kpos, seg,
                             p);
      // dv += P^T.dO (P^T rounded to bf16; the query rows are the depth,
      // read through the transpose) runs while dS^T is formed
      uint32_t a[BQ / 16][4];
      acc_to_a<BQ>(sc, a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<1>(dv, a[kk], desc(Gs + kk * 2048, BQ * 128, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T
      fence_acc(dp);
      // dS^T = P^T o (dP^T - delta)
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        dp[i] = __fmul_rn(sc[i], __fsub_rn(dp[i], ls[BQ + acc_col(i)]));
      wgmma_wait<0>();  // dv: its A operand's registers are free
      fence_acc(dv);
      fence_regs(a);
      // dk += dS^T.Q
      acc_to_a<BQ>(dp, a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<1>(dk, a[kk], desc(Qs + kk * 2048, BQ * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dk);
      fence_regs(a);
    }
    release(empty + 8 * s, lane);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (kpos[j] >= p.Sk) continue;
    bf16* kout = p.dk + b * p.dks.b + hk * p.dks.h + kpos[j] * p.dks.s;
    bf16* vout = p.dv + b * p.dvs.b + hk * p.dvs.h + kpos[j] * p.dvs.s;
#pragma unroll
    for (int i = 2 * j; i < D / 2; i += 4) {
      const int c = acc_col(i);
      *reinterpret_cast<uint32_t*>(kout + c) =
          pack_bf16(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(vout + c) = pack_bf16(dv[i], dv[i + 1]);
    }
  }
}

Params params(const Args& a) {
  Params p{};
  p.q = static_cast<const bf16*>(a.q);
  p.k = static_cast<const bf16*>(a.k);
  p.v = static_cast<const bf16*>(a.v);
  p.dout = static_cast<const bf16*>(a.dout);
  p.lse = a.lse;
  p.delta = a.delta;
  p.dq = static_cast<bf16*>(a.dq);
  p.dk = static_cast<bf16*>(a.dk);
  p.dv = static_cast<bf16*>(a.dv);
  p.H = a.H; p.G = a.G; p.Sq = a.Sq; p.Sk = a.Sk;
  p.qs = a.qs; p.ks = a.ks; p.vs = a.vs; p.gs = a.gs;
  p.dqs = a.dqs; p.dks = a.dks; p.dvs = a.dvs;
  p.scale = a.scale; p.causal = a.causal; p.window = a.window;
  p.qseg = a.qseg; p.kseg = a.kseg; p.seg_b = a.seg_b;
  return p;
}

// the four operands' maps (q and dO in boxes of qrows, k and v of krows)
// when TMA takes all four; *tma says which
cudaError_t maps(const Args& a, int D, int qrows, int krows, CUtensorMap* m,
                 Params* p, bool* tma) {
  memset(m, 0, 4 * sizeof(CUtensorMap));
  const int Hkv = a.H / a.G;
  *tma = tma_ok(a.q, a.qs, a.Sq, a.H, a.B) &&
         tma_ok(a.k, a.ks, a.Sk, Hkv, a.B) &&
         tma_ok(a.v, a.vs, a.Sk, Hkv, a.B) &&
         tma_ok(a.dout, a.gs, a.Sq, a.H, a.B);
  if (!*tma) return cudaSuccess;
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  const Strides st[4] = {a.qs, a.ks, a.vs, a.gs};
  const int S[4] = {a.Sq, a.Sk, a.Sk, a.Sq};
  const int H[4] = {a.H, Hkv, Hkv, a.H};
  const int rows[4] = {qrows, krows, krows, qrows};
  for (int i = 0; i < 4; ++i) {
    bool hf = false;
    const cudaError_t err =
        flash_map(m + i, &hf, base[i], D, S[i], H[i], a.B, st[i], rows[i]);
    if (err != cudaSuccess) return err;
    p->hfirst |= hf ? 1 << i : 0;
  }
  return cudaSuccess;
}

template <typename K>
cudaError_t run(K* kern, int smem, dim3 grid, int nthreads,
                const CUtensorMap* m, const Params& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, nthreads, smem, st>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t launch_dq(const Args& a) {
  constexpr int R = 64 * DQ_WGS;
  const int smem = 1024 + 2 * R * D * 2 + STAGES * 2 * BN * D * 2 +
                   STAGES * BN * 4;
  Params p = params(a);
  CUtensorMap m[4];
  bool tma;
  const cudaError_t err = maps(a, D, R, BN, m, &p, &tma);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + R - 1) / R, a.B * a.H);
  return tma ? run(flash_bwd_dq_kernel<D, SEG, true>, smem, grid,
                   threads(DQ_WGS), m, p, a.stream)
             : run(flash_bwd_dq_kernel<D, SEG, false>, smem, grid,
                   threads(DQ_WGS), m, p, a.stream);
}

template <int D, bool SEG, bool TMA>
cudaError_t launch_dkv_as(const Args& a, const CUtensorMap* m,
                          const Params& p) {
  constexpr int R = 64 * dkv_wgs<D, TMA, SEG>();
  const int smem = 1024 + 2 * R * D * 2 + STAGES * 2 * BQ * D * 2 +
                   STAGES * 3 * BQ * 4;
  const dim3 grid((a.Sk + R - 1) / R, a.B * (a.H / a.G));
  return run(flash_bwd_dkv_kernel<D, SEG, TMA>, smem, grid,
             threads(dkv_wgs<D, TMA, SEG>()), m, p, a.stream);
}

template <int D, bool SEG>
cudaError_t launch_dkv(const Args& a) {
  Params p = params(a);
  CUtensorMap m[4];
  bool tma;
  const cudaError_t err =
      maps(a, D, BQ, 64 * dkv_wgs<D, true, SEG>(), m, &p, &tma);
  if (err != cudaSuccess) return err;
  return tma ? launch_dkv_as<D, SEG, true>(a, m, p)
             : launch_dkv_as<D, SEG, false>(a, m, p);
}

}  // namespace tc

template <bool DQ, typename T, int D, bool SEG>
cudaError_t launch_simt(const Args& a) {
  return DQ ? simt::launch_dq<T, D, SEG>(a) : simt::launch_dkv<T, D, SEG>(a);
}

template <bool DQ, int D, bool SEG>
cudaError_t launch_tc(const Args& a) {
  return DQ ? tc::launch_dq<D, SEG>(a) : tc::launch_dkv<D, SEG>(a);
}

template <bool DQ, bool SEG>
cudaError_t dispatch_t(int dtype, int D, const Args& a) {
  if (dtype == 0) {
    switch (D) {
      case 8: return launch_simt<DQ, float, 8, SEG>(a);
      case 12: return launch_simt<DQ, float, 12, SEG>(a);
      case 16: return launch_simt<DQ, float, 16, SEG>(a);
      case 32: return launch_simt<DQ, float, 32, SEG>(a);
      case 64: return launch_simt<DQ, float, 64, SEG>(a);
      case 128: return launch_simt<DQ, float, 128, SEG>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 8: return launch_simt<DQ, __nv_bfloat16, 8, SEG>(a);
      case 12: return launch_simt<DQ, __nv_bfloat16, 12, SEG>(a);
      case 16: return launch_simt<DQ, __nv_bfloat16, 16, SEG>(a);
      case 32: return launch_simt<DQ, __nv_bfloat16, 32, SEG>(a);
      case 64: return launch_tc<DQ, 64, SEG>(a);
      case 128: return launch_tc<DQ, 128, SEG>(a);
      default: return cudaErrorInvalidValue;
    }
  }
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
