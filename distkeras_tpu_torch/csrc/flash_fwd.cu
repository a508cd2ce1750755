// Flash-attention forward for Hopper (sm_90a), float32 or bfloat16.
//
// Replaces the TPU kernel distkeras_tpu/ops/flash_attention.py
// `_flash_forward` (pl.pallas_call at :321, body `_fwd_kernel` :125, mask
// :176-191, merge :193-208) on the serving path (one-pass prompt prefill
// and both passes of chunked prefill) and in training. Returns out (q's
// dtype) and the row log-sum-exp (float32, natural log).
//
// Bound on this card: 4*B*H*P*D operations for P admitted (query, key)
// pairs (about Sq*Sk/2 when causal) at 989 TFLOP/s bf16, against the
// q/k/v/out bytes at 3.35 TB/s; at the prefill and training shapes
// (Sq = Sk >= 256, D = 64) the operations bound it. Only the tensor cores
// come near that rate, and each score needs an exp and a few float32
// operations beside its two products, so the design keeps both products
// on wgmma and the per-score work in registers.
//
// bf16 at D = 64 and 128 (namespace tc), after flash_bwd.cu's dq kernel:
//   * one block per (batch*head, 128 query rows): two consumer
//     warpgroups of 64 rows and one producer warp; the longest causal
//     walks are scheduled first. Where 128-row blocks would fill fewer
//     blocks than the card has SMs (small serving grids), a block runs
//     one warpgroup (64 rows) and the grid doubles.
//   * the producer brings the block's Q tile once, then keeps a ring of 3
//     stages of (K, V) tiles filled (128 keys at D = 64, 64 at D = 128),
//     from the window's first key block to the causal diagonal (all of Sk
//     when not causal): an mbarrier per stage that the copies complete,
//     and one that the consumers' warps release. With segment ids each
//     stage also carries its key ids.
//   * per key tile a warpgroup issues S = Q.K^T by wgmma (both operands
//     K-major, as stored), takes the online softmax on the accumulator in
//     registers (each thread holds two rows; the row max across the quad
//     by two shuffles), rescales O by alpha, rounds P to bf16 in wgmma's
//     A-fragment layout (the m64nNk16 accumulator converts element for
//     element) and adds P.V by wgmma with A from registers and the same
//     stage's V tile read MN-major through the transpose bit. The 128-key
//     tile at D = 64 halves the tiles, and with them each tile's fixed
//     costs (barrier waits, shuffles, the latency of the wgmma chains);
//     at D = 128 the O accumulator leaves the registers for 64 keys.
//   * the softmax runs in base 2 with the scale folded in: m is the row
//     max of S * scale*log2(e), p = 2^(S * scale*log2(e) - m) is one FFMA
//     and one ex2.approx. A masked pair enters as S = -inf, so its p is
//     2^-inf = 0 whatever m is: m starts at the finite NEG_INF and is
//     real once any pair is admitted, so -m never overflows and no pair
//     needs another formula (a row whose tiles so far are all masked
//     carries m = NEG_INF, l = 0, O = 0 and alpha = 1; the first admitted
//     key gives alpha = 2^(NEG_INF - m) = 0).
//   * l, the row sum, is kept in float32 from the unrounded p (each
//     thread's share, summed across the quad once at the end); P is
//     rounded to bf16 only as the operand of P.V, as `_fwd_kernel`
//     :203-205 does. The epilogue writes O / l (1 for an empty row) in
//     bf16 and lse = m*ln(2) + log(l) (NEG_INF for an empty row).
//   * masks cost only where they cut: a tile wholly inside the causal /
//     window band with no ids and no ragged key tail skips the mask; a
//     warpgroup skips a tile its 64 rows cannot see at all; no tile is
//     skipped for its ids. A masked and a mask-free tile compute an
//     admitted pair with the same instructions, so all-equal ids give
//     bitwise the result of no ids; no atomics and a fixed summation
//     order, so the same inputs give the same bits.
//   * copies: a 4-d TMA map per operand (head_dim, positions, heads,
//     batch, with the wrapper's strides: both layouts and the strided
//     cache-prefix views of chunked prefill), boxes of [rows][64] in the
//     128-byte swizzle, TMA's zero fill past the end. Where a base or
//     stride is not a multiple of 16 bytes the producer warp copies the
//     same layout element by element (compiled per instantiation).
//
// float32, and bf16 at D = 8, 12, 16 and 32 (namespace simt), keep the
// CUDA-core kernel: TF32 would break the float32 limits, and a head dim
// under 64 leaves wgmma's 16-deep steps with little to do.
//   * one block of 128 threads per (batch*head, 64-row query block); a
//     loop inside the block walks 64-key blocks, the online-softmax state
//     (m, l, acc) stays in registers the whole sweep;
//   * thread t owns query row t/2 and every other key column / head-dim
//     column (interleaved, so the two threads of a row read neighbouring
//     shared-memory banks); the row max and sum combine across the pair
//     with one shuffle;
//   * the tiles are converted to float32 on load; P goes through shared
//     memory to the P.V loop;
//   * a row whose first visited tiles are wholly masked carries m =
//     NEG_INF with alpha = 1 through them (each masked element adds
//     exp(0) to l and its V row to acc, all finite); the first admitted
//     key raises m to a real score and its alpha = exp(NEG_INF - m) is
//     exactly 0, which clears that residue.
//
// Both: masks as `_fwd_kernel` (causal k_pos <= q_pos, window k_pos >
// q_pos - window, ragged tail k_pos < Sk, and with packed-sequence ids
// qseg == kseg, :188-189); causal blocks above the diagonal and blocks
// wholly older than the window are never loaded; grouped queries (H = G *
// Hkv) read their shared K/V head directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

using sm90::Strides;

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, G, Sq, Sk;
  Strides qs, ks, vs, os;
  float scale;
  int causal, window;
  const int *qseg, *kseg;
  long long seg_b;
  cudaStream_t stream;
};

// --- float32, and bf16 at D <= 32: FMAs on the CUDA cores ------------------
namespace simt {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per step
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
cudaError_t launch(const Args& a) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BM - 1) / BM, a.B * a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.H, a.G,
      a.Sq, a.Sk, a.qs, a.ks, a.vs, a.os, a.scale, a.causal, a.window,
      a.qseg, a.kseg, a.seg_b);
  return cudaGetLastError();
}

}  // namespace simt

// --- bf16 at D = 64 and 128: wgmma on the tensor cores ---------------------
namespace tc {

using namespace sm90;

constexpr int STAGES = 3;   // the (K, V) ring

// keys a stage: at D = 64 a 128-key score tile (HGMMA.64x128x16)
// amortises each tile's fixed costs (barriers, shuffles, the wgmma
// chains' latency); at D = 128 the O accumulator leaves registers for 64
template <int D>
__host__ __device__ constexpr int tile_keys() {
  return D == 64 ? 128 : 64;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the SFU: one instruction (2 ulp; a result below 2^-126 flushes
// to 0, far below P's bf16 rounding; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the consumer warpgroups and one producer warp
__host__ __device__ constexpr int threads(int wgs) { return 128 * wgs + 32; }

// the kernel's view of the launch: its arguments, and which maps have
// heads as their second dim
struct Params : Args {
  int hfirst;  // bit i (0 q, 1 k, 2 v): map i's second dim is heads
};

__device__ __forceinline__ bool admitted(int qp, int kp, const Params& p,
                                         bool same_segment) {
  bool ok = kp < p.Sk && same_segment;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// one key tile of the online softmax for this thread's two query rows (j
// = 0: the accumulator's row, 1: eight rows down): S (in sc) -> p (in
// sc, float32), the running max m (S * scale*log2(e) units), this
// thread's share of the row sums l, and O rescaled by alpha. A masked
// pair enters as -inf and leaves as p = 0; an admitted one takes the same
// instructions with or without the mask.
template <int D, int BN, bool MASK, bool SEG>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BN / 2], float (&o)[D / 2], float (&m)[2], float (&l)[2],
    const int* kseg, int k0, const int (&qpos)[2], const int (&seg)[2],
    float sl2, const Params& p) {
  const float neg_inf = __uint_as_float(0xff800000u);
  float mx[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int j = (i % 4) / 2;
    if (MASK) {
      const int col = acc_col(i);
      if (!admitted(qpos[j], k0 + col, p, !SEG || kseg[col] == seg[j]))
        sc[i] = neg_inf;
    }
    mx[j] = fmaxf(mx[j], sc[i]);
  }
  float alpha[2], nm[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    const float m_new = fmaxf(m[j], __fmul_rn(mx[j], sl2));
    alpha[j] = ex2(__fsub_rn(m[j], m_new));
    nm[j] = -m_new;
    m[j] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int j = (i % 4) / 2;
    sc[i] = ex2(__fmaf_rn(sc[i], sl2, nm[j]));
    rs[j] = __fadd_rn(rs[j], sc[i]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] = __fmaf_rn(l[j], alpha[j], rs[j]);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = __fmul_rn(o[i], alpha[(i % 4) / 2]);
}

// grid (ceil(Sq / (64 * WGS)), B*H)
template <int D, int WGS, bool SEG, bool TMA>
__global__ void __launch_bounds__(threads(WGS), 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const Params p) {
  constexpr int BN = tile_keys<D>();
  constexpr int R = 64 * WGS;          // query rows of the block
  constexpr int TQ = R * D * 2;        // bytes of the Q tile
  constexpr int TK = BN * D * 2;       // of a stage's K (or V) tile
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[2 * STAGES + 1];
  const uint32_t base = ring_base(smem);
  const uint32_t Qs = base, ring = base + TQ;
  int* kseg_s = reinterpret_cast<int*>(smem + (base - smem_u32(smem)) + TQ +
                                       STAGES * 2 * TK);
  const uint32_t full = init_bars<STAGES, WGS>(bar_mem);
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

  if (warp == 4 * WGS) {  // the producer
    begin_stage<TMA>(once, TQ, lane);
    load_rows<R, D, TMA>(Qs, &mq, p.hfirst & 1, (const bf16*)p.q, p.qs,
                         p.Sq, b, h, q0, once, lane);
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
      load_rows<BN, D, TMA>(st, &mk, p.hfirst & 2, (const bf16*)p.k,
                            p.ks, p.Sk, b, hk, k0, full + 8 * s, lane);
      load_rows<BN, D, TMA>(st + TK, &mv, p.hfirst & 4, (const bf16*)p.v,
                            p.vs, p.Sk, b, hk, k0, full + 8 * s, lane);
      end_stage<TMA>(full + 8 * s, lane);
    }
    return;
  }

  // a consumer warpgroup: query rows qa .. qa + 63
  const int wg = warp / 4;
  const int qa = q0 + 64 * wg;
  int qpos[2], seg[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    qpos[j] = q0 + acc_row(2 * j);
    seg[j] = (SEG && qpos[j] < p.Sq) ? p.qseg[b * p.seg_b + qpos[j]] : 0;
  }
  float o[D / 2];
  zero(o);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = __fmul_rn(p.scale, kLog2e);
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
      float sc[BN / 2];
      zero(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma<0, 0>(sc, desc(Qs + (kk / 4) * (R * 128) + wg * (64 * 128) +
                                 (kk % 4) * 32, 16, 1024),
                    desc(Ks + (kk / 4) * (BN * 128) + (kk % 4) * 32, 16,
                         1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      // every pair admitted: the tile lies inside the band, no ids, no tail
      const bool inside = !SEG && k0 + BN <= p.Sk &&
                          (!p.causal || k0 + BN - 1 <= qa) &&
                          (p.window <= 0 || k0 > qa + 63 - p.window);
      if (inside)
        softmax_tile<D, BN, false, SEG>(sc, o, m, l, kseg_s + s * BN, k0,
                                        qpos, seg, sl2, p);
      else
        softmax_tile<D, BN, true, SEG>(sc, o, m, l, kseg_s + s * BN, k0,
                                       qpos, seg, sl2, p);
      // O += P.V: P rounded to bf16 as the A operand; V's rows (the keys)
      // are the depth, read through the transpose
      uint32_t a[BN / 16][4];
      acc_to_a<BN>(sc, a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<1>(o, a[kk], desc(Vs + kk * 2048, BN * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(a);
    }
    release(empty + 8 * s, lane);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] = __fadd_rn(l[j], __shfl_xor_sync(0xffffffffu, l[j], 1));
    l[j] = __fadd_rn(l[j], __shfl_xor_sync(0xffffffffu, l[j], 2));
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (qpos[j] >= p.Sq) continue;
    const float ls = l[j] == 0.f ? 1.f : l[j];
    bf16* out = (bf16*)p.o + b * p.os.b + h * p.os.h + qpos[j] * p.os.s;
#pragma unroll
    for (int i = 2 * j; i < D / 2; i += 4)
      *reinterpret_cast<uint32_t*>(out + acc_col(i)) =
          pack_bf16(__fdiv_rn(o[i], ls), __fdiv_rn(o[i + 1], ls));
    if (threadIdx.x % 4 == 0)
      p.lse[(long long)bh * p.Sq + qpos[j]] =
          l[j] == 0.f ? kNegInf : __fmaf_rn(m[j], kLn2, logf(l[j]));
  }
}

// the three operands' maps (q in boxes of qrows, k and v of the stage's
// keys) when TMA takes all three; *tma says which
template <int D>
cudaError_t maps(const Args& a, int qrows, CUtensorMap* m, Params* p,
                 bool* tma) {
  memset(m, 0, 3 * sizeof(CUtensorMap));
  const int Hkv = a.H / a.G;
  *tma = a.Sk > 0 && tma_ok(a.q, a.qs, a.Sq, a.H, a.B) &&
         tma_ok(a.k, a.ks, a.Sk, Hkv, a.B) &&
         tma_ok(a.v, a.vs, a.Sk, Hkv, a.B);
  if (!*tma) return cudaSuccess;
  const void* base[3] = {a.q, a.k, a.v};
  const Strides st[3] = {a.qs, a.ks, a.vs};
  const int S[3] = {a.Sq, a.Sk, a.Sk};
  const int H[3] = {a.H, Hkv, Hkv};
  const int rows[3] = {qrows, tile_keys<D>(), tile_keys<D>()};
  for (int i = 0; i < 3; ++i) {
    bool hf = false;
    const cudaError_t err =
        flash_map(m + i, &hf, base[i], D, S[i], H[i], a.B, st[i], rows[i]);
    if (err != cudaSuccess) return err;
    p->hfirst |= hf ? 1 << i : 0;
  }
  return cudaSuccess;
}

template <int D, int WGS, bool SEG, bool TMA>
cudaError_t run(const Args& a, const CUtensorMap* m, const Params& p) {
  constexpr int R = 64 * WGS, BN = tile_keys<D>();
  const int smem = 1024 + R * D * 2 + STAGES * 2 * BN * D * 2 +
                   STAGES * BN * 4;
  auto kern = flash_fwd_kernel<D, WGS, SEG, TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + R - 1) / R, a.B * a.H);
  kern<<<grid, threads(WGS), smem, a.stream>>>(m[0], m[1], m[2], p);
  return cudaGetLastError();
}

template <int D, int WGS, bool SEG>
cudaError_t launch_as(const Args& a) {
  Params p{a, 0};
  CUtensorMap m[3];
  bool tma;
  const cudaError_t err = maps<D>(a, 64 * WGS, m, &p, &tma);
  if (err != cudaSuccess) return err;
  return tma ? run<D, WGS, SEG, true>(a, m, p)
             : run<D, WGS, SEG, false>(a, m, p);
}

// the current device's SM count, read from the runtime once per device
// (every prefill and training step launches this kernel)
cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> cache[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *sms = dev < kDevices ? cache[dev].load(std::memory_order_relaxed) : 0;
  if (*sms > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices)
    cache[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// blocks of two warpgroups, unless that leaves SMs of the card idle
// (small serving grids): then blocks of one warpgroup (64 rows), twice
// as many
template <int D, bool SEG>
cudaError_t launch(const Args& a) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.Sq + 127) / 128) * a.B * a.H;
  return blocks < sms ? launch_as<D, 1, SEG>(a) : launch_as<D, 2, SEG>(a);
}

}  // namespace tc

template <bool SEG>
cudaError_t dispatch_t(int dtype, int D, const Args& a) {
  if (dtype == 0) {
    switch (D) {
      case 8: return simt::launch<float, 8>(a);
      case 12: return simt::launch<float, 12>(a);
      case 16: return simt::launch<float, 16>(a);
      case 32: return simt::launch<float, 32>(a);
      case 64: return simt::launch<float, 64>(a);
      case 128: return simt::launch<float, 128>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 8: return simt::launch<__nv_bfloat16, 8>(a);
      case 12: return simt::launch<__nv_bfloat16, 12>(a);
      case 16: return simt::launch<__nv_bfloat16, 16>(a);
      case 32: return simt::launch<__nv_bfloat16, 32>(a);
      case 64: return tc::launch<64, SEG>(a);
      case 128: return tc::launch<128, SEG>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
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
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.B = B; a.H = H; a.G = G; a.Sq = Sq; a.Sk = Sk;
  a.qs = {qsb, qss, qsh}; a.ks = {ksb, kss, ksh}; a.vs = {vsb, vss, vsh};
  a.os = {osb, oss, osh};
  a.scale = scale; a.causal = causal; a.window = window;
  a.qseg = qseg; a.kseg = kseg; a.seg_b = seg_b;
  a.stream = static_cast<cudaStream_t>(stream);
  if (qseg != nullptr && kseg != nullptr) return dispatch_t<true>(dtype, D, a);
  return dispatch_t<false>(dtype, D, a);
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
