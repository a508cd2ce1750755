// Paged decode attention for Hopper (sm_90a): K/V read through the page
// table; float32 or bfloat16 pages, int8 pages and packed-int4 pages with
// float32 per-token scale planes; float32 queries and output.
//
// Replaces the TPU kernel distkeras_tpu/ops/paged_attention.py
// `paged_decode_attention` (pl.pallas_call at :365, body `_kernel` :131):
// grouped queries, W >= 1 window-causal rows, a sliding window, sentinel
// table entries, and the quantized pages: for int8 and int4 the score is
// multiplied by k_scale[pos] after the D contraction, l accumulates the
// unscaled probabilities, which are multiplied by v_scale[pos] before the
// value sum (the Pallas order, :212-235); float pages round the
// probabilities to the page dtype before the value sum. An int4 page
// holds page_len/2 byte rows: byte row r carries position r in its low
// nibble and position r + page_len/2 in its high nibble (`_unpack4` :116).
//
// K3-anc, the tree ancestor mask of tree speculation (the Pallas `anc`
// operand, `_kernel` :177-195), is a template flag on the same kernel,
// with exported launchers of its own for the three page variants: window
// row i admits the committed prefix (pos < t) and window column j's
// position t + j iff anc[s, i, j]; with SWA each row's own position is
// t + depth, depth = the row's ancestor count - 1. The slot's W x W mask
// is staged once per block as one 64-bit word per window row (W*G <= 64
// rows per kv head, so W <= 64). Everything else -- the split plan, the
// pages walked ((t - window, t + W - 1]), the arithmetic, the merge order
// -- is the window-causal kernel's, so a lower-triangular anc gives
// bitwise its output.
//
// Bound on this card: the bytes of the live K and V pages it must read
// (payload and scale planes, plus q and out) at 3.35 TB/s; a decode step
// does 4*W*G*D operations per cached position, far below the card's
// operations-per-byte balance.
//
// Design (flash-decoding over logical pages):
//   * the grid is (slot, kv head, split): split z owns the table's
//     logical pages [z * pps, (z + 1) * pps). nsplit and pps come from
//     the shapes and the SM count alone (ops/paged_attention.py
//     `split_plan`), never from t, so a decode step needs no device-to-host
//     read and can be captured in a CUDA graph;
//   * a split clips its pages to the slot's live range first; one that
//     keeps none exits before it forms a page address (every split knows
//     from t which splits are live, so nothing waits on it). A page whose
//     entry is >= N (the unallocated sentinel; free slots carry a
//     position past capacity) is skipped the same way;
//   * a split walks its pages in chunks of CK positions. The page ids
//     come from the table into shared memory once; each chunk's K and V
//     payload rows (and scale planes) arrive by 16-byte (4-byte) cp.async
//     (8 or 4 bytes where a row is no whole number of 16-byte pieces:
//     bf16 at D = 12, int8 and int4 at D = 8 and 12; a staged row is
//     padded to whole 8-dim pieces whose dims past D are zero, q's too)
//     into a ring of kStages (2) buffers, the next chunk loading while one
//     is scored. About 8 KB of K (and of V) a chunk keeps the block small
//     enough for five or six to share an SM, which hides the latency
//     better than a deeper ring (4 buffers: 0.0355 against 0.0285 ms at
//     phase 4's bf16 W1, PERF.md);
//   * scoring: a thread owns one position of the chunk and every query
//     row (rows of the W*G that share the kv head), reads its key 8 dims
//     at a time from the staged bytes (bf16 by a shift, int8 and int4 by
//     the byte permute of dequant.cuh, no I2F: modelled for every value
//     in tests/test_torch_conversion.py) and keeps q in shared
//     memory; the masks use the finite NEG_INF. Each warp reduces its
//     32 positions' maximum and probability sum by shuffles, so every
//     thread takes part in the online softmax; the per-row state (m, l)
//     lives in shared memory and takes a chunk's partial maxima and sums
//     while the next chunk is scored;
//   * P.V: a thread owns 8 output dims of one row and a strided subset of
//     the chunk's positions, its sums kept in registers across chunks
//     (rescaled by each chunk's alpha) and added in a fixed order at the
//     end;
//   * merge: each live split writes its (m, l, acc) for every row; the
//     last live split of a (slot, head) to arrive (a counter per (slot,
//     head) in a workspace allocated once per device, reset by that
//     split) merges them in split order through their log-sum-exps (M =
//     max m_i over splits with l_i > 0, L = sum l_i e^(m_i - M), acc
//     likewise) and writes the output; the l == 0 guard makes a row with
//     no live key 0. One launch per call; a single live split writes the
//     output itself, the merge of one split bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"
#include "sm90.cuh"

namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::smem_u32;

constexpr int NT = 128;
constexpr int kMaxRows = 64;                // W * G per kv head
constexpr int kMaxSplitPages = 512;         // pps, the page ids staged
constexpr int kStages = 2;                  // chunks in the ring
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

// page payload kinds: float32/bfloat16 pages (T), int8 pages, packed int4
enum Quant { kFloat = 0, kInt8 = 8, kInt4 = 4 };

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// N (4, 8 or 16) bytes global -> shared; bytes < N zero-fills the rest
template <int N>
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src,
                                           int bytes) {
  if constexpr (N == 16) {
    cp_async16(dst, src, bytes);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(bytes)
                 : "memory");
  }
}

// the kernel's geometry for one page type and head dim
template <typename T, int D, int QUANT>
struct Geo {
  static constexpr bool Q = QUANT != kFloat;
  // the staged head dim: whole 8-dim pieces (D = 12 stages 16, the last
  // four zero)
  static constexpr int DP = (D + 7) / 8 * 8;
  // bytes of one payload row in the pool: a position's D values, or an
  // int4 byte row (two positions); and of a staged row, DP values
  static constexpr int GROW = QUANT == kInt4 ? D : D * (int)sizeof(T);
  static constexpr int ROW = QUANT == kInt4 ? DP : DP * (int)sizeof(T);
  // bytes a cp.async: 16 where the pool's rows are whole 16-byte pieces,
  // else 8 or 4 (bf16 at D = 12, int8 and int4 at D = 8 and 12)
  static constexpr int CB = GROW % 16 == 0 ? 16 : (GROW % 8 == 0 ? 8 : 4);
  static_assert(GROW % 4 == 0, "a payload row must be whole 4-byte words");
  static constexpr int BPP = QUANT == kInt4 ? DP / 2 : ROW;  // per position
  // about 8 KB of K (and of V) a stage, so more blocks fit an SM; at
  // least a warp's 32 positions, at most 128
  static constexpr int CK =
      8192 / BPP < 32 ? 32 : (8192 / BPP < 128 ? 8192 / BPP : 128);
  static constexpr int CKR = QUANT == kInt4 ? CK / 2 : CK;  // payload rows
  static constexpr int ROWB = ROW + 16;                     // staged stride
  static constexpr int PAY = CKR * ROWB;                    // K (or V) bytes
  static constexpr int STAGE = 2 * PAY + (Q ? 2 * CK * 4 : 0);
  static constexpr int P8 = DP / 8;                         // 8-dim pieces
  static constexpr int MAXSL = (kMaxRows * P8 + NT - 1) / NT;
};

// dims [8p, 8p + 8) of chunk position j from a staged K or V payload
template <typename T, int D, int QUANT>
__device__ __forceinline__ void piece8(const uint8_t* pay, int j, int p,
                                       float (&f)[8]) {
  using G = Geo<T, D, QUANT>;
  if constexpr (QUANT == kInt4) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        pay + (j % G::CKR) * G::ROWB + 8 * p);
    const int sh = j >= G::CKR ? 4 : 0;   // high nibble: row + page_len/2
    const uint32_t a = dq::and_xor(w.x >> sh, dq::kNibble, dq::kSign4);
    const uint32_t b = dq::and_xor(w.y >> sh, dq::kNibble, dq::kSign4);
    f[0] = dq::magic<0>(a) - dq::kBias4;
    f[1] = dq::magic<1>(a) - dq::kBias4;
    f[2] = dq::magic<2>(a) - dq::kBias4;
    f[3] = dq::magic<3>(a) - dq::kBias4;
    f[4] = dq::magic<0>(b) - dq::kBias4;
    f[5] = dq::magic<1>(b) - dq::kBias4;
    f[6] = dq::magic<2>(b) - dq::kBias4;
    f[7] = dq::magic<3>(b) - dq::kBias4;
  } else if constexpr (QUANT == kInt8) {
    const uint2 w =
        *reinterpret_cast<const uint2*>(pay + j * G::ROWB + 8 * p);
    float a[4], b[4];
    dq::int8x4(w.x, a);
    dq::int8x4(w.y, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[e] = a[e];
      f[4 + e] = b[e];
    }
  } else if constexpr (sizeof(T) == 2) {
    const uint4 w =
        *reinterpret_cast<const uint4*>(pay + j * G::ROWB + 16 * p);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(u[e] << 16);
      f[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  } else {
    const float4* r =
        reinterpret_cast<const float4*>(pay + j * G::ROWB + 32 * p);
    const float4 a = r[0], b = r[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
}

template <typename T, int D, int QUANT, bool ANC>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const float* __restrict__ ksp,
                    const float* __restrict__ vsp, const int* __restrict__ t,
                    const int* __restrict__ table,
                    const uint8_t* __restrict__ anc, float* __restrict__ o,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int* __restrict__ counters, int W, int Hkv, int G,
                    int PL, int P, int N, int pps, float scale, int window) {
  using Gm = Geo<T, D, QUANT>;
  constexpr bool Q = Gm::Q;
  constexpr int CK = Gm::CK, CKR = Gm::CKR, P8 = Gm::P8, DP = Gm::DP;
  constexpr int NPW = CK / 32;           // warps a row's positions span
  extern __shared__ __align__(16) uint8_t smem[];
  // tree mask (ANC): bit j of AncBits[i] = anc[s, i, j]; Depth[i] =
  // popcount - 1, the row's own position offset
  __shared__ unsigned long long AncBits[ANC ? kMaxRows : 1];
  __shared__ int Depth[ANC ? kMaxRows : 1];
  __shared__ int Pid[kMaxSplitPages];
  __shared__ int last;
  const int R = W * G;
  uint8_t* stage0 = smem;                             // kStages x STAGE
  float* Qs = reinterpret_cast<float*>(smem + kStages * Gm::STAGE);  // [R][DP]
  float* Ss = Qs + R * DP;                                  // [R][CK+1]
  float* Ms = Ss + R * (CK + 1);                            // [R]
  float* Ls = Ms + R;
  // each warp's max and sum over its 32 positions of a chunk, by chunk
  // parity: [2][R][NPW]
  float* Mp = Ls + R;
  float* Lp = Mp + 2 * R * NPW;

  const int s = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int ts = t[s];
  const long long sh = (long long)s * Hkv + h;

  // logical pages any window row can reach: positions (t - window, t+W-1]
  const long long hi = (long long)ts + W - 1;
  const long long lastp = hi / PL + 1;
  const int p_end = hi < 0 ? 0 : (lastp < P ? (int)lastp : P);
  int p_begin = 0;
  if (window > 0) {
    const long long lo = (long long)ts - window + 1;
    const long long first = lo / PL;
    p_begin = lo <= 0 ? 0 : (first < P ? (int)first : P);
  }
  const int pb = max(p_begin, sp * pps);
  const int pe = min(p_end, (sp + 1) * pps);

  // the splits that hold live pages: z0 .. z0 + nlive - 1. A split
  // outside them forms no address and writes nothing; with none at all,
  // split 0 writes the rows' zeros. One live split writes the output
  // itself (what the merge of one split would give, bit for bit)
  const int z0 = p_begin / pps;
  const int nlive = p_begin < p_end ? (p_end - 1) / pps - z0 + 1 : 0;
  const bool direct = nlive == 1;
  float* ml = part_ml + ((sh * nsplit + sp) * R) * 2;
  if (pb >= pe) {
    if (nlive == 0 && sp == 0)
      for (int i = tid; i < R * D; i += NT) {
        const int r = i / D, d = i % D, w = r / G, g = r % G;
        o[((((long long)s * W + w) * Hkv + h) * G + g) * D + d] = 0.f;
      }
    return;
  } else {
    for (int i = tid; i < pe - pb; i += NT) {
      const int e = table[(long long)s * P + pb + i];
      Pid[i] = e >= 0 && e < N ? e : -1;
    }
    for (int i = tid; i < R * DP; i += NT) {
      const int r = i / DP, d = i % DP, w = r / G, g = r % G;
      Qs[i] = d < D ? q[((((long long)s * W + w) * Hkv + h) * G + g) * D + d]
                    : 0.f;
    }
    // a staged row's dims past D read as zeros: its bytes past the pool
    // row's are zeroed once (the copies never write them)
    if constexpr (Gm::ROW > Gm::GROW) {
      for (int i = tid; i < kStages * 2 * CKR; i += NT) {
        uint8_t* row = stage0 + (i / (2 * CKR)) * Gm::STAGE +
                       ((i / CKR) % 2) * Gm::PAY + (i % CKR) * Gm::ROWB +
                       Gm::GROW;
#pragma unroll
        for (int e = 0; e < Gm::ROW - Gm::GROW; e += 4)
          *reinterpret_cast<uint32_t*>(row + e) = 0u;
      }
    }
    for (int r = tid; r < R; r += NT) {
      Ms[r] = kNegInf;
      Ls[r] = 0.f;
    }
    if constexpr (ANC) {
      for (int i = tid; i < W; i += NT) {
        const uint8_t* row = anc + ((long long)s * W + i) * W;
        unsigned long long bits = 0ull;
        for (int j = 0; j < W; ++j)
          if (row[j]) bits |= 1ull << j;
        AncBits[i] = bits;
        Depth[i] = __popcll(bits) - 1;
      }
    }
    __syncthreads();

    // payload rows of the split: u in [u_begin, u_end), row u of logical
    // page u / PR at page row u % PR
    const int PR = QUANT == kInt4 ? PL / 2 : PL;
    const int u_begin = pb * PR, u_end = pe * PR;
    const int nchunks = (u_end - u_begin + CKR - 1) / CKR;

    auto issue = [&](int c) {
      uint8_t* st = stage0 + (c % kStages) * Gm::STAGE;
      const int u0 = u_begin + c * CKR;
      constexpr int CB = Gm::CB, PIECES = Gm::GROW / CB;
      for (int i = tid; i < CKR * PIECES; i += NT) {
        const int rr = i / PIECES, pc = i % PIECES;
        const int u = u0 + rr;
        const int pid = u < u_end ? Pid[u / PR - pb] : -1;
        const long long off =
            (((long long)(pid < 0 ? 0 : pid) * Hkv + h) * PR + u % PR) *
                Gm::GROW + CB * pc;
        const int bytes = pid >= 0 ? CB : 0;
        const uint8_t* kb = reinterpret_cast<const uint8_t*>(kp);
        const uint8_t* vb = reinterpret_cast<const uint8_t*>(vp);
        cp_async_n<CB>(smem_u32(st + rr * Gm::ROWB + CB * pc), kb + off,
                       bytes);
        cp_async_n<CB>(smem_u32(st + Gm::PAY + rr * Gm::ROWB + CB * pc),
                       vb + off, bytes);
      }
      if constexpr (Q) {
        float* ksc = reinterpret_cast<float*>(st + 2 * Gm::PAY);
        for (int j = tid; j < CK; j += NT) {
          const int u = u0 + j % CKR;
          const int pid = u < u_end ? Pid[u / PR - pb] : -1;
          const int pip = u % PR + (j >= CKR ? PR : 0);
          const long long off =
              ((long long)(pid < 0 ? 0 : pid) * Hkv + h) * PL + pip;
          const int bytes = pid >= 0 ? 4 : 0;
          cp_async_n<4>(smem_u32(ksc + j), ksp + off, bytes);
          cp_async_n<4>(smem_u32(ksc + CK + j), vsp + off, bytes);
        }
      }
    };

    // P.V ownership: slot i = (position group pg, row r, piece); PG
    // position groups when the rows' pieces leave threads idle
    const int pairs = R * P8;
    int PG = 1;
    while (2 * PG * pairs <= NT && 2 * PG <= CK) PG *= 2;
    const int slots = pairs * PG;
    float acc[Gm::MAXSL][8];
#pragma unroll
    for (int k = 0; k < Gm::MAXSL; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;

    const int nrs = NT / CK;                  // row subsets a position has
    const int jpos = tid % CK, rsub = tid / CK, wpos = jpos / 32;

    // chunk c's running max of row r, and the factor its sums take
    auto m_of = [&](int par, int r) {
      float m = Ms[r];
#pragma unroll
      for (int w = 0; w < NPW; ++w) m = fmaxf(m, Mp[(par * R + r) * NPW + w]);
      return m;
    };
    // fold chunk parity `par`'s partial maxima and sums into (Ms, Ls)
    auto fold = [&](int par) {
      for (int r = tid; r < R; r += NT) {
        const float m = m_of(par, r);
        float l = Ls[r] * __expf(Ms[r] - m);
#pragma unroll
        for (int w = 0; w < NPW; ++w) l += Lp[(par * R + r) * NPW + w];
        Ms[r] = m;
        Ls[r] = l;
      }
    };

    // the ring: chunks issued kStages - 1 ahead of the one being scored
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < nchunks) issue(c);
      cp_async_commit();
    }
    for (int c = 0; c < nchunks; ++c) {
      const int par = c & 1;
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (c + kStages - 1 < nchunks) issue(c + kStages - 1);
      cp_async_commit();
      if (c > 0) fold(par ^ 1);
      const uint8_t* st = stage0 + (c % kStages) * Gm::STAGE;
      const float* ksc = reinterpret_cast<const float*>(st + 2 * Gm::PAY);

      // scores of chunk position jpos for the rows of this row subset,
      // and each warp's maximum of them
      const int j = jpos;
      const int u = u_begin + c * CKR + j % CKR;
      const bool live = u < u_end && Pid[u / PR - pb] >= 0;
      const int pos = (u / PR) * PL + u % PR + (j >= CKR ? PR : 0);
      for (int r0 = 4 * rsub; r0 < R; r0 += 4 * nrs) {
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        if (live) {
#pragma unroll 2
          for (int p = 0; p < P8; ++p) {
            float kv[8];
            piece8<T, D, QUANT>(st, j, p, kv);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (r0 + i < R) {
                const float4* qr =
                    reinterpret_cast<const float4*>(Qs + (r0 + i) * DP + 8 * p);
                const float4 a = qr[0], b = qr[1];
                float x = dot[i];
                x = fmaf(a.x, kv[0], x);
                x = fmaf(a.y, kv[1], x);
                x = fmaf(a.z, kv[2], x);
                x = fmaf(a.w, kv[3], x);
                x = fmaf(b.x, kv[4], x);
                x = fmaf(b.y, kv[5], x);
                x = fmaf(b.z, kv[6], x);
                x = fmaf(b.w, kv[7], x);
                dot[i] = x;
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + i;
          if (r >= R) break;
          const int jw = r / G;
          bool ok;
          if constexpr (ANC) {
            const int rel = pos - ts;
            ok = rel < 0 || (rel < W && ((AncBits[jw] >> rel) & 1ull));
            if (window > 0) ok = ok && pos > ts + Depth[jw] - window;
          } else {
            ok = pos <= ts + jw;
            if (window > 0) ok = ok && pos > ts + jw - window;
          }
          float x = dot[i] * scale;
          if (Q) x = x * ksc[j];
          x = live && ok ? x : kNegInf;
          Ss[r * (CK + 1) + j] = x;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
          if (lane == 0) Mp[(par * R + r) * NPW + wpos] = x;
        }
      }
      __syncthreads();

      // the probabilities (rounded to the page dtype, or times v_scale)
      // and each warp's sum of them
      for (int r0 = 4 * rsub; r0 < R; r0 += 4 * nrs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + i;
          if (r >= R) break;
          float p = live ? __expf(Ss[r * (CK + 1) + j] - m_of(par, r)) : 0.f;
          Ss[r * (CK + 1) + j] = Q ? p * ksc[CK + j] : round_to<T>(p);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            p += __shfl_xor_sync(0xffffffffu, p, off);
          if (lane == 0) Lp[(par * R + r) * NPW + wpos] = p;
        }
      }
      __syncthreads();

      // P.V into the slots' registers
      const uint8_t* vpay = st + Gm::PAY;
#pragma unroll
      for (int k = 0; k < Gm::MAXSL; ++k) {
        const int i = tid + k * NT;
        if (i < slots) {
          const int piece = i % P8, rest = i / P8;
          const int r = rest % R, pg = rest / R;
          const float alpha = __expf(Ms[r] - m_of(par, r));
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[k][e] *= alpha;
          const float* pr = Ss + r * (CK + 1);
          for (int jj = pg; jj < CK; jj += PG) {
            const float p = pr[jj];
            float v[8];
            piece8<T, D, QUANT>(vpay, jj, piece, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[k][e] = fmaf(p, v[e], acc[k][e]);
          }
        }
      }
    }
    __syncthreads();            // the last chunk's P.V has read Ms
    if (nchunks > 0) fold((nchunks - 1) & 1);
    cp_async_wait<0>();
    __syncthreads();

    // the position groups' sums, in group order, through the free buffers
    float* red = reinterpret_cast<float*>(stage0);
#pragma unroll
    for (int k = 0; k < Gm::MAXSL; ++k) {
      const int i = tid + k * NT;
      if (i < slots)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[i * 8 + e] = acc[k][e];
    }
    __syncthreads();
    float* pacc = part_acc + (sh * nsplit + sp) * R * D;
    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, d = i % D;
      float a = 0.f;
      for (int pg = 0; pg < PG; ++pg)
        a += red[((pg * R + r) * P8 + d / 8) * 8 + d % 8];
      if (!direct) {
        pacc[i] = a;
      } else {
        const int w = r / G, g = r % G;
        const float l = Ls[r];
        o[((((long long)s * W + w) * Hkv + h) * G + g) * D + d] =
            a / (l == 0.f ? 1.f : l);
      }
    }
    if (!direct)
      for (int r = tid; r < R; r += NT) {
        ml[2 * r] = Ms[r];
        ml[2 * r + 1] = Ls[r];
      }
  }
  if (direct) return;

  // the last live split of this (slot, head) to arrive merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[sh], 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* wt = reinterpret_cast<float*>(stage0);     // [nlive][R] weights
  float* lsum = wt + nlive * R;                     // [R]
  const float* mlb = part_ml + (sh * nsplit + z0) * R * 2;
  for (int r = tid; r < R; r += NT) {
    bool any = false;
    float M = kNegInf;
    for (int z = 0; z < nlive; ++z) {
      const float l = __ldcg(mlb + (z * R + r) * 2 + 1);
      if (l > 0.f) {
        const float m = __ldcg(mlb + (z * R + r) * 2);
        M = any ? fmaxf(M, m) : m;
        any = true;
      }
    }
    float L = 0.f;
    for (int z = 0; z < nlive; ++z) {
      const float l = __ldcg(mlb + (z * R + r) * 2 + 1);
      float w = 0.f;
      if (l > 0.f) {
        w = expf(__ldcg(mlb + (z * R + r) * 2) - M);
        L += l * w;
      }
      wt[z * R + r] = w;
    }
    lsum[r] = L;
  }
  __syncthreads();
  const float* accb = part_acc + (sh * nsplit + z0) * R * D;
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i % D, w = r / G, g = r % G;
    float a = 0.f;
    for (int z = 0; z < nlive; ++z) {
      const float wz = wt[z * R + r];
      if (wz != 0.f) a += wz * __ldcg(accb + (long long)z * R * D + i);
    }
    const float l = lsum[r];
    o[((((long long)s * W + w) * Hkv + h) * G + g) * D + d] =
        a / (l == 0.f ? 1.f : l);
  }
  if (tid == 0) counters[sh] = 0;
}

size_t smem_bytes(size_t stage, int R, int D, int CK) {
  return kStages * stage + 4 * ((size_t)R * D + (size_t)R * (CK + 1) +
                          2 * (size_t)R + 4 * (size_t)R * (CK / 32));
}

template <typename T, int D, int QUANT, bool ANC>
cudaError_t launch(const float* q, const void* kp, const void* vp,
                   const float* ksp, const float* vsp, const int* t,
                   const int* table, const uint8_t* anc, float* o,
                   float* ml, float* acc, int* cnt, int S, int W, int Hkv,
                   int G, int PL, int P, int N, int nsplit, int pps,
                   float scale, int window, cudaStream_t stream) {
  using Gm = Geo<T, D, QUANT>;
  if (QUANT == kInt4 && PL % 2) return cudaErrorInvalidValue;
  if (W * G > kMaxRows || (ANC && anc == nullptr) || pps < 1 ||
      pps > kMaxSplitPages || nsplit < 1 || (long long)nsplit * pps < P ||
      (nsplit > 1 && (ml == nullptr || acc == nullptr || cnt == nullptr)))
    return cudaErrorInvalidValue;
  // the merge's weights ([nsplit][R] + [R]) reuse the stage buffers
  if ((size_t)(nsplit + 1) * W * G * 4 > kStages * (size_t)Gm::STAGE)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Gm::STAGE, W * G, Gm::DP, Gm::CK);
  auto kern = paged_decode_kernel<T, D, QUANT, ANC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S, Hkv, nsplit);
  kern<<<grid, NT, smem, stream>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), ksp, vsp, t,
      table, anc, o, ml, acc, cnt, W, Hkv, G, PL, P, N, pps, scale, window);
  return cudaGetLastError();
}

struct Args {
  const float* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int* t;
  const int* table;
  const uint8_t* anc;
  float* o;
  float* ml;
  float* acc;
  int* cnt;
  int S, W, Hkv, G, D, PL, P, N, nsplit, pps;
  float scale;
  int window;
  cudaStream_t st;
};

template <typename T, int QUANT, bool ANC>
int dispatch_d(const Args& a) {
#define DKT_LAUNCH(DIM)                                                     \
  case DIM:                                                                 \
    return launch<T, DIM, QUANT, ANC>(a.q, a.kp, a.vp, a.ks, a.vs, a.t,     \
                                      a.table, a.anc, a.o, a.ml, a.acc,     \
                                      a.cnt, a.S, a.W, a.Hkv, a.G, a.PL,    \
                                      a.P, a.N, a.nsplit, a.pps, a.scale,   \
                                      a.window, a.st);
  switch (a.D) {
    DKT_LAUNCH(8)
    DKT_LAUNCH(12)
    DKT_LAUNCH(16)
    DKT_LAUNCH(32)
    DKT_LAUNCH(64)
    DKT_LAUNCH(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DKT_LAUNCH
}

// float32 (dtype 0) or bfloat16 (dtype 1) pages
template <bool ANC>
int float_pages(const Args& a, int dtype) {
  if (dtype == 0) return dispatch_d<float, kFloat, ANC>(a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, kFloat, ANC>(a);
  return cudaErrorInvalidValue;
}

Args args(const void* q, const void* kp, const void* vp, const void* ks,
          const void* vs, const void* t, const void* table, const void* anc,
          void* o, void* ml, void* acc, void* cnt, int S, int W, int Hkv,
          int G, int D, int PL, int P, int N, int nsplit, int pps,
          float scale, int window, void* stream) {
  return Args{static_cast<const float*>(q), kp, vp,
              static_cast<const float*>(ks), static_cast<const float*>(vs),
              static_cast<const int*>(t), static_cast<const int*>(table),
              static_cast<const uint8_t*>(anc), static_cast<float*>(o),
              static_cast<float*>(ml), static_cast<float*>(acc),
              static_cast<int*>(cnt), S, W, Hkv, G, D, PL, P, N, nsplit,
              pps, scale, window, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Every launcher: `ml` ([S, Hkv, nsplit, W*G, 2] float32), `acc` ([S, Hkv,
// nsplit, W*G, D] float32) and `cnt` (S*Hkv zeroed ints) are the split
// workspaces, read only when nsplit > 1; split z covers the table's
// logical pages [z * pps, (z + 1) * pps).
