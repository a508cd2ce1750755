// One-step decode attention over the slab KV cache for Hopper (sm_90a):
// float32 / bfloat16 caches, and int8 caches with per-token float32 scale
// planes (int4 slab caches are int8 bytes in [-7, 7] and take the int8
// path). Queries float32 or bfloat16, output float32.
//
// Replaces the TPU kernel distkeras_tpu/ops/decode_attention.py
// `decode_attention` (pl.pallas_call at :233, body `_kernel` :92): the
// G query heads sharing one kv head score against that head's cache
// positions [lo, t] (lo = t - window + 1 with a sliding window, else 0),
// online softmax, value mix. GQA is native: the G rows share each staged
// chunk of K/V, nothing is expanded. The cache is read in place through
// its row and position strides (the port's [B, Hkv, L, D] slab viewed as
// [B*Hkv, L, D]), and q through its own row and group strides.
//
// Numerics, as the plain version (ops/decode_attention.py) has them:
// q * scale in float32, rounded to the cache dtype for a float cache
// (int8 contracts in float32; a bf16 q widens exactly, so bf16 and
// float32 queries of the same values give the same bits); scores in
// float32; for int8 the score is multiplied by k_scale[pos] AFTER the D
// contraction; l accumulates the UNSCALED probabilities, which are then
// multiplied by v_scale[pos] (int8) or rounded to the cache dtype
// (float) before the value sum; out = acc / l with the l == 0 -> 1 guard.
// The one difference: the probabilities rounded are the unnormalised
// online-softmax ones (exp(s - m) against the running max).
//
// Bound on this card: the bytes of K and V over [lo, t] (plus q, out and
// the scales) at 3.35 TB/s; a step does 4*G*D operations per position,
// far below the card's operations-per-byte balance.
//
// Design (flash-decoding over the slab, one launch per call):
//   * the grid is (row, split): split z owns the cache positions
//     [z * chunk, (z + 1) * chunk). nsplit and chunk come from the shapes,
//     the static window and the SM count alone (ops/decode_attention.py
//     `split_plan`), never from t, so the grid of a decode step does not
//     move as the context grows;
//   * a split clips its range to [lo, t] on the device; one left with
//     nothing exits before it forms an address, and writes and arrives
//     nowhere. Every split knows from t which splits are live (z0 = lo /
//     chunk .. t / chunk), so nothing waits on a dead one;
//   * a split walks its positions in chunks of CK (about 8 KB of K; 32 to
//     128 positions). Each chunk's K and V rows (and the int8 scale
//     planes) arrive by 16-byte (4-byte) cp.async in the cache's own dtype
//     (8 or 4 bytes where a row is no whole number of 16-byte pieces: bf16
//     at D = 12, int8 at D = 8 and 12) into a ring of kStages (2) buffers,
//     a staged row padded to whole 8-dim pieces whose dims past D are
//     zero (q's too), so the scoring and P.V loops below are those of
//     every head dim; both buffers are filled at once
//     when the split starts, then the next chunk loads while one is
//     scored. Nothing is widened in shared memory; int8 bytes become
//     floats by the byte permute of dequant.cuh (no I2F);
//   * scoring: a thread owns one position of the chunk and a group of RG
//     query rows (RG = 1 at G = 1, else 4; a template argument, so G = 1
//     issues one row's work), reading its key 8 dims at a time with q in
//     shared memory. With one such group (G <= RG) and more threads than
//     chunk positions, the threads of a position split its D pieces among
//     them and add their partial dots by shuffles, so every thread scores
//     at G = 1. Each warp reduces its positions' maximum and probability sum
//     by shuffles; the per-row (m, l) lives in shared memory and takes a
//     chunk's partial maxima and sums while the next chunk is scored;
//   * P.V: a thread owns 8 output dims of one row and a strided subset of
//     the chunk's positions, its sums kept in registers across chunks
//     (rescaled by each chunk's alpha) and added in a fixed order at the
//     end;
//   * merge: each live split writes its (m, l, acc) to the partials
//     workspace (slot z - z0 of the row); the last live split of a row
//     to arrive (a counter per row in a zeroed workspace kept across
//     calls, reset by that split) loads every live split's (m, l), and
//     their acc by cp.async, in one round, and merges them in split order
//     through their log-sum-exps (M = max m_i over splits with l_i > 0,
//     L = sum l_i e^(m_i - M), acc likewise) and writes the output. A
//     single live split writes the output itself. One CUDA launch per
//     call;
//   * occupancy: at generate()'s shape every block of the grid is
//     resident at once (5 or 6 an SM), so the G = 1 kernels are compiled
//     to that bound and launched with the largest shared-memory carveout;
//     a second wave of blocks would add a whole block's latency.

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
constexpr int NWARP = NT / 32;
constexpr int kMaxRows = 64;                // G, the query rows a kv head
constexpr int kStages = 2;                  // chunks in the ring
constexpr int kMaxGridY = 65535;            // splits (grid.y)
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

// rounding of q and of the probabilities to the cache dtype: a no-op for
// float32 and for int8 (whose products run in float32)
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

// the kernel's geometry for one cache dtype and head dim
template <typename T, int D>
struct Geo {
  static constexpr bool Q = sizeof(T) == 1;                 // int8 cache
  // the staged head dim: whole 8-dim pieces (D = 12 stages 16, the last
  // four zero)
  static constexpr int DP = (D + 7) / 8 * 8;
  static constexpr int GROW = D * (int)sizeof(T);           // bytes in the cache
  static constexpr int ROW = DP * (int)sizeof(T);           // bytes staged
  // bytes a cp.async: 16 where the cache's rows are whole 16-byte pieces,
  // else 8 or 4 (bf16 at D = 12, int8 at D = 8 and 12)
  static constexpr int CB = GROW % 16 == 0 ? 16 : (GROW % 8 == 0 ? 8 : 4);
  static_assert(GROW % 4 == 0, "a cache row must be whole 4-byte words");
  // about 8 KB of K (and of V) a stage, so five or six blocks fit an SM;
  // at least a warp's 32 positions, at most 128
  static constexpr int CK =
      8192 / ROW < 32 ? 32 : (8192 / ROW < 128 ? 8192 / ROW : 128);
  static constexpr int ROWB = ROW + 16;                     // staged stride
  static constexpr int PAY = CK * ROWB;                     // K (or V) bytes
  static constexpr int STAGE = 2 * PAY + (Q ? 2 * CK * 4 : 0);
  static constexpr int PIECES = GROW / CB;                  // copies a row
  static constexpr int P8 = DP / 8;                         // 8-dim pieces
  static constexpr int NRS = NT / CK;        // threads a chunk position has
  static constexpr int MAXSL = (kMaxRows * P8 + NT - 1) / NT;
  // the P.V sums are added through the free ring at the end
  static_assert(kMaxRows * P8 * 8 * 4 <= kStages * STAGE, "ring too small");
};

// shared memory a block takes at G = 1 (with the SM's 1 KB a block), and
// the blocks an SM's 228 KB hold: the launch bound of the G = 1 kernels,
// so that their registers leave room for all of them
template <typename T, int D>
struct Occupancy {
  using G = Geo<T, D>;
  static constexpr int SMEM =
      kStages * G::STAGE + 4 * (G::DP + G::CK + 1 + 2 + 4 * NWARP) + 1024 +
      16;
  static constexpr int FIT = 233472 / SMEM;
  static constexpr int BLOCKS = FIT < 1 ? 1 : (FIT > 8 ? 8 : FIT);
};

// dims [8p, 8p + 8) of chunk position j from a staged K or V payload
template <typename T, int D>
__device__ __forceinline__ void piece8(const uint8_t* pay, int j, int p,
                                       float (&f)[8]) {
  using G = Geo<T, D>;
  if constexpr (G::Q) {
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  float* o;
  float* ml;          // [BH, max_live, G, 2] partial (m, l)
  float* acc;         // [BH, max_live, G, D] partial acc
  int* cnt;           // [BH] zeroed arrival counters
  int q_bf16, BH, G, D;
  long long q_row, q_g, s_row, s_pos, ss_row, ss_pos;   // in elements
  int t, window, chunk, nsplit, max_live;
  float scale;
  cudaStream_t st;
};

template <typename T, int D, int RG>
__global__ void __launch_bounds__(NT, RG == 1 ? Occupancy<T, D>::BLOCKS : 1)
slab_decode_kernel(const Args a) {
  using Gm = Geo<T, D>;
  constexpr bool Q = Gm::Q;
  constexpr int CK = Gm::CK, P8 = Gm::P8, NRS = Gm::NRS, DP = Gm::DP;
  // P.V slots a thread holds: one at G = 1 (D / 8 pieces, position groups
  // filling the block)
  constexpr int MAXSL = RG == 1 ? 1 : Gm::MAXSL;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  const int R = a.G;
  const int row = blockIdx.x, z = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the positions the row attends, [lo, t], and this split's share
  const int t = a.t, chunk = a.chunk;
  const int lo = a.window > 0 ? max(0, t - a.window + 1) : 0;
  const int pb = max(lo, z * chunk);
  const int pe = min(t + 1, z * chunk + chunk);        // exclusive
  if (pb >= pe) return;
  const int z0 = lo / chunk;
  const int nlive = t / chunk - z0 + 1;
  const bool direct = nlive == 1;
  const int nchunks = (pe - pb + CK - 1) / CK;

  uint8_t* stage0 = smem;                              // kStages x STAGE
  float* Qs = reinterpret_cast<float*>(smem + kStages * Gm::STAGE);  // [R][DP]
  float* Ss = Qs + R * DP;                             // [R][CK+1]
  float* Ms = Ss + R * (CK + 1);                       // [R]
  float* Ls = Ms + R;                                  // [R]
  // each warp's max and sum over its positions of a chunk, by chunk
  // parity: [2][R][NWARP]
  float* Mp = Ls + R;
  float* Lp = Mp + 2 * R * NWARP;

  const uint8_t* kb = reinterpret_cast<const uint8_t*>(
      static_cast<const T*>(a.k) + row * a.s_row);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(
      static_cast<const T*>(a.v) + row * a.s_row);
  const long long pos_bytes = a.s_pos * (long long)sizeof(T);

  auto issue = [&](int c) {
    uint8_t* st = stage0 + (c % kStages) * Gm::STAGE;
    const int p0 = pb + c * CK;
    constexpr int CB = Gm::CB;
    for (int i = tid; i < CK * Gm::PIECES; i += NT) {
      const int j = i / Gm::PIECES, pc = i % Gm::PIECES;
      const bool ok = p0 + j < pe;
      const long long off = (ok ? p0 + j : pb) * pos_bytes + CB * pc;
      cp_async_n<CB>(smem_u32(st + j * Gm::ROWB + CB * pc), kb + off,
                     ok ? CB : 0);
      cp_async_n<CB>(smem_u32(st + Gm::PAY + j * Gm::ROWB + CB * pc),
                     vb + off, ok ? CB : 0);
    }
    if constexpr (Q) {
      float* sc = reinterpret_cast<float*>(st + 2 * Gm::PAY);
      const float* ksr = a.ks + row * a.ss_row;
      const float* vsr = a.vs + row * a.ss_row;
      for (int j = tid; j < CK; j += NT) {
        const bool ok = p0 + j < pe;
        const long long off = (long long)(ok ? p0 + j : pb) * a.ss_pos;
        cp_async_n<4>(smem_u32(sc + j), ksr + off, ok ? 4 : 0);
        cp_async_n<4>(smem_u32(sc + CK + j), vsr + off, ok ? 4 : 0);
      }
    }
  };

  // a staged row's dims past D read as zeros: its bytes past the cache
  // row's are zeroed once (the copies never write them)
  if constexpr (Gm::ROW > Gm::GROW) {
    for (int i = tid; i < kStages * 2 * CK; i += NT) {
      uint8_t* r = stage0 + (i / (2 * CK)) * Gm::STAGE +
                   ((i / CK) % 2) * Gm::PAY + (i % CK) * Gm::ROWB + Gm::GROW;
#pragma unroll
      for (int e = 0; e < Gm::ROW - Gm::GROW; e += 4)
        *reinterpret_cast<uint32_t*>(r + e) = 0u;
    }
  }

  // both ring buffers start loading before anything else
  issue(0);
  cp_async_commit();
  if (nchunks > 1) issue(1);
  cp_async_commit();

  for (int i = tid; i < R * DP; i += NT) {
    const int r = i / DP, d = i % DP;
    const long long off = row * a.q_row + r * a.q_g + d;
    float x = 0.f;
    if (d < D)
      x = a.q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(a.q)[off])
                   : static_cast<const float*>(a.q)[off];
    Qs[i] = round_to<T>(x * a.scale);
  }
  for (int r = tid; r < R; r += NT) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }

  // scoring ownership. dsplit: one group of <= 4 rows, the NRS threads of
  // a position (lanes PW apart in one warp) take every NRS-th D piece
  const bool dsplit = NRS > 1 && R <= RG;
  constexpr int PW = 32 / NRS;                // positions a warp (dsplit)
  const int jpos = dsplit ? warp * PW + lane % PW : tid % CK;
  const int rsub = dsplit ? 0 : tid / CK;
  const int slice = dsplit ? lane / PW : 0;
  const int pstep = dsplit ? NRS : 1;
  const int npw = dsplit ? NWARP : CK / 32;   // warps covering a chunk
  const int wpos = dsplit ? warp : jpos / 32;

  // P.V ownership: slot i = (position group pg, row r, piece); PG
  // position groups when the rows' pieces leave threads idle
  const int pairs = R * P8;
  int PG = 1;
  while (2 * PG * pairs <= NT && 2 * PG <= CK) PG *= 2;
  const int slots = pairs * PG;
  float acc[MAXSL][8];
#pragma unroll
  for (int s = 0; s < MAXSL; ++s)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[s][e] = 0.f;

  // chunk parity par's running max of row r
  auto m_of = [&](int par, int r) {
    float m = Ms[r];
#pragma unroll
    for (int w = 0; w < NWARP; ++w)
      if (w < npw) m = fmaxf(m, Mp[(par * R + r) * NWARP + w]);
    return m;
  };
  // fold chunk parity par's partial maxima and sums into (Ms, Ls)
  auto fold = [&](int par) {
    for (int r = tid; r < R; r += NT) {
      const float m = m_of(par, r);
      float l = Ls[r] * __expf(Ms[r] - m);
#pragma unroll
      for (int w = 0; w < NWARP; ++w)
        if (w < npw) l += Lp[(par * R + r) * NWARP + w];
      Ms[r] = m;
      Ls[r] = l;
    }
  };

  for (int c = 0; c < nchunks; ++c) {
    const int par = c & 1;
    if (c == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    // chunk c - 1 is done with its buffer: chunk c + 1 loads into it
    if (c > 0 && c + 1 < nchunks) issue(c + 1);
    cp_async_commit();
    if (c > 0) fold(par ^ 1);
    const uint8_t* st = stage0 + (c % kStages) * Gm::STAGE;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * Gm::PAY);
    const int p0 = pb + c * CK;
    const int n = min(CK, pe - p0);           // live positions of the chunk
    const int j = jpos;
    const bool live = j < n;

    // scores of position j for this thread's rows, and each warp's max
    for (int r0 = RG * rsub; r0 < R; r0 += RG * NRS) {
      float dot[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i) dot[i] = 0.f;
      if (live) {
#pragma unroll 4
        for (int p = slice; p < P8; p += pstep) {
          float kv[8];
          piece8<T, D>(st, j, p, kv);
#pragma unroll
          for (int i = 0; i < RG; ++i) {
            if (r0 + i < R) {
              const float4* qr =
                  reinterpret_cast<const float4*>(Qs + (r0 + i) * DP + 8 * p);
              const float4 qa = qr[0], qb = qr[1];
              float x = dot[i];
              x = fmaf(qa.x, kv[0], x);
              x = fmaf(qa.y, kv[1], x);
              x = fmaf(qa.z, kv[2], x);
              x = fmaf(qa.w, kv[3], x);
              x = fmaf(qb.x, kv[4], x);
              x = fmaf(qb.y, kv[5], x);
              x = fmaf(qb.z, kv[6], x);
              x = fmaf(qb.w, kv[7], x);
              dot[i] = x;
            }
          }
        }
      }
      if (dsplit) {
        // the slices' partial dots: every lane of a position ends with
        // the same sum (a + b == b + a at each step)
#pragma unroll
        for (int off = 16; off >= PW; off >>= 1)
#pragma unroll
          for (int i = 0; i < RG; ++i)
            dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
      }
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        float x = dot[i];
        if (Q) x = x * ksc[j];
        dot[i] = x = live && r0 + i < R ? x : kNegInf;
        if (slice == 0 && r0 + i < R) Ss[(r0 + i) * (CK + 1) + j] = x;
      }
      // the rows' warp maxima, their shuffle chains interleaved (lanes
      // PW apart hold the same position when D is split)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        if (!dsplit || off < PW)
#pragma unroll
          for (int i = 0; i < RG; ++i)
            dot[i] =
                fmaxf(dot[i], __shfl_xor_sync(0xffffffffu, dot[i], off));
      if (lane == 0)
#pragma unroll
        for (int i = 0; i < RG; ++i)
          if (r0 + i < R) Mp[(par * R + r0 + i) * NWARP + wpos] = dot[i];
    }
    __syncthreads();

    // the probabilities (rounded to the cache dtype, or times v_scale)
    // and each warp's sum of them
    for (int r0 = RG * rsub; r0 < R; r0 += RG * NRS) {
      float p[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const int r = r0 + i;
        p[i] = 0.f;
        if (live && slice == 0 && r < R) {
          p[i] = __expf(Ss[r * (CK + 1) + j] - m_of(par, r));
          Ss[r * (CK + 1) + j] = Q ? p[i] * ksc[CK + j] : round_to<T>(p[i]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < RG; ++i)
          p[i] += __shfl_xor_sync(0xffffffffu, p[i], off);
      if (lane == 0)
#pragma unroll
        for (int i = 0; i < RG; ++i)
          if (r0 + i < R) Lp[(par * R + r0 + i) * NWARP + wpos] = p[i];
    }
    __syncthreads();

    // P.V into the slots' registers, over the chunk's live positions
    const uint8_t* vpay = st + Gm::PAY;
#pragma unroll
    for (int s = 0; s < MAXSL; ++s) {
      const int i = tid + s * NT;
      if (i < slots) {
        const int piece = i % P8, rest = i / P8;
        const int r = rest % R, pg = rest / R;
        const float alpha = __expf(Ms[r] - m_of(par, r));
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[s][e] *= alpha;
        const float* pr = Ss + r * (CK + 1);
#pragma unroll 4
        for (int jj = pg; jj < n; jj += PG) {
          const float p = pr[jj];
          float vv[8];
          piece8<T, D>(vpay, jj, piece, vv);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[s][e] = fmaf(p, vv[e], acc[s][e]);
        }
      }
    }
  }
  __syncthreads();              // the last chunk's P.V has read Ms
  fold((nchunks - 1) & 1);
  cp_async_wait<0>();
  __syncthreads();

  // the position groups' sums, in group order, through the free buffers
  float* red = reinterpret_cast<float*>(stage0);
#pragma unroll
  for (int s = 0; s < MAXSL; ++s) {
    const int i = tid + s * NT;
    if (i < slots)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[i * 8 + e] = acc[s][e];
  }
  __syncthreads();
  float* out = a.o + (long long)row * R * D;
  const long long slot = (long long)row * a.max_live + (z - z0);
  float* pacc = a.acc + slot * R * D;
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i % D;
    float s = 0.f;
#pragma unroll 8
    for (int pg = 0; pg < PG; ++pg)
      s += red[((pg * R + r) * P8 + d / 8) * 8 + d % 8];
    if (direct) {
      const float l = Ls[r];
      out[i] = s / (l == 0.f ? 1.f : l);
    } else {
      pacc[i] = s;
    }
  }
  if (direct) return;
  float* pml = a.ml + slot * R * 2;
  for (int r = tid; r < R; r += NT) {
    pml[2 * r] = Ms[r];
    pml[2 * r + 1] = Ls[r];
  }

  // the last live split of this row to arrive merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.cnt[row], 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every live split's (m, l), and the partial sums of as many live
  // splits as the ring holds (by cp.async), in one round of loads; then,
  // per row, the maximum, and each split's weight in place of its m
  const int RD = R * D;
  float2* MLz = reinterpret_cast<float2*>(stage0);    // [nlive][R]
  float* Lm = reinterpret_cast<float*>(MLz + nlive * R);   // [R] merged sum
  float* Acs = reinterpret_cast<float*>(stage0) +     // [nfit][R*D]
               ((2 * nlive * R + R + 3) & ~3);
  const int nfit = min(nlive, (int)((kStages * Gm::STAGE / 4 -
                                     (Acs - reinterpret_cast<float*>(stage0))) /
                                    RD));
  const float2* mlb =
      reinterpret_cast<const float2*>(a.ml) + (long long)row * a.max_live * R;
  const float* accb = a.acc + (long long)row * a.max_live * RD;
  for (int e = 4 * tid; e < nfit * RD; e += 4 * NT)
    cp_async16(smem_u32(Acs + e), accb + e, 16);
  cp_async_commit();
  for (int i = tid; i < nlive * R; i += NT) MLz[i] = __ldcg(mlb + i);
  cp_async_wait<0>();
  __syncthreads();
  for (int r = tid; r < R; r += NT) {
    bool any = false;
    float M = kNegInf;
#pragma unroll 8
    for (int zz = 0; zz < nlive; ++zz) {
      const float2 ml = MLz[zz * R + r];
      if (ml.y > 0.f) {
        M = any ? fmaxf(M, ml.x) : ml.x;
        any = true;
      }
    }
    float L = 0.f;
#pragma unroll 8
    for (int zz = 0; zz < nlive; ++zz) {
      const float2 ml = MLz[zz * R + r];
      float w = 0.f;
      if (ml.y > 0.f) {
        w = expf(ml.x - M);
        L += ml.y * w;
      }
      MLz[zz * R + r].x = w;
    }
    Lm[r] = L;
  }
  __syncthreads();
  // the weighted partial sums in split order
  for (int i = tid; i < RD; i += NT) {
    const int r = i / D;
    float s = 0.f;
#pragma unroll 8
    for (int zz = 0; zz < nlive; ++zz)
      s += MLz[zz * R + r].x *
           (zz < nfit ? Acs[zz * RD + i]
                      : __ldcg(accb + (long long)zz * RD + i));
    const float l = Lm[r];
    out[i] = s / (l == 0.f ? 1.f : l);
  }
  if (tid == 0) a.cnt[row] = 0;
}

size_t smem_bytes(int stage, int R, int D, int CK) {
  return (size_t)kStages * stage +
         4 * ((size_t)R * D + (size_t)R * (CK + 1) + 2 * (size_t)R +
              4 * (size_t)R * NWARP);
}

template <typename T, int D, int RG>
cudaError_t launch(const Args& a) {
  using Gm = Geo<T, D>;
  if (a.G < 1 || a.G > kMaxRows || a.BH < 1 || a.nsplit < 1 ||
      a.nsplit > kMaxGridY || a.chunk < Gm::CK || a.chunk % Gm::CK ||
      a.t < 0 || (long long)a.nsplit * a.chunk <= a.t || a.window < 0 ||
      a.max_live < 1 || a.max_live > a.nsplit || a.cnt == nullptr ||
      (a.max_live > 1 && (a.ml == nullptr || a.acc == nullptr)) ||
      (Gm::Q && (a.ks == nullptr || a.vs == nullptr)))
    return cudaErrorInvalidValue;
  // the merge stages 2 floats a (live split, row) and 1 a row in the ring
  if ((size_t)(2 * a.max_live + 1) * a.G * 4 > (size_t)kStages * Gm::STAGE)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Gm::STAGE, a.G, Gm::DP, Gm::CK);
  auto kern = slab_decode_kernel<T, D, RG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // the largest shared-memory carveout, so every block the SM's shared
  // memory holds is resident at once
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid(a.BH, a.nsplit);
  kern<<<grid, NT, smem, a.st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a) {
  switch (a.D) {
    case 8:
      return a.G == 1 ? launch<T, 8, 1>(a) : launch<T, 8, 4>(a);
    case 12:
      return a.G == 1 ? launch<T, 12, 1>(a) : launch<T, 12, 4>(a);
    case 16:
      return a.G == 1 ? launch<T, 16, 1>(a) : launch<T, 16, 4>(a);
    case 32:
      return a.G == 1 ? launch<T, 32, 1>(a) : launch<T, 32, 4>(a);
    case 64:
      return a.G == 1 ? launch<T, 64, 1>(a) : launch<T, 64, 4>(a);
    case 128:
      return a.G == 1 ? launch<T, 128, 1>(a) : launch<T, 128, 4>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Both launchers: q [BH, G, D] float32 (q_dtype 0) or bfloat16 (1) with
// element strides (q_row, q_g); out [BH, G, D] float32 contiguous; ml
// ([BH, max_live, G, 2] float32) and acc ([BH, max_live, G, D] float32)
// are the partials, read only when a row has more than one live split;
// cnt (BH zeroed ints) the arrival counters, left zeroed; split z covers
// positions [z * chunk, (z + 1) * chunk) of [max(0, t - window + 1), t]
// (window 0: no window), at most max_live of them live.
//
