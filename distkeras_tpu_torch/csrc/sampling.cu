// Fused sampling epilogue (K4) for Hopper (sm_90a): one token id per row
// from the raw logits, the temperature, top-k, top-p and a Gumbel field,
// in one launch and without a sort.
//
// Replaces the TPU kernel distkeras_tpu/ops/sampling.py `sample_epilogue`
// (pl.pallas_call at :180, body `_kernel` :98-143) together with the
// temperature scale and the descending sort that fed it (:164-167):
//   lf = float(x) / t (t = 1 on a greedy row); kc = clip(k, 1, V)
//   kth = the kc-th largest lf; n_gt = #{lf > kth}
//   keep_k = k <= 0 | lf > kth | (lf == kth & n_gt + tie_rank <= kc)
//     (tie_rank: the inclusive count of entries equal to kth in index
//     order, so ties go to the lowest index)
//   the top-k multiset: every lf > kth and kc - n_gt copies of kth (the
//     whole row when k <= 0 or k >= V); Z its softmax mass, M(> v) the
//     mass of its entries strictly above v (each term exp(lf - max))
//   thresh = the smallest v >= kth in the row with M(> v) < p Z (+inf
//     when p <= 0): the sorted row's exclusive cumsum is M(> v) / Z at
//     the first position of each value and does not decrease, so this is
//     `_kernel`'s min{srt_m[i] : excl[i] < p}, whatever the ties
//   lfm = (p >= 1 | lfk >= thresh) ? lfk : NEG_INF
//   token = t > 0 ? first argmax(lfm + g) : first argmax(lf)
//
// Bound on this card: the [S, V] logits in their own dtype and the
// float32 Gumbel field of the sampled rows, each read once at 3.35 TB/s;
// the work per entry is a division, an exp and a few comparisons.
//
// Design. One thread-block cluster per row: C <= 8 blocks, chosen from V
// alone (one block per SLICE entries). Block r holds the contiguous index
// slice r, so rank order is index order. Each block reads its slice of
// the logits and of the Gumbel field from device memory once, into shared
// memory (a slice too wide for it re-reads the slice from L2 on each
// pass), and computes lf with IEEE division (__fdiv_rn), so lf is
// bitwise the plain version's and so are kth, the ties and the greedy
// argmax. kth and thresh come from two radix descents, 8 bits a pass,
// over an order-preserving uint32 key of lf with -0.0 folded into +0.0
// (the comparisons treat them as equal). In each pass every block
// histograms its slice with shared-memory atomics (the k descent's first
// pass while the slice loads) and sends the histogram to every rank of
// the cluster (st.async into the rank's receive buffer, completing bytes
// on the rank's mbarrier); each block waits on its own barrier, adds the
// C messages in rank order, and warp 0 picks the digit, the same in
// every block. That spares each pass a cluster barrier and the remote
// loads of a pull (what they cost on the card: probes/cluster_costs.cu).
// The k descent counts entries; the
// nucleus descent adds their masses as 40-bit fixed point, so the sums
// are exact integers whatever the order of the atomics and a call is
// bitwise repeatable, and picks the lowest bucket whose mass above stays
// under p Z. Each descent stops at the first chosen bin that holds one
// key (the messages carry each bin's key range from pass 1 on), which
// random rows reach in 2 or 3 passes. The tie ranks at kth come from
// the chosen bin's per-rank counts (an exclusive prefix over the ranks)
// and, only when the ties outnumber what k leaves them, block scans.
// The draw, each block's first argmax of lfm + g, goes to rank 0, which
// writes the int64 token after one cluster barrier. A cluster's blocks
// take the same branches (they follow the row's knobs and cluster-wide
// sums only), so each sends and waits for every round. NEG_INF is the
// port's finite constant (ops/attention.py), so NEG_INF + g rounds to
// NEG_INF and a row with nothing kept returns index 0, as the plain
// version does.
//
// The arithmetic differs from the plain version only in the nucleus
// mass: the fixed-point sum is closer to float64 than torch.cumsum's
// float32 one, so at a row whose cumulative mass lies within float32
// rounding of p the cut may keep one value more or fewer
// (ops.sampling.boundary_partings admits such a row).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;
using sm90::bar_expect;
using sm90::bar_init;
using sm90::bar_init_fence;
using sm90::bar_wait;
using sm90::smem_u32;

namespace {

typedef unsigned long long u64;

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int NBIN = 256;                      // 8-bit digits
constexpr int SLICE = 4096;                    // entries a block
constexpr int MAX_CLUSTER = 8;                 // portable cluster size
// dynamic shared memory a block may take: the receive buffers, then the
// slice's lf and g when they fit (the card's 227 KB less the static part)
constexpr size_t DYN_BYTES = 211 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;
constexpr float kFix = 1099511627776.f;        // 2^40: mass fraction bits
// the mass goes into 32-bit shared atomics as three 14-bit limbs, whose
// sums over a slice stay exact below 2^18 entries
constexpr int LIMB = 14;
constexpr unsigned LIMB_MASK = (1u << LIMB) - 1u;
constexpr int MAX_SLICE = 1 << 18;
// a cluster's bins in shared memory, one u64 of padding after every 8, so
// a warp reading 8 neighbouring bins a lane hits distinct banks
constexpr int NPAD = NBIN + NBIN / 8;
__device__ __forceinline__ int pad(int b) { return b + (b >> 3); }

// one block's histogram of a pass, by shared-memory atomics: entries by
// digit (k descent) or their fixed-point mass (nucleus descent), and each
// bin's key range
struct alignas(16) Local {
  unsigned cnt[NBIN];                 // (16-byte aligned: sent as uint4)
  unsigned mass[3][NBIN];
  unsigned kmax[NBIN];      // the bin's largest key
  unsigned kinv[NBIN];      // ~ the bin's smallest key (0: empty)
};

// what a block sends each rank of its cluster in one round: the bins'
// masses or counts, their key ranges below the digit (passes 1 and 2:
// the largest key's low bits above, ~ the smallest's below), and its
// largest key (first round). A round moves C messages into every block
// and its time grows with their bytes, so a count round sends 32-bit
// counts.
struct alignas(16) Msg {
  union {                    // a round sends one of them
    u64 mass[NBIN];
    unsigned cnt[NBIN];
  };
  unsigned keys[NBIN];
  unsigned key;
  unsigned pad_[3];
};
constexpr int MASS_CHUNKS = NBIN * 8 / 16;     // 16-byte stores a message
constexpr int CNT_CHUNKS = NBIN * 4 / 16;
constexpr int KEY_CHUNKS = NBIN * 4 / 16;

__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 (or 4) bytes into another block's shared memory, completing that
// many bytes on its barrier
__device__ __forceinline__ void st_async(uint32_t addr, u64 a, u64 b,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 "
      "[%0], {%1, %2}, [%3];" ::"r"(addr), "l"(a), "l"(b), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, uint4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr), "r"(v.x), "r"(v.y),
      "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, unsigned v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];" ::"r"(addr), "r"(v), "r"(bar)
      : "memory");
}

struct Scratch {
  float f[NWARP];
  int i[NWARP + 1];
  unsigned u[NWARP];
  float rf;
  int ri;
  unsigned ru;
};

// order-preserving key of a float (-0.0 as +0.0) and back
__device__ __forceinline__ unsigned fkey(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float kval(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

__device__ __forceinline__ u64 fixed(float m) {
  return __float2ull_rn(m * kFix);
}

// torch.argmax's order: a NaN beats every number, ties go to the lower
// index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (v > bv) return true;
  if (v != v) return bv == bv || i < bi;
  return v == bv && i < bi;
}

__device__ void block_argmax(float& bv, int& bi, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
  if (lane == 0) { sh.f[warp] = bv; sh.i[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    float v = lane < NWARP ? sh.f[lane] : -INFINITY;
    int i = lane < NWARP ? sh.i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, off);
      const int oi = __shfl_xor_sync(FULL, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { sh.rf = v; sh.ri = i; }
  }
  __syncthreads();
  bv = sh.rf;
  bi = sh.ri;
}

__device__ unsigned block_max(unsigned v, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(FULL, v, off));
  if (lane == 0) sh.u[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < NWARP ? sh.u[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w = max(w, __shfl_xor_sync(FULL, w, off));
    if (lane == 0) sh.ru = w;
  }
  __syncthreads();
  return sh.ru;
}

// exclusive scan of one count a thread, in thread order
__device__ int block_excl_scan(int v, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sh.i[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < NWARP ? sh.i[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += y;
    }
    if (lane < NWARP) sh.i[lane] = s;
  }
  __syncthreads();
  const int res = (warp > 0 ? sh.i[warp - 1] : 0) + x - v;
  __syncthreads();
  return res;
}

// a key into the key range of the local histogram's bin b
__device__ __forceinline__ void add_key(Local& x, unsigned b, unsigned key) {
  atomicMax(&x.kmax[b], key);
  atomicMax(&x.kinv[b], ~key);
}

// the nucleus limit on the fixed-point mass above a value: the mass is
// under p Z exactly when it is under this integer
__device__ __forceinline__ u64 nucleus_limit(float p, u64 z) {
  return (u64)ceil((double)p * (double)z);
}

struct Pick {
  int bin;        // NBIN when no bin qualifies
  u64 above;      // the value of the bins above it
  u64 total;      // the value of all bins
  unsigned lo;    // the bin's key range (lo < top: more than one key)
  unsigned top;
  int tie;        // k descent: the bin's entries in the lower ranks
};

// one warp's pick: the lowest bin b with base + (the value of the bins
// above b) < thr, with thr = ceil(frac * total) when frac >= 0 (an integer
// is under a real number when it is under its ceiling). The bins that
// qualify run down from the top to a limit, so the lowest one holds the
// bucket the descent continues in. It is never empty: an empty bin's
// value above equals that of the next non-empty bin below it or, below
// them all, base + the bucket's whole value, which the pass before kept
// at or over thr (the first pass's is the total: all kc entries, or Z,
// which p < 1 keeps over p Z).
__device__ Pick pick(const u64* tot_val, u64 base, u64 thr, float frac) {
  const int lane = threadIdx.x & 31;
  u64 v[8];
  u64 s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = tot_val[pad(8 * lane + j)];
    s += v[j];
  }
  u64 incl = s;                        // the lanes from this one up
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 y = __shfl_down_sync(FULL, incl, off);
    if (lane + off < 32) incl += y;
  }
  Pick p;
  p.total = __shfl_sync(FULL, incl, 0);
  if (frac >= 0.f) thr = nucleus_limit(frac, p.total);
  u64 run = incl - s;
  int best = NBIN;
  u64 best_above = 0;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    if (base + run < thr) {
      best = 8 * lane + j;
      best_above = run;
    }
    run += v[j];
  }
  int m = best;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = min(m, __shfl_xor_sync(FULL, m, off));
  p.bin = m;
  p.above = __shfl_sync(FULL, best_above, (m < NBIN ? m : 0) >> 3);
  return p;
}

// the token: each block's first argmax into rank 0's shared memory, then
// rank 0 takes the first argmax over the blocks in rank (so index) order.
// Nothing reads a block's shared memory after this sync, so the others
// leave at once.
__device__ void finish(cg::cluster_group& cl, float* fin_v, int* fin_i,
                       int rank, int nblk, float bv, int bi,
                       long long* out) {
  if (threadIdx.x == 0) {
    cl.map_shared_rank(fin_v, 0)[rank] = bv;
    cl.map_shared_rank(fin_i, 0)[rank] = bi;
  }
  cl.sync();
  if (rank != 0 || threadIdx.x != 0) return;
  bv = -INFINITY;
  bi = INT_MAX;
  for (int r = 0; r < nblk; ++r)
    if (better(fin_v[r], fin_i[r], bv, bi)) { bv = fin_v[r]; bi = fin_i[r]; }
  *out = bi == INT_MAX ? 0 : bi;
}

// CACHED: the slice's lf and g stay in shared memory (else each pass
// reads the slice again, from L2)
template <typename T, bool CACHED>
__global__ void __launch_bounds__(NT)
    sample_kernel(const T* __restrict__ logits, long long ld,
                  const float* __restrict__ gumbel,
                  const float* __restrict__ temp,
                  const long long* __restrict__ top_k,
                  const float* __restrict__ top_p,
                  long long* __restrict__ out, int V, int L) {
  // dynamic: the receive buffers (two rounds' messages from each rank),
  // then, CACHED, the slice's lf and g
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Local loc;
  __shared__ uint64_t mbar[2];         // a round's messages, by parity
  __shared__ u64 tot[NPAD];
  __shared__ float fin_v[MAX_CLUSTER];
  __shared__ int fin_i[MAX_CLUSTER];
  __shared__ Scratch sh;
  __shared__ unsigned s_max;
  __shared__ Pick s_pick;

  cg::cluster_group cl = cg::this_cluster();
  const int nblk = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int s0 = rank * L;
  const int n = max(0, min(L, V - s0));
  const T* x = logits + (size_t)row * ld + s0;
  const float* g = gumbel + (size_t)row * V + s0;
  Msg* rx = reinterpret_cast<Msg*>(dyn);      // [2][nblk]
  float* s_lf = reinterpret_cast<float*>(rx + 2 * nblk);
  float* s_g = s_lf + L;

  {
    unsigned* w = reinterpret_cast<unsigned*>(&loc);
    for (int i = tid; i < (int)(sizeof(Local) / sizeof(unsigned)); i += NT)
      w[i] = 0u;
  }
  const float t = temp[row];
  const bool greedy = !(t > 0.f);
  if (tid == 0 && !greedy) {           // (a greedy row exchanges nothing)
    bar_init(smem_u32(&mbar[0]));
    bar_init(smem_u32(&mbar[1]));
    bar_init_fence();
  }
  __syncthreads();                     // loc zeroed before the load adds
  const float ts = greedy ? 1.f : t;
  auto lf_at = [&](int i) {
    if constexpr (CACHED) return s_lf[i];
    else return __fdiv_rn(to_f(x[i]), ts);
  };
  auto g_at = [&](int i) {
    if constexpr (CACHED) return s_g[i];
    else return g[i];
  };
  // f(i, lf[i]) over the slice, U of a thread's loads in flight at once
  constexpr int U = 8;
  auto each = [&](auto&& f) {
    for (int i0 = tid; i0 < n; i0 += U * NT) {
      float v[U];
#pragma unroll
      for (int j = 0; j < U; ++j)
        v[j] = i0 + j * NT < n ? lf_at(i0 + j * NT) : 0.f;
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (i0 + j * NT < n) f(i0 + j * NT, v[j]);
    }
  };

  const long long k = top_k[row];
  const float p = top_p[row];
  const bool do_k = !greedy && k > 0 && k < V;   // k >= V: the whole row
  const int kc = do_k ? (int)k : V;
  const bool do_p = p > 0.f && p < 1.f;
  const bool cut = !(p >= 1.f);        // p <= 0 keeps nothing

  // every block of the cluster has started, its barriers initialised,
  // before one touches another's shared memory: arrive now, wait after
  // the load
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");

  // the one read of the slice: lf (and g) into shared memory, with the
  // block's first argmax (greedy) or its largest key and, with a top-k,
  // the k descent's first histogram
  float bv = -INFINITY;
  int bi = INT_MAX;
  unsigned mk = 0u;
  for (int i0 = tid; i0 < n; i0 += U * NT) {
    T xv[U];
    float gv[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = i0 + j * NT;
      if (i < n) {
        xv[j] = x[i];
        if (!greedy) gv[j] = g[i];
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = i0 + j * NT;
      if (i >= n) break;
      const float v = __fdiv_rn(to_f(xv[j]), ts);
      if (greedy) {
        if (better(v, s0 + i, bv, bi)) { bv = v; bi = s0 + i; }
        continue;
      }
      if (CACHED) {
        s_lf[i] = v;
        s_g[i] = gv[j];
      }
      const unsigned key = fkey(v);
      mk = max(mk, key);
      if (do_k) atomicAdd(&loc.cnt[key >> 24], 1u);
    }
  }

  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");

  if (greedy) {
    block_argmax(bv, bi, sh);
    finish(cl, fin_v, fin_i, rank, nblk, bv, bi, out + row);
    return;
  }

  mk = block_max(mk, sh);

  // one round: this block's histogram (`val`, with the key ranges below
  // the digit at `shift` when `keys`, and its largest key when `key`)
  // goes into its slot of every rank's receive buffer by st.async, each
  // store completing its bytes on the receiver's barrier; the block then
  // waits for every rank's message on its own barrier and adds them in
  // rank order into tot (with `emass` at bin `ebin`) and s_max. Buffers
  // and barriers alternate by round: a rank sends round j + 2 only after
  // its round j + 1 completed, which needs this block's round j + 1
  // message, sent after this block read round j.
  int round = 0;
  auto exchange = [&](bool val, bool mass, bool keys, int shift, bool key,
                      int ebin, u64 emass) {
    __syncthreads();
    const int par = round & 1;
    const uint32_t bar = smem_u32(&mbar[par]);
    const uint32_t slot = smem_u32(&rx[par * nblk + rank]);
    const unsigned low = (1u << shift) - 1u;
    const int vchunks = !val ? 0 : mass ? MASS_CHUNKS : CNT_CHUNKS;
    const int chunks = vchunks + (keys ? KEY_CHUNKS : 0);
    for (int c = tid; c < nblk * chunks; c += NT) {
      const int r = c / chunks, q = c % chunks;
      const uint32_t dst = mapa(slot, r), rbar = mapa(bar, r);
      if (q < vchunks && mass) {
        u64 v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int b = 2 * q + j;
          v[j] = loc.mass[0][b] + ((u64)loc.mass[1][b] << LIMB) +
                 ((u64)loc.mass[2][b] << (2 * LIMB));
        }
        st_async(dst + 16 * q, v[0], v[1], rbar);
      } else if (q < vchunks) {
        st_async(dst + offsetof(Msg, cnt) + 16 * q,
                 *reinterpret_cast<const uint4*>(loc.cnt + 4 * q), rbar);
      } else {
        const int b = 4 * (q - vchunks);
        unsigned k4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          k4[j] = (loc.kmax[b + j] & low) << 16 | (loc.kinv[b + j] & low);
        st_async(dst + offsetof(Msg, keys) + 4 * b,
                 make_uint4(k4[0], k4[1], k4[2], k4[3]), rbar);
      }
    }
    if (key && tid < nblk)
      st_async(mapa(slot, tid) + offsetof(Msg, key), mk, mapa(bar, tid));
    __syncthreads();                   // loc read: zero it for the next pass
    {
      unsigned* w = reinterpret_cast<unsigned*>(&loc);
      for (int i = tid; i < (int)(sizeof(Local) / sizeof(unsigned)); i += NT)
        w[i] = 0u;
    }
    if (tid == 0)
      bar_expect(bar, nblk * (16 * chunks + (key ? 4 : 0)));
    bar_wait(bar, (round >> 1) & 1);
    const Msg* in = rx + par * nblk;
    if (val && tid < NBIN) {
      u64 m = tid == ebin ? emass : 0;
      for (int r = 0; r < nblk; ++r)
        m += mass ? in[r].mass[tid] : in[r].cnt[tid];
      tot[pad(tid)] = m;
    }
    if (key && tid == 0) {
      unsigned m = 0u;
      for (int r = 0; r < nblk; ++r) m = max(m, in[r].key);
      s_max = m;
    }
    __syncthreads();
    ++round;
    return in;
  };

  // warp 0's choice of a pass, for all: the pick; from pass 1 on the
  // chosen bin's key range over the cluster (with `ekey` when the bin is
  // `ebin`, the extra entries'), so lo == top when it holds one key (pass
  // 0 keeps no ranges: lo != top); and the bin's entries in the lower
  // ranks
  auto decide = [&](const Msg* in, int pass, int shift, unsigned prefix,
                    u64 base, u64 thr, float frac, int ebin, unsigned ekey) {
    if (tid < 32) {
      Pick pk = pick(tot, base, thr, frac);
      const unsigned low = (1u << shift) - 1u;
      const bool extra = pk.bin == ebin;
      unsigned hi = 0u, inv = 0u;
      if (pass > 0 && pk.bin < NBIN) {
        hi = extra ? ekey & low : 0u;
        inv = extra ? ~ekey & low : 0u;
        if (shift > 0 && tid < nblk) {
          const unsigned k = in[tid].keys[pk.bin];
          hi = max(hi, k >> 16);
          inv = max(inv, k & 0xffffu);
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) {
          hi = max(hi, __shfl_xor_sync(FULL, hi, off));
          inv = max(inv, __shfl_xor_sync(FULL, inv, off));
        }
      }
      const unsigned at = prefix | (unsigned)pk.bin << shift;
      pk.top = at | hi;
      pk.lo = pass > 0 ? at | (~inv & low) : ~pk.top;
      int c = tid < rank && pk.bin < NBIN ? (int)in[tid].cnt[pk.bin] : 0;
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        c += __shfl_xor_sync(FULL, c, off);
      pk.tie = c;
      if (tid == 0) s_pick = pk;
    }
    __syncthreads();
    return s_pick;
  };

  // the k descent: kth's key, the entries above it, the entries equal to
  // it in the row and in the blocks of lower rank. It stops at the first
  // pass whose chosen bin holds one key (always so at the last): that key
  // is kth, its count the bin's, the counts above it what lay above the
  // bin. Key ranges are kept from the second pass on (the first pass's
  // bins are wide and contended).
  unsigned kkey = 0u;
  int n_gt = 0, n_eq = 0, tie0 = 0;
  if (do_k) {
    unsigned prefix = 0u;
    u64 rem = (u64)kc;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      const unsigned hi = pass == 0 ? 0u : FULL << (shift + 8);
      if (pass > 0)                    // (pass 0's came with the load)
        each([&](int, float v) {
          const unsigned key = fkey(v);
          if ((key & hi) != prefix) return;
          const unsigned b = (key >> shift) & 255u;
          atomicAdd(&loc.cnt[b], 1u);
          add_key(loc, b, key);
        });
      const Msg* in = exchange(true, false, pass == 1 || pass == 2, shift,
                               pass == 0, -1, 0ull);
      const Pick pk = decide(in, pass, shift, prefix, 0ull, rem, -1.f, -1,
                             0u);
      rem -= pk.above;
      if (pk.lo == pk.top) {
        kkey = pk.top;
        n_eq = (int)tot[pad(pk.bin)];
        tie0 = pk.tie;
        break;
      }
      prefix |= (unsigned)pk.bin << shift;
    }
    n_gt = kc - (int)rem;
  }

  // the nucleus descent over the top-k multiset: entries above kth, and
  // kth's kc - n_gt copies added at its bin in each pass that holds it.
  // It stops, as the k descent does, at a chosen bin of one key.
  float thresh = INFINITY;
  if (do_p) {
    if (!do_k) exchange(false, false, false, 0, true, -1, 0ull);
    const float mx = kval(s_max);
    const u64 emass =
        do_k ? (u64)(kc - n_gt) * fixed(expf(kval(kkey) - mx)) : 0ull;
    unsigned prefix = 0u;
    u64 above = 0ull;
    u64 thr = 0ull;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      const unsigned hi = pass == 0 ? 0u : FULL << (shift + 8);
      each([&](int, float v) {
        const unsigned key = fkey(v);
        if ((do_k && key <= kkey) || (key & hi) != prefix) return;
        const unsigned b = (key >> shift) & 255u;
        const u64 f = fixed(expf(v - mx));
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          const unsigned part = (unsigned)(f >> (l * LIMB)) &
                                (l < 2 ? LIMB_MASK : FULL);
          if (part) atomicAdd(&loc.mass[l][b], part);
        }
        if (pass > 0) add_key(loc, b, key);
      });
      const bool in_k = do_k && (kkey & hi) == prefix;
      const int ebin = in_k ? (int)((kkey >> shift) & 255u) : -1;
      const Msg* in = exchange(true, true, pass == 1 || pass == 2, shift,
                               false, ebin, emass);
      const Pick pk = decide(in, pass, shift, prefix, above, thr,
                             pass == 0 ? p : -1.f, ebin, kkey);
      if (pass == 0) thr = nucleus_limit(p, pk.total);
      if (pk.bin >= NBIN) break;       // (never: the max qualifies)
      above += pk.above;
      if (pk.lo == pk.top) {
        thresh = kval(pk.top);
        break;
      }
      prefix |= (unsigned)pk.bin << shift;
    }
  }

  // the draw: masks and the first argmax of lfm + g. When the ties at kth
  // outnumber what k leaves for them, their ranks come from a block scan
  // of each NT entries in index order, on top of the lower ranks' count.
  __syncthreads();
  const bool ranked = do_k && n_eq > kc - n_gt;
  int tie_base = tie0;
  float best = -INFINITY;
  int bidx = INT_MAX;
  auto draw = [&](int i, float v, float gi, bool keep) {
    const float lfk = keep ? v : kNegInf;
    const float lfm = (!cut || lfk >= thresh) ? lfk : kNegInf;
    const float z = lfm + gi;
    if (better(z, s0 + i, best, bidx)) { best = z; bidx = s0 + i; }
  };
  if (!ranked) {
    each([&](int i, float v) {
      draw(i, v, g_at(i), !do_k || fkey(v) >= kkey);
    });
  } else {
    for (int i0 = 0; i0 < n; i0 += NT) {
      const int i = i0 + tid;
      const float v = i < n ? lf_at(i) : 0.f;
      const unsigned key = fkey(v);
      const bool eq = i < n && key == kkey;
      const int below = block_excl_scan(eq, sh);
      const bool keep =
          key > kkey || (eq && n_gt + tie_base + below + 1 <= kc);
      tie_base += __syncthreads_count(eq);
      if (i < n) draw(i, v, g_at(i), keep);
    }
  }
  block_argmax(best, bidx, sh);
  finish(cl, fin_v, fin_i, rank, nblk, best, bidx, out + row);
}

template <typename T>
cudaError_t launch(const void* logits, long long ld, const void* g,
                   const void* temp, const void* top_k, const void* top_p,
                   void* out, int S, int V, cudaStream_t st) {
  const int C = min(MAX_CLUSTER, (V + SLICE - 1) / SLICE);
  const int L = (V + C - 1) / C;
  if (L >= MAX_SLICE) return cudaErrorInvalidValue;
  const size_t rxb = 2 * (size_t)C * sizeof(Msg);
  const size_t lfg = 2 * (size_t)L * sizeof(float);
  const bool cached = rxb + lfg <= DYN_BYTES;
  const size_t smem = rxb + (cached ? lfg : 0);
  void (*kern)(const T*, long long, const float*, const float*,
               const long long*, const float*, long long*, int, int) =
      cached ? sample_kernel<T, true> : sample_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, S);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(logits), ld,
                           static_cast<const float*>(g),
                           static_cast<const float*>(temp),
                           static_cast<const long long*>(top_k),
                           static_cast<const float*>(top_p),
                           static_cast<long long*>(out), V, L);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// logits: [S, V] rows `ld` elements apart, dtype 0 float32, 1 bfloat16,
// 2 float16; g: [S, V] float32; temp, top_p: [S] float32; top_k: [S]
// int64; out: [S] int64
extern "C" int dkt_sample_epilogue(const void* logits, int dtype,
                                   long long ld, const void* g,
                                   const void* temp, const void* top_k,
                                   const void* top_p, void* out, int S,
                                   int V, void* stream) {
  if (S <= 0) return cudaSuccess;
  if (V <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(logits, ld, g, temp, top_k, top_p, out, S, V, st);
    case 1:
      return launch<__nv_bfloat16>(logits, ld, g, temp, top_k, top_p, out, S,
                                   V, st);
    case 2:
      return launch<__half>(logits, ld, g, temp, top_k, top_p, out, S, V, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
