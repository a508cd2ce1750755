// Fused sampling epilogue (K4) for Hopper (sm_90a): one token id per row
// from temperature-scaled logits, their descending sort and a Gumbel
// field, with rank top-k, the nucleus cut, the Gumbel-argmax draw and
// the greedy override fused into one kernel.
//
// Replaces the TPU kernel distkeras_tpu/ops/sampling.py `sample_epilogue`
// (pl.pallas_call at :180, body `_kernel` :98-143), row by row:
//   kc = clip(k, 1, V); kth = srt[kc - 1]
//   keep_k = k <= 0 | lf > kth | (lf == kth & n_gt + tie_rank <= kc)
//     (n_gt: entries above kth; tie_rank: the inclusive count of entries
//     equal to kth in index order, so ties go to the lowest index)
//   srt_m[i] = srt[i] for i < kcount (V when k <= 0, else kc), NEG_INF
//     after; probs = softmax(srt_m) (max srt[0]); excl = cumsum - probs
//   thresh = min over i with excl[i] < p of srt_m[i]
//   lfm = (p >= 1 | lfk >= thresh) ? lfk : NEG_INF
//   token = temp > 0 ? first argmax(lfm + g) : first argmax(lf)
// The one sort stays outside (torch.sort), as XLA's sort stayed outside
// the TPU kernel.
//
// Bound on this card: the three float32 [S, V] operands read once (lf,
// srt, g) at 3.35 TB/s; the work per entry is a few comparisons and one
// exp.
//
// Design (simple and right first): one block of 1024 threads per row.
// The row's three operands (384 KB at V = 32768) stay in the 50 MB L2
// across a few passes: (1) the count above kth; (2) the softmax sum over
// the first kcount sorted values; (3) a tile-by-tile inclusive scan of
// the probabilities (4 neighbouring entries per thread, a warp-shuffle
// scan, a carry between tiles) giving excl and the threshold (a block
// min); (4) the tie ranks as a block-wide integer scan in index order,
// the masks and the first-index argmax of lfm + g. Every sum and scan
// runs in a fixed order, so the same inputs give the same token; that
// order is not torch.cumsum's, so at a row whose excl lies within
// float32 rounding of p the nucleus may keep one token more or fewer
// than the plain version. Greedy rows run the argmax pass only.
// NEG_INF is the port's finite constant (ops/attention.py), so
// exp(NEG_INF - max) is 0 and no row ever holds a NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;
constexpr int NWARP = NT / 32;
constexpr int PER = 4;                  // neighbouring entries per thread
constexpr int TILE = NT * PER;
constexpr unsigned FULL = 0xffffffffu;
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

struct Sum {
  template <typename T> __device__ T operator()(T a, T b) const {
    return a + b;
  }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
  __device__ int operator()(int a, int b) const { return min(a, b); }
};

// block-wide reduction in a fixed order (shuffle tree, then warp 0)
template <typename T, typename Op>
__device__ T block_reduce(T v, T* sh, Op op, T identity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_xor_sync(FULL, v, off));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < NWARP ? sh[lane] : identity;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w = op(w, __shfl_xor_sync(FULL, w, off));
    if (lane == 0) sh[NWARP] = w;
  }
  __syncthreads();
  const T r = sh[NWARP];
  __syncthreads();
  return r;
}

// block-wide exclusive scan of one value per thread in thread order;
// `total` gets the sum over the block
template <typename T>
__device__ T block_excl_scan(T v, T* sh, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  T wex = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) wex = T(0);
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < NWARP ? sh[lane] : T(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += y;
    }
    T se = __shfl_up_sync(FULL, s, 1);
    if (lane == 0) se = T(0);
    sh[lane] = se;
    if (lane == 31) sh[NWARP] = s;
  }
  __syncthreads();
  const T res = sh[warp] + wex;
  total = sh[NWARP];
  __syncthreads();
  return res;
}

// first index of the largest value over the block (value, then index)
__device__ int block_argmax(float bv, int bi, float* shf, int* shi, int V) {
  const float mx = block_reduce(bv, shf, Max(), -INFINITY);
  return block_reduce(bv == mx ? bi : V, shi, Min(), V);
}

__global__ void __launch_bounds__(NT)
    sample_kernel(const float* __restrict__ lf_all,
                  const float* __restrict__ srt_all,
                  const float* __restrict__ g_all,
                  const float* __restrict__ temp,
                  const int* __restrict__ top_k,
                  const float* __restrict__ top_p, int* __restrict__ out,
                  int V) {
  __shared__ float shf[NWARP + 1];
  __shared__ int shi[NWARP + 1];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* lf = lf_all + (size_t)row * V;
  const float* srt = srt_all + (size_t)row * V;
  const float* g = g_all + (size_t)row * V;

  if (!(temp[row] > 0.f)) {           // greedy: first argmax of lf
    float bv = -INFINITY;
    int bi = V;
    for (int i = tid; i < V; i += NT) {
      const float v = lf[i];
      if (v > bv) { bv = v; bi = i; }
    }
    const int tok = block_argmax(bv, bi, shf, shi, V);
    if (tid == 0) out[row] = tok;
    return;
  }

  const int kk = top_k[row];
  const float p = top_p[row];
  const int kc = min(max(kk, 1), V);
  const float kth = srt[kc - 1];
  const int kcount = kk <= 0 ? V : kc;

  // (1) entries strictly above the k-th value
  int n_gt = 0;
  if (kk > 0) {
    int cnt = 0;
    for (int i = tid; i < V; i += NT) cnt += lf[i] > kth;
    n_gt = block_reduce(cnt, shi, Sum(), 0);
  }

  // (2)-(3) the nucleus threshold over the top-k-masked sorted row
  float thresh = kNegInf;
  if (p < 1.f) {
    const float mx = srt[0];
    float se = 0.f;
    for (int i = tid; i < kcount; i += NT) se += expf(srt[i] - mx);
    const float sum = block_reduce(se, shf, Sum(), 0.f);
    float carry = 0.f;
    float tmin = INFINITY;
    for (int base = 0; base < V; base += TILE) {
      float pr[PER];
      float ts = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = base + tid * PER + j;
        pr[j] = i < kcount ? expf(srt[i] - mx) / sum : 0.f;
        ts += pr[j];
      }
      float tile_total;
      float c = carry + block_excl_scan(ts, shf, tile_total);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = base + tid * PER + j;
        c += pr[j];
        if (i < V && c - pr[j] < p)
          tmin = fminf(tmin, i < kcount ? srt[i] : kNegInf);
      }
      carry += tile_total;
    }
    thresh = block_reduce(tmin, shf, Min(), INFINITY);
  }

  // (4) the masks, then the first argmax of lfm + g
  float bv = -INFINITY;
  int bi = V;
  int tie_carry = 0;
  for (int base = 0; base < V; base += TILE) {
    bool eq[PER];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = base + tid * PER + j;
      eq[j] = kk > 0 && i < V && lf[i] == kth;
      cnt += eq[j];
    }
    int rank = tie_carry;
    if (kk > 0) {
      int tile_total;
      rank += block_excl_scan(cnt, shi, tile_total);
      tie_carry += tile_total;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = base + tid * PER + j;
      if (i >= V) continue;
      const float v = lf[i];
      rank += eq[j];
      const bool keep_k = kk <= 0 || v > kth || (eq[j] && n_gt + rank <= kc);
      const float lfk = keep_k ? v : kNegInf;
      const float lfm = (p >= 1.f || lfk >= thresh) ? lfk : kNegInf;
      const float z = lfm + g[i];
      if (z > bv) { bv = z; bi = i; }
    }
  }
  const int tok = block_argmax(bv, bi, shf, shi, V);
  if (tid == 0) out[row] = tok;
}

}  // namespace

// lf, srt, g: [S, V] float32 rows; temp, top_p: [S] float32; top_k: [S]
// int32; out: [S] int32
extern "C" int dkt_sample_epilogue(const void* lf, const void* srt,
                                   const void* g, const void* temp,
                                   const void* top_k, const void* top_p,
                                   void* out, int S, int V, void* stream) {
  if (S <= 0) return cudaSuccess;
  if (V <= 0) return cudaErrorInvalidValue;
  sample_kernel<<<S, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lf), static_cast<const float*>(srt),
      static_cast<const float*>(g), static_cast<const float*>(temp),
      static_cast<const int*>(top_k), static_cast<const float*>(top_p),
      static_cast<int*>(out), V);
  return cudaGetLastError();
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
