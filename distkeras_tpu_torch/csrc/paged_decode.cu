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
// value sum (the Pallas order, :212-235). An int4 page holds page_len/2
// byte rows: byte row r carries position r in its low nibble and
// position r + page_len/2 in its high nibble (`_unpack4` :116).
//
// K3-anc, the tree ancestor mask of tree speculation (the Pallas `anc`
// operand, `_kernel` :177-195), is a template flag on the same kernel,
// with exported launchers of its own for the three page variants: window
// row i admits the committed prefix (pos < t) and window column j's
// position t + j iff anc[s, i, j]; with SWA each row's own position is
// t + depth, depth = the row's ancestor count - 1. The slot's W x W mask
// is staged once per block as one 64-bit word per window row (W*G <= 64
// rows per kv head, so W <= 64). Everything else -- the pages walked
// ((t - window, t + W - 1]), the arithmetic, the rounding points -- is
// the window-causal kernel's, so a lower-triangular anc gives bitwise
// its output.
//
// Bound on this card: the bytes of the live K and V pages it must read
// (payload and scale planes, plus q and out) at 3.35 TB/s; a decode step
// does 4*W*G*D operations per cached position, far below the card's
// operations-per-byte balance.
//
// Design (simple and right first):
//   * one block of 128 threads per (slot, kv head); a loop inside the
//     block walks the slot's logical pages, a chunk of up to 128
//     positions (several pages) per step, reading table[s, p] itself;
//   * a page is skipped BEFORE any address is formed when its entry is
//     >= N (the unallocated sentinel; free slots carry a position past
//     capacity), when it starts past t + W - 1, or when it ends at or
//     before t - window. The TPU kernel clamped the index instead; here
//     an unclamped index would read out of bounds;
//   * the W*G query rows that share one kv head are scored together
//     against the staged chunk (scores in float32), masked with
//     pos <= t + row/G (and pos > t + row/G - window) using the finite
//     NEG_INF, folded into a per-row online softmax (m, l, acc in
//     shared memory); probabilities are rounded to the page dtype before
//     the P.V sum (float pages) or scaled by v_scale (quantized pages);
//     the l == 0 guard makes a row with no live key 0;
//   * quantized pages are staged with 16-byte loads of 16 int8 (int8:
//     16 dims of one position; int4: 16 dims of one byte row, i.e. of
//     two positions half a page apart), converted to float32 in shared
//     memory beside the chunk's scale planes. The quantized variants are
//     separate instantiations with their own exported launchers.
// Each thread issues four 16-byte loads of K and four of V before it
// uses any, but each chunk still waits for its own loads and only one
// block works on a (slot, head): the kernel is latency bound rather
// than at the card's memory rate. Splitting a long context over several
// blocks (as csrc/decode_attention.cu does) and prefetching the next
// chunk are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int NWARP = NT / 32;
constexpr int kChunkPositions = 128;        // positions staged per step
constexpr size_t kSmemLimit = 200 * 1024;   // of the 227 KB a block may use
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

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// a 4-bit two's-complement nibble as a float
__device__ __forceinline__ float nibble(int b) {
  return static_cast<float>(b > 7 ? b - 16 : b);
}

// page payload kinds: float32/bfloat16 pages (T), int8 pages, packed int4
enum Quant { kFloat = 0, kInt8 = 8, kInt4 = 4 };

size_t smem_bytes(int R, int CK, int D, bool quant) {
  const size_t floats = (size_t)R * D + (size_t)CK * (D + 1) +
                        (size_t)CK * D + (size_t)R * (CK + 1) +
                        (size_t)R * D + 3 * (size_t)R +
                        (quant ? 2 * (size_t)CK : 0);
  return 4 * floats + 4 * (size_t)CK;
}

template <typename T, int D, int QUANT, bool ANC>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const float* __restrict__ ksp,
                    const float* __restrict__ vsp, const int* __restrict__ t,
                    const int* __restrict__ table,
                    const uint8_t* __restrict__ anc, float* __restrict__ o,
                    int W, int Hkv, int G, int PL, int P, int N, int NPC,
                    float scale, int window) {
  extern __shared__ float sm[];
  // tree mask (ANC): bit j of AncBits[i] = anc[s, i, j]; Depth[i] =
  // popcount - 1, the row's own position offset
  __shared__ unsigned long long AncBits[ANC ? 64 : 1];
  __shared__ int Depth[ANC ? 64 : 1];
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LOADS_IN_FLIGHT = 4;
  constexpr bool Q = QUANT != kFloat;
  const int R = W * G;
  const int CK = NPC * PL;
  float* Qs = sm;                     // [R][D]
  float* Ks = Qs + R * D;             // [CK][D+1]
  float* Vs = Ks + CK * (D + 1);      // [CK][D]
  float* Ss = Vs + CK * D;            // [R][CK+1]
  float* Acc = Ss + R * (CK + 1);     // [R][D]
  float* Ms = Acc + R * D;            // [R]
  float* Ls = Ms + R;                 // [R]
  float* As = Ls + R;                 // [R]
  float* KSc = As + R;                // [CK] (quantized pages only)
  float* VSc = KSc + (Q ? CK : 0);    // [CK]
  int* Pid = reinterpret_cast<int*>(VSc + (Q ? CK : 0));  // [NPC]

  const int s = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ts = t[s];

  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i % D, w = r / G, g = r % G;
    Qs[i] = q[((((long long)s * W + w) * Hkv + h) * G + g) * D + d];
    Acc[i] = 0.f;
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

  // logical pages any window row can reach: positions (t - window, t+W-1]
  const long long hi = (long long)ts + W - 1;
  const long long last = hi / PL + 1;
  const int p_end = hi < 0 ? 0 : (last < P ? (int)last : P);
  int p_begin = 0;
  if (window > 0) {
    const long long lo = (long long)ts - window + 1;
    const long long first = lo / PL;
    p_begin = lo <= 0 ? 0 : (first < P ? (int)first : P);
  }

  for (int c0 = p_begin; c0 < p_end; c0 += NPC) {
    __syncthreads();  // the previous chunk's readers are done
    if (tid < NPC) {
      const int lp = c0 + tid;
      int pid = -1;
      if (lp < p_end) {
        const int e = table[(long long)s * P + lp];
        if (e >= 0 && e < N) pid = e;
      }
      Pid[tid] = pid;
    }
    __syncthreads();
    // stage the chunk: 16-byte loads, LOADS_IN_FLIGHT per thread issued
    // before any is used, so one memory latency covers several. A load
    // covers VEC dims of one position, or for int4 16 dims of one byte
    // row (two positions half a page apart)
    const int PR = QUANT == kInt4 ? PL / 2 : PL;  // payload rows per page
    const int NL = NPC * PR * D / VEC;
    for (int base = tid; base < NL; base += NT * LOADS_IN_FLIGHT) {
      uint4 kr[LOADS_IN_FLIGHT], vr[LOADS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < LOADS_IN_FLIGHT; ++u) {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
        const int i = base + u * NT;
        if (i < NL) {
          const int j = i * VEC / D, d = i * VEC % D;
          const int pid = Pid[j / PR];
          if (pid >= 0) {
            const long long off =
                (((long long)pid * Hkv + h) * PR + (j % PR)) * D + d;
            kr[u] = *reinterpret_cast<const uint4*>(kp + off);
            vr[u] = *reinterpret_cast<const uint4*>(vp + off);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS_IN_FLIGHT; ++u) {
        const int i = base + u * NT;
        if (i < NL) {
          const int j = i * VEC / D, d = i * VEC % D;
          const T* kx = reinterpret_cast<const T*>(&kr[u]);
          const T* vx = reinterpret_cast<const T*>(&vr[u]);
          if (QUANT == kInt4) {
            // byte row j % PR of page slot j / PR: low nibble = position
            // row, high nibble = position row + PL/2
            const int lo_pos = (j / PR) * PL + (j % PR);
            const int hi_pos = lo_pos + PR;
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const int kb = static_cast<int>(kx[e]) & 255;
              const int vb = static_cast<int>(vx[e]) & 255;
              Ks[lo_pos * (D + 1) + d + e] = nibble(kb & 15);
              Ks[hi_pos * (D + 1) + d + e] = nibble(kb >> 4);
              Vs[lo_pos * D + d + e] = nibble(vb & 15);
              Vs[hi_pos * D + d + e] = nibble(vb >> 4);
            }
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              Ks[j * (D + 1) + d + e] = to_f<T>(kx[e]);
              Vs[j * D + d + e] = to_f<T>(vx[e]);
            }
          }
        }
      }
    }
    if (Q) {
      for (int j = tid; j < CK; j += NT) {
        const int pid = Pid[j / PL];
        const long long off =
            ((long long)(pid < 0 ? 0 : pid) * Hkv + h) * PL + (j % PL);
        KSc[j] = pid >= 0 ? ksp[off] : 0.f;
        VSc[j] = pid >= 0 ? vsp[off] : 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < R * CK; i += NT) {
      const int r = i / CK, j = i % CK;
      const int pg = j / PL;
      float x = kNegInf;
      if (Pid[pg] >= 0) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          dot = fmaf(Qs[r * D + d], Ks[j * (D + 1) + d], dot);
        const int pos = (c0 + pg) * PL + (j % PL);
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
        if (Q) dot = dot * scale * KSc[j];
        else dot = dot * scale;
        x = ok ? dot : kNegInf;
      }
      Ss[r * (CK + 1) + j] = x;
    }
    __syncthreads();
    for (int r = warp; r < R; r += NWARP) {
      float mx = kNegInf;
      for (int j = lane; j < CK; j += 32)
        if (Pid[j / PL] >= 0) mx = fmaxf(mx, Ss[r * (CK + 1) + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < CK; j += 32) {
        float p = 0.f;
        if (Pid[j / PL] >= 0) p = expf(Ss[r * (CK + 1) + j] - m_new);
        sum += p;
        Ss[r * (CK + 1) + j] = Q ? p * VSc[j] : round_to<T>(p);
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
    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, d = i % D;
      float a = Acc[i] * As[r];
      const float* pr = Ss + r * (CK + 1);
      for (int j = 0; j < CK; ++j) a = fmaf(pr[j], Vs[j * D + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i % D, w = r / G, g = r % G;
    const float l = Ls[r];
    o[((((long long)s * W + w) * Hkv + h) * G + g) * D + d] =
        Acc[i] / (l == 0.f ? 1.f : l);
  }
}

template <typename T, int D, int QUANT, bool ANC>
cudaError_t launch(const float* q, const void* kp, const void* vp,
                   const float* ksp, const float* vsp, const int* t,
                   const int* table, const uint8_t* anc, float* o, int S,
                   int W, int Hkv, int G, int PL, int P, int N, float scale,
                   int window, cudaStream_t stream) {
  constexpr bool Q = QUANT != kFloat;
  if (QUANT == kInt4 && PL % 2) return cudaErrorInvalidValue;
  if (W * G > 64 || (ANC && anc == nullptr)) return cudaErrorInvalidValue;
  // pages staged per step: as many as fit kChunkPositions positions,
  // halved until the block's shared memory fits kSmemLimit
  int NPC = PL < kChunkPositions ? kChunkPositions / PL : 1;
  while (NPC > 1 && smem_bytes(W * G, NPC * PL, D, Q) > kSmemLimit)
    NPC /= 2;
  const size_t smem = smem_bytes(W * G, NPC * PL, D, Q);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kern = paged_decode_kernel<T, D, QUANT, ANC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S, Hkv);
  kern<<<grid, NT, smem, stream>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), ksp, vsp, t,
      table, anc, o, W, Hkv, G, PL, P, N, NPC, scale, window);
  return cudaGetLastError();
}

template <typename T, int QUANT, bool ANC>
cudaError_t dispatch_d(int D, const float* q, const void* kp,
                       const void* vp, const float* ksp, const float* vsp,
                       const int* t, const int* table, const uint8_t* anc,
                       float* o, int S, int W, int Hkv, int G, int PL, int P,
                       int N, float scale, int window, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32, QUANT, ANC>(q, kp, vp, ksp, vsp, t, table, anc,
                                       o, S, W, Hkv, G, PL, P, N, scale,
                                       window, st);
    case 64:
      return launch<T, 64, QUANT, ANC>(q, kp, vp, ksp, vsp, t, table, anc,
                                       o, S, W, Hkv, G, PL, P, N, scale,
                                       window, st);
    case 128:
      return launch<T, 128, QUANT, ANC>(q, kp, vp, ksp, vsp, t, table, anc,
                                        o, S, W, Hkv, G, PL, P, N, scale,
                                        window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// float32 (dtype 0) or bfloat16 (dtype 1) pages
template <bool ANC>
int float_pages(const void* q, const void* kp, const void* vp,
                const void* t, const void* table, const void* anc, void* o,
                int dtype, int S, int W, int Hkv, int G, int D, int PL,
                int P, int N, float scale, int window, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const int* ti = static_cast<const int*>(t);
  const int* tb = static_cast<const int*>(table);
  const uint8_t* an = static_cast<const uint8_t*>(anc);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, kFloat, ANC>(D, qf, kp, vp, nullptr, nullptr,
                                          ti, tb, an, of, S, W, Hkv, G, PL,
                                          P, N, scale, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, kFloat, ANC>(
        D, qf, kp, vp, nullptr, nullptr, ti, tb, an, of, S, W, Hkv, G, PL,
        P, N, scale, window, st);
  return cudaErrorInvalidValue;
}

// int8 (QUANT kInt8) or packed int4 (kInt4) pages with scale planes
template <int QUANT, bool ANC>
int quant_pages(const void* q, const void* kp, const void* vp,
                const void* ks, const void* vs, const void* t,
                const void* table, const void* anc, void* o, int S, int W,
                int Hkv, int G, int D, int PL, int P, int N, float scale,
                int window, void* stream) {
  return dispatch_d<int8_t, QUANT, ANC>(
      D, static_cast<const float*>(q), kp, vp, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(t),
      static_cast<const int*>(table), static_cast<const uint8_t*>(anc),
      static_cast<float*>(o), S, W, Hkv, G, PL, P, N, scale, window,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int dkt_paged_decode(const void* q, const void* kp,
                                const void* vp, const void* t,
                                const void* table, void* o, int dtype, int S,
                                int W, int Hkv, int G, int D, int PL, int P,
                                int N, float scale, int window,
                                void* stream) {
  return float_pages<false>(q, kp, vp, t, table, nullptr, o, dtype, S, W,
                            Hkv, G, D, PL, P, N, scale, window, stream);
}

// K3-anc, float pages: anc is [S, W, W] bool (one byte per entry)
extern "C" int dkt_paged_decode_anc(const void* q, const void* kp,
                                    const void* vp, const void* t,
                                    const void* table, const void* anc,
                                    void* o, int dtype, int S, int W,
                                    int Hkv, int G, int D, int PL, int P,
                                    int N, float scale, int window,
                                    void* stream) {
  return float_pages<true>(q, kp, vp, t, table, anc, o, dtype, S, W, Hkv,
                           G, D, PL, P, N, scale, window, stream);
}

// int8 pages [N, Hkv, PL, D] with float32 scale planes [N, Hkv, PL]
extern "C" int dkt_paged_decode_q8(const void* q, const void* kp,
                                   const void* vp, const void* ks,
                                   const void* vs, const void* t,
                                   const void* table, void* o, int S, int W,
                                   int Hkv, int G, int D, int PL, int P,
                                   int N, float scale, int window,
                                   void* stream) {
  return quant_pages<kInt8, false>(q, kp, vp, ks, vs, t, table, nullptr, o,
                                   S, W, Hkv, G, D, PL, P, N, scale, window,
                                   stream);
}

extern "C" int dkt_paged_decode_q8_anc(const void* q, const void* kp,
                                       const void* vp, const void* ks,
                                       const void* vs, const void* t,
                                       const void* table, const void* anc,
                                       void* o, int S, int W, int Hkv, int G,
                                       int D, int PL, int P, int N,
                                       float scale, int window,
                                       void* stream) {
  return quant_pages<kInt8, true>(q, kp, vp, ks, vs, t, table, anc, o, S,
                                  W, Hkv, G, D, PL, P, N, scale, window,
                                  stream);
}

// packed int4 pages [N, Hkv, PL/2, D] with float32 scale planes
// [N, Hkv, PL]; PL is the page's position count (even)
extern "C" int dkt_paged_decode_q4(const void* q, const void* kp,
                                   const void* vp, const void* ks,
                                   const void* vs, const void* t,
                                   const void* table, void* o, int S, int W,
                                   int Hkv, int G, int D, int PL, int P,
                                   int N, float scale, int window,
                                   void* stream) {
  return quant_pages<kInt4, false>(q, kp, vp, ks, vs, t, table, nullptr, o,
                                   S, W, Hkv, G, D, PL, P, N, scale, window,
                                   stream);
}

extern "C" int dkt_paged_decode_q4_anc(const void* q, const void* kp,
                                       const void* vp, const void* ks,
                                       const void* vs, const void* t,
                                       const void* table, const void* anc,
                                       void* o, int S, int W, int Hkv, int G,
                                       int D, int PL, int P, int N,
                                       float scale, int window,
                                       void* stream) {
  return quant_pages<kInt4, true>(q, kp, vp, ks, vs, t, table, anc, o, S,
                                  W, Hkv, G, D, PL, P, N, scale, window,
                                  stream);
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
