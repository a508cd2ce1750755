// Hopper (sm_90a) building blocks shared by the tensor-core kernels of
// moe_bwd.cu (K6b, K6c), flash_bwd.cu (K1dq, K1dkv) and flash_fwd.cu
// (K1f): mbarriers, TMA loads and the tensor-map encoder, cp.async, the
// 128-byte-swizzle slice loader, the wgmma wrappers (A from shared
// memory or from registers) and their descriptors, the fences, the
// accumulator fragment's coordinates, and the flash kernels' producer
// warp and tensor maps. Every layout here is the one wgmma's
// 128-byte-swizzle descriptors read: 64 bf16 columns (128 bytes) a row,
// the 16-byte piece c of row i at ((c ^ (i % 8)) * 16), tiles 1024-byte
// aligned.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes < 16 zero-fills the rest (0: all)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// generic-proxy writes (cp.async, st.shared) before async-proxy reads
// (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier that completes a phase after `count` arrivals (and the bytes
// announced by bar_expect)
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the initialised barriers, visible to the async proxy (TMA)
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the thread's arrival, and the bytes the stage's TMA copies will bring
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// the thread's arrival alone
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one box of a 3-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// one box of a 4-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load4(uint32_t dst,
                                          const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// one operand of a product: a row-major bf16 source whose row r is
// tok[r] (gathered; -1 reads zeros) or r itself (tok null), rows `rs`
// elements apart; rows r >= nrows read zeros, and so do columns >= ld. A
// contiguous operand with a TMA map (map not null: expert e of a [E,
// nrows, ld] tensor) comes in by TMA, the rest by cp.async.
struct Rows {
  const bf16* src;
  const int* tok;
  int ld, nrows;
  bool vec;  // ld, rs and src 16-byte aligned: 16-byte copies
  const CUtensorMap* map;
  int e;
  long long rs;
};

__device__ __forceinline__ Rows rows_of(const bf16* src, const int* tok,
                                        int ld, int nrows,
                                        const CUtensorMap* map = nullptr,
                                        int e = 0) {
  const bool vec = (ld % 8) == 0 &&
                   (reinterpret_cast<uintptr_t>(src) % 16) == 0;
  return Rows{src, tok, ld, nrows, vec, map, e, ld};
}

// rows [0, nrows) of ld columns, `rs` elements apart, no gather, no
// map, copied element by element: for an operand that TMA cannot take
// (a base or stride off 16 bytes), so 16-byte copies could not either
__device__ __forceinline__ Rows strided_rows(const bf16* src, int ld,
                                             long long rs, int nrows) {
  return Rows{src, nullptr, ld, nrows, false, nullptr, 0, rs};
}

// rows [r0, r0 + NR) x columns [c0, c0 + NC) of an operand into NC / 64
// chunks of [NR][64] at dst, 128-byte rows in the 128-byte swizzle (the
// 16-byte piece c of row i at ((c ^ (i % 8)) * 16)): the layout wgmma's
// B128 descriptors read (and TMA's SWIZZLE_128B writes). NT threads
// share the copy; tid is this thread's index among them.
template <int NR, int NC, int NT>
__device__ __forceinline__ void load_slice(uint32_t dst, const Rows& o,
                                           int r0, int c0,
                                           int tid = threadIdx.x) {
  constexpr int PR = NC / 8;  // 16-byte pieces a row
  static_assert((NR * PR) % NT == 0, "whole pieces a thread");
  if (o.vec) {
#pragma unroll
    for (int q = 0; q < NR * PR / NT; ++q) {
      const int p = tid + q * NT;
      const int i = p / PR;
      const int c = p % PR;
      const int r = r0 + i;
      int sr = -1;
      if (r < o.nrows) sr = o.tok != nullptr ? __ldg(o.tok + r) : r;
      const int col = c0 + c * 8;
      const bool in = sr >= 0 && col < o.ld;
      cp_async16(dst + (c / 8) * (NR * 128) + i * 128 +
                     (((c % 8) ^ (i % 8)) << 4),
                 in ? o.src + (size_t)sr * o.rs + col : o.src, in ? 16 : 0);
    }
    return;
  }
  // a width, stride or base that is not a multiple of 8 elements:
  // element by element
#pragma unroll 1
  for (int q = 0; q < NR * PR / NT; ++q) {
    const int p = tid + q * NT;
    const int i = p / PR;
    const int c = p % PR;
    const int r = r0 + i;
    int sr = -1;
    if (r < o.nrows) sr = o.tok != nullptr ? __ldg(o.tok + r) : r;
    const int col = c0 + c * 8;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (sr >= 0) {
      const unsigned short* src =
          reinterpret_cast<const unsigned short*>(o.src) + (size_t)sr * o.rs;
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (col + t < o.ld)
          w[t / 2] |= static_cast<uint32_t>(__ldg(src + col + t))
                      << (16 * (t % 2));
    }
    st_shared16(dst + (c / 8) * (NR * 128) + i * 128 +
                    (((c % 8) ^ (i % 8)) << 4),
                w[0], w[1], w[2], w[3]);
  }
}

// the wgmma shared-memory descriptor of a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// keeps the compiler from moving reads of an accumulator (or of an A
// fragment still being read by an asynchronous wgmma) across it
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[64 x 128] += A[64 x 16] @ B[16 x 128], A and B in shared memory; TA /
// TB: the operand is MN-major (wgmma's transpose bit)
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64]
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64], A from registers (wgmma's A
// fragment: four bf16 pairs a thread, see acc_to_a), B in shared memory;
// TB: B is MN-major (the transpose bit)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// d[64 x 128] += A[64 x 16] @ B[16 x 128], A from registers
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
}

// the ring, 1024-byte aligned (the swizzle's period)
__device__ __forceinline__ uint32_t ring_base(uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// the accumulator's element i of this thread: tile row and column
// (wgmma's m64nNk16 f32 fragment, the warpgroup's rows 64 * wg ..)
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x;
  return (t / 128) * 64 + ((t % 128) / 32) * 16 + (t % 32) / 4 +
         ((i % 4) / 2) * 8;
}
__device__ __forceinline__ int acc_col(int i) {
  return (i / 4) * 8 + (threadIdx.x % 4) * 2 + (i % 2);
}

// two float32 values as one register of two bf16 (x in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an m64nNk16 accumulator (N / 2 floats, as acc_row / acc_col place
// them) rounded to bf16 as the A fragments of the N / 16 k-steps of a
// product that multiplies it: k-step j's fragment holds columns 16j ..
// 16j + 15, whose accumulator elements are 8j .. 8j + 7 in this order
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2)
    a[i / 8][(i % 8) / 2] = pack_bf16(d[i], d[i + 1]);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, fetched through the
// runtime so that the library need not link libcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// --- the flash kernels' producer warp and copies -------------------------
// (flash_fwd.cu, flash_bwd.cu). A block holds consumer warpgroups and one producer warp; the producer
// fills a ring of shared-memory stages from [B, S, H, D] or [B, H, S, D]
// operands, by TMA or, where TMA cannot take an operand, element by element.

struct Strides {
  long long b, s, h;  // element strides; head_dim is contiguous
};

// the producer warp: rows [r0, r0 + R) of head h of batch b into D / 64
// chunks of [R][64] at dst, by TMA (lane 0, completing on bar) or by the
// warp's own loads
template <int R, int D, bool TMA>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const CUtensorMap* map,
                                          bool hfirst, const bf16* base,
                                          Strides st, int S, int b, int h,
                                          int r0, uint32_t bar, int lane) {
  if (TMA) {
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load4(dst + c * (R * 128), map, bar, 64 * c, hfirst ? h : r0,
                  hfirst ? r0 : h, b);
    }
  } else {
    load_slice<R, D, 32>(dst, strided_rows(base + b * st.b + h * st.h, D,
                                           st.s, S),
                         r0, 0, lane);
  }
}

// the producer warp's stage: what its lanes stored before this is
// ordered before the arrival; with TMA, lane 0 announces the bytes the
// copies issued next will complete
template <bool TMA>
__device__ __forceinline__ void begin_stage(uint32_t bar, uint32_t bytes,
                                            int lane) {
  if (TMA) {
    __syncwarp();
    if (lane == 0) bar_expect(bar, bytes);
  }
}

// without TMA the warp's stores are made visible to wgmma and announced
// by lane 0's arrival
template <bool TMA>
__device__ __forceinline__ void end_stage(uint32_t bar, int lane) {
  if (!TMA) {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) bar_arrive(bar);
  }
}

// the block's barriers: full[s] (the producer's copies), empty[s] (one
// arrival from each consumer warp of the WGS warpgroups), once (the tiles
// loaded once)
template <int STAGES, int WGS>
__device__ __forceinline__ uint32_t init_bars(uint64_t* mem) {
  const uint32_t bars = smem_u32(mem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      bar_init(bars + 8 * s, 1);
      bar_init(bars + 8 * (STAGES + s), 4 * WGS);
    }
    bar_init(bars + 16 * STAGES, 1);
    bar_init_fence();
  }
  __syncthreads();
  return bars;
}

// the consumer warp is done with stage s
__device__ __forceinline__ void release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(empty);
}

// TMA takes an operand whose base is 16-byte aligned and whose strides
// are multiples of 16 bytes (a dim of extent 1 is never stepped)
inline bool tma_ok(const void* base, Strides st, int S, int H, int B) {
  const auto ok = [](long long stride, int n) {
    return n == 1 || stride % 8 == 0;
  };
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && ok(st.s, S) &&
         ok(st.h, H) && ok(st.b, B);
}

// the 4-d map (head_dim, positions, heads, batch) of one bf16 operand in
// boxes of [rows][64], in the 128-byte swizzle, with positions and heads
// in the order of their strides (*hfirst: heads first, as in bhsd's
// [B, H, S, D] read as (D, S, H, B) it is not)
inline cudaError_t flash_map(CUtensorMap* map, bool* hfirst,
                             const void* base, int D, int S, int H, int B,
                             Strides st, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const long long ss = S > 1 ? st.s : D, hs = H > 1 ? st.h : D,
                  bs = B > 1 ? st.b : D;
  *hfirst = hs < ss;
  const cuuint64_t dims[4] = {(cuuint64_t)D,
                              (cuuint64_t)(*hfirst ? H : S),
                              (cuuint64_t)(*hfirst ? S : H), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(2 * (*hfirst ? hs : ss)),
                                 (cuuint64_t)(2 * (*hfirst ? ss : hs)),
                                 (cuuint64_t)(2 * bs)};
  const cuuint32_t box[4] = {64, (cuuint32_t)(*hfirst ? 1 : rows),
                             (cuuint32_t)(*hfirst ? rows : 1), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
