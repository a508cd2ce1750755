// K7: JAX's threefry2x32 draw over the partitionable counters, with its
// epilogue, in one launch (ops/prng.py holds the plain version).
//
// Replaces no Pallas kernel. In JAX, XLA fuses the 20 threefry rounds
// (add / rotate / xor of two 32-bit words, the key injected every four
// rounds) into the op that consumes the bits. Written out in PyTorch the
// same hash is a chain of about a hundred elementwise launches per draw,
// on a serving step that is already host bound; here it is one.
//
// Work: out[r, i] for R keys and n counters per key. Counter i of a row is
// the 64-bit flat index, hashed as (hi, lo) = (i >> 32, i & 0xffffffff)
// under key r (JAX's iota_2x32_shape with threefry_partitionable), giving
// the two words (x0, x1). The epilogue (mode):
//   0 SPLIT   out int64 [R, n, 2] = (x0, x1)            (jax.random.split)
//   1 BITS    out int64 [R, n]    = x0 ^ x1             (random_bits, 32)
//   2 UNIFORM out float [R, n]    = max(lo, f * (hi - lo) + lo) with
//             f = bits((x0 ^ x1) >> 9 | 0x3f800000) - 1 (uniform, f32)
//   3 GUMBEL  out float [R, n]    = -log(-log(u)), u the UNIFORM draw with
//             lo = FLT_MIN, hi = 1                      (gumbel, mode low)
// Bits, splits and uniforms are bitwise JAX's: integer work, and the
// uniform's scale in one fused multiply-add (__fmaf_rn), as XLA contracts
// f * span + lo (the plain version computes it exactly in float64 and
// rounds once). The Gumbel field goes through CUDA's logf (within 1 ulp),
// so it agrees with the plain version within a few ulps, not bitwise.
//
// Bound: bytes written (8 or 16 bytes an element for the integer modes,
// 4 for the float ones; the keys are read once). The hash is ~100 integer
// operations an element, far under the card's integer rate at that many
// bytes. One thread an element, a grid-stride loop over R * n.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__device__ __forceinline__ float uniform(uint32_t bits, float lo,
                                         float span) {
  const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  return fmaxf(lo, __fmaf_rn(f, span, lo));
}

__global__ void prng_kernel(const long long* __restrict__ keys, int R,
                            long long n, int mode, float lo, float span,
                            void* __restrict__ out) {
  const long long total = static_cast<long long>(R) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += stride) {
    const long long r = e / n;
    const unsigned long long i = static_cast<unsigned long long>(e - r * n);
    uint32_t x0 = static_cast<uint32_t>(i >> 32);
    uint32_t x1 = static_cast<uint32_t>(i & 0xffffffffull);
    threefry2x32(static_cast<uint32_t>(keys[2 * r]),
                 static_cast<uint32_t>(keys[2 * r + 1]), x0, x1);
    if (mode == 0) {
      long long* o = static_cast<long long*>(out) + 2 * e;
      o[0] = static_cast<long long>(x0);
      o[1] = static_cast<long long>(x1);
    } else if (mode == 1) {
      static_cast<long long*>(out)[e] = static_cast<long long>(x0 ^ x1);
    } else {
      float u = uniform(x0 ^ x1, lo, span);
      if (mode == 3) u = -logf(-logf(u));
      static_cast<float*>(out)[e] = u;
    }
  }
}

}  // namespace

// keys: int64 [R, 2] (uint32 words); out as the mode says; minval and
// maxval: the uniform's range (the Gumbel mode passes FLT_MIN and 1).
extern "C" int dkt_prng(const void* keys, int R, long long n, int mode,
                        float minval, float maxval, void* out,
                        void* stream) {
  if (R < 0 || n < 0 || mode < 0 || mode > 3) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(R) * n;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  // the span rounds to float32 first, as the plain version subtracts two
  // float32 scalars (host float arithmetic: IEEE single on x86-64)
  const float span = maxval - minval;
  prng_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), R, n, mode, minval, span, out);
  return cudaGetLastError();
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
