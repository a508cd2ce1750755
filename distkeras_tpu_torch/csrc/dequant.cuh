// Integer-to-float conversion without I2F, shared by quant_matmul.cu (K5)
// and paged_decode.cu (K3): Hopper issues 16 I2F a clock per SM, which at
// one conversion per weight or cache byte sits at the memory rate, so the
// kernels build each float from its integer's bits instead.
//
// int8: a byte v in [-128, 127] XOR 0x80 is v + 128 in [0, 255]; one byte
// permute (prmt) drops it into the low mantissa byte of 2^23 (0x4B000000),
// which reads as the float 2^23 + v + 128, and one subtraction of
// 2^23 + 128 leaves v exactly.
// int4: a nibble n in [-8, 7], masked out of its byte and XOR 8 in one
// lop3, is n + 8 in [0, 15]; the same permute and a subtraction of 2^23 + 8
// leave n exactly.
// bf16: an integer of at most 8 significant bits is exact in bf16, so the
// high half of its float's bits is its bf16 (one prmt packs two).
//
// tests/test_torch_conversion.py models these steps in numpy with the
// constants below (read from this file) for all 256 bytes and 16 nibbles.

#pragma once

#include <stdint.h>

namespace dq {

constexpr uint32_t kMagic = 0x4B000000u;        // 2^23 as float bits
constexpr uint32_t kSign8 = 0x80808080u;        // int8 -> v + 128
constexpr uint32_t kNibble = 0x0F0F0F0Fu;       // the low nibble of each byte
constexpr uint32_t kSign4 = 0x08080808u;        // int4 -> n + 8
constexpr uint32_t kPermByte = 0x7540u;         // byte i | magic's upper bytes
constexpr uint32_t kPermHigh = 0x7632u;         // two floats' high halves
constexpr float kBias8 = 8388736.0f;            // 2^23 + 128
constexpr float kBias4 = 8388616.0f;            // 2^23 + 8

// (a & b) ^ c in one instruction
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the four bytes of w, each biased to [0, 255] (int8) ...
__device__ __forceinline__ uint32_t bias8(uint32_t w) { return w ^ kSign8; }
// ... or the low (HI false) / high nibbles of w's bytes, biased to [0, 15]
template <bool HI>
__device__ __forceinline__ uint32_t bias4(uint32_t w) {
  return and_xor(HI ? (w >> 4) : w, kNibble, kSign4);
}

// byte i of a biased word as the float 2^23 + byte
template <int I>
__device__ __forceinline__ float magic(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, kMagic, kPermByte | I));
}

// the four signed bytes of w as floats
__device__ __forceinline__ void int8x4(uint32_t w, float (&f)[4]) {
  const uint32_t b = bias8(w);
  f[0] = magic<0>(b) - kBias8;
  f[1] = magic<1>(b) - kBias8;
  f[2] = magic<2>(b) - kBias8;
  f[3] = magic<3>(b) - kBias8;
}

// the four low (HI false) or high nibbles of w's bytes as floats
template <bool HI>
__device__ __forceinline__ void int4x4(uint32_t w, float (&f)[4]) {
  const uint32_t b = bias4<HI>(w);
  f[0] = magic<0>(b) - kBias4;
  f[1] = magic<1>(b) - kBias4;
  f[2] = magic<2>(b) - kBias4;
  f[3] = magic<3>(b) - kBias4;
}

// two small integers held exactly as floats -> one bf16x2 word (lo in the
// low half)
__device__ __forceinline__ uint32_t bf16x2_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), kPermHigh);
}

}  // namespace dq
