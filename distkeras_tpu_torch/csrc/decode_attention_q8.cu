// K2-q8 over int8 slab caches (int4 slab caches hold one int8 byte
// per entry): the launcher of decode_attention.cuh's kernel.

#include "decode_attention.cuh"

// int8 cache with float32 per-token scale planes [BH, L] (element strides
// ss_row, ss_pos)
extern "C" int dkt_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, void* o, void* ml, void* acc, void* cnt, int q_dtype,
    int BH, int G, int D, long long q_row, long long q_g, long long s_row,
    long long s_pos, long long ss_row, long long ss_pos, int t, int window,
    int chunk, int nsplit, int max_live, float scale, void* stream) {
  if (q_dtype != 0 && q_dtype != 1) return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<float*>(o),
               static_cast<float*>(ml), static_cast<float*>(acc),
               static_cast<int*>(cnt), q_dtype, BH, G, D, q_row, q_g, s_row,
               s_pos, ss_row, ss_pos, t, window, chunk, nsplit, max_live,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch_d<int8_t>(a);
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
