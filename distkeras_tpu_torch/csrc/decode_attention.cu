// K2 over float32 or bfloat16 slab caches: the launcher of
// decode_attention.cuh's kernel for float caches
// (decode_attention_q8.cu holds the int8 one; one nvcc each, so the
// two build in parallel).

#include "decode_attention.cuh"

// float32 (dtype 0) or bfloat16 (dtype 1) cache
extern "C" int dkt_decode_attention(
    const void* q, const void* k, const void* v, void* o, void* ml,
    void* acc, void* cnt, int q_dtype, int dtype, int BH, int G, int D,
    long long q_row, long long q_g, long long s_row, long long s_pos, int t,
    int window, int chunk, int nsplit, int max_live, float scale,
    void* stream) {
  if (q_dtype != 0 && q_dtype != 1) return cudaErrorInvalidValue;
  const Args a{q, k, v, nullptr, nullptr, static_cast<float*>(o),
               static_cast<float*>(ml), static_cast<float*>(acc),
               static_cast<int*>(cnt), q_dtype, BH, G, D, q_row, q_g, s_row,
               s_pos, 0, 0, t, window, chunk, nsplit, max_live, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<float>(a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
