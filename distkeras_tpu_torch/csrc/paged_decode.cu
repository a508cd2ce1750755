// K3 and K3-anc over float32 or bfloat16 pages: the launchers of
// paged_decode.cuh's kernel for float pages (paged_decode_q.cu holds
// the int8 and int4 ones; one nvcc each, so the two build in
// parallel).

#include "paged_decode.cuh"

extern "C" int dkt_paged_decode(const void* q, const void* kp,
                                const void* vp, const void* t,
                                const void* table, void* o, void* ml,
                                void* acc, void* cnt, int dtype, int S,
                                int W, int Hkv, int G, int D, int PL, int P,
                                int N, int nsplit, int pps, float scale,
                                int window, void* stream) {
  return float_pages<false>(
      args(q, kp, vp, nullptr, nullptr, t, table, nullptr, o, ml, acc, cnt,
           S, W, Hkv, G, D, PL, P, N, nsplit, pps, scale, window, stream),
      dtype);
}

// K3-anc, float pages: anc is [S, W, W] bool (one byte per entry)
extern "C" int dkt_paged_decode_anc(const void* q, const void* kp,
                                    const void* vp, const void* t,
                                    const void* table, const void* anc,
                                    void* o, void* ml, void* acc, void* cnt,
                                    int dtype, int S, int W, int Hkv, int G,
                                    int D, int PL, int P, int N, int nsplit,
                                    int pps, float scale, int window,
                                    void* stream) {
  return float_pages<true>(
      args(q, kp, vp, nullptr, nullptr, t, table, anc, o, ml, acc, cnt, S,
           W, Hkv, G, D, PL, P, N, nsplit, pps, scale, window, stream),
      dtype);
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
