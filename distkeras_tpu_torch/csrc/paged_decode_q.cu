// K3-q8, K3-q4 and their -anc variants: the launchers of
// paged_decode.cuh's kernel for int8 and packed int4 pages.

#include "paged_decode.cuh"

// int8 pages [N, Hkv, PL, D] with float32 scale planes [N, Hkv, PL]
extern "C" int dkt_paged_decode_q8(const void* q, const void* kp,
                                   const void* vp, const void* ks,
                                   const void* vs, const void* t,
                                   const void* table, void* o, void* ml,
                                   void* acc, void* cnt, int S, int W,
                                   int Hkv, int G, int D, int PL, int P,
                                   int N, int nsplit, int pps, float scale,
                                   int window, void* stream) {
  return dispatch_d<int8_t, kInt8, false>(
      args(q, kp, vp, ks, vs, t, table, nullptr, o, ml, acc, cnt, S, W, Hkv,
           G, D, PL, P, N, nsplit, pps, scale, window, stream));
}

extern "C" int dkt_paged_decode_q8_anc(const void* q, const void* kp,
                                       const void* vp, const void* ks,
                                       const void* vs, const void* t,
                                       const void* table, const void* anc,
                                       void* o, void* ml, void* acc,
                                       void* cnt, int S, int W, int Hkv,
                                       int G, int D, int PL, int P, int N,
                                       int nsplit, int pps, float scale,
                                       int window, void* stream) {
  return dispatch_d<int8_t, kInt8, true>(
      args(q, kp, vp, ks, vs, t, table, anc, o, ml, acc, cnt, S, W, Hkv, G,
           D, PL, P, N, nsplit, pps, scale, window, stream));
}

// packed int4 pages [N, Hkv, PL/2, D] with float32 scale planes
// [N, Hkv, PL]; PL is the page's position count (even)
extern "C" int dkt_paged_decode_q4(const void* q, const void* kp,
                                   const void* vp, const void* ks,
                                   const void* vs, const void* t,
                                   const void* table, void* o, void* ml,
                                   void* acc, void* cnt, int S, int W,
                                   int Hkv, int G, int D, int PL, int P,
                                   int N, int nsplit, int pps, float scale,
                                   int window, void* stream) {
  return dispatch_d<int8_t, kInt4, false>(
      args(q, kp, vp, ks, vs, t, table, nullptr, o, ml, acc, cnt, S, W, Hkv,
           G, D, PL, P, N, nsplit, pps, scale, window, stream));
}

extern "C" int dkt_paged_decode_q4_anc(const void* q, const void* kp,
                                       const void* vp, const void* ks,
                                       const void* vs, const void* t,
                                       const void* table, const void* anc,
                                       void* o, void* ml, void* acc,
                                       void* cnt, int S, int W, int Hkv,
                                       int G, int D, int PL, int P, int N,
                                       int nsplit, int pps, float scale,
                                       int window, void* stream) {
  return dispatch_d<int8_t, kInt4, true>(
      args(q, kp, vp, ks, vs, t, table, anc, o, ml, acc, cnt, S, W, Hkv, G,
           D, PL, P, N, nsplit, pps, scale, window, stream));
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
