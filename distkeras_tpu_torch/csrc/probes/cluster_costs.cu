// Costs of the Hopper primitives K4 (csrc/sampling.cu) is built from, on
// one card, at K4's launch shape (8 rows x a cluster of 8 blocks of 512
// threads):
//   - __syncthreads, barrier.cluster (cluster.sync) at cluster sizes 8,
//     4 and 2, and one dependent distributed-shared-memory load: 200
//     repetitions inside a kernel, per-block %globaltimer, averaged;
//   - an empty cluster launch and one with a single cluster.sync: 50
//     launches captured in a CUDA graph and replayed between CUDA events,
//     at several dynamic shared-memory sizes and block widths.
//
// A measurement, not a kernel of the port: nothing builds it. Run it
// from the repo root on the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o cluster_costs distkeras_tpu_torch/csrc/probes/cluster_costs.cu \
//       && ./cluster_costs
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdio.h>

namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int REPS = 200;
__device__ unsigned long long elapsed[3][64];

__global__ void k_syncthreads(int*) {
  const unsigned long long t0 = now();
  for (int i = 0; i < REPS; ++i) __syncthreads();
  if (threadIdx.x == 0) elapsed[0][blockIdx.x] = now() - t0;
}

__global__ void k_cluster_sync(int*) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned long long t0 = now();
  for (int i = 0; i < REPS; ++i) cl.sync();
  if (threadIdx.x == 0) elapsed[1][blockIdx.x] = now() - t0;
}

__global__ void k_dsmem(int* sink) {
  __shared__ unsigned buf[1024];
  cg::cluster_group cl = cg::this_cluster();
  buf[threadIdx.x] = threadIdx.x;
  cl.sync();
  unsigned s = 0;
  const unsigned long long t0 = now();
  for (int i = 0; i < REPS; ++i)  // each load's address needs the last one
    s += cl.map_shared_rank(buf, (cl.block_rank() + 1 + i) %
                                     cl.num_blocks())[(threadIdx.x + s) & 511];
  if (threadIdx.x == 0) elapsed[2][blockIdx.x] = now() - t0;
  cl.sync();
  if (s == 0xdeadbeefu) *sink = s;
}

__global__ void k_empty(int* sink) {
  extern __shared__ int d[];
  if (threadIdx.x == 0 && blockIdx.x == 0xffff) *sink = d[0];
}

__global__ void k_one_sync(int* sink) {
  extern __shared__ int d[];
  cg::this_cluster().sync();
  if (threadIdx.x == 0 && blockIdx.x == 0xffff) *sink = d[0];
}

cudaLaunchConfig_t config(int cx, int rows, int nt, size_t smem,
                          int cluster, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cx, rows);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  return cfg;
}

void inside(void (*k)(int*), int slot, const char* name, int cluster,
            int* sink) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(64, 1, 512, 0, cluster, 0, &attr);
  for (int rep = 0; rep < 2; ++rep) cudaLaunchKernelEx(&cfg, k, sink);
  cudaDeviceSynchronize();
  unsigned long long h[3][64];
  cudaMemcpyFromSymbol(h, elapsed, sizeof(h));
  double sum = 0;
  for (int b = 0; b < 64; ++b) sum += h[slot][b];
  printf("%-34s cluster %d: %7.1f ns each\n", name, cluster,
         sum / 64 / REPS);
}

void replayed(void (*k)(int*), const char* name, int cx, int nt,
              size_t smem, int cluster, int* sink) {
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cudaStream_t st;
  cudaStreamCreate(&st);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(cx, 8, nt, smem, cluster, st, &attr);
  cudaGraph_t g;
  cudaGraphExec_t ge;
  cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal);
  for (int i = 0; i < 50; ++i) cudaLaunchKernelEx(&cfg, k, sink);
  cudaStreamEndCapture(st, &g);
  cudaGraphInstantiate(&ge, g, 0);
  cudaGraphLaunch(ge, st);
  cudaStreamSynchronize(st);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0, st);
  cudaGraphLaunch(ge, st);
  cudaEventRecord(e1, st);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  printf("%-10s grid %dx8, %4d threads, %6zu B dynamic smem, cluster %d: "
         "%.2f us a launch (graph replay)\n",
         name, cx, nt, smem, cluster, ms / 50 * 1e3f);
  cudaGraphExecDestroy(ge);
  cudaGraphDestroy(g);
  cudaStreamDestroy(st);
}

int main() {
  int* sink;
  cudaMalloc(&sink, sizeof(int));
  inside(k_syncthreads, 0, "__syncthreads (512 threads)", 8, sink);
  for (int c : {8, 4, 2}) inside(k_cluster_sync, 1, "cluster.sync", c, sink);
  inside(k_dsmem, 2, "dependent DSMEM load", 8, sink);
  for (size_t smem : {0, 32768, 83000, 201000}) {
    replayed(k_empty, "empty", 8, 512, smem, 8, sink);
    replayed(k_one_sync, "one sync", 8, 512, smem, 8, sink);
  }
  replayed(k_empty, "empty", 8, 256, 83000, 8, sink);
  replayed(k_empty, "empty", 1, 512, 0, 0, sink);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
