// A chain of 4 KB cluster copies into shared memory, synchronous or one
// copy ahead, for NVIDIA Hopper (sm_90a): the latency a leaf visit exposes
// when it fetches its cluster and waits, against a prefetch.
//
// Replaces the TPU kernels experiments/dma_probe.py::kern_sync (:36) and
// ::kern_db (:50) (through run :78, pallas_call :79):
//   * kSync: the block's 256 threads copy cluster c_i (16 B each) into
//     shared memory with plain loads and stores, __syncthreads, one thread
//     adds its element 0, __syncthreads;
//   * kDb: the copy of c_{i+1} is issued with cp.async into the other slot
//     of a two-slot ring before the wait on c_i (commit_group /
//     wait_group 1), as pltpu.make_async_copy's double buffer maps to
//     Hopper.
//
// Contract. blocks is [C, 1024] f32 (C clusters of 4 KB; the TPU's
// (8, 128) tiles); c_i = (i * 611) % C for i < k. One block runs the whole
// chain, and its output is acc = sum_i blocks[c_i, 0], added in order by
// one thread (the plain version adds in the same order, so the two agree
// bit for bit).
//
// What bounds it: by design, the latency of each copy (the chain waits on
// it); its bytes, k * 4 KB, give the bound the record carries, and the
// time a copy takes is the number to read. C * 4 KB (8 MB at C = 2048)
// sits in the 50 MB L2 after the first pass.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // 16 B a thread: one cluster a step
constexpr int kCluster4 = kThreads;  // float4 a cluster: 4096 B
constexpr int kStride = 611;

enum Mode : int { kSync = 0, kDb = 1 };

__device__ __forceinline__ int cluster(int i, int C) {
  return static_cast<int>((static_cast<long long>(i) * kStride) % C);
}

__global__ void __launch_bounds__(kThreads)
sync_kernel(const float4* __restrict__ blocks, int C, int k,
            float* __restrict__ out) {
  __shared__ float4 buf[kCluster4];
  const int tid = threadIdx.x;
  float acc = 0.f;
  for (int i = 0; i < k; ++i) {
    buf[tid] = blocks[static_cast<size_t>(cluster(i, C)) * kCluster4 + tid];
    __syncthreads();
    if (tid == 0) acc += buf[0].x;
    __syncthreads();
  }
  if (tid == 0) *out = acc;
}

__device__ __forceinline__ void copy16_async(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads)
db_kernel(const float4* __restrict__ blocks, int C, int k,
          float* __restrict__ out) {
  __shared__ float4 ring[2][kCluster4];
  const int tid = threadIdx.x;
  float acc = 0.f;
  if (k > 0) copy16_async(&ring[0][tid], blocks + tid);  // c_0 = 0
  for (int i = 0; i < k; ++i) {
    if (i + 1 < k) {
      copy16_async(&ring[(i + 1) & 1][tid],
                   blocks + static_cast<size_t>(cluster(i + 1, C)) *
                                kCluster4 + tid);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // every thread's part of c_i is in
    if (tid == 0) acc += ring[i & 1][0].x;
    __syncthreads();  // slot i & 1 is read before copy i + 2 refills it
  }
  if (tid == 0) *out = acc;
}

}  // namespace

// Launches one mode (0 sync, 1 db) as one block on `stream`; returns
// cudaGetLastError() (0 = launched). blocks is [C, 1024] f32, 16-byte
// aligned; out is one float.
extern "C" int dma_probe_launch(int mode, const float* blocks, int C, int k,
                                float* out, void* stream) {
  if (C < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* b = reinterpret_cast<const float4*>(blocks);
  switch (mode) {
    case kSync:
      sync_kernel<<<1, kThreads, 0, st>>>(b, C, k, out);
      break;
    case kDb:
      db_kernel<<<1, kThreads, 0, st>>>(b, C, k, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
