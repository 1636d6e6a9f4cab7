// A chain of 4 KB cluster copies into shared memory on Hopper's bulk-copy
// engine (sm_90a), synchronous or one copy ahead: the latency a leaf visit
// exposes when it fetches its cluster and waits, against a prefetch.
//
// Replaces the TPU kernels experiments/dma_probe.py::kern_sync (:36) and
// ::kern_db (:50) (through run :78, pallas_call :79). The TPU's
// pltpu.make_async_copy with a DMA semaphore is a copy engine that one
// issuer starts and waits on; Hopper's counterpart is the bulk copy (the
// TMA unit without a tensor map): one thread asks for a contiguous copy,
// and its completion lands on an mbarrier in shared memory as a count of
// bytes. So a block is one warp, and its lane 0 is both the issuer and
// the reader (the other lanes exit):
//   * kSync: for each copy i, lane 0 arrives on the one mbarrier with
//     expect_tx 4,096 B, issues one cp.async.bulk of cluster c_i, waits
//     with try_wait.parity at parity i & 1 and adds the slot's element 0
//     (make_async_copy(...).start(); .wait());
//   * kDb: two slots and two mbarriers; copy i + 1 is issued into the
//     other slot before the wait on copy i, at parity (i >> 1) & 1 for its
//     slot; the last iteration issues copy k too, and it is drained after
//     the loop (the TPU kernel's drain of the last started copy), so every
//     iteration is alike and no copy is in flight at the end.
// The first form gave the copy to 256 threads, each a 16 B load and store
// (kSync) or a 16 B cp.async (kDb), with two __syncthreads a copy.
//
// Ordering. The barriers are initialised (arrival count 1) and fenced
// with fence.mbarrier_init before a copy may complete on them. No generic
// write to a slot precedes a bulk copy into it; a slot's only read is lane
// 0's element 0, before that slot's next copy. Does that read need a fence
// before the next copy? By PTX's memory model, yes: one location accessed
// through the generic proxy and then the async proxy is ordered only by a
// proxy fence, and the data dependence of acc on the read does not order
// the copy's write after it (the compiler may issue the copy before the
// add that consumes the load). So lane 0 issues fence.proxy.async before
// every copy (kProxyFence 1); the A/B times the chain without it
// (kProxyFence:0, experiments/dma_probe.py) to price the fence.
//
// Contract. blocks is [C, 1024] f32 (C clusters of 4 KB; the TPU's
// (8, 128) tiles), 16-byte aligned; c_i = (i * 611) % C for i < k. One
// block runs the whole chain, and its output is acc = sum_i blocks[c_i, 0],
// added in order by one thread (the plain version adds in the same order,
// so the two agree bit for bit).
//
// What bounds it: by design, the latency of each copy (the chain waits on
// it); its bytes, k * 4 KB (k + 1 in kDb), give the bound the record
// carries, and the time a copy takes is the number to read. C * 4 KB (8 MB
// at C = 2048) sits in the 50 MB L2 after the first pass.

#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 32;     // one warp: lane 0 issues and reads
constexpr int kCluster4 = 256;   // float4 a cluster: 4096 B
constexpr int kProxyFence = 1;   // fence.proxy.async before every copy
constexpr int kStride = 611;
constexpr unsigned kBytes = kCluster4 * 16;

enum Mode : int { kSync = 0, kDb = 1 };

__device__ __forceinline__ int cluster(int i, int C) {
  return static_cast<int>((static_cast<long long>(i) * kStride) % C);
}

// Cluster c into `dst` by one bulk copy, completing on `bar`.
__device__ __forceinline__ void fetch(float4* dst, const float4* blocks,
                                      int c, uint64_t* bar) {
  if (kProxyFence) pt::proxy_fence();
  pt::arrive_expect_tx(bar, kBytes);
  pt::bulk_copy(dst, blocks + static_cast<size_t>(c) * kCluster4, kBytes,
                bar);
}

__device__ __forceinline__ void init(uint64_t* bar, int n) {
  for (int b = 0; b < n; ++b) pt::bar_init(bar + b, 1);
  pt::bar_init_fence();
}

__global__ void __launch_bounds__(kThreads)
sync_kernel(const float4* __restrict__ blocks, int C, int k,
            float* __restrict__ out) {
  __shared__ float4 buf[kCluster4];
  __shared__ uint64_t bar;
  if (threadIdx.x != 0) return;
  init(&bar, 1);
  float acc = 0.f;
  for (int i = 0; i < k; ++i) {
    fetch(buf, blocks, cluster(i, C), &bar);
    pt::bar_wait(&bar, i & 1);
    acc += buf[0].x;
  }
  *out = acc;
}

__global__ void __launch_bounds__(kThreads)
db_kernel(const float4* __restrict__ blocks, int C, int k,
          float* __restrict__ out) {
  __shared__ float4 ring[2][kCluster4];
  __shared__ uint64_t bar[2];
  if (threadIdx.x != 0) return;
  init(bar, 2);
  float acc = 0.f;
  if (k > 0) fetch(ring[0], blocks, 0, &bar[0]);  // c_0 = 0
  for (int i = 0; i < k; ++i) {
    const int j = (i + 1) & 1;
    fetch(ring[j], blocks, cluster(i + 1, C), &bar[j]);
    pt::bar_wait(&bar[i & 1], (i >> 1) & 1);
    acc += ring[i & 1][0].x;
  }
  if (k > 0) pt::bar_wait(&bar[k & 1], (k >> 1) & 1);  // drain copy k
  *out = acc;
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
