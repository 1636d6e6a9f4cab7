// V back-to-back nearest-hit visits of a 1024-ray tile to a 64-triangle
// cluster, for NVIDIA Hopper (sm_90a): the floor of a leaf test with no
// traversal around it, and the cost of each way of fetching the cluster.
//
// Replaces the TPU kernel experiments/leafmt_probe.py::_kernel (:36,
// through run :168, pallas_call :172) and its modes:
//   * kPure (pure): the cluster is staged once into shared memory and
//     every visit tests it from there;
//   * kCond (cond): kPure, plus one branch a visit on a kernel argument
//     the compiler cannot fold (the TPU mode's lax.cond join): visit i
//     runs unless besti < skip - 1, which never holds at skip = 0;
//   * kDma (dma): a synchronous fetch on every visit, in K5's form: each
//     lane reads the visit's rows from global memory with __ldg, nothing
//     staged;
//   * kDb (db, and db2): the cluster staged into a two-slot shared-memory
//     ring with cp.async one visit ahead (commit_group / wait_group 1), as
//     pltpu.make_async_copy maps to Hopper. The TPU's db2 differs from db
//     only in using a dynamic slot offset, which this kernel does anyway,
//     so db2 is this mode too.
//
// Contract. A block is one 1024-ray tile (the TPU probe's (8, 128) tile);
// n is a multiple of 1024, every tile computing the same function per ray.
// Clusters are [C, 64, 12] f32 rows (v0, e1, e2, n = e1 x e2; tris.cu's
// layout). Visit i (0 <= i < V) tests cluster 0 (kPure, kCond) or
// cluster i % C (kDma, kDb), slot w = 0..63 in order, with pt::mt_hit at
// t_min 1e-3: a strict-less nearest update of (closest, besti = i*64 + w).
// Outputs closest [n] (t_max where nothing hit) and besti [n] (-1).
//
// What bounds it: FP32 work, 37 operations a slot (ray-triangle pair),
// all of it in one SM a tile: the launch occupies min(tiles, 132) SMs.
// Built with -fmad=false and the plain version's operation order
// (leafmt_probe.py), so kernel and plain version agree bit for bit.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kWidth = 64;
constexpr int kCluster4 = kWidth * 3;  // float4 a cluster: 3072 B
constexpr float kTMin = 1e-3f;

enum Mode : int { kPure = 0, kCond = 1, kDma = 2, kDb = 3 };

struct Ray {
  float o1, o2, o3, d1, d2, d3;
};

// One visit: the 64 slots of `rows` in order (GLOBAL: read with __ldg from
// global memory; else from shared memory).
template <bool GLOBAL>
__device__ __forceinline__ void visit(const float4* rows, int i, const Ray& r,
                                      float& closest, int& besti) {
#pragma unroll
  for (int w = 0; w < kWidth; ++w) {
    const float4 p = GLOBAL ? __ldg(rows + 3 * w) : rows[3 * w];
    const float4 q = GLOBAL ? __ldg(rows + 3 * w + 1) : rows[3 * w + 1];
    const float4 s = GLOBAL ? __ldg(rows + 3 * w + 2) : rows[3 * w + 2];
    float t, u, v;
    if (pt::mt_hit<false>(p, q, s, r.o1, r.o2, r.o3, r.d1, r.d2, r.d3, kTMin,
                          closest, t, u, v)) {
      closest = t;
      besti = i * kWidth + w;
    }
  }
}

__device__ __forceinline__ void copy16_async(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <int MODE>
__global__ void __launch_bounds__(kTile, 1)
leafmt_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
              const float* __restrict__ oz, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const float* __restrict__ tmax,
              const float4* __restrict__ clusters, int C, int visits,
              int skip, float* __restrict__ t_out,
              int* __restrict__ best_out) {
  __shared__ float4 ring[2][kCluster4];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kTile + tid;
  const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
  float closest = tmax[i];
  int besti = -1;
  if (MODE == kPure || MODE == kCond) {
    for (int j = tid; j < kCluster4; j += kTile) ring[0][j] = clusters[j];
    __syncthreads();
    for (int v = 0; v < visits; ++v) {
      // the cluster never changes here, so without this compiler barrier
      // its 768 words would be hoisted out of the loop (and spilled); a
      // visit reads its rows from shared memory, as the TPU's from SMEM
      asm volatile("" ::: "memory");
      // kCond: a branch on the loop-carried besti, which no compiler can
      // hoist out of the loop; at skip = 0 it is always taken
      if (MODE == kCond && besti < skip - 1) continue;
      visit<false>(ring[0], v, r, closest, besti);
    }
  } else if (MODE == kDma) {
    for (int v = 0; v < visits; ++v)
      visit<true>(clusters + static_cast<size_t>(v % C) * kCluster4, v, r,
                  closest, besti);
  } else {
    const auto issue = [&](int v) {
      if (tid < kCluster4)
        copy16_async(&ring[v & 1][tid],
                     clusters + static_cast<size_t>(v % C) * kCluster4 + tid);
      asm volatile("cp.async.commit_group;\n" ::);
    };
    issue(0);
    for (int v = 0; v < visits; ++v) {
      if (v + 1 < visits) {
        issue(v + 1);  // into the slot visit v - 1 read
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();  // every thread's part of visit v's copy is in
      visit<false>(ring[v & 1], v, r, closest, besti);
      __syncthreads();  // slot v & 1 is read before visit v + 2 refills it
    }
  }
  t_out[i] = closest;
  best_out[i] = besti;
}

template <int MODE>
void launch(int tiles, cudaStream_t st, const float* ox, const float* oy,
            const float* oz, const float* dx, const float* dy,
            const float* dz, const float* tmax, const float4* cl, int C,
            int visits, int skip, float* t_out, int* best_out) {
  leafmt_kernel<MODE><<<tiles, kTile, 0, st>>>(
      ox, oy, oz, dx, dy, dz, tmax, cl, C, visits, skip, t_out, best_out);
}

}  // namespace

// Launches one mode (0 pure, 1 cond, 2 dma, 3 db) over n / 1024 tiles on
// `stream`; returns cudaGetLastError() (0 = launched). clusters is
// [C, 64, 12] f32, 16-byte aligned; skip is the cond mode's branch bound
// (0: every visit runs).
extern "C" int leafmt_probe_launch(int mode, const float* ox, const float* oy,
                                   const float* oz, const float* dx,
                                   const float* dy, const float* dz,
                                   const float* tmax, const float* clusters,
                                   int C, int visits, int skip, int n,
                                   float* t_out, int* best_out,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n % kTile || C < 1 || visits < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = n / kTile;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* cl = reinterpret_cast<const float4*>(clusters);
  switch (mode) {
    case kPure:
      launch<kPure>(tiles, st, ox, oy, oz, dx, dy, dz, tmax, cl, C, visits,
                    skip, t_out, best_out);
      break;
    case kCond:
      launch<kCond>(tiles, st, ox, oy, oz, dx, dy, dz, tmax, cl, C, visits,
                    skip, t_out, best_out);
      break;
    case kDma:
      launch<kDma>(tiles, st, ox, oy, oz, dx, dy, dz, tmax, cl, C, visits,
                   skip, t_out, best_out);
      break;
    case kDb:
      launch<kDb>(tiles, st, ox, oy, oz, dx, dy, dz, tmax, cl, C, visits,
                  skip, t_out, best_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
