// Nearest ray-triangle hit over the implicit-heap BVH with a regrouped
// leaf phase (config.regroup), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_pathtracer/ops/pallas_bvh_rg.py
//   ::_kernel_nearest_rg (:230, through packet_trace_rg :622).
//
// Contract (pallas_bvh_rg.py:1-42, :630-634, as ops/cuda_bvh_rg.py states
// it): every accepted hit is an exact per-pair Moller-Trumbore accept
// (pt::mt_hit, bvh.cu's test); commits are deferred, so node culling uses
// the last committed closest; the final per-ray minimum does not depend
// on the order of the tests; so t equals bvh.cu's for the same winner,
// winners differ only where two slots give the same t, and leaf visits
// are never fewer than bvh.cu's.
//
// Rounds. Each thread walks one ray (bvh.cu's walk, pt::heap_node_step)
// until it has recorded kWindow leaf visits or its walk ends; a visit is
// recorded as the key (leaf << 7 | ray) and popped, with no test. The
// block then
//   1. sorts its 128 * kWindow keys (bitonic, in shared memory), which
//      groups the round's (ray, leaf) pairs by leaf;
//   2. numbers the distinct leaves (a block-wide scan);
//   3. stages `stage` leaves' triangle rows (P x 48 B each) in shared
//      memory at a time, each demanded leaf once;
//   4. tests every (pair, slot) of the staged leaves, one a thread, with
//      pt::mt_hit against the ray's committed closest;
//   5. keeps per ray the minimum of (t, slot) by a 64-bit atomicMin of
//      (order-preserving bits of t) << 32 | slot, so the result does not
//      depend on the order of the tests;
// and each ray commits its minimum, and the next round starts. A ray's
// result and counters depend on its own walk alone (the window is per
// ray), so the plain version (ops/cuda_bvh_rg.py) runs the same rounds
// over all rays at once and agrees bit for bit.
//
// Design. The TPU kernel packs a 1024-ray packet's sparse leaf demand
// into windows of (ray, leaf) pairs and contracts their operands on the
// MXU, because its scalar leaf loop tests each cluster against all 1024
// lanes. A 128-thread block plays the packet here: the leaf phase becomes
// leaf-major (a leaf's rows read from memory once a round for all the
// block's rays that reach it, the threads busy on (pair, slot) items
// rather than each walking its own leaf), which is the shape a
// tensor-core leaf test would need (ROADMAP). Its cost is the sort, the
// barriers and the idle threads of rays that finish early.
//
// What bounds it: FP32 ALU work, as bvh.cu (24 flops a node step, 37 a
// slot of a recorded visit), against the distinct node and triangle rows
// a round reads; the sort adds log2(128 * kWindow)^2 / 2 compare passes
// a round. The window trades rounds (sorts, barriers) against the extra
// leaf visits of later commits: 2 keeps the dragon-class knot's leaf
// visits at 1.17x the heap kernel's on its primary rays, inside the 1.5x
// the JAX package holds its regroup kernel to (tests/test_packet_rg.py:
// 88-89), where 4 gives 1.69x and 8 2.35x (PERF.md).
//
// Numerics: -fmad=false and IEEE division, the plain version's order.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kThreads = 128;  // rays a block
constexpr int kRayBits = 7;    // log2(kThreads)
constexpr int kWindow = 2;     // leaf visits a ray records a round
constexpr int kPairs = kThreads * kWindow;  // a power of two
constexpr unsigned kEmpty = 0xFFFFFFFFu;
constexpr unsigned long long kNoHit = ~0ull;

// t's bits mapped so that unsigned order is float order (t not NaN).
__device__ __forceinline__ unsigned ordered_bits(float t) {
  const unsigned b = __float_as_uint(t);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__global__ void __launch_bounds__(kThreads)
rg_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
          const float* __restrict__ oz, const float* __restrict__ dx,
          const float* __restrict__ dy, const float* __restrict__ dz,
          const float* __restrict__ tmax, const float4* __restrict__ nodes,
          const float4* __restrict__ tri, unsigned first_leaf, int P,
          float t_min, int n, int stage,
          float* __restrict__ t_out, int* __restrict__ tri_out,
          int* __restrict__ cnt) {
  extern __shared__ float4 rows[];  // stage * P * 3 triangle rows
  __shared__ unsigned keys[kPairs];
  __shared__ unsigned short rank[kPairs];  // distinct-leaf number
  __shared__ unsigned short start[kPairs + 1];
  __shared__ unsigned long long best_key[kThreads];
  __shared__ float ray[7][kThreads];  // o, d, committed closest
  __shared__ int warp_sum[kThreads / 32];
  __shared__ int n_pairs;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kThreads + tid;
  const bool real = i < n;
  const float o1 = real ? ox[i] : 0.f, o2 = real ? oy[i] : 0.f;
  const float o3 = real ? oz[i] : 0.f;
  const float d1 = real ? dx[i] : 1.f, d2 = real ? dy[i] : 0.f;
  const float d3 = real ? dz[i] : 0.f;
  float closest = real ? tmax[i] : -1.f;
  const float i1 = 1.0f / d1, i2 = 1.0f / d2, i3 = 1.0f / d3;
  const bool n1 = i1 < 0.f, n2 = i2 < 0.f, n3 = i3 < 0.f;
  int best = -1;
  int nb = 0, nsg = 0, nl = 0, steps = 0;
  unsigned idx = closest > 0.f ? 1u : 0u, bs = 1u;
  const int per_leaf = 3 * P;  // float4 rows of a leaf

  while (true) {
    // 1. walk: record up to kWindow leaf visits
    int rec = 0;
    while (idx != 0u && rec < kWindow) {
      if (idx >= first_leaf) {
        keys[tid * kWindow + rec] =
            ((idx - first_leaf) << kRayBits) | static_cast<unsigned>(tid);
        ++rec;
        ++nl;
        pt::pop_bitstack(bs, idx);
      } else {
        ++steps;
        pt::heap_node_step(nodes, idx, bs, closest, o1, o2, o3, i1, i2, i3,
                           n1, n2, n3, nb, nsg);
      }
    }
    for (int k = rec; k < kWindow; ++k) keys[tid * kWindow + k] = kEmpty;
    ray[0][tid] = o1;
    ray[1][tid] = o2;
    ray[2][tid] = o3;
    ray[3][tid] = d1;
    ray[4][tid] = d2;
    ray[5][tid] = d3;
    ray[6][tid] = closest;
    best_key[tid] = kNoHit;
    if (tid == 0) n_pairs = 0;
    if (!__syncthreads_or(rec > 0)) break;  // every walk has ended

    // 2. bitonic sort of the keys: pairs grouped by leaf, empties last
    for (int size = 2; size <= kPairs; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int e = tid; e < kPairs / 2; e += kThreads) {
          const int lo = 2 * stride * (e / stride) + (e % stride);
          const int hi = lo + stride;
          const bool up = (lo & size) == 0;
          const unsigned a = keys[lo], b = keys[hi];
          if ((a > b) == up) {
            keys[lo] = b;
            keys[hi] = a;
          }
        }
        __syncthreads();
      }
    }

    // 3. number the distinct leaves: thread tid scans its kWindow
    // consecutive sorted keys, then a block-wide exclusive scan
    int firsts = 0, valid = 0;
    for (int k = 0; k < kWindow; ++k) {
      const int e = tid * kWindow + k;
      const unsigned key = keys[e];
      if (key == kEmpty) break;
      ++valid;
      if (e == 0 || (keys[e - 1] >> kRayBits) != (key >> kRayBits)) ++firsts;
    }
    int incl = firsts;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    if (valid) atomicAdd(&n_pairs, valid);
    __syncthreads();
    int before = 0, n_leaves = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) before += warp_sum[w];
      n_leaves += warp_sum[w];
    }
    int u = before + incl - firsts;  // leaves numbered before mine
    for (int k = 0; k < valid; ++k) {
      const int e = tid * kWindow + k;
      if (e == 0 || (keys[e - 1] >> kRayBits) != (keys[e] >> kRayBits)) {
        start[u] = static_cast<unsigned short>(e);
        ++u;
      }
      rank[e] = static_cast<unsigned short>(u - 1);
    }
    if (tid == 0) start[n_leaves] = static_cast<unsigned short>(n_pairs);
    __syncthreads();

    // 4-5. the staged leaves' (pair, slot) items, min (t, slot) per ray
    for (int u0 = 0; u0 < n_leaves; u0 += stage) {
      const int ub = min(stage, n_leaves - u0);
      for (int e = tid; e < ub * per_leaf; e += kThreads) {
        const unsigned leaf = keys[start[u0 + e / per_leaf]] >> kRayBits;
        rows[e] = __ldg(tri + static_cast<size_t>(leaf) * per_leaf +
                        e % per_leaf);
      }
      __syncthreads();
      const int p0 = start[u0];
      const int items = (start[u0 + ub] - p0) * P;
      for (int it = tid; it < items; it += kThreads) {
        const int p = p0 + it / P;
        const int k = it % P;
        const unsigned key = keys[p];
        const int r = static_cast<int>(key & (kThreads - 1));
        const float4* row = rows + ((rank[p] - u0) * P + k) * 3;
        float t, uu, vv;
        if (pt::mt_hit(row[0], row[1], row[2], ray[0][r], ray[1][r],
                       ray[2][r], ray[3][r], ray[4][r], ray[5][r], t_min,
                       ray[6][r], t, uu, vv)) {
          if (t == 0.f) t = 0.f;  // one zero: -0 ties +0
          const unsigned slot = (key >> kRayBits) * P + k;
          atomicMin(&best_key[r],
                    (static_cast<unsigned long long>(ordered_bits(t)) << 32) |
                        slot);
        }
      }
      __syncthreads();
    }

    // 6. commit
    const unsigned long long bk = best_key[tid];
    if (bk != kNoHit) {
      closest = from_ordered(static_cast<unsigned>(bk >> 32));
      best = static_cast<int>(bk & 0xFFFFFFFFull);
    }
    __syncthreads();
  }
  if (real) {
    t_out[i] = closest;
    tri_out[i] = best;
    cnt[i] = nb;
    cnt[n + i] = nsg;
    cnt[2 * n + i] = nl;
    cnt[3 * n + i] = 0;
    cnt[4 * n + i] = steps;
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 =
// launched). nodes is [2*first_leaf, 8] f32 and tri [T, 12] f32 (bvh.cu's
// tables), both 16-byte aligned; first_leaf < 2^25 (a key below kEmpty);
// cnt is [5, n] int32.
extern "C" int bvh_rg_launch(const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const float* tmax, const float* nodes,
                             const float* tri, int first_leaf, int P,
                             float t_min, int n, float* t_out,
                             int* tri_out, int* cnt, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1 || first_leaf >= (1 << 25) || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // leaves staged at once: about 12 KB of rows, at least one leaf
  const int leaf_bytes = P * 3 * static_cast<int>(sizeof(float4));
  const int stage = max(1, min(8, 12288 / leaf_bytes));
  const size_t smem = static_cast<size_t>(stage) * leaf_bytes;
  if (smem > 32 * 1024) {  // beside the ~7 KB of static shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        rg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kThreads - 1) / kThreads);
  rg_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, tmax, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tri),
      static_cast<unsigned>(first_leaf), P, t_min, n, stage, t_out,
      tri_out, cnt);
  return static_cast<int>(cudaGetLastError());
}
