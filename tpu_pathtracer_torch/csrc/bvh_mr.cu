// Nearest / any ray-triangle hit over the implicit-heap BVH by a packet
// walk with leaf queues, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel experiments/pallas_bvh_mr.py::_kernel_mr (:214)
//   with shadow=False (through packet_trace_mr :430)    -> kNearest,
//   with shadow=True  (through packet_occluded_mr :489) -> kAnyHit,
// the JAX package's measured-negative multirow decision record: 8
// independent 128-ray rows a TPU tile, each with its own traversal state
// and a queue of leaf clusters. No config reaches it.
//
// Contract (the results of the TPU kernel; ops/cuda_bvh_mr.py spells out
// the walk):
//   * a packet is 32 consecutive rays, one warp, sharing one walk over the
//     heap (nodes from 1, children of i at 2i and 2i+1, node i >=
//     first_leaf is leaf i - first_leaf over slots [l*P, (l+1)*P)): one
//     node index, one uint32 bitstack, a queue of up to kQueue leaves;
//   * node round (pallas_bvh_mr.py:257-291): every lane slab-tests both
//     children against its own closest; the packet enters a child that
//     some lane enters; with both entered, the right one first if more
//     lanes that enter both find it strictly nearer than find it not, the
//     other remembered in the bitstack; with none, the packet pops;
//   * leaf push (:243-255): a packet at a leaf with room in its queue
//     queues it and pops, then steps on in the same round;
//   * leaf round: fires when the queue is full or the packet cannot step
//     (its node index is 0) (fire_and_active :362-374 read for one packet:
//     its clause "every active row has work queued" holds for one row
//     whenever the queue is not empty, and taken alone would make the
//     queue one deep); every lane tests every queued leaf's slots, queue
//     order then slot order, with pt::mt_hit and a strict <;
//   * nearest: t = closest (the ray's t_max on a miss), tri = the winning
//     heap slot (-1 on a miss). Per ray this is bvh.cu's nearest hit: the
//     cull against a closest that lags behind the queue only adds visits;
//   * any-hit: a lane that hits is occluded and retires (closest =
//     -1e30, :335); a packet whose lanes have all retired stops after its
//     leaf round (:357-358);
//   * lanes past n are padding: t_max 0 (nearest, inert) or -1 (any-hit,
//     retired), as the TPU wrapper pads (:445, :502);
//   * counters per packet (int32 [3, packets]): nodes_both, nodes_single
//     (node rounds entering two / one child) and leaf_visits (queued leaves
//     tested).
//
// Design. On the TPU the 8 rows of a tile are the packets and advance in
// lockstep rounds: one row's leaf round makes all 8 wait (the convoy
// PERFORMANCE.md:463-468 measured). Here a packet is a warp, the natural
// SIMD packet of the card, and the 8 warps of a 256-thread block never
// wait for each other: each keeps its own walk, steps by __ballot_sync
// votes, and has its own slice of shared memory. The walk state is
// warp-uniform (computed from votes), so every lane runs the same control
// flow and the votes always see all 32 lanes. A leaf round stages each
// queued leaf's triangle rows (three float4 a slot, 32 slots at a time)
// into the warp's slice with coalesced loads; every lane then reads them
// as broadcasts.
//
// What bounds it: FP32 ALU work, 24 flops a lane a node round (two slab
// tests) and 37 flops and one IEEE division a lane a leaf slot, against
// 28 B a ray in and 8 B out; node and triangle rows are gathers that the
// L2 serves. A packet's lanes all pay for the union of their walks: the
// price of one walk a warp, against bvh.cu's divergent per-ray walks.
//
// Numerics: -fmad=false, IEEE division, bvh_common.cuh's slab test and
// Moller-Trumbore, the plain version's order: the two agree bit for bit,
// counters included.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kQueue = 4;   // ops/cuda_bvh_mr.py QUEUE
constexpr int kStage = 32;  // slots staged at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr float kRetired = -1e30f;

enum Mode : int { kNearest = 0, kAnyHit = 1 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
mr_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
          const float* __restrict__ oz, const float* __restrict__ dx,
          const float* __restrict__ dy, const float* __restrict__ dz,
          const float* __restrict__ tmax, const float4* __restrict__ nodes,
          const float4* __restrict__ tri, unsigned first_leaf, int P,
          float t_min, int n, float* __restrict__ t_out,
          int* __restrict__ tri_out, bool* __restrict__ occ_out,
          int* __restrict__ cnt) {
  __shared__ float4 stage[kWarps][3 * kStage];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int packets = (n + kLanes - 1) / kLanes;
  const int packet = blockIdx.x * kWarps + warp;
  if (packet >= packets) return;  // the whole warp
  const int i = packet * kLanes + lane;
  const bool live = i < n;
  float o1 = 0.f, o2 = 0.f, o3 = 0.f, d1 = 1.f, d2 = 0.f, d3 = 0.f;
  float closest = MODE == kAnyHit ? -1.f : 0.f;
  if (live) {
    o1 = ox[i]; o2 = oy[i]; o3 = oz[i];
    d1 = dx[i]; d2 = dy[i]; d3 = dz[i];
    closest = tmax[i];
  }
  const float i1 = 1.0f / d1, i2 = 1.0f / d2, i3 = 1.0f / d3;
  const bool n1 = i1 < 0.f, n2 = i2 < 0.f, n3 = i3 < 0.f;
  int best = -1;
  bool occ = false;
  // the packet's walk: the same value in every lane
  unsigned idx = 1u, bs = 1u;
  int queue[kQueue] = {0, 0, 0, 0};
  int queued = 0;
  int nb = 0, nsg = 0, nl = 0;
  float4* slice = stage[warp];

  while (idx != 0u || queued > 0) {
    if (queued > 0 && (queued >= kQueue || idx == 0u)) {
      // leaf round
#pragma unroll
      for (int q = 0; q < kQueue; ++q) {
        if (q >= queued) break;
        ++nl;
        const int leaf_base = queue[q] * P;
        for (int c0 = 0; c0 < P; c0 += kStage) {
          const int m = min(kStage, P - c0);
          __syncwarp();  // the previous slots are no longer read
          const float4* src = tri + 3 * static_cast<size_t>(leaf_base + c0);
          for (int e = lane; e < 3 * m; e += kLanes) slice[e] = __ldg(src + e);
          __syncwarp();
          for (int k = 0; k < m; ++k) {
            float t, u, v;
            if (pt::mt_hit(slice[3 * k], slice[3 * k + 1], slice[3 * k + 2],
                           o1, o2, o3, d1, d2, d3, t_min, closest, t, u,
                           v)) {
              if (MODE == kAnyHit) {
                occ = true;
                closest = kRetired;
              } else {
                closest = t;
                best = leaf_base + c0 + k;
              }
            }
          }
        }
      }
      queued = 0;
      if (MODE == kAnyHit && __all_sync(kFull, closest < 0.f)) idx = 0u;
      continue;
    }
    // node round: a packet at a leaf with room queues it and pops on
    if (idx >= first_leaf && queued < kQueue) {
#pragma unroll
      for (int q = 0; q < kQueue; ++q)
        if (q == queued) queue[q] = static_cast<int>(idx - first_leaf);
      ++queued;
      pt::pop_bitstack(bs, idx);
    }
    if (idx == 0u || idx >= first_leaf) continue;
    const unsigned l = idx << 1;
    const float4 la = __ldg(nodes + 2 * static_cast<size_t>(l));
    const float4 lb = __ldg(nodes + 2 * static_cast<size_t>(l) + 1);
    const float4 ra = __ldg(nodes + 2 * static_cast<size_t>(l) + 2);
    const float4 rb = __ldg(nodes + 2 * static_cast<size_t>(l) + 3);
    const float lhit = pt::slab_entry(la.x, la.y, la.z, la.w, lb.x, lb.y, o1,
                                      o2, o3, i1, i2, i3, n1, n2, n3, closest);
    const float rhit = pt::slab_entry(ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, o1,
                                      o2, o3, i1, i2, i3, n1, n2, n3, closest);
    const bool tl = lhit < closest;
    const bool tr = rhit < closest;
    const bool right_nearer = rhit < lhit;
    const unsigned vl = __ballot_sync(kFull, tl);
    const unsigned vr = __ballot_sync(kFull, tr);
    const int n_right = __popc(__ballot_sync(kFull, tl && tr && right_nearer));
    const int n_left = __popc(__ballot_sync(kFull, tl && tr && !right_nearer));
    if (vl && vr) {
      ++nb;
      idx = l + (n_right > n_left ? 1u : 0u);
      bs = (bs << 1) + 1u;
    } else if (vl || vr) {
      ++nsg;
      idx = vl ? l : l + 1u;
      bs <<= 1;
    } else {
      pt::pop_bitstack(bs, idx);
    }
  }
  if (live) {
    if (MODE == kAnyHit) {
      occ_out[i] = occ;
    } else {
      t_out[i] = closest;
      tri_out[i] = best;
    }
  }
  if (lane == 0) {
    cnt[packet] = nb;
    cnt[packets + packet] = nsg;
    cnt[2 * packets + packet] = nl;
  }
}

}  // namespace

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// nodes is [2*first_leaf, 8] f32 rows (minx, miny, minz, maxx, maxy, maxz,
// 0, 0), tri is [T, 12] f32 rows (v0, e1, e2, n), both 16-byte aligned;
// cnt is [3, ceil(n / 32)] int32. Pointers the mode does not use may be
// null.
extern "C" int bvh_mr_launch(int mode, const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const float* tmax, const float* nodes,
                             const float* tri, int first_leaf, int P,
                             float t_min, int n, float* t_out, int* tri_out,
                             bool* occ_out, int* cnt, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1 || P < 1 || (mode != kNearest && mode != kAnyHit))
    return static_cast<int>(cudaErrorInvalidValue);
  const int packets = (n + kLanes - 1) / kLanes;
  const dim3 grid((packets + kWarps - 1) / kWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* tb = reinterpret_cast<const float4*>(tri);
  const unsigned fl = static_cast<unsigned>(first_leaf);
  if (mode == kNearest) {
    mr_kernel<kNearest><<<grid, kThreads, 0, st>>>(
        ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, t_out,
        tri_out, occ_out, cnt);
  } else {
    mr_kernel<kAnyHit><<<grid, kThreads, 0, st>>>(
        ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, t_out,
        tri_out, occ_out, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
