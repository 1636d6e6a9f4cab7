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
//   * a packet is 32 consecutive rays sharing one walk over the heap
//     (nodes from 1, children of i at 2i and 2i+1, node i >=
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
// PERFORMANCE.md:463-468 measured). Here the packets of a block never
// wait for each other, and a packet is spread over kWarpsPerPacket (W)
// warps, which all hold its 32 rays:
//   * node rounds: warp 0 of the packet walks them alone (the votes never
//     cross warps); the other W - 1 wait at the packet's named barrier
//     (bar.sync 1 + the packet's index in its block, 32 W threads) and
//     take no issue slots until a leaf round, whose queue warp 0 hands
//     them through shared memory;
//   * leaf rows staged when queued: pushing a leaf starts the cp.async
//     copy of its first kStage slots (three float4 a slot) into the
//     packet's slice of shared memory; the copy runs under the node
//     rounds that follow, and the leaf round waits on it (the TPU
//     kernel's own idea, pallas_bvh_mr.py:303-318). A leaf of more than
//     kStage slots stages its later chunks in the round;
//   * leaf rounds split, then merged: the queued leaves' slots are dealt
//     to the W warps (slot k of a chunk to warp k mod W); each lane tests
//     its share against the closest the round started with, so no select
//     is carried from one mt_hit to the next but the warp's own least
//     (t, key), key = (queue position, slot); the W warps then merge
//     through shared memory behind the packet's barrier: the least t,
//     among equal t the least key. That is the serial strict-< walk's
//     result (mt_hit reads t_best only in !(t < t_best); the cull
//     against a stale closest only adds tests that cannot win). Any-hit:
//     the warps OR their hits and retire the lanes that hit.
// Every warp reads the merged closest and winner back, so the W copies
// of the rays stay identical; warp 0 writes the outputs and the counters.
//
// What bounds it: FP32 ALU work, 24 flops a lane a node round (two slab
// tests) and 37 flops and one IEEE division a lane a leaf slot, against
// 28 B a ray in and 8 B out; node and triangle rows are gathers that the
// L2 serves. A packet's lanes all pay for the union of their walks: the
// price of one walk a packet, against bvh.cu's divergent per-ray walks.
// The widest packets set the time (a packet's median leaf visits are 0,
// its widest over 100 on the dragon's primary rays): the split cuts
// their chains of slot tests W-fold; their node rounds stay one chain.
// The helper warps hold registers through the node rounds, so an SM
// holds few packets: kMinBlocks caps the registers at 64, no spills.
//
// Numerics: -fmad=false, IEEE division, bvh_common.cuh's slab test and
// Moller-Trumbore, the plain version's order: the two agree bit for bit,
// counters included.

#include <cfloat>
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarpsPerPacket = 8;  // W: warps sharing one packet's walk
constexpr int kBlockWarps = 8;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 64 registers
constexpr int kPackets = kBlockWarps / kWarpsPerPacket;  // a block
constexpr int kThreads = kLanes * kBlockWarps;
constexpr int kPacketThreads = kLanes * kWarpsPerPacket;
constexpr int kQueue = 4;   // ops/cuda_bvh_mr.py QUEUE
constexpr int kStage = 64;  // slots of a leaf staged at a time
constexpr int kKeyShift = 24;  // key = queue position << 24 | slot
constexpr unsigned kFull = 0xffffffffu;
constexpr float kRetired = -1e30f;
// a packet's slice of shared memory: the merge's least t and key of each
// lane of each warp (any-hit: the key holds the lane's hit), the queue
// and its length (the walking warp's, for the others), then kQueue
// stages of S slots of three float4
constexpr int kMergeBytes = 2 * 4 * kLanes * kWarpsPerPacket;
constexpr int kQueueBytes = 16 * ((4 * (kQueue + 1) + 15) / 16);
static_assert(kBlockWarps % kWarpsPerPacket == 0 && kPackets >= 1 &&
                  kPackets <= 15,
              "a block holds 1 to 15 whole packets (named barriers 1-15)");

enum Mode : int { kNearest = 0, kAnyHit = 1 };

__host__ __device__ constexpr size_t packet_bytes(int S) {
  return kMergeBytes + kQueueBytes + kQueue * 3 * S * sizeof(float4);
}

// The packet's W warps meet at its named barrier (ids 1-15; 0 is
// __syncthreads'); orders their shared-memory writes and reads.
__device__ __forceinline__ void packet_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kPacketThreads)
               : "memory");
}

// Starts the copy of `count` (<= 3 kStage) float4 from src to dst (shared
// memory), spread over the walking warp's lanes, and commits it as one
// group.
__device__ __forceinline__ void stage_rows(float4* dst,
                                           const float4* __restrict__ src,
                                           int count, int lane) {
#pragma unroll 1
  for (int e = lane; e < count; e += kLanes) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + e));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(src + e)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits for this thread's copies, then for the packet's other threads:
// every staged row has landed and is visible to all of them.
__device__ __forceinline__ void rows_landed(int id) {
  asm volatile("cp.async.wait_all;" ::: "memory");
  packet_sync(id);
}

// A ray's state in a packet's walk.
struct Ray {
  float o1, o2, o3, d1, d2, d3;
  float closest;
  int best;
  bool occ;
};

// One leaf round of a packet, run by each of its W warps (wp: the warp's
// place in the packet) after the round's first barrier: the warp's share
// of the queued leaves' slots against the closest the round started
// with, then the merge. Leaves every warp's rays the same.
template <int MODE>
__device__ __forceinline__ void leaf_round(
    Ray& r, const int (&queue)[kQueue], int queued, int wp, int lane,
    int bar, float4* stage, float* m_t, int* m_key,
    const float4* __restrict__ tri, int P, int S, float t_min) {
  const float c0 = r.closest;
  float bt = c0;
  int bk = INT_MAX;
  bool hit = false;
#pragma unroll
  for (int q = 0; q < kQueue; ++q) {
    if (q >= queued) break;
    float4* rows = stage + q * 3 * S;
    for (int c = 0; c < P; c += S) {
      const int m = min(S, P - c);
      if (c > 0) {  // a later chunk of a leaf wider than a stage
        packet_sync(bar);  // the previous chunk is no longer read
        if (wp == 0)
          stage_rows(rows, tri + 3 * (static_cast<size_t>(queue[q]) * P + c),
                     3 * m, lane);
        rows_landed(bar);
      }
      const int key0 = (q << kKeyShift) + c;
      for (int k = wp; k < m; k += kWarpsPerPacket) {
        float t, u, v;
        const bool h = pt::mt_hit(rows[3 * k], rows[3 * k + 1],
                                  rows[3 * k + 2], r.o1, r.o2, r.o3, r.d1,
                                  r.d2, r.d3, t_min, c0, t, u, v);
        if (MODE == kAnyHit) {
          hit = hit || h;
        } else if (h && t < bt) {
          bt = t;
          bk = key0 + k;
        }
      }
    }
  }
  // merge: the least (t, key) of the W warps, or their hits' OR
  const int me = wp * kLanes + lane;
  if (MODE == kAnyHit) {
    m_key[me] = hit;
  } else {
    m_t[me] = bt;
    m_key[me] = bk;
  }
  packet_sync(bar);
#pragma unroll
  for (int w = 0; w < kWarpsPerPacket; ++w) {
    const int k2 = m_key[w * kLanes + lane];
    if (MODE == kAnyHit) {
      hit = hit || k2 != 0;
    } else {
      const float t2 = m_t[w * kLanes + lane];
      if (t2 < bt || (t2 == bt && k2 < bk)) {
        bt = t2;
        bk = k2;
      }
    }
  }
  if (MODE == kAnyHit) {
    if (hit) {
      r.occ = true;
      r.closest = kRetired;
    }
  } else if (bk != INT_MAX) {
    const int qw = bk >> kKeyShift;
    int leaf = queue[0];
#pragma unroll
    for (int q = 1; q < kQueue; ++q)
      if (q == qw) leaf = queue[q];
    r.closest = bt;
    r.best = leaf * P + (bk & ((1 << kKeyShift) - 1));
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mr_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
          const float* __restrict__ oz, const float* __restrict__ dx,
          const float* __restrict__ dy, const float* __restrict__ dz,
          const float* __restrict__ tmax, const float4* __restrict__ nodes,
          const float4* __restrict__ tri, unsigned first_leaf, int P, int S,
          float t_min, int n, float* __restrict__ t_out,
          int* __restrict__ tri_out, bool* __restrict__ occ_out,
          int* __restrict__ cnt) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int slot = warp / kWarpsPerPacket;  // the packet's place in its block
  const int wp = warp % kWarpsPerPacket;    // the warp's place in its packet
  const int bar = 1 + slot;
  const int packets = (n + kLanes - 1) / kLanes;
  const int packet = blockIdx.x * kPackets + slot;
  if (packet >= packets) return;  // the packet's W warps
  char* slice = reinterpret_cast<char*>(smem) + slot * packet_bytes(S);
  float* m_t = reinterpret_cast<float*>(slice);
  int* m_key = reinterpret_cast<int*>(slice) + kLanes * kWarpsPerPacket;
  int* m_queue = reinterpret_cast<int*>(slice + kMergeBytes);
  float4* stage = reinterpret_cast<float4*>(slice + kMergeBytes + kQueueBytes);

  const int i = packet * kLanes + lane;
  const bool live = i < n;
  Ray r{0.f, 0.f, 0.f, 1.f, 0.f, 0.f, MODE == kAnyHit ? -1.f : 0.f, -1,
        false};
  if (live) {
    r.o1 = ox[i]; r.o2 = oy[i]; r.o3 = oz[i];
    r.d1 = dx[i]; r.d2 = dy[i]; r.d3 = dz[i];
    r.closest = tmax[i];
  }
  int queue[kQueue] = {0, 0, 0, 0};

  if (wp != 0) {
    // a helper warp: the packet's leaf rounds, the queue from warp 0
    while (true) {
      rows_landed(bar);
      const int queued = m_queue[kQueue];
      if (queued == 0) return;  // warp 0 has ended the walk
#pragma unroll
      for (int q = 0; q < kQueue; ++q) queue[q] = m_queue[q];
      leaf_round<MODE>(r, queue, queued, wp, lane, bar, stage, m_t, m_key,
                       tri, P, S, t_min);
    }
  }

  const float i1 = 1.0f / r.d1, i2 = 1.0f / r.d2, i3 = 1.0f / r.d3;
  const bool n1 = i1 < 0.f, n2 = i2 < 0.f, n3 = i3 < 0.f;
  // warp 0: the packet's walk, the same value in every lane
  unsigned idx = 1u, bs = 1u;
  int queued = 0;
  int nb = 0, nsg = 0, nl = 0;

  while (idx != 0u || queued > 0) {
    if (queued > 0 && (queued >= kQueue || idx == 0u)) {
      nl += queued;
#pragma unroll
      for (int q = 0; q < kQueue; ++q)  // the queue, for the helper warps
        if (lane == q) m_queue[q] = queue[q];
      if (lane == kQueue) m_queue[kQueue] = queued;
      rows_landed(bar);
      leaf_round<MODE>(r, queue, queued, wp, lane, bar, stage, m_t, m_key,
                       tri, P, S, t_min);
      queued = 0;
      if (MODE == kAnyHit && __all_sync(kFull, r.closest < 0.f)) idx = 0u;
      continue;
    }
    // node round: a packet at a leaf with room queues it, starts staging
    // its rows and pops on
    if (idx >= first_leaf && queued < kQueue) {
      const int leaf = static_cast<int>(idx - first_leaf);
#pragma unroll
      for (int q = 0; q < kQueue; ++q)
        if (q == queued) queue[q] = leaf;
      stage_rows(stage + queued * 3 * S,
                 tri + 3 * static_cast<size_t>(leaf) * P, 3 * S, lane);
      ++queued;
      pt::pop_bitstack(bs, idx);
    }
    if (idx == 0u || idx >= first_leaf) continue;
    const unsigned l = idx << 1;
    const float4 la = __ldg(nodes + 2 * static_cast<size_t>(l));
    const float4 lb = __ldg(nodes + 2 * static_cast<size_t>(l) + 1);
    const float4 ra = __ldg(nodes + 2 * static_cast<size_t>(l) + 2);
    const float4 rb = __ldg(nodes + 2 * static_cast<size_t>(l) + 3);
    const float lhit =
        pt::slab_entry(la.x, la.y, la.z, la.w, lb.x, lb.y, r.o1, r.o2, r.o3,
                       i1, i2, i3, n1, n2, n3, r.closest);
    const float rhit =
        pt::slab_entry(ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, r.o1, r.o2, r.o3,
                       i1, i2, i3, n1, n2, n3, r.closest);
    const bool tl = lhit < r.closest;
    const bool tr = rhit < r.closest;
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
  if (lane == kQueue) m_queue[kQueue] = 0;  // release the helper warps
  rows_landed(bar);
  if (live) {
    if (MODE == kAnyHit) {
      occ_out[i] = r.occ;
    } else {
      t_out[i] = r.closest;
      tri_out[i] = r.best;
    }
  }
  if (lane == 0) {
    cnt[packet] = nb;
    cnt[packets + packet] = nsg;
    cnt[2 * packets + packet] = nl;
  }
}

template <int MODE>
int launch_mode(const float* ox, const float* oy, const float* oz,
                const float* dx, const float* dy, const float* dz,
                const float* tmax, const float4* nodes, const float4* tri,
                unsigned first_leaf, int P, float t_min, int n, float* t_out,
                int* tri_out, bool* occ_out, int* cnt, cudaStream_t st) {
  const int S = P < kStage ? P : kStage;
  const size_t smem = kPackets * packet_bytes(S);
  static size_t allowed = 48 * 1024;  // the default dynamic limit
  if (smem > allowed) {
    const cudaError_t rc = cudaFuncSetAttribute(
        mr_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    allowed = smem;
  }
  const int packets = (n + kLanes - 1) / kLanes;
  const dim3 grid((packets + kPackets - 1) / kPackets);
  mr_kernel<MODE><<<grid, kThreads, smem, st>>>(
      ox, oy, oz, dx, dy, dz, tmax, nodes, tri, first_leaf, P, S, t_min, n,
      t_out, tri_out, occ_out, cnt);
  return static_cast<int>(cudaGetLastError());
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
  if (first_leaf < 1 || P < 1 || P >= (1 << kKeyShift) ||
      (mode != kNearest && mode != kAnyHit))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* tb = reinterpret_cast<const float4*>(tri);
  const unsigned fl = static_cast<unsigned>(first_leaf);
  if (mode == kNearest)
    return launch_mode<kNearest>(ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P,
                                 t_min, n, t_out, tri_out, occ_out, cnt, st);
  return launch_mode<kAnyHit>(ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P,
                              t_min, n, t_out, tri_out, occ_out, cnt, st);
}
