// Nearest ray-triangle hit over the implicit-heap BVH with deferred
// commits in windows of leaf visits (config.regroup), for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel tpu_pathtracer/ops/pallas_bvh_rg.py
//   ::_kernel_nearest_rg (:230, through packet_trace_rg :622).
//
// Contract (pallas_bvh_rg.py:1-42, :630-634, as ops/cuda_bvh_rg.py states
// it, whose plain version _rg_walk_ref defines the function): each ray
// walks bvh.cu's heap walk (pt::heap_node_step, pt::pop_bitstack) in
// windows: it records up to kWindow leaf visits, each popped with no
// test, culling nodes by the closest hit committed at the end of its last
// window; then every recorded (ray, leaf) pair is tested with the exact
// per-pair Moller-Trumbore (pt::mt_hit) against that same committed
// closest, and the ray commits the lexicographic minimum of (t, heap
// slot) over its window, -0 tied to +0. So every accepted hit is exact,
// t equals bvh.cu's for the same winner, winners differ from it only
// where two slots give the same t, and leaf visits are never fewer than
// bvh.cu's. A ray's result and counters depend on its own walk alone.
// The window is part of the function (the leaf-visit count, the winners
// on exact ties), not a tuning knob: 2 keeps the dragon-class knot's leaf
// visits at 1.17x the heap kernel's on its primary rays, inside the 1.5x
// the JAX package holds its regroup kernel to (tests/test_packet_rg.py:
// 88-89), where 4 gives 1.69x and 8 2.35x (PERF.md).
//
// The TPU kernel packs a 1024-ray packet's sparse leaf demand into
// windows of (ray, leaf) pairs and contracts them on the MXU, because its
// scalar leaf loop tests each cluster against all 1024 lanes. The first
// CUDA form played the packet with a 128-thread block: block-wide rounds
// in lockstep (every round held to the block's slowest walk by
// __syncthreads_or), a 256-key bitonic sort of the round's pairs by leaf
// (36 passes, a barrier each), a serial flush staging 4 leaves (12 KB) at
// a time in shared memory, and a 64-bit shared-memory atomicMin a passing
// slot. Since a ray's result depends on its own walk alone, no round
// needs the block; this form is bvh.cu's split (csrc/bvh.cu, leaf_phase)
// with the windows:
//   1. Node steps: one thread a ray. A thread walks until it has recorded
//      kWindow leaves (their first heap slots kept in registers, each
//      popped) or its walk ends.
//   2. Leaf visits: by the warp, with no block barrier. When kLeafBatch of
//      the warp's threads have a full window, or none still walks, the
//      warp tests the waiting windows 32 / kLeafLanes at a time,
//      kLeafLanes lanes a window: lane s of a window's lanes tests slots
//      s, s + kLeafLanes, ... of both its leaves in one loop (two
//      independent row loads in flight), each leaf against its own running
//      best starting at the committed closest. Of mt_hit's accept test
//      only t < t_best depends on t_best, so a lane's best in a leaf is the
//      least t among its slots that pass against the committed closest,
//      the lower slot on an equal t (a NaN t never passes). The lane
//      merges its two leaves' bests, then the window's lanes merge theirs,
//      in log2(kLeafLanes) __shfl_xor_sync steps, all on the lexicographic
//      minimum of (t, heap slot) (a lane without a candidate never wins):
//      the plain version's minimum over the window, bit for bit. The ray's
//      thread commits it and starts its next window; no other ray waits.
// Gone with the rounds: the sort, the scan, the distinct-leaf tables, the
// staged flush and the atomicMin.
//
// Parameters. The A/B (experiments/bvh_rg_ab.py on an H100, every source
// held bit-equal to the plain walk first, device time a call in a CUDA
// graph, in turns with the first form and with K5; PERF.md)
// picked each on the dragon-class knot's sets (phase 10's primary and
// bounce-2 rays, the pool's primary rays, the frame's rays at regen
// iterations 2 and 4); they agreed:
//   * the split as first built (16 lanes a window, a batch of 2, 8
//     blocks of 128 an SM: bvh.cu's nearest parameters) was 1.38-2.03x
//     the first form;
//   * kLeafLanes 32: lane s tests slots s and s + 32 of both leaves (16:
//     7-15% slower on every set; 8: 1.38-1.49x slower);
//   * kLeafBatch 1 (2: 0-2% slower; 3: 2-5%; 4: 2-7%);
//   * 8 blocks of 128 an SM, 61 registers, no spills (7 and 6 blocks:
//     within 1.4%); the leaf loop not unrolled (twice: 1-2% slower);
//   * leaf-major batches, not kept: 28-52% of the pool's and the
//     full frame's recorded pairs share a leaf with a neighbouring ray's
//     pair of the same window round, 0.02% in the frame's tail. At 16
//     lanes a window and a batch of 2 to 8, a pass's second window taken
//     among the waiting windows that share a leaf with its first (so its
//     lanes read the same rows) was 1-2% slower than lane order at the
//     same batch, and 7-18% slower than 32 lanes a window: the rows a
//     neighbouring ray's window shares come from the L1 (__ldg) in the
//     next pass anyway.
// The result: 1.58-2.18x the first form, and 0.88-0.97 of K5's time, on
// every set.
//
// No tensor cores. A warp's windows stand at different leaves, so an mma
// has no shared operand; and mt_hit is a chain of FP32 operations whose
// order the plain version fixes (-fmad=false, IEEE division): an mma's
// products and accumulation would not round as it does. (ROADMAP B-16
// asked for an mma inside the first form's leaf-major flush; the same
// rounding rules it out there.)
//
// What bounds it: latency, as bvh.cu. A slot test is mt_hit's 37 FP32
// operations, each its own instruction under -fmad=false, with the IEEE
// division's sequence and the compares; a node step a dependent chain of
// node-row loads from the L2; each lane's slot waits on its 48 B row from
// the L2. At phase 10's primary rays' hit t the node walk alone (the leaf
// loop cut) takes 34% of the time; chip_smoke.py phase 10 sets
// each call's time beside its issue-rate floor.
//
// Numerics: -fmad=false, IEEE division, the plain version's operation
// order (ops/cuda_bvh_rg.py), so the two agree bit for bit.

#include <climits>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kThreads = 128;  // rays a block
constexpr int kWindow = 2;     // leaf visits a ray records before a test
// lanes that test one window
constexpr int kLeafLanes = 32;
// full windows of a warp that start a leaf phase (or no walking lane)
constexpr int kLeafBatch = 1;
constexpr int kMinBlocks = 8;  // resident blocks an SM
constexpr unsigned kAll = 0xffffffffu;

static_assert(kWindow == 2, "the leaf loop tests a window's two leaves");

// One ray's walk state: a thread's own.
struct Ray {
  float o1, o2, o3, d1, d2, d3, i1, i2, i3;
  bool n1, n2, n3;
  float closest;
  int best;
  unsigned idx, bs;  // the heap node (0: done) and the bitstack
  int rec;           // leaves recorded in the window
  int base0, base1;  // their first heap slots (base1 -1: none)
  int nb, nsg, nl, steps;
};

// (t, k) becomes (t2, k2) if k2 is a candidate (k2 >= 0) and the pair is
// the lexicographically smaller; k < 0 is no candidate.
__device__ __forceinline__ void take_min(float& t, int& k, float t2,
                                         int k2) {
  if (k2 >= 0 && (k < 0 || t2 < t || (t2 == t && k2 < k))) {
    t = t2;
    k = k2;
  }
}

// The warp's full windows (lanes in `todo`), kLeafLanes lanes a window,
// 32 / kLeafLanes windows at a time; each window's ray commits its
// minimum. Warp-uniform: every lane calls it.
__device__ __forceinline__ void leaf_phase(Ray& r, unsigned todo,
                                           const float4* __restrict__ tri,
                                           int P, float t_min) {
  constexpr int L = kLeafLanes;
  static_assert(L == 4 || L == 8 || L == 16 || L == 32,
                "a window's lanes divide the warp");
  const int lane = threadIdx.x & 31;
  const int g = lane / L;  // the lane's part of the warp
  const int s = lane % L;  // its slot residue
  while (todo) {
    // part g takes the (g+1)-th waiting lane
    unsigned m = todo;
#pragma unroll
    for (int x = 0; x < 32 / L - 1; ++x)
      if (x < g) m &= m - 1u;
    const bool mine = m != 0u;
    const int q = mine ? __ffs(m) - 1 : lane;
    const float o1 = __shfl_sync(kAll, r.o1, q);
    const float o2 = __shfl_sync(kAll, r.o2, q);
    const float o3 = __shfl_sync(kAll, r.o3, q);
    const float d1 = __shfl_sync(kAll, r.d1, q);
    const float d2 = __shfl_sync(kAll, r.d2, q);
    const float d3 = __shfl_sync(kAll, r.d3, q);
    const float closest = __shfl_sync(kAll, r.closest, q);
    const int b0 = __shfl_sync(kAll, r.base0, q);
    const int b1 = __shfl_sync(kAll, r.base1, q);
    const bool two = b1 >= 0;
    const float4* row0 = tri + 3 * static_cast<size_t>(mine ? b0 : 0);
    const float4* row1 = tri + 3 * static_cast<size_t>(two ? b1 : 0);
    float ta = closest, tb = closest;
    int ka = -1, kb = -1;
    if (mine) {
#pragma unroll 1
      for (int k = s; k < P; k += L) {
        float t, u, v;
        if (pt::mt_hit(__ldg(row0 + 3 * k), __ldg(row0 + 3 * k + 1),
                       __ldg(row0 + 3 * k + 2), o1, o2, o3, d1, d2, d3,
                       t_min, ta, t, u, v)) {
          ta = t;
          ka = k;
        }
        if (two &&
            pt::mt_hit(__ldg(row1 + 3 * k), __ldg(row1 + 3 * k + 1),
                       __ldg(row1 + 3 * k + 2), o1, o2, o3, d1, d2, d3,
                       t_min, tb, t, u, v)) {
          tb = t;
          kb = k;
        }
      }
    }
    // the lane's best over both leaves, as heap slots, then the window's
    if (ka >= 0) ka += b0;
    if (kb >= 0) kb += b1;
    take_min(ta, ka, tb, kb);
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
      const float t2 = __shfl_xor_sync(kAll, ta, off);
      const int k2 = __shfl_xor_sync(kAll, ka, off);
      take_min(ta, ka, t2, k2);
    }
    // the owner's place among the waiting lanes: the part that tested it
    const int rank = __popc(todo & ((1u << lane) - 1u));
    const bool owner = ((todo >> lane) & 1u) && rank < 32 / L;
    const int from = (owner ? rank : 0) * L;
    const float t_w = __shfl_sync(kAll, ta, from);
    const int k_w = __shfl_sync(kAll, ka, from);
    if (owner) {
      if (k_w >= 0) {
        r.closest = t_w == 0.f ? 0.f : t_w;  // one zero: -0 ties +0
        r.best = k_w;
      }
      r.rec = 0;
      r.base1 = -1;
    }
    todo &= ~__ballot_sync(kAll, owner);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
rg_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
          const float* __restrict__ oz, const float* __restrict__ dx,
          const float* __restrict__ dy, const float* __restrict__ dz,
          const float* __restrict__ tmax, const float4* __restrict__ nodes,
          const float4* __restrict__ tri, unsigned first_leaf, int P,
          float t_min, int n, float* __restrict__ t_out,
          int* __restrict__ tri_out, int* __restrict__ cnt) {
  const int w0 = blockIdx.x * kThreads + (threadIdx.x & ~31);
  if (w0 >= n) return;  // the warp has no ray (no block barrier follows)
  const int j = blockIdx.x * kThreads + static_cast<int>(threadIdx.x);
  const bool has = j < n;
  const int i = has ? j : 0;
  Ray r;
  r.o1 = ox[i]; r.o2 = oy[i]; r.o3 = oz[i];
  r.d1 = dx[i]; r.d2 = dy[i]; r.d3 = dz[i];
  r.closest = tmax[i];
  r.i1 = 1.0f / r.d1; r.i2 = 1.0f / r.d2; r.i3 = 1.0f / r.d3;
  r.n1 = r.i1 < 0.f; r.n2 = r.i2 < 0.f; r.n3 = r.i3 < 0.f;
  r.best = -1;
  r.idx = has && r.closest > 0.f ? 1u : 0u;
  r.bs = 1u;
  r.rec = 0;
  r.base0 = 0;
  r.base1 = -1;
  r.nb = r.nsg = r.nl = r.steps = 0;
  for (;;) {
    const bool walking = r.idx != 0u && r.rec < kWindow;
    const bool full = r.rec == kWindow || (r.rec > 0 && r.idx == 0u);
    const unsigned pend = __ballot_sync(kAll, full);
    const unsigned walk = __ballot_sync(kAll, walking);
    if ((pend | walk) == 0u) break;
    if (pend != 0u && (walk == 0u || __popc(pend) >= kLeafBatch)) {
      leaf_phase(r, pend, tri, P, t_min);
    } else if (walking) {
      if (r.idx < first_leaf) {
        ++r.steps;
        pt::heap_node_step(nodes, r.idx, r.bs, r.closest, r.o1, r.o2, r.o3,
                           r.i1, r.i2, r.i3, r.n1, r.n2, r.n3, r.nb, r.nsg);
      }
      // record the leaves reached, up to the window, each popped
      while (r.idx >= first_leaf && r.rec < kWindow) {
        const int base = static_cast<int>(r.idx - first_leaf) * P;
        if (r.rec == 0) r.base0 = base;
        else r.base1 = base;
        ++r.rec;
        ++r.nl;
        pt::pop_bitstack(r.bs, r.idx);
      }
    }
  }
  if (has) {
    t_out[j] = r.closest;
    tri_out[j] = r.best;
    cnt[j] = r.nb;
    cnt[n + j] = r.nsg;
    cnt[2 * n + j] = r.nl;
    cnt[3 * n + j] = 0;
    cnt[4 * n + j] = r.steps;
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 =
// launched). nodes is [2*first_leaf, 8] f32 and tri [T, 12] f32 (bvh.cu's
// tables), both 16-byte aligned; first_leaf * P < 2^31 (a heap slot is an
// int); cnt is [5, n] int32.
extern "C" int bvh_rg_launch(const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const float* tmax, const float* nodes,
                             const float* tri, int first_leaf, int P,
                             float t_min, int n, float* t_out,
                             int* tri_out, int* cnt, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1 || P < 1 ||
      static_cast<long long>(first_leaf) * P > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  rg_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, tmax, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tri),
      static_cast<unsigned>(first_leaf), P, t_min, n, t_out, tri_out, cnt);
  return static_cast<int>(cudaGetLastError());
}
