// Nearest / any ray-triangle hit over the implicit-heap BVH, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels tpu_pathtracer/ops/pallas_bvh.py
//   ::_kernel_nearest (:937, through packet_trace :2695)   -> kNearest,
//   ::_kernel_shadow  (:1393, through packet_occluded :2839) -> kAnyHit,
// each in two arithmetic modes: exact, and fast_math (approx_recip,
// :820-828: the reciprocal in Moller-Trumbore from rcp.approx, see
// bvh_common.cuh). The multi-packet kernels _kernel_nearest_mp (:1766),
// _kernel_shadow_mp (:2056), _kernel_nearest_mps (:2415) and
// _kernel_shadow_mps (:2539), which packet_packs > 1 and packet_split
// select, compute the same function as the two above, outputs and
// counters bit-identical to packs = 1 (tests/test_packet_bvh.py:513-610),
// and differ only in how 1024-ray packets are interleaved on a TPU; this
// kernel is their counterpart too.
//
// Contract (the results of the TPU kernels, and the semantics of the
// reference's hitBvh, kernels.cu:148-224, as ops/bvh.traverse has them):
//   * the tree is the implicit complete heap: nodes from 1, children of
//     node i at 2i and 2i+1, node i >= first_leaf is leaf l = i -
//     first_leaf, covering triangle slots [l*P, (l+1)*P);
//   * dual-node descent: at an interior node both children's boxes are
//     slab-tested against the ray's current closest t; a child is entered
//     if its entry distance is < closest; with both entered, the nearer
//     (right only if strictly nearer) is visited first and the other is
//     remembered in the uint32 bitstack; a leaf or a node entering no
//     child pops the bitstack (pop_bitstack, kernels.cu:148);
//   * a leaf tests its P triangles in slot order with pt::mt_hit, strict
//     < against closest, so on an exact tie the first tested wins;
//   * nearest: t = closest (the ray's t_max on a miss), tri = the winning
//     heap slot (-1 on a miss);
//   * any-hit: occ = some triangle hit in (t_min, t_max); the walk ends at
//     the first hit;
//   * a ray with t_max <= 0 (a dead lane, t_max = -1) tests nothing;
//   * per-ray counters (int32 [5, n]): nodes_both, nodes_single (interior
//     steps entering two / one child, kernels.cu:220-221), leaf_visits,
//     leaf_pop (0 here: the heap walk has no ref stack), node_steps (all
//     interior steps).
//
// Design. The TPU kernel traces a packet of 1024 rays with one shared
// traversal state, decides descents by majority votes, DMAs node tables
// and leaf clusters into SMEM and prefetches sibling clusters, all
// because a TPU lane cannot gather (pallas_bvh.py:1-35). None of that
// carries over: each ray walks its own path with its own bitstack, as
// the original CUDA hitBvh does. Node boxes are read from a [nodes, 8]
// f32 table (two float4 a node; the 872k-triangle dragon's 32,768 nodes
// are 1 MB, staircase-hires' 8,192 are 256 KB), which stays in the 50 MB
// L2. Triangles come from the [T, 12] table of tris.cu (three float4 a
// slot, 48 B; the dragon's 1,048,576 slots are 50 MB); sentinel slots are
// zero rows and miss through a = 0. The engine launches each mode once a
// regen iteration on the dragon's lane pool, 196,608 rays (engine/regen.py
// _pool_size, the untextured packet path).
//
// The first form of this kernel walked a ray a thread throughout and
// tested each leaf's P slots alone (P = 64 on the dragon-class knot): at
// K5's hit t its time was node walk 6-9%, leaf-row fetch 39-41% and leaf
// arithmetic 51-53% (experiments/iter_ablate.py, K13), a warp as slow as
// its slowest ray in each leaf. So the two phases are split, as
// csrc/bvh4.cu and csrc/bvh_mx.cu split theirs:
//   1. Node steps: one thread a ray (pt::heap_node_step, unchanged). The
//      node walk is a chain of dependent L2 loads and wants every ray in
//      flight (several rays a thread lose 1.28-2.38x, K16).
//   2. Leaf visits: by the warp. A thread whose walk reaches a leaf waits;
//      when kLeafBatch of the warp's threads wait, or none still walks
//      nodes, the warp tests the waiting (ray, leaf) pairs
//      32 / kLeafLanes at a time, kLeafLanes lanes a pair: lane s of a
//      pair's lanes tests slots s, s + kLeafLanes, ... of the leaf
//      (neighbouring lanes on neighbouring 48 B rows, read from the L2)
//      against its own running best, starting at the ray's closest; the
//      tail lanes of a leaf whose width is no multiple test nothing. Of
//      mt_hit's accept test only t < t_best depends on t_best, so the
//      serial loop's winner is the least t among the slots that pass
//      against the entry closest, the lower slot on an equal t (a NaN t
//      never passes); the lanes merge their (t, slot) on that
//      lexicographic minimum in log2(kLeafLanes) __shfl_xor_sync steps (a
//      lane without a candidate never wins) and the ray's thread takes the
//      winner, bit for bit, and pops. Any-hit: a ballot of the pair's
//      lanes; the walk ends at a hit (the counters do not depend on which
//      slot hit). A pair's lanes take the ray's o, d and closest from its
//      thread by __shfl_sync.
//   3. Any-hit compacts a block's window of kRounds rays a thread to its
//      live rays (t_max > 0, __ballot_sync/__popc and a prefix over the
//      warps, as csrc/bvh4.cu does), writes false and zero counters for
//      the others, and walks only live rays.
// Each slot still runs pt::mt_hit<APPROX> in the same operation order, so
// a slot's t, u, v and accept test are the first form's in both modes:
// the exact mode is bit-equal to the plain version, and the fast_math
// mode to the first form's fast_math mode.
//
// Parameters. The A/B (experiments/bvh_ab.py on an H100, each source held
// bit-equal to the plain walk in exact mode and to the first form in
// fast_math mode, device time a call in a CUDA graph, in turns with the
// first form; PERF.md) picked each on the dragon-class knot's sets in
// both modes; where they disagreed, the frame's own rays (the engine's
// at regen iterations 2 and 4, shadow rays at 2 and 3) decided:
//   * the split as first built (8 lanes a pair, 16 for any-hit, a batch of
//     4, 8 blocks of 128 an SM) was 4.5-7.3x the first form on every set;
//   * kLeafLanes 16 for nearest (8: 4-9% slower on the frame's and the
//     pool's rays; 4: 1.4x slower; 32: up to 14% slower, 13-20% in
//     fast_math), 32 for any-hit (16: 3-16% slower on the shadow sets);
//   * kLeafBatch 2 for nearest (1: 4-8% slower; 3: 1-4% slower; 4: 3%
//     slower on the frame's later rays and 1-5% in fast_math, up to 2%
//     faster on the pool's primary rays) and 1 for any-hit (2: 3-6%
//     slower; 4: 4-9% slower);
//   * launch bounds: nearest exact 8 blocks of 128 an SM (59 registers; 7
//     blocks: within 1%); nearest fast_math 7 (71 registers; 8: 6-19%
//     slower on the frame's rays; 6: within 1%); any-hit 8 of 128 (61 and
//     59 registers; 4 of 256: 12% faster on the pool's shadow rays, 3-5%
//     slower on the frame's);
//   * kRounds 1 (2: up to 21% slower, most on phase 10's 131,072 NEE
//     lanes, whose 512 two-round windows filled half the card's resident
//     blocks);
//   * the nearest leaf loop not unrolled in exact mode (twice: 2-6% slower,
//     and 4 B of spills at the 64-register bound) and unrolled twice in
//     fast_math (once: 8-20% slower on the frame's rays); any-hit's not
//     unrolled (2 or 4: within 2%).
// The result: 5.5-8.7x the first form on the frame's and the pool's rays
// in both modes (PERF.md).
//
// No tensor cores. The warp's rays stand at different leaves, so an mma
// has no shared operand; and mt_hit is a chain of FP32 operations whose
// order the plain version fixes (-fmad=false, IEEE division): an mma's
// accumulation would no longer round as it does.
//
// What bounds it: latency, not issue. A slot test is mt_hit's 37 FP32
// operations (each its own FMUL/FADD under -fmad=false) with the IEEE
// division's sequence and the compares, about 68 SASS instructions (58
// with the fast_math reciprocal); a node step about 117 with the walk
// loop's ballots. At the pool a call takes 6.7-9.3x the time the card
// needs to issue them (chip_smoke.py phase 10): each lane's slot waits on
// its 48 B row from the L2, and each node step on its parent's load. The
// node walk alone (--noleaf, at phase 10's primary rays' hit t) takes
// 1.76x the first form's cut walk, which keeps a thread's registers for
// its own ray.
//
// Numerics: -fmad=false, IEEE division, and the plain version's
// operation order (ops/cuda_bvh.py), so the two agree bit for bit. The
// fast_math mode's reciprocal is within about 1 ulp of the division; its
// plain version keeps the division, so there the two agree to that bound
// and on every winner whose accept test is not within it of a bound.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

enum Mode : int { kNearest = 0, kAnyHit = 1 };

constexpr int kThreadsNearest = 128;  // threads a block, nearest
constexpr int kThreadsAnyHit = 128;   // threads a block, any-hit
// lanes that test one (ray, leaf) pair
constexpr int kLeafLanesNearest = 16;
constexpr int kLeafLanesAnyHit = 32;
// pending leaves of a warp that start a leaf phase (or no walking lane)
constexpr int kLeafBatchNearest = 2;
constexpr int kLeafBatchAnyHit = 1;
// resident blocks an SM: nearest exact, nearest fast_math, any-hit
constexpr int kMinBlocksNearest = 8;
constexpr int kMinBlocksNearestFast = 7;
constexpr int kMinBlocksAnyHit = 8;
constexpr int kRounds = 1;  // any-hit: rays a thread of a window
// the leaf loop's unrolling: nearest exact, nearest fast_math, any-hit
constexpr int kUnrollNearest = 1;
constexpr int kUnrollNearestFast = 2;
constexpr int kUnrollAnyHit = 1;
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int threads(int mode) {
  return mode == kAnyHit ? kThreadsAnyHit : kThreadsNearest;
}
__host__ __device__ constexpr int min_blocks(int mode, bool approx) {
  return mode == kAnyHit ? kMinBlocksAnyHit
         : approx        ? kMinBlocksNearestFast
                         : kMinBlocksNearest;
}
__host__ __device__ constexpr int leaf_lanes(int mode) {
  return mode == kAnyHit ? kLeafLanesAnyHit : kLeafLanesNearest;
}
__host__ __device__ constexpr int leaf_batch(int mode) {
  return mode == kAnyHit ? kLeafBatchAnyHit : kLeafBatchNearest;
}
// rays a block takes
__host__ __device__ constexpr int window(int mode) {
  return mode == kAnyHit ? threads(mode) * kRounds : threads(mode);
}

// Ranks the rays of [w0, w1) with t_max > 0 into live[] in lane order,
// writes false and zero counters for the others (a NaN t_max is dead);
// returns how many are live. T threads a block.
template <int T>
__device__ __forceinline__ int compact(const float* __restrict__ tmax,
                                       int w0, int w1, int n, int* live,
                                       int* warp_live,
                                       bool* __restrict__ occ_out,
                                       int* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int count = 0;
  for (int x0 = w0; x0 < w1; x0 += T) {
    const int i = x0 + threadIdx.x;
    const bool in = i < w1;
    const bool liv = in && tmax[i] > 0.f;
    if (in && !liv) {
      occ_out[i] = false;
      for (int q = 0; q < 5; ++q) cnt[q * n + i] = 0;
    }
    const unsigned b = __ballot_sync(kAll, liv);
    if (lane == 0) warp_live[warp] = __popc(b);
    __syncthreads();
    int before = 0, total = 0;
    for (int q = 0; q < T / 32; ++q) {
      const int c = warp_live[q];
      before += q < warp ? c : 0;
      total += c;
    }
    if (liv) live[count + before + __popc(b & ((1u << lane) - 1u))] = i;
    count += total;
    __syncthreads();  // warp_live is rewritten; live[] is complete
  }
  return count;
}

// One ray's walk state: a thread's own.
struct Ray {
  float o1, o2, o3, d1, d2, d3, i1, i2, i3;
  bool n1, n2, n3;
  float closest;
  int best;
  unsigned idx, bs;  // the heap node (0: done) and the bitstack
  bool occ;
  int nb, nsg, nl, steps;
};

// The warp's pending leaf visits (lanes in `todo`), kLeafLanes lanes a
// visit, 32 / kLeafLanes visits at a time. Warp-uniform: every lane calls
// it.
template <int MODE, bool APPROX>
__device__ __forceinline__ void leaf_phase(Ray& r, unsigned todo,
                                           const float4* __restrict__ tri,
                                           unsigned first_leaf, int P,
                                           float t_min) {
  constexpr int L = leaf_lanes(MODE);
  static_assert(L == 4 || L == 8 || L == 16 || L == 32,
                "a leaf's lanes divide the warp");
  constexpr unsigned lmask = L == 32 ? kAll : (1u << L) - 1u;
  const int lane = threadIdx.x & 31;
  const int g = lane / L;  // the lane's part of the warp
  const int s = lane % L;  // its slot residue
  while (todo) {
    // part g takes the (g+1)-th pending lane
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
    const unsigned idx = __shfl_sync(kAll, r.idx, q);
    const float4* row =
        mine ? tri + 3 * static_cast<size_t>(idx - first_leaf) *
                         static_cast<size_t>(P)
             : tri;
    // the owner's place among the pending lanes: the part that tests it
    const int rank = __popc(todo & ((1u << lane) - 1u));
    const bool owner = ((todo >> lane) & 1u) && rank < 32 / L;
    if constexpr (MODE == kAnyHit) {
      bool hit = false;
      if (mine) {
#pragma unroll kUnrollAnyHit
        for (int k = s; k < P && !hit; k += L) {
          float t, u, v;
          hit = pt::mt_hit<APPROX>(__ldg(row + 3 * k), __ldg(row + 3 * k + 1),
                                   __ldg(row + 3 * k + 2), o1, o2, o3, d1,
                                   d2, d3, t_min, closest, t, u, v);
        }
      }
      const unsigned hb = __ballot_sync(kAll, hit);
      if (owner) {
        ++r.nl;
        if ((hb >> (rank * L)) & lmask) {
          r.occ = true;
          r.idx = 0u;
        } else {
          pt::pop_bitstack(r.bs, r.idx);
        }
      }
    } else {
      constexpr int U = APPROX ? kUnrollNearestFast : kUnrollNearest;
      float tb = closest;
      int kb = -1;
      if (mine) {
#pragma unroll U
        for (int k = s; k < P; k += L) {
          float t, u, v;
          if (pt::mt_hit<APPROX>(__ldg(row + 3 * k), __ldg(row + 3 * k + 1),
                                 __ldg(row + 3 * k + 2), o1, o2, o3, d1, d2,
                                 d3, t_min, tb, t, u, v)) {
            tb = t;
            kb = k;
          }
        }
      }
      // the part's first-wins winner: the least (t, slot)
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        const float t2 = __shfl_xor_sync(kAll, tb, off);
        const int k2 = __shfl_xor_sync(kAll, kb, off);
        if (k2 >= 0 && (kb < 0 || t2 < tb || (t2 == tb && k2 < kb))) {
          tb = t2;
          kb = k2;
        }
      }
      const int from = (owner ? rank : 0) * L;
      const float t_w = __shfl_sync(kAll, tb, from);
      const int k_w = __shfl_sync(kAll, kb, from);
      if (owner) {
        ++r.nl;
        if (k_w >= 0) {
          r.closest = t_w;
          r.best = static_cast<int>(r.idx - first_leaf) * P + k_w;
        }
        pt::pop_bitstack(r.bs, r.idx);
      }
    }
    todo &= ~__ballot_sync(kAll, owner);
  }
}

template <int MODE, bool APPROX>
__global__ void __launch_bounds__(threads(MODE), min_blocks(MODE, APPROX))
heap_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float* __restrict__ tmax, const float4* __restrict__ nodes,
            const float4* __restrict__ tri, unsigned first_leaf, int P,
            float t_min, int n, float* __restrict__ t_out,
            int* __restrict__ tri_out, bool* __restrict__ occ_out,
            int* __restrict__ cnt) {
  constexpr int T = threads(MODE);
  __shared__ int live[MODE == kAnyHit ? window(MODE) : 1];
  __shared__ int warp_live[T / 32];
  const int w0 = blockIdx.x * window(MODE);
  const int w1 = min(n, w0 + window(MODE));
  int count = w1 - w0;
  if constexpr (MODE == kAnyHit)
    count = compact<T>(tmax, w0, w1, n, live, warp_live, occ_out, cnt);
  const int warp0 = threadIdx.x & ~31;
  for (int base = 0; base < count; base += T) {
    if (base + warp0 >= count) break;  // the warp has no ray left
    const int j = base + static_cast<int>(threadIdx.x);
    const bool has = j < count;
    const int i = !has ? 0 : MODE == kAnyHit ? live[j] : w0 + j;
    Ray r;
    r.o1 = ox[i]; r.o2 = oy[i]; r.o3 = oz[i];
    r.d1 = dx[i]; r.d2 = dy[i]; r.d3 = dz[i];
    r.closest = tmax[i];
    r.i1 = 1.0f / r.d1; r.i2 = 1.0f / r.d2; r.i3 = 1.0f / r.d3;
    r.n1 = r.i1 < 0.f; r.n2 = r.i2 < 0.f; r.n3 = r.i3 < 0.f;
    r.best = -1;
    r.idx = has && r.closest > 0.f ? 1u : 0u;
    r.bs = 1u;
    r.occ = false;
    r.nb = r.nsg = r.nl = r.steps = 0;
    for (;;) {
      const bool walking = r.idx != 0u && r.idx < first_leaf;
      const unsigned pend = __ballot_sync(kAll, r.idx >= first_leaf);
      const unsigned walk = __ballot_sync(kAll, walking);
      if ((pend | walk) == 0u) break;
      if (pend != 0u && (walk == 0u || __popc(pend) >= leaf_batch(MODE))) {
        leaf_phase<MODE, APPROX>(r, pend, tri, first_leaf, P, t_min);
      } else if (walking) {
        ++r.steps;
        pt::heap_node_step(nodes, r.idx, r.bs, r.closest, r.o1, r.o2, r.o3,
                           r.i1, r.i2, r.i3, r.n1, r.n2, r.n3, r.nb, r.nsg);
      }
    }
    if (has) {
      if (MODE == kAnyHit) {
        occ_out[i] = r.occ;
      } else {
        t_out[i] = r.closest;
        tri_out[i] = r.best;
      }
      cnt[i] = r.nb;
      cnt[n + i] = r.nsg;
      cnt[2 * n + i] = r.nl;
      cnt[3 * n + i] = 0;
      cnt[4 * n + i] = r.steps;
    }
  }
}

template <int MODE, bool APPROX>
void launch(dim3 grid, cudaStream_t st, const float* ox, const float* oy,
            const float* oz, const float* dx, const float* dy,
            const float* dz, const float* tmax, const float4* nd,
            const float4* tb, unsigned fl, int P, float t_min, int n,
            float* t_out, int* tri_out, bool* occ_out, int* cnt) {
  heap_kernel<MODE, APPROX><<<grid, threads(MODE), 0, st>>>(
      ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, t_out, tri_out,
      occ_out, cnt);
}

}  // namespace

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// approx != 0 selects the fast_math reciprocal. nodes is [2*first_leaf, 8]
// f32 rows (minx, miny, minz, maxx, maxy, maxz, 0, 0), tri is [T, 12] f32
// rows (v0, e1, e2, n), both 16-byte aligned; cnt is [5, n] int32.
// Pointers the mode does not use may be null.
extern "C" int bvh_heap_launch(int mode, int approx, const float* ox,
                               const float* oy, const float* oz,
                               const float* dx, const float* dy,
                               const float* dz, const float* tmax,
                               const float* nodes, const float* tri,
                               int first_leaf, int P, float t_min, int n,
                               float* t_out, int* tri_out, bool* occ_out,
                               int* cnt, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1 || P < 1 || (mode != kNearest && mode != kAnyHit))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + window(mode) - 1) / window(mode));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* tb = reinterpret_cast<const float4*>(tri);
  const unsigned fl = static_cast<unsigned>(first_leaf);
#define PT_HEAP_LAUNCH(M, A)                                               \
  launch<M, A>(grid, st, ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, \
               n, t_out, tri_out, occ_out, cnt)
  if (mode == kNearest) {
    if (approx) PT_HEAP_LAUNCH(kNearest, true);
    else PT_HEAP_LAUNCH(kNearest, false);
  } else {
    if (approx) PT_HEAP_LAUNCH(kAnyHit, true);
    else PT_HEAP_LAUNCH(kAnyHit, false);
  }
#undef PT_HEAP_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
