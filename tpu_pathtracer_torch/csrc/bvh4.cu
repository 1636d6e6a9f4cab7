// Nearest / any ray-triangle hit over the SAH BVH4 tables, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels tpu_pathtracer/ops/pallas_bvh4.py
//   ::_kernel_nearest4 (:295, through packet_trace4 :771)    -> kNearest,
//   ::_kernel_shadow4  (:598, through packet_occluded4 :832) -> kAnyHit.
//
// Contract (the results of the TPU kernels over ops/bvh4's tables):
//   * node k holds four child slots: f32 bounds at bounds[24k + 6j]
//     (minx, miny, minz, maxx, maxy, maxz) and refs[4k + j]: 0 = empty,
//     +m = interior node m-1, -(c+1) = leaf cluster c; the root is node 0;
//   * a node step slab-tests its four children against the ray's current
//     closest t (pt::slab_entry); a child is hit if its ref is not 0 and
//     its entry distance is < closest. The hit children are ordered by
//     entry distance (slot order on a tie); the ray descends into the
//     nearest and pushes the others on its own ref stack far-first, so
//     they pop nearest-first; a step with no hit child pops;
//   * a leaf visit tests the cluster's `width` slots of the [C*width, 12]
//     triangle table in slot order with pt::mt_hit (padding rows are zero
//     and miss through a = 0), strict < against closest; then it pops;
//   * nearest: t = closest (t_max on a miss), tri = the winning SAH slot
//     (-1 on a miss); ids are in SAH cluster-slot space, tri_map maps
//     them to heap slots. Any-hit: occ, the walk ends at the first hit;
//   * a ray with t_max <= 0 tests nothing;
//   * per-ray counters (int32 [5, n]): nodes_both (node steps with two or
//     more hit children), nodes_single (exactly one), leaf_visits,
//     leaf_pop (visits entered by popping a leaf ref off the stack),
//     node_steps (all node steps);
//   * the stack holds `cap` refs (the tables' stack_cap = 3*depth + 8,
//     which bounds it: each level pushes at most three). A push past cap
//     never writes: the ray stops, its leaf_pop counter is set to -1 and
//     *overflow is set to 1, which the wrapper's check_stack reads and
//     raises for. The wrapper refuses tables whose stack_cap exceeds
//     kStackCap.
//
// Design. The TPU kernel runs a packet of 1024 rays on one scalar ref
// stack in SMEM, votes the descent order by majority, DMAs the whole node
// table into SMEM and double-buffers leaf clusters, because a TPU lane
// cannot gather (pallas_bvh4.py:1-33). Here each ray walks alone, in the
// contract's order: no votes, no DMA, no prefetch. The engine launches
// each mode once a regen iteration on config 4's lane pool, 131,072 rays
// (engine/regen.py _pool_size, the textured packet path). The first form
// of this kernel, one thread a ray throughout, spent 87% of its time in
// leaves (a run with the leaf loop cut took 0.020 of 0.153 ms at the
// primary rays' hit t, H100, PERF.md): each thread tested its leaf's 64
// slots alone, a warp as long as its slowest ray, while the node walk,
// a chain of dependent L2 loads, needs as many rays in flight as the SM
// holds. So the two phases are split:
//   1. Node steps: one thread a ray, as before. The thread loads the
//      node's 24 bounds as six float4 and its 4 refs as one int4, tests
//      the four children, ranks the hit ones in registers (nearer first,
//      the lower slot on an exact tie: the stable order of the contract's
//      insertion sort; an entry distance is never NaN), descends into
//      rank 0 and writes rank j >= 1 where the far-first pushes put it,
//      sp + nhit - 1 - j.
//   2. Leaf visits: by the warp. A thread whose walk reaches a leaf waits;
//      when kLeafBatch of the warp's threads wait, or none still walks
//      nodes, the warp tests the waiting (ray, leaf) pairs
//      32 / kLeafLanes at a time, kLeafLanes lanes a pair: lane s of a
//      pair's lanes tests slots s, s + kLeafLanes, ... of the cluster
//      (neighbouring lanes on neighbouring 48 B rows) against its own
//      running best, starting at the ray's closest. Of mt_hit's conditions
//      only t < t_best depends on t_best, so the serial loop's winner is
//      the least t among the slots that pass with t < closest, the lower
//      slot on an exact tie; the lanes merge their (t, slot) in
//      log2(kLeafLanes) __shfl_xor_sync steps on that lexicographic
//      minimum (a lane without a candidate never wins) and the ray's
//      thread takes the winner, bit for bit, and pops. Any-hit: a ballot
//      of the pair's lanes; the walk ends at a hit (occlusion is a
//      boolean, and the counters do not depend on which slot hit).
//   3. The ref stack lives in shared memory, `cap` ints a thread
//      (dynamic shared memory sized by the tables' stack_cap), entry e of
//      thread x at e * threads + x: no bank conflicts.
//   4. Any-hit compacts a block's window of kRounds rays a thread to its
//      live rays (t_max > 0, __ballot_sync/__popc and a prefix over the
//      warps, as csrc/tris.cu does), writes false and zero counters for
//      the others, and walks only live rays: 28-45% of the pool's lanes
//      carry a shadow ray.
//   5. Launch bounds hold nearest to 8 blocks of 128 threads an SM (64
//      registers) and any-hit to 4 of 256.
// The A/B (experiments/bvh4_ab.py on an H100, each source held bit-equal
// to the plain walk first, device time a call in a CUDA graph, in turns
// with the first form; PERF.md) picked the design and each
// parameter at the frame's rays (the rays the engine hands a mode at a
// regen iteration), where they diverge most:
//   * a group of 4 lanes a ray for the whole walk, csrc/tris.cu's design,
//     gained 1.35x on primary rays and lost 4% on the pool's: its node
//     walk took 4x the first form's, with a quarter of the rays in
//     flight. This split gains 2.3-2.5x on primary and NEE rays, 4.1x on
//     bounce-2 rays and 3.9-4.7x on the frame's;
//   * kLeafLanes 8 for nearest (4: -6% on the frame's rays; 16: -14% on
//     the pool's primary rays), 16 for any-hit (8: -7% on the frame's
//     shadow rays, -14% on phase 9's);
//   * kLeafBatch 16 and 12: waiting for every thread is 3% slower on the
//     frame's rays (7% faster on the coherent primary rays);
//   * nearest at 64 registers, 8 blocks of 128 threads an SM: 70
//     registers (7 blocks) were 4% faster on primary rays and 19% slower
//     on the frame's, 56 (9 blocks, spilling) 7% slower on both;
//   * any-hit at 256 threads a block (128: -4% on the frame's shadow
//     rays) and kRounds 2.
//
// What bounds it: issue and latency. A slot test is mt_hit's 37 FP32
// operations (each its own FMUL/FADD under -fmad=false, none pairs into
// an FFMA) with the IEEE division's sequence and the compares, ~80 SASS
// instructions; a node step ~210, a leaf visit's broadcast, merge and
// pop ~140 a lane of its pair. The node walk is a chain of dependent L2
// loads a ray (96 B a node); the rows a leaf visit reads (48 B a slot)
// come from L2 too: staircase-hires' f32 node table is 140 KB and its
// triangle table 9 MB. No wgmma and no TMA: there is no matrix product,
// and a walk's reads are data-dependent gathers of a few hundred bytes.
//
// Numerics: -fmad=false, IEEE division, and the plain version's
// operation order (ops/cuda_bvh4.py), so the two agree bit for bit.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

enum Mode : int { kNearest = 0, kAnyHit = 1 };

constexpr int kStackCap = 128;  // refs a ray's stack holds at most
constexpr int kThreadsNearest = 128;  // threads a block, nearest
constexpr int kThreadsAnyHit = 256;   // threads a block, any-hit
// lanes that test one (ray, leaf) pair
constexpr int kLeafLanesNearest = 8;
constexpr int kLeafLanesAnyHit = 16;
// pending leaves of a warp that start a leaf phase (or no walking lane)
constexpr int kLeafBatchNearest = 16;
constexpr int kLeafBatchAnyHit = 12;
constexpr int kNearestMinBlocks = 8;  // resident blocks an SM, nearest
constexpr int kAnyHitMinBlocks = 4;   // resident blocks an SM, any-hit
constexpr int kRounds = 2;      // any-hit: rays a thread of a window
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int threads(int mode) {
  return mode == kAnyHit ? kThreadsAnyHit : kThreadsNearest;
}
__host__ __device__ constexpr int min_blocks(int mode) {
  return mode == kAnyHit ? kAnyHitMinBlocks : kNearestMinBlocks;
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
// dynamic shared memory of a block: the threads' stacks (at least one
// entry), and any-hit's live list
__host__ int smem_bytes(int mode, int cap) {
  return static_cast<int>(sizeof(int)) *
         (threads(mode) * (cap > 1 ? cap : 1) +
          (mode == kAnyHit ? window(mode) : 0));
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
  int best, cur, sp;
  bool popped, occ, overflow;
  int nb, nsg, nl, nlp, steps;
};

// One node step of ray r at node cur - 1 (the contract's order); the
// ref stack's entry e is stack[e * T], T threads a block.
template <int T>
__device__ __forceinline__ void node_step(Ray& r,
                                          const float4* __restrict__ bounds,
                                          const int4* __restrict__ refs,
                                          int cap, int* stack,
                                          int* __restrict__ overflow_flag) {
  ++r.steps;
  const size_t node = static_cast<size_t>(r.cur - 1);
  const float4* b = bounds + 6 * node;
  const int4 rf = __ldg(refs + node);
  const int ref[4] = {rf.x, rf.y, rf.z, rf.w};
  float h[4];
  bool hit[4];
#pragma unroll
  for (int k = 0; k < 4; k += 2) {
    // children k and k + 1: 12 floats in three float4
    const float4 p = __ldg(b + 3 * (k / 2));
    const float4 q = __ldg(b + 3 * (k / 2) + 1);
    const float4 w = __ldg(b + 3 * (k / 2) + 2);
    h[k] = pt::slab_entry(p.x, p.y, p.z, p.w, q.x, q.y, r.o1, r.o2, r.o3,
                          r.i1, r.i2, r.i3, r.n1, r.n2, r.n3, r.closest);
    h[k + 1] = pt::slab_entry(q.z, q.w, w.x, w.y, w.z, w.w, r.o1, r.o2, r.o3,
                              r.i1, r.i2, r.i3, r.n1, r.n2, r.n3, r.closest);
  }
  int nhit = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hit[k] = ref[k] != 0 && h[k] < r.closest;
    nhit += hit[k];
  }
  if (nhit == 0) {
    r.popped = r.sp > 0;
    r.cur = r.popped ? stack[--r.sp * T] : 0;
    return;
  }
  r.nb += nhit >= 2;
  r.nsg += nhit == 1;
  if (r.sp + nhit - 1 > cap) {
    r.overflow = true;
    r.cur = 0;
    *overflow_flag = 1;
    return;
  }
  // each hit child's place in the stable order by entry distance (an
  // entry distance is never NaN); rank 0 is descended into, rank j >= 1
  // goes where the far-first pushes put it
  int next = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int rank = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (m != k) rank += hit[m] && (h[m] < h[k] || (h[m] == h[k] && m < k));
    if (hit[k]) {
      if (rank == 0)
        next = ref[k];
      else
        stack[(r.sp + nhit - 1 - rank) * T] = ref[k];
    }
  }
  r.sp += nhit - 1;
  r.cur = next;
  r.popped = false;
}

// The warp's pending leaf visits (lanes in `todo`), kLeafLanes lanes a
// visit, 32 / kLeafLanes visits at a time. Warp-uniform: every lane
// calls it.
template <int MODE>
__device__ __forceinline__ void leaf_phase(Ray& r, unsigned todo,
                                           const float4* __restrict__ tri,
                                           int width, float t_min,
                                           int* stack) {
  constexpr int L = leaf_lanes(MODE);
  constexpr int T = threads(MODE);
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
    const int cur = __shfl_sync(kAll, r.cur, q);
    const float4* row =
        tri + 3 * static_cast<size_t>(-cur - 1) * static_cast<size_t>(width);
    // the owner's place among the pending lanes: the part that tests it
    const int rank = __popc(todo & ((1u << lane) - 1u));
    const bool owner = ((todo >> lane) & 1u) && rank < 32 / L;
    if constexpr (MODE == kAnyHit) {
      bool hit = false;
      if (mine) {
        for (int k = s; k < width && !hit; k += L) {
          float t, u, v;
          hit = pt::mt_hit(__ldg(row + 3 * k), __ldg(row + 3 * k + 1),
                           __ldg(row + 3 * k + 2), o1, o2, o3, d1, d2, d3,
                           t_min, closest, t, u, v);
        }
      }
      const unsigned hb = __ballot_sync(kAll, hit);
      if (owner) {
        ++r.nl;
        r.nlp += r.popped;
        if ((hb >> (rank * L)) & lmask) {
          r.occ = true;
          r.cur = 0;
        } else {
          r.popped = r.sp > 0;
          r.cur = r.popped ? stack[--r.sp * T] : 0;
        }
      }
    } else {
      float tb = closest;
      int kb = -1;
      if (mine) {
        for (int k = s; k < width; k += L) {
          float t, u, v;
          if (pt::mt_hit(__ldg(row + 3 * k), __ldg(row + 3 * k + 1),
                         __ldg(row + 3 * k + 2), o1, o2, o3, d1, d2, d3,
                         t_min, tb, t, u, v)) {
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
        r.nlp += r.popped;
        if (k_w >= 0) {
          r.closest = t_w;
          r.best = (-r.cur - 1) * width + k_w;
        }
        r.popped = r.sp > 0;
        r.cur = r.popped ? stack[--r.sp * T] : 0;
      }
    }
    todo &= ~__ballot_sync(kAll, owner);
  }
}

template <int MODE>
__global__ void __launch_bounds__(threads(MODE), min_blocks(MODE))
bvh4_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float* __restrict__ tmax, const float4* __restrict__ bounds,
            const int4* __restrict__ refs, const float4* __restrict__ tri,
            int width, int cap, float t_min, int n,
            float* __restrict__ t_out, int* __restrict__ tri_out,
            bool* __restrict__ occ_out, int* __restrict__ cnt,
            int* __restrict__ overflow_flag) {
  extern __shared__ int smem[];
  constexpr int T = threads(MODE);
  __shared__ int warp_live[T / 32];
  int* const stack = smem + threadIdx.x;
  int* const live = smem + T * (cap > 1 ? cap : 1);
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
    r.cur = has && r.closest > 0.f ? 1 : 0;
    r.sp = 0;
    r.popped = r.occ = r.overflow = false;
    r.nb = r.nsg = r.nl = r.nlp = r.steps = 0;
    for (;;) {
      const unsigned pend = __ballot_sync(kAll, r.cur < 0);
      const unsigned walking = __ballot_sync(kAll, r.cur > 0);
      if ((pend | walking) == 0u) break;
      if (pend != 0u && (walking == 0u || __popc(pend) >= leaf_batch(MODE)))
        leaf_phase<MODE>(r, pend, tri, width, t_min, stack);
      else if (r.cur > 0)
        node_step<T>(r, bounds, refs, cap, stack, overflow_flag);
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
      cnt[3 * n + i] = r.overflow ? -1 : r.nlp;
      cnt[4 * n + i] = r.steps;
    }
  }
}

// Sets a mode's dynamic shared memory limit the first time a launch needs
// more than the default 48 KB (a stack_cap above 96 at 128 threads).
template <int MODE>
cudaError_t allow_smem(int bytes) {
  static int allowed[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(bvh4_kernel<MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

template <int MODE>
int launch(const float* ox, const float* oy, const float* oz,
           const float* dx, const float* dy, const float* dz,
           const float* tmax, const float* bounds, const int* refs,
           const float4* tri, int width, int cap, float t_min, int n,
           float* t_out, int* tri_out, bool* occ_out, int* cnt,
           int* overflow, cudaStream_t st) {
  const int smem = smem_bytes(MODE, cap);
  const cudaError_t e = allow_smem<MODE>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + window(MODE) - 1) / window(MODE));
  bvh4_kernel<MODE><<<grid, threads(MODE), smem, st>>>(
      ox, oy, oz, dx, dy, dz, tmax, reinterpret_cast<const float4*>(bounds),
      reinterpret_cast<const int4*>(refs), tri, width, cap, t_min, n, t_out,
      tri_out, occ_out, cnt, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The ref-stack capacity the kernels are compiled with.
extern "C" int bvh4_stack_capacity() { return kStackCap; }

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// bounds is [n_nodes*24] f32 and refs [n_nodes*4] int32, each 16-byte
// aligned, tri [C*width, 12] f32 rows (v0, e1, e2, n), 16-byte aligned;
// cnt is [5, n] int32; cap <= kStackCap; overflow is one int32 the kernel
// sets to 1 if a ray's stack would outgrow cap. Pointers the mode does
// not use may be null.
extern "C" int bvh4_launch(int mode, const float* ox, const float* oy,
                           const float* oz, const float* dx, const float* dy,
                           const float* dz, const float* tmax,
                           const float* bounds, const int* refs,
                           const float* tri, int width, int cap, float t_min,
                           int n, float* t_out, int* tri_out, bool* occ_out,
                           int* cnt, int* overflow, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (width < 1 || cap < 0 || cap > kStackCap || overflow == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* tb = reinterpret_cast<const float4*>(tri);
  switch (mode) {
    case kNearest:
      return launch<kNearest>(ox, oy, oz, dx, dy, dz, tmax, bounds, refs, tb,
                              width, cap, t_min, n, t_out, tri_out, occ_out,
                              cnt, overflow, st);
    case kAnyHit:
      return launch<kAnyHit>(ox, oy, oz, dx, dy, dz, tmax, bounds, refs, tb,
                             width, cap, t_min, n, t_out, tri_out, occ_out,
                             cnt, overflow, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
