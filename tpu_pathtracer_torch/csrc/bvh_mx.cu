// Nearest / any ray-triangle hit over the implicit-heap BVH with the
// MXU-leaf test (config.mx_leaf), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels tpu_pathtracer/ops/pallas_bvh_mx.py
//   ::_kernel_nearest_mx (:190, through packet_trace_mx :474)   -> kNearest,
//   ::_kernel_shadow_mx  (:302, through packet_occluded_mx :535) -> kAnyHit.
//
// Contract. The walk over the f32 node table is bvh.cu's (the uint32
// bitstack, pt::heap_node_step, a ray's steps in its own order). Only the
// leaf test differs: Moller-Trumbore linearized, as the TPU kernel does
// it on its matrix unit. Every numerator is bilinear in the ray and the
// triangle:
//   a = -(d.n), t*a = o'.n - v0'.n, u*a = (o'xd).e2 + d.(v0'xe2),
//   v*a = -(o'xd).e1 - d.(v0'xe1),
// with o' = o - center, v0' = v0 - center (center: the root box's centre
// rounded to powers of two, cuda_bvh_mx.pow2_center). So the ray's
// feature vector F = [d, o', o'xd, 1] (10 values) against the triangle's
// test columns G gives all four. G is a [20] f32 row a triangle slot
// (cuda_bvh_mx.G_COLUMNS) holding only the entries that are not zero by
// construction; a structurally zero entry adds +-0 to a sum that starts
// at +0, which leaves it unchanged, so the numerators equal the TPU
// kernel's [16, 4w] x [16, 1024] product over the same G and F.
//
// The product is taken as the TPU takes it: each G and F value split into
// bf16 parts (round to nearest even: __float2bfloat16_rn, as astype
// rounds) hi, mid, lo (_split3, pallas_bvh_mx.py:158), and
//   passes = 3: N = S(g_hi, f_hi) + (S(g_hi, f_mid) + S(g_mid, f_hi));
//   passes = 6: N = S(hi, hi); N += S(hi, mid) + S(mid, hi);
//               N += (S(hi, lo) + S(lo, hi)) + S(mid, mid)
// (_mm_split :170-187; at three passes G's second part bf16(g - g_hi) is
// _split3's mid), where S(x, y) sums x_k * y_k over the group's used rows
// k in ascending order, starting from +0. A product of two bf16 values
// is exact in f32, so with that fixed order the plain version
// (ops/cuda_bvh_mx.py) rounds alike, bit for bit. Then f = 1/a, t = tn f,
// u = un f, v = vn f; a slot is accepted unless |a| < 1e-7,
// min(u, v) < 0, u + v > 1, !(t > t_min) or !(t < closest)
// (pallas_bvh_mx.py:249-262). Nearest: the first minimum t of the
// accepted slots of a leaf wins and becomes closest (the same winner as
// the TPU's first-minimum over the whole leaf); any-hit: the walk ends at
// the first accepted slot (:361-369). The winner's exact t, u, v and
// features are recomputed afterwards from its id
// (cuda_bvh_mx.exact_winner, the TPU's _exact_winner post-pass).
//
// G's parts come built: cuda_bvh_mx.mx_tables splits every G row once a
// render into a [64] bf16 row a slot (cuda_bvh_mx.PART_COLUMNS): _split3's
// hi at columns 0-19, mid at 20-39, lo at 40-59, zeros at 60-63, 128 B a
// slot. Three passes read the first 80 B (hi and mid), six all 128. A
// bf16 value widens to f32 exactly, so the kernel multiplies the same
// values in the same order as a kernel that splits G itself.
//
// Per-ray counters (int32 [5, n]): nodes_both, nodes_single, leaf_visits,
// 0, node_steps (bvh.cu's). A ray with t_max <= 0 (or NaN) tests nothing.
//
// Design. The TPU kernel streams a cluster's G block to VMEM and runs one
// [16, 4w] x [16, 1024] product a leaf visit for its 1024-ray packet. The
// first form of this kernel walked a ray a thread throughout and tested
// its leaf's P slots alone (P = 64 on the dragon-class knot), re-splitting
// each slot's G row on every visit: about 184 FP32 operations a slot at
// three passes, 57 of them the split. As csrc/bvh4.cu does for the BVH4:
//   1. Node steps: one thread a ray (pt::heap_node_step, unchanged). The
//      node walk is a chain of dependent L2 loads and wants every ray in
//      flight.
//   2. Leaf visits: by the warp. A thread whose walk reaches a leaf waits;
//      when kLeafBatch of the warp's threads wait, or none still walks
//      nodes, the warp tests the waiting (ray, leaf) pairs
//      32 / kLeafLanes at a time, kLeafLanes lanes a pair: lane s of a
//      pair's lanes tests slots s, s + kLeafLanes, ... of the leaf
//      against its own running best, starting at the ray's closest (tail
//      lanes of a leaf whose width is no multiple test nothing). Of the
//      accept test only t < closest depends on closest, so the serial
//      loop's winner is the least t among the slots that pass against the
//      entry closest, the lower slot on an equal t (a NaN t never
//      passes); the lanes merge their (t, slot) on that lexicographic
//      minimum in log2(kLeafLanes) __shfl_xor_sync steps (a lane without
//      a candidate never wins) and the ray's thread takes the winner, bit
//      for bit, and pops. Any-hit: a ballot of the pair's lanes; the walk
//      ends at a hit (the counters do not depend on which slot hit).
//   3. F's parts are split once a ray, by its thread, into shared memory
//      (value e's part p of thread x at (e * parts + p) * threads + x: no
//      bank conflicts); a pair's lanes read them from there.
//   4. G's parts are read, not split (the table above).
//   5. Any-hit compacts a block's window of kRounds rays a thread to its
//      live rays (t_max > 0, __ballot_sync/__popc and a prefix over the
//      warps, as csrc/bvh4.cu and csrc/tris.cu do), writes false and zero
//      counters for the others, and walks only live rays.
// The A/B (experiments/bvh_mx_ab.py on an H100, each source held
// bit-equal to the plain walk first, device time a call in a CUDA graph,
// in turns with the first form; PERF.md) picked each parameter on the
// dragon-class knot's sets at 3 and 6 passes; where they disagreed, the
// frame's own rays at 3 passes (the config's default) decided:
//   * the split with 8 lanes a pair, a batch of 16 and 8 blocks of 128
//     threads an SM (64 registers; 216 B of spills at six passes) was
//     4.7-8.1x the first form on every set;
//   * launch bounds: at three passes 6 blocks an SM (80 registers) over 8
//     (64): 1.22-1.39x; 4 (104 registers) 6% slower to 3% faster than 6.
//     At six passes 4 blocks (104 registers, no spills) over 6 (80, 72 B
//     of spills): 1.02-1.26x;
//   * kLeafLanes 16 for nearest (8: 2-7% slower on the frame's rays; 32:
//     3% slower than 16 on the pool's primary rays), 32 for any-hit (8:
//     1.02-1.61x slower on the shadow sets; 16: 9-15% slower on phase
//     10's and the frame's shadow rays, 4% faster on the pool's);
//   * kLeafBatch 4 (8: 2-11% slower for nearest, 2-4% for any-hit; 12:
//     5-12% slower for nearest);
//   * kRounds 2 (1: 6% slower to 5% faster; the frame's two shadow sets
//     split);
//   * F's parts from shared memory: each lane recomputing them from the
//     ray's o and d was 3-5% slower on the shadow sets and the frame's
//     nearest rays at iteration 4, 3-7% at six passes, and 1-3% faster
//     only on the primary rays at three passes.
//
// No tensor cores. The warp's rays stand at different leaves, so an mma
// has no shared operand; one pair fills at most 3 of an mma's 16 rows
// and 10 of its 16 depth entries; and an mma's FP32 accumulation does not
// follow the plain version's ascending sum, so the kernel would no longer
// be bit-equal to it. The tensor-core leaf test belongs to a leaf-major
// flush that gathers many rays at one leaf (csrc/bvh_rg.cu's form; ROADMAP
// B-16, B-18).
//
// What bounds it: latency more than issue. A slot is 127 FP32 operations
// at three passes (19 x 3 products and 19 x 3 sums, 4 x 2 combining adds,
// the division, t, u, v and u + v), 253 at six, against mt_hit's 37; each
// its own FMUL/FADD under -fmad=false, plus the bf16 widenings and the
// compares: about 195 SASS instructions a slot at three passes, 105 a
// node step. Yet the kernel takes about 8x the time the card needs to
// issue them: each lane's slot waits on its 80 B row from the L2 (the
// dragon's parts table is 134 MB, its node table 1 MB), and a node step
// on its parent's load.
//
// Numerics: -fmad=false and IEEE division, the plain version's order.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
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
constexpr int kLeafBatchNearest = 4;
constexpr int kLeafBatchAnyHit = 4;
constexpr int kMinBlocks3 = 6;  // resident blocks an SM at three passes
constexpr int kMinBlocks6 = 4;  // and at six
constexpr int kRounds = 2;      // any-hit: rays a thread of a window
constexpr int kPartCols = 20;  // one part's entries (G_COLUMNS)
constexpr int kRowWords = 32;  // a slot's parts row: 64 bf16 in 32 words
constexpr int kFValues = 9;    // F without its constant 1: d, o', o'xd
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int threads(int mode) {
  return mode == kAnyHit ? kThreadsAnyHit : kThreadsNearest;
}
__host__ __device__ constexpr int min_blocks(int passes) {
  return passes == 3 ? kMinBlocks3 : kMinBlocks6;
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
// F's parts a ray: hi, mid (and lo at six passes)
__host__ __device__ constexpr int f_parts(int passes) {
  return passes == 3 ? 2 : 3;
}
// dynamic shared memory of a block: F's parts, and any-hit's live list
__host__ int smem_bytes(int mode, int passes) {
  return 4 * (kFValues * f_parts(passes) * threads(mode) +
              (mode == kAnyHit ? window(mode) : 0));
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Parts {
  float hi, mid, lo;
};

// _split3: hi + mid + lo reproduces x to about 2^-27.
__device__ __forceinline__ Parts split3(float x) {
  const float hi = bf16r(x);
  const float r1 = x - hi;
  const float mid = bf16r(r1);
  return {hi, mid, bf16r(r1 - mid)};
}

// bf16 entry e of a parts row held as words (entry 2j is word j's low
// half), widened to f32: exact.
template <int W>
__device__ __forceinline__ float entry(const uint32_t (&w)[W], int e) {
  const uint32_t x = w[e >> 1];
  return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
}

// One numerator: the row's G columns c0 .. c0 + K - 1, each part, against
// F values f[0 .. K - 1], in the contract's order.
template <int PASSES, int K, int W>
__device__ __forceinline__ float numerator(const uint32_t (&w)[W], int c0,
                                           const Parts (&f)[K]) {
  float hh = 0.f, hm = 0.f, mh = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float gh = entry(w, c0 + k), gm = entry(w, kPartCols + c0 + k);
    hh = hh + gh * f[k].hi;
    hm = hm + gh * f[k].mid;
    mh = mh + gm * f[k].hi;
  }
  if constexpr (PASSES == 3) {
    return hh + (hm + mh);
  } else {
    float hl = 0.f, lh = 0.f, mm = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float gh = entry(w, c0 + k), gm = entry(w, kPartCols + c0 + k);
      const float gl = entry(w, 2 * kPartCols + c0 + k);
      hl = hl + gh * f[k].lo;
      lh = lh + gl * f[k].hi;
      mm = mm + gm * f[k].mid;
    }
    float out = hh;
    out = out + (hm + mh);
    out = out + ((hl + lh) + mm);
    return out;
  }
}

// The accept test of one slot (its parts row at `row`) for a ray with F
// parts f against `best`; t is the slot's t.
template <int PASSES>
__device__ __forceinline__ bool slot_hit(const uint4* __restrict__ row,
                                         const Parts (&f)[kFValues],
                                         float t_min, float best, float& t) {
  constexpr int Q = PASSES == 3 ? 5 : 8;  // 16-byte words: 80 B or 128 B
  uint32_t w[4 * Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const uint4 x = __ldg(row + q);
    w[4 * q] = x.x;
    w[4 * q + 1] = x.y;
    w[4 * q + 2] = x.z;
    w[4 * q + 3] = x.w;
  }
  const Parts one = {1.f, 0.f, 0.f};  // _split3(1.0)
  const Parts fa[3] = {f[0], f[1], f[2]};
  const Parts ft[4] = {f[3], f[4], f[5], one};
  const Parts fuv[6] = {f[0], f[1], f[2], f[6], f[7], f[8]};
  const float a = numerator<PASSES>(w, 0, fa);
  const float tn = numerator<PASSES>(w, 3, ft);
  const float un = numerator<PASSES>(w, 7, fuv);
  const float vn = numerator<PASSES>(w, 13, fuv);
  const float r = 1.0f / a;
  t = tn * r;
  const float u = un * r;
  const float v = vn * r;
  const bool neg = (u < 0.f || v < 0.f) && !isnan(u) && !isnan(v);
  return !(fabsf(a) < 1e-7f || neg || u + v > 1.f || !(t > t_min) ||
           !(t < best));
}

// F = [d, o', o' x d] (pallas_bvh_mx._fmat) of a ray, split.
__device__ __forceinline__ void ray_features(float o1, float o2, float o3,
                                             float d1, float d2, float d3,
                                             float cx, float cy, float cz,
                                             Parts (&f)[kFValues]) {
  const float p1 = o1 - cx, p2 = o2 - cy, p3 = o3 - cz;
  f[0] = split3(d1);
  f[1] = split3(d2);
  f[2] = split3(d3);
  f[3] = split3(p1);
  f[4] = split3(p2);
  f[5] = split3(p3);
  f[6] = split3(p2 * d3 - p3 * d2);
  f[7] = split3(p3 * d1 - p1 * d3);
  f[8] = split3(p1 * d2 - p2 * d1);
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
// it. fs: the warp's first thread's F parts in shared memory.
template <int MODE, int PASSES>
__device__ __forceinline__ void leaf_phase(Ray& r, unsigned todo,
                                           const uint4* __restrict__ parts,
                                           unsigned first_leaf, int P,
                                           float t_min, const float* fs) {
  constexpr int L = leaf_lanes(MODE);
  constexpr int T = threads(MODE);
  constexpr int NP = f_parts(PASSES);
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
    const float closest = __shfl_sync(kAll, r.closest, q);
    const unsigned idx = __shfl_sync(kAll, r.idx, q);
    Parts f[kFValues];
#pragma unroll
    for (int e = 0; e < kFValues; ++e) {
      f[e].hi = fs[(e * NP) * T + q];
      f[e].mid = fs[(e * NP + 1) * T + q];
      f[e].lo = NP == 3 ? fs[(e * NP + 2) * T + q] : 0.f;
    }
    const uint4* leaf =
        mine ? parts + static_cast<size_t>(idx - first_leaf) *
                           static_cast<size_t>(P) * (kRowWords / 4)
             : parts;
    // the owner's place among the pending lanes: the part that tests it
    const int rank = __popc(todo & ((1u << lane) - 1u));
    const bool owner = ((todo >> lane) & 1u) && rank < 32 / L;
    if constexpr (MODE == kAnyHit) {
      bool hit = false;
      if (mine) {
        for (int k = s; k < P && !hit; k += L) {
          float t;
          hit = slot_hit<PASSES>(leaf + k * (kRowWords / 4), f, t_min,
                                 closest, t);
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
      float tb = closest;
      int kb = -1;
      if (mine) {
        for (int k = s; k < P; k += L) {
          float t;
          if (slot_hit<PASSES>(leaf + k * (kRowWords / 4), f, t_min, tb,
                               t)) {
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

template <int MODE, int PASSES>
__global__ void __launch_bounds__(threads(MODE), min_blocks(PASSES))
mx_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
          const float* __restrict__ oz, const float* __restrict__ dx,
          const float* __restrict__ dy, const float* __restrict__ dz,
          const float* __restrict__ tmax, const float4* __restrict__ nodes,
          const uint4* __restrict__ parts, unsigned first_leaf, int P,
          float cx, float cy, float cz, float t_min, int n,
          float* __restrict__ t_out, int* __restrict__ tri_out,
          bool* __restrict__ occ_out, int* __restrict__ cnt) {
  extern __shared__ float smem[];
  constexpr int T = threads(MODE);
  constexpr int NP = f_parts(PASSES);
  __shared__ int warp_live[T / 32];
  int* const live = reinterpret_cast<int*>(smem + kFValues * NP * T);
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
    __syncwarp();  // the warp's lanes are done with the last rays' F
    if (r.idx != 0u) {
      Parts f[kFValues];
      ray_features(r.o1, r.o2, r.o3, r.d1, r.d2, r.d3, cx, cy, cz, f);
      float* const own = smem + threadIdx.x;
#pragma unroll
      for (int e = 0; e < kFValues; ++e) {
        own[(e * NP) * T] = f[e].hi;
        own[(e * NP + 1) * T] = f[e].mid;
        if (NP == 3) own[(e * NP + 2) * T] = f[e].lo;
      }
    }
    __syncwarp();
    for (;;) {
      const bool walking = r.idx != 0u && r.idx < first_leaf;
      const unsigned pend = __ballot_sync(kAll, r.idx >= first_leaf);
      const unsigned walk = __ballot_sync(kAll, walking);
      if ((pend | walk) == 0u) break;
      if (pend != 0u && (walk == 0u || __popc(pend) >= leaf_batch(MODE))) {
        leaf_phase<MODE, PASSES>(r, pend, parts, first_leaf, P, t_min,
                                 smem + warp0);
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

template <int MODE, int PASSES>
int launch(const float* ox, const float* oy, const float* oz,
           const float* dx, const float* dy, const float* dz,
           const float* tmax, const float4* nodes, const uint4* parts,
           unsigned first_leaf, int P, float cx, float cy, float cz,
           float t_min, int n, float* t_out, int* tri_out, bool* occ_out,
           int* cnt, cudaStream_t st) {
  const dim3 grid((n + window(MODE) - 1) / window(MODE));
  mx_kernel<MODE, PASSES>
      <<<grid, threads(MODE), smem_bytes(MODE, PASSES), st>>>(
          ox, oy, oz, dx, dy, dz, tmax, nodes, parts, first_leaf, P, cx, cy,
          cz, t_min, n, t_out, tri_out, occ_out, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 entries of a slot's row of G's parts (cuda_bvh_mx.PART_COLUMNS).
extern "C" int bvh_mx_part_columns() { return 2 * kRowWords; }

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// passes is 3 or 6. nodes is [2*first_leaf, 8] f32 (bvh.cu's table),
// parts is [T, bvh_mx_part_columns()] bf16, G's parts, both 16-byte
// aligned; (cx, cy, cz) is the recentering G was built with; cnt is
// [5, n] int32. Pointers the mode does not use may be null.
extern "C" int bvh_mx_launch(int mode, int passes, const float* ox,
                             const float* oy, const float* oz,
                             const float* dx, const float* dy,
                             const float* dz, const float* tmax,
                             const float* nodes, const void* parts,
                             int first_leaf, int P, float cx, float cy,
                             float cz, float t_min, int n, float* t_out,
                             int* tri_out, bool* occ_out, int* cnt,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1 || P < 1 || (passes != 3 && passes != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const uint4* gp = static_cast<const uint4*>(parts);
  const unsigned fl = static_cast<unsigned>(first_leaf);
#define PT_MX_LAUNCH(M, S)                                                   \
  launch<M, S>(ox, oy, oz, dx, dy, dz, tmax, nd, gp, fl, P, cx, cy, cz,     \
               t_min, n, t_out, tri_out, occ_out, cnt, st)
  switch (mode * 8 + passes) {
    case kNearest * 8 + 3: return PT_MX_LAUNCH(kNearest, 3);
    case kNearest * 8 + 6: return PT_MX_LAUNCH(kNearest, 6);
    case kAnyHit * 8 + 3: return PT_MX_LAUNCH(kAnyHit, 3);
    case kAnyHit * 8 + 6: return PT_MX_LAUNCH(kAnyHit, 6);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_MX_LAUNCH
}
