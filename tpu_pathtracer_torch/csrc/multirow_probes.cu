// The 8-row packet probes, for NVIDIA Hopper (sm_90a): 8 rows of 128 ray
// lanes, each row walking on its own, its next step learned from its own
// lanes.
//
// Replaces three TPU kernels:
//   * K22, experiments/leafround_probe.py::_kernel (:39, through run :126,
//     pallas_call :127): one leaf round of the packet, LEAF_MODE 0, 1, 2;
//   * K23, experiments/multirow_probe.py::_kernel (:57, run :163,
//     pallas_call :164): a synthetic node step, modes fixed and assemble;
//   * K24, experiments/gather_probe.py::_kernel (:49, run :136,
//     pallas_call :137): the same node step from a per-component table of
//     S * 128 node pairs, fetched by two chained per-lane gathers.
//
// K22 (leafround_kernel). A round: row r tests its 128 lanes against the w
// triangles of cluster ids[r] (word c * w + j of the cluster is component
// c of triangle j: v0, e1, e2, n), a strict-less nearest update of
// closest, then ids[r] = (ids[r] * 5 + 1 + (bits(closest[r, 0]) & 1)) &
// 1023 from (r * 37 + 1) & 1023. The 1,024 lanes spread over the card:
// 128 / kRoundRays blocks a row, each of kRoundRays rays at kRoundLanes
// lanes a ray (the consumer warps), lane s of a ray testing triangles
// j = s (mod kRoundLanes), the ray's lanes merging by one integer min of
// the accepted t's bits (REDUX). An accepted t is > 1e-3 (never NaN or
// -0) and 1e30 never beats a hit, so the minimum is exact and free of
// order: bit-equal to the serial strict-< update however the triangles
// are dealt. In front of the consumers a producer warp tests the row's
// ray 0 itself (32 lanes, w / 32 triangles a lane) and derives every next
// id: no block waits on another. Modes, each adding a step of the TPU's:
//   0 (MT only): the consumers' MT loop on the row's cluster slot in
//     shared memory, which nothing writes: the TPU reads an unwritten VMEM
//     scratch there (ROADMAP C-18); the port zero-fills it once, so every
//     lane misses, as interpret mode gives. No chain: the producer exits;
//   1 (+ ids): the producer walks the chain on the zero slot and hands
//     each round's id to the consumers through a ring of kRoundRing slots
//     in shared memory behind named barriers (the GPU's "ids leave the
//     vector domain"); the consumers address the slot by it;
//   2 (+ fetch): the producer's lane 0 stages cluster ids[r] by one
//     cp.async.bulk on an mbarrier into a ring of kRoundStages stages (its
//     12 w used words, or with kRoundWhole the whole (16 w / 128, 128)
//     block) as soon as ray 0's test of the round before gives the id; the
//     consumers wait on the stage, read its words as shared-memory
//     broadcasts and release it on its empty mbarrier.
// The test divides by (parallel ? 1 : a), as the TPU kernel does
// (leafround_probe.py:90): a parallel triangle fails either way, so the
// result is unchanged, and the zero slot of modes 0 and 1 (a = 0) no
// longer sends every division to its slow path. The 1 is hidden from the
// compiler (opaque_one), which would otherwise divide by a and select the
// 1 after. A lane's tests are split at their divisions so that the
// divisions sit back to back.
//
// K23 and K24 (walk8_kernel): a row to an SM, over kWalkWarps warps
// (kWalkWarpsFixed in K23 fixed; 4, 2 or 1 of its 128 lanes a thread). A
// step: the left and right boxes of
// the row's node pair (12 words), two slab tests a lane, then one vote:
// each lane's pref + 1 (pref = +-1 in both boxes, +1 where the right is
// nearer), tl and tr packed into one 32-bit integer (bits 0-8, 9-16,
// 17-24: 256, 128 and 128 at most over 128 lanes, so no field carries
// into the next) and summed by one __reduce_add_sync a warp; a row of
// several warps adds their sums from a two-slot buffer in shared memory
// behind the row's named barrier (one bar.sync a step). Every warp then
// takes the
// same bitstack advance, ctz = __ffs - 1 (K24's float-exponent ctz is the
// same for 0 < bs < 2^31; bs <= 0xFFFF here). Fetch modes:
//   kFixed (K23 fixed): constant boxes, 0.1 i and 0.1 i + 0.05, so a step
//     is the vote and the advance alone: one warp a row, no barrier;
//   kShfl (K23 assemble, K24 shfl): lane i < 12 of warp 0 loads word i
//     and hands the words to the row's warps through a two-slot buffer in
//     shared memory behind a second named barrier;
//   kLanes (K24 lanes): every thread loads the 12 words itself (__ldg of
//     one address across the warp).
// K23 reads word i of pair idx at ntab[12 idx + i] and keeps idx in
// [1, N/2) odd ((x & (N/2 - 1)) | 1); K24 reads tabs[i][idx] and masks idx
// to S * 128 - 1. The tables stay in device memory. Optionally each row's
// idx and bs after every step are written out (the walk's trajectory: the
// outputs' acc counts only misses, ROADMAP C-19).
//
// What bounds them: latency, by design. K22's rounds are a chain through
// ray 0's test (and in mode 2 a bulk copy's round trip); the walk's steps
// are a chain through the fetch, the slab tests and the vote. Their
// card-wide FP32 bounds (37 operations a lane-triangle; two slab tests and
// two adds a lane-step) are far below. PERF.md §6 K22-K24 gives each
// build's issue-rate floor (experiments/multirow_probe.py round_sass,
// walk_sass) and the chains' latency floors: K22's producer step (and in
// mode 2 a bulk copy's round trip), the walk's step issued by one warp
// and (but in fixed) a dependent on-chip load, since a launch's few
// hundred node pairs stay in the L1.
//
// The constants are the A/B's (leafround_probe.leafround_ab,
// gather_probe.walk_ab; device time in CUDA graphs in turns on an H100,
// PERF.md §6 K22-K24 has the readings): K22 at kRoundLanes 32, a ray to a
// warp, so a ray's merge is one full-warp REDUX (16 lanes a ray, K19's
// split, read 1.5-1.8x slower in modes 0 and 1: its half-warp REDUX runs
// once a half), and kRoundRays 2 (64 blocks a row, 512 in all; 4 rays 5%
// slower in mode 2, 8 rays 7-11%), 3 stages (2 and 4 within 3%), the used
// words only (the whole block within 2%); the walk at 4 warps a row, one
// lane a thread (1 warp 1.5-1.7x slower in shfl and lanes, 2 warps
// 1.2-1.4x), warp 0 loading the words and handing them over (each warp
// loading its own, a yardstick outside the package: 4% slower in K24's
// shfl, 6% faster in K23's assemble); K23 fixed at 1 warp a row (4 warps
// 1.7x slower: its step has no slab work to spread, only the vote that
// would cross warps).
//
// min/max follow jnp.minimum/jnp.maximum (and torch's): a NaN in either
// operand gives NaN, where fminf/fmaxf would drop it. Built with
// -fmad=false and the plain versions' operation order (leafround_probe.py,
// multirow_probe.py), so kernels and plain versions agree bit for bit.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kTile = kRows * kLanes;
constexpr int kClusters = 1024;
constexpr float kFar = 1e30f;
constexpr float kTMin = 1e-3f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kRoundLanes = 32;  // K22: lanes that test one ray (8, 16, 32)
constexpr int kRoundRays = 2;    // K22: rays a block (2 to 16)
constexpr int kRoundStages = 3;  // K22 mode 2: the ring's stages
constexpr int kRoundWhole = 0;   // K22 mode 2: copy the whole block (1)
constexpr int kRoundRing = 4;    // K22 mode 1: the ring of id slots
constexpr int kProxyFence = 1;   // K22 mode 2: proxy fence before a copy
constexpr int kWalkWarps = 4;       // K23 assemble, K24: warps a row
constexpr int kWalkWarpsFixed = 1;  // K23 fixed: warps a row (1, 2, 4)

// ------------------------------------------------------------------ K22
struct RoundGrid {
  static_assert(kRoundLanes == 8 || kRoundLanes == 16 || kRoundLanes == 32,
                "a ray's lanes divide the warp");
  static_assert((kRoundRays == 2 || kRoundRays == 4 || kRoundRays == 8 ||
                 kRoundRays == 16) && kRoundRays * kRoundLanes % 32 == 0,
                "2 to 16 rays a block, whole warps of rays");
  static constexpr int kConsumers = kRoundRays * kRoundLanes / 32;
  static constexpr int kThreads = 32 + kRoundRays * kRoundLanes;
  static constexpr int kBlocksPerRow = kLanes / kRoundRays;
  static constexpr int kBlocks = kRows * kBlocksPerRow;
};
static_assert(kRoundStages >= 1 && kRoundRing >= 1 && kRoundRing <= 7,
              "a ring; named barriers 1-14");

struct Ray {
  float o1, o2, o3, d1, d2, d3;
};

__device__ __forceinline__ Ray ray_at(const float* __restrict__ rays, int p) {
  return Ray{rays[p], rays[kTile + p], rays[2 * kTile + p],
             rays[3 * kTile + p], rays[4 * kTile + p], rays[5 * kTile + p]};
}

// pt::mt_hit's test of one ray and triangle j of a cluster, in its order,
// split at the division: mt_part computes the three sums that f scales and
// f's denominator (a, or 1 where parallel, as the TPU kernel divides);
// mt_finish takes f = 1 / den and returns the accepted t or 1e30 (the
// strict-< against closest is the caller's min).
struct Part {
  float den, su, sv, st;
  bool parallel;
};

// 1.0f that the compiler cannot see: with a literal 1 it divides by a and
// selects 1 after (1 / 1 folds), which sends a = 0 to the slow path again
__device__ __forceinline__ float opaque_one() {
  float one;
  asm("mov.f32 %0, 0f3F800000;" : "=f"(one));
  return one;
}

template <int W>
__device__ __forceinline__ Part mt_part(const float* c, int j, const Ray& r) {
  const float v0x = c[j], v0y = c[W + j], v0z = c[2 * W + j];
  const float g1x = c[3 * W + j], g1y = c[4 * W + j], g1z = c[5 * W + j];
  const float g2x = c[6 * W + j], g2y = c[7 * W + j], g2z = c[8 * W + j];
  const float n1 = c[9 * W + j], n2 = c[10 * W + j], n3 = c[11 * W + j];
  const float a = -(r.d1 * n1 + r.d2 * n2 + r.d3 * n3);
  const bool parallel = fabsf(a) < 1e-7f;
  const float sx = r.o1 - v0x, sy = r.o2 - v0y, sz = r.o3 - v0z;
  const float qx = sy * r.d3 - sz * r.d2;
  const float qy = sz * r.d1 - sx * r.d3;
  const float qz = sx * r.d2 - sy * r.d1;
  return {parallel ? opaque_one() : a, qx * g2x + qy * g2y + qz * g2z,
          qx * g1x + qy * g1y + qz * g1z, sx * n1 + sy * n2 + sz * n3,
          parallel};
}

__device__ __forceinline__ float mt_finish(const Part& p, float f) {
  const float u = f * p.su;
  const float v = -(f * p.sv);
  const float t = f * p.st;
  const bool neg = (u < 0.f || v < 0.f) && !isnan(u) && !isnan(v);
  return (p.parallel || neg || (u + v > 1.f) || !(t > kTMin)) ? kFar : t;
}

// The bits of the least accepted t (1e30 where none) of one ray over the
// cluster `c`, on an aligned group of S lanes of the warp: lane s tests
// triangles s, s + S, ... (W / S of them), then one REDUX over the group.
// Accepted t's and 1e30 are positive floats, which order as their bits.
template <int S, int W>
__device__ __forceinline__ unsigned ray_min(const float* c, int s,
                                            const Ray& r) {
  static_assert(W % S == 0, "a lane's share of the triangles");
  constexpr int K = W / S;
  Part p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = mt_part<W>(c, s + k * S, r);
  float f[K];
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = 1.0f / p[k].den;
  unsigned m = __float_as_uint(kFar);
#pragma unroll
  for (int k = 0; k < K; ++k) m = min(m, __float_as_uint(mt_finish(p[k], f[k])));
  if constexpr (S == 32) {
    return __reduce_min_sync(kFull, m);
  } else {
    const int base = (threadIdx.x & 31) & ~(S - 1);
    return __reduce_min_sync(((1u << S) - 1u) << base, m);
  }
}

// Named barrier `id` (1-15; 0 is __syncthreads') of `n` threads: arrive
// without waiting, or arrive and wait. An arrive synchronizes with the
// syncs of the same phase, so what a thread wrote before its arrive is
// visible to the waiters after their sync.
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ int next_id(int id, unsigned best0) {
  return (id * 5 + 1 + static_cast<int>(best0 & 1u)) & (kClusters - 1);
}

// Block b holds row b / kBlocksPerRow, rays (b % kBlocksPerRow) *
// kRoundRays on. Warp 0 is the producer (ray 0 of the row), the rest the
// consumers. Dynamic shared memory: mode 2's ring of stages, or the zero
// slot of modes 0 and 1.
template <int MODE, int W>
__global__ void __launch_bounds__(RoundGrid::kThreads)
leafround_kernel(const float* __restrict__ rays,
                 const float* __restrict__ blocks, int rounds,
                 float* __restrict__ out) {
  constexpr int kUsed = 12 * W;                     // the words the test reads
  constexpr int kWords = 16 * W;                    // a cluster's block
  constexpr int kStage = kRoundWhole ? kWords : kUsed;
  constexpr unsigned kBytes = kStage * 4u;
  constexpr int kThreads = RoundGrid::kThreads;
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kRoundStages], empty[kRoundStages];
  __shared__ int idring[kRoundRing];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x / RoundGrid::kBlocksPerRow;
  if (MODE == 2) {
    if (threadIdx.x == 0) {
      for (int j = 0; j < kRoundStages; ++j) {
        pt::bar_init(&full[j], 1);
        pt::bar_init(&empty[j], RoundGrid::kConsumers);
      }
      pt::bar_init_fence();
    }
  } else {
    for (int i = threadIdx.x; i < kUsed; i += kThreads) ring[i] = 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    if (MODE == 0) return;  // no chain
    const Ray r0 = ray_at(rays, row * kLanes);
    unsigned best0 = __float_as_uint(kFar);
    int id = (row * 37 + 1) & (kClusters - 1);
    if (MODE == 2 && rounds > 0 && lane == 0) {
      pt::arrive_expect_tx(&full[0], kBytes);
      pt::bulk_copy(ring, blocks + static_cast<size_t>(id) * kWords, kBytes,
                    &full[0]);
    }
#pragma unroll 1
    for (int i = 0; i < rounds; ++i) {
      const float* c = ring;
      if (MODE == 2) {
        const int st = i % kRoundStages;
        pt::bar_wait(&full[st], (i / kRoundStages) & 1);
        c = ring + st * kStage;
      } else {
        const int j = i % kRoundRing;
        if (i >= kRoundRing) named_sync(1 + kRoundRing + j, kThreads);
        if (lane == 0) idring[j] = id;
        named_arrive(1 + j, kThreads);
      }
      best0 = min(best0, ray_min<32, W>(c, lane, r0));
      id = next_id(id, best0);
      if (MODE == 2 && i + 1 < rounds) {
        const int nx = (i + 1) % kRoundStages;
        if (i + 1 >= kRoundStages)
          pt::bar_wait(&empty[nx], ((i + 1) / kRoundStages - 1) & 1);
        __syncwarp();  // the warp has read the stage it may refill
        if (lane == 0) {
          if (kProxyFence) pt::proxy_fence();
          pt::arrive_expect_tx(&full[nx], kBytes);
          pt::bulk_copy(ring + nx * kStage,
                        blocks + static_cast<size_t>(id) * kWords, kBytes,
                        &full[nx]);
        }
      }
    }
    return;
  }
  const int t = threadIdx.x - 32, s = t % kRoundLanes;
  const int p = row * kLanes +
                (blockIdx.x % RoundGrid::kBlocksPerRow) * kRoundRays +
                t / kRoundLanes;
  const Ray r = ray_at(rays, p);
  unsigned best = __float_as_uint(kFar);
#pragma unroll 1
  for (int i = 0; i < rounds; ++i) {
    const float* c = ring;
    if (MODE == 2) {
      const int st = i % kRoundStages;
      pt::bar_wait(&full[st], (i / kRoundStages) & 1);
      c = ring + st * kStage;
    } else if (MODE == 1) {
      const int j = i % kRoundRing;
      named_sync(1 + j, kThreads);
      const int id = *static_cast<volatile int*>(&idring[j]);
      if (i + kRoundRing < rounds)
        named_arrive(1 + kRoundRing + j, kThreads);
      c = ring + (id >> 10);  // id < 1024: the zero slot, addressed by it
    } else {
      // the slot is never written: without this compiler barrier its
      // words, and the tests, would be hoisted out of the loop
      asm volatile("" ::: "memory");
    }
    best = min(best, ray_min<kRoundLanes, W>(c, s, r));
    if (MODE == 2) {
      __syncwarp();  // every lane has read the stage
      if (lane == 0 && i + kRoundStages < rounds)
        pt::bar_arrive(&empty[i % kRoundStages]);
    }
  }
  if (s == 0) out[p] = __uint_as_float(best);
}

// ------------------------------------------------------------ K23, K24
enum Fetch : int { kFixed = 0, kShfl = 1, kLanesFetch = 2 };

__device__ __forceinline__ float jmax(float a, float b) {
  return a > b ? a : (a == a ? b : a);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return a < b ? a : (a == a ? b : a);
}

// the TPU probes' slab(): the entry distance into the box b (lo xyz, hi
// xyz), or 1e30 on a miss
__device__ __forceinline__ float slab(const float* b, float o1, float o2,
                                      float o3, float i1, float i2, float i3,
                                      float closest) {
  const float t0x = (b[0] - o1) * i1, t1x = (b[3] - o1) * i1;
  const float t0y = (b[1] - o2) * i2, t1y = (b[4] - o2) * i2;
  const float t0z = (b[2] - o3) * i3, t1z = (b[5] - o3) * i3;
  const bool n1 = i1 < 0.f, n2 = i2 < 0.f, n3 = i3 < 0.f;
  const float lox = n1 ? t1x : t0x, hix = n1 ? t0x : t1x;
  const float loy = n2 ? t1y : t0y, hiy = n2 ? t0y : t1y;
  const float loz = n3 ? t1z : t0z, hiz = n3 ? t0z : t1z;
  const float tmin = jmax(jmax(lox, loy), jmax(loz, 1e-4f));
  const float tmax = jmin(jmin(hix, hiy), jmin(hiz, closest));
  return tmax < tmin ? kFar : tmin;
}

template <int FETCH>
struct WalkGrid {
  static constexpr int kWarps =
      FETCH == kFixed ? kWalkWarpsFixed : kWalkWarps;
  static_assert(kWarps == 1 || kWarps == 2 || kWarps == 4,
                "4, 2 or 1 lanes a thread");
  static constexpr int kRowThreads = 32 * kWarps;
  static constexpr int kPer = kLanes / kRowThreads;  // lanes a thread
  static constexpr int kBlocks = kRows;  // a row a block
};

// The vote's fields: pref + 1 a lane in bits 0-8, tl in 9-16, tr in 17-24.
constexpr int kNlShift = 9, kNrShift = 17;

// PAIRS: K24's tables (word i of pair idx at tab[i * words + idx]); else
// K23's flat node table (at tab[12 idx + i]). `words` is K24's S * 128
// or K23's N. A block is a row: named barrier 1 is its vote (over several
// warps), 2 its words (kShfl).
template <int FETCH, bool PAIRS>
__global__ void __launch_bounds__(WalkGrid<FETCH>::kRowThreads)
walk8_kernel(const float* __restrict__ rays, const float* __restrict__ tab,
             int words, int steps, float* __restrict__ acc_out,
             int* __restrict__ idx_tr, int* __restrict__ bs_tr) {
  using Grid = WalkGrid<FETCH>;
  constexpr int kWarps = Grid::kWarps, kPer = Grid::kPer,
                kRowThreads = Grid::kRowThreads;
  __shared__ unsigned votes[2][kWarps];
  __shared__ float shared_words[2][12];
  const int row = blockIdx.x, rt = threadIdx.x;
  const int warp = rt >> 5, lane = rt & 31;
  float o1[kPer], o2[kPer], o3[kPer], i1[kPer], i2[kPer], i3[kPer];
  float cl[kPer], acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = row * kLanes + rt + kRowThreads * k;
    o1[k] = rays[p];
    o2[k] = rays[kTile + p];
    o3[k] = rays[2 * kTile + p];
    i1[k] = 1.0f / rays[3 * kTile + p];
    i2[k] = 1.0f / rays[4 * kTile + p];
    i3[k] = 1.0f / rays[5 * kTile + p];
    cl[k] = rays[6 * kTile + p] * 0.0f + kFar;
    acc[k] = 0.f;
  }
  const int mask = PAIRS ? words - 1 : words / 2 - 1;
  const int or_bits = PAIRS ? 0 : 1;
  int idx = PAIRS ? (row * 37 + 1) & mask : row % (words / 2 - 1) + 1;
  unsigned bs = 0x15u;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    const float* word_of = PAIRS ? tab + idx : tab + 12 * idx;
    const int stride = PAIRS ? words : 1;
    float b[12];
    if (FETCH == kFixed) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        b[i] = static_cast<float>(0.1 * i);
        b[6 + i] = static_cast<float>(0.1 * i + 0.05);
      }
    } else if (FETCH == kShfl) {
      float* sw = shared_words[step & 1];
      if (warp == 0 && lane < 12)
        sw[lane] = __ldg(word_of + static_cast<size_t>(lane) * stride);
      named_sync(2, kRowThreads);
#pragma unroll
      for (int i = 0; i < 12; ++i) b[i] = sw[i];
    } else {
#pragma unroll
      for (int i = 0; i < 12; ++i)
        b[i] = __ldg(word_of + static_cast<size_t>(i) * stride);
    }
    unsigned vote = 0u;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float lh =
          slab(b, o1[k], o2[k], o3[k], i1[k], i2[k], i3[k], cl[k]);
      const float rh =
          slab(b + 6, o1[k], o2[k], o3[k], i1[k], i2[k], i3[k], cl[k]);
      const bool tl = lh < cl[k], tr = rh < cl[k];
      vote += ((tl && tr) ? (rh < lh ? 2u : 0u) : 1u) +
              (static_cast<unsigned>(tl) << kNlShift) +
              (static_cast<unsigned>(tr) << kNrShift);
      acc[k] = (acc[k] + lh) + rh;
    }
    vote = __reduce_add_sync(kFull, vote);
    if (kWarps > 1) {
      unsigned* slot = votes[step & 1];
      if (lane == 0) slot[warp] = vote;
      named_sync(1, kRowThreads);
      vote = 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) vote += slot[w];
    }
    const int pref = static_cast<int>(vote & 0x1FFu) - kLanes;
    const int nl = static_cast<int>((vote >> kNlShift) & 0xFFu);
    const int nr = static_cast<int>(vote >> kNrShift);
    // the bitstack advance, uniform across the row
    const bool vl = nl > 0, vr = nr > 0;
    const int swap = pref > 0;
    const bool both = vl && vr, single = vl != vr;
    const int m = bs > 0u ? __ffs(bs) - 1 : 0;
    const unsigned bs_p = (bs >> m) ^ 1u;
    const int idx_p = (idx >> m) ^ 1;
    const int l2 = idx * 2;
    int nidx = both ? l2 + swap : (single ? (vl ? l2 : l2 + 1) : idx_p);
    unsigned nbs = both ? (bs << 1) + 1u : (single ? bs << 1 : bs_p);
    idx = (nidx & mask) | or_bits;
    nbs &= 0xFFFFu;
    bs = nbs == 0u ? 1u : nbs;
    if (idx_tr != nullptr && rt == 0) {
      idx_tr[step * kRows + row] = idx;
      bs_tr[step * kRows + row] = static_cast<int>(bs);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    acc_out[row * kLanes + rt + kRowThreads * k] = acc[k];
}

// K22's launch in a mode at a width: blocks, threads a block and bytes of
// dynamic shared memory (mode 2's ring, or the zero slot).
struct Launch {
  int grid, threads, smem;
};

inline Launch round_launch(int mode, int w) {
  const int stage = (kRoundWhole ? 16 : 12) * w * 4;
  return {RoundGrid::kBlocks, RoundGrid::kThreads,
          mode == 2 ? kRoundStages * stage : 12 * w * 4};
}

template <int FETCH>
inline Launch walk_launch() {
  return {WalkGrid<FETCH>::kBlocks, WalkGrid<FETCH>::kRowThreads, 0};
}

template <int MODE, int W>
int launch_leafround(cudaStream_t st, const float* rays, const float* blocks,
                     int rounds, float* out) {
  const Launch l = round_launch(MODE, W);
  leafround_kernel<MODE, W><<<l.grid, l.threads, l.smem, st>>>(
      rays, blocks, rounds, out);
  return static_cast<int>(cudaGetLastError());
}

template <int FETCH, bool PAIRS>
int launch_walk8(cudaStream_t st, const float* rays, const float* tab,
                 int words, int steps, float* acc, int* idx_tr, int* bs_tr) {
  const Launch l = walk_launch<FETCH>();
  walk8_kernel<FETCH, PAIRS><<<l.grid, l.threads, 0, st>>>(
      rays, tab, words, steps, acc, idx_tr, bs_tr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K22: LEAF_MODE `mode` (0, 1, 2) at width w (32 or 64) for `rounds`
// rounds on `stream`. rays [7][1024] f32, blocks [1024][16 w] f32 16-byte
// aligned (mode 2's bulk copy), out [1024]. Returns cudaGetLastError()
// (0 = launched).
extern "C" int leafround_probe_launch(int mode, int w, const float* rays,
                                      const float* blocks, int rounds,
                                      float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rounds < 0 || (mode == 2 && reinterpret_cast<uintptr_t>(blocks) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
#define PT_LEAFROUND(M, WW) \
  if (mode == M && w == WW) return launch_leafround<M, WW>(st, rays, blocks, rounds, out);
  PT_LEAFROUND(0, 32)
  PT_LEAFROUND(1, 32)
  PT_LEAFROUND(2, 32)
  PT_LEAFROUND(0, 64)
  PT_LEAFROUND(1, 64)
  PT_LEAFROUND(2, 64)
#undef PT_LEAFROUND
  return static_cast<int>(cudaErrorInvalidValue);
}

// K22's launch in `mode` at width `w`: its blocks, threads a block and
// bytes of dynamic shared memory, for the records and the checks.
extern "C" int leafround_probe_shape(int mode, int w, int* grid,
                                     int* threads, int* smem) {
  if (mode < 0 || mode > 2 || (w != 32 && w != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = round_launch(mode, w);
  *grid = l.grid;
  *threads = l.threads;
  *smem = l.smem;
  return 0;
}

// K23 (pairs = 0: ntab [N * 6], words = N, a power of two >= 32) and K24
// (pairs = 1: tabs [12][S * 128], words = S * 128, a power of two), fetch
// 0 fixed (K23 only), 1 shfl, 2 lanes (K24 only), for `steps` steps on
// `stream`. acc [1024]; idx_tr and bs_tr [steps][8] int32, or both null.
// Returns cudaGetLastError() (0 = launched).
extern "C" int walk8_probe_launch(int pairs, int fetch, const float* rays,
                                  const float* tab, int words, int steps,
                                  float* acc, int* idx_tr, int* bs_tr,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (steps < 0 || words < 2 || (words & (words - 1)) ||
      (!pairs && words < 32) || ((idx_tr == nullptr) != (bs_tr == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!pairs && fetch == kFixed)
    return launch_walk8<kFixed, false>(st, rays, tab, words, steps, acc,
                                       idx_tr, bs_tr);
  if (!pairs && fetch == kShfl)
    return launch_walk8<kShfl, false>(st, rays, tab, words, steps, acc,
                                      idx_tr, bs_tr);
  if (pairs && fetch == kShfl)
    return launch_walk8<kShfl, true>(st, rays, tab, words, steps, acc,
                                     idx_tr, bs_tr);
  if (pairs && fetch == kLanesFetch)
    return launch_walk8<kLanesFetch, true>(st, rays, tab, words, steps, acc,
                                           idx_tr, bs_tr);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The walk's launch in fetch mode `fetch` (0 fixed, 1 shfl, 2 lanes): its
// blocks, threads a block and bytes of dynamic shared memory (none), for
// the records and the checks.
extern "C" int walk8_probe_shape(int fetch, int* grid, int* threads,
                                 int* smem) {
  if (fetch < kFixed || fetch > kLanesFetch)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = fetch == kFixed  ? walk_launch<kFixed>()
                   : fetch == kShfl ? walk_launch<kShfl>()
                                    : walk_launch<kLanesFetch>();
  *grid = l.grid;
  *threads = l.threads;
  *smem = l.smem;
  return 0;
}
