// The TPU micro-benchmarks of experiments/tpu_micro.py, for NVIDIA Hopper
// (sm_90a): six chains of dependent steps, each the GPU form of one TPU
// kernel body, computing that body's function on the same inputs.
//
// Replaces (experiments/tpu_micro.py):
//   * E3 `kernel` :123 (through _pallas_steps_runner :98, pallas_call
//     :101): a per-lane gather from an (R, T) table, acc += table[r, idx],
//     idx = (idx * 1664525 + int(acc)) mod T. Modes: kL2 reads the table
//     with __ldcg (cached in L2 only, so every step pays an L2 round trip);
//     kSmem stages the block's table row (T * 4 B, 64 KB at T = 16384) in
//     dynamic shared memory first;
//   * E4 `kernel` :154: one (8, 128) tile against a row i of a (T, 8)
//     table read as a broadcast; near = max of three slab terms, acc +=
//     near, and i steps by a block-wide vote on sum(near) > 0. The sum is
//     a warp shuffle tree, then the 32 warp partials through shared memory
//     and the same tree in warp 0; the plain version sums in this order;
//   * E7 `kernel` :254: the one-hot MXU fetch of 8 columns. The one-hot
//     product selects one bf16-rounded element a column, so its GPU form
//     is a per-lane gather of the 8 values, each rounded with
//     __float2bfloat16_rn. L2 only: the (8, 16384) table in bf16 (256 KB)
//     exceeds a block's 227 KB of shared memory;
//   * E5 `kernel` :187 (pallas_call :206): a chain of blocking 8 KB copies
//     of a (16, 128) block into shared memory, of which row 0 is added to
//     acc; the next block's index follows from the data just copied,
//     c = (c * 5 + int(acc[0]) % 3 + 1) % C, so no copy can be issued
//     before the last one has landed and been read: a leaf learned with
//     no lead. The TPU's make_async_copy on a DMA semaphore is Hopper's
//     bulk copy on an mbarrier (csrc/dma_probe.cu's K15a): a block is one
//     warp; for each step lane 0 arrives with expect_tx 8,192 B and issues
//     one cp.async.bulk of block c, the warp waits with try_wait.parity
//     and adds row 0 (4 floats a lane), lane 0 takes the next c from its
//     own acc[0] and a __shfl_sync gives it to the warp; a __syncwarp
//     orders every lane's reads of the buffer before lane 0's
//     fence.proxy.async (kProxyFence; the A/B prices it at 0) and the next
//     copy. The first form gave each copy to 128 threads' 16 B loads and
//     stores, with two __syncthreads a copy;
//   * E8 `kernel` :299 (pallas_call :341): leaf phase A, the cluster
//     staged in shared memory and its 128 triangles' 9 words read as
//     broadcasts by the 1024 lanes, best updated triangle by triangle;
//   * E9 `kernel` :367 (pallas_call :411): leaf phase B, each lane loads
//     the cluster's words itself (__ldg: L1/L2) and takes the min of each
//     chunk of 32. t > 0.001 excludes NaN and 1e30 never beats best, so
//     this is E8's function and the two outputs are bit-equal.
//   Both chain their leaves: the next cluster is c = (c * 5 + int(best[0,
//   0]) % 3 + 1) % C, learned from the leaf just tested, with no lead.
//   The first forms ran the TPU's one-core shape, one block of 1024
//   threads on 1 of 132 SMs. Here the 1024 lanes spread over the card:
//   kTile / R blocks of R rays at L lanes a ray (LeafGrid), lane s of a
//   ray testing triangles s, s + L, ... and the ray's lanes merging the
//   least accepted t (exact and order-free, so bit-equal to both TPU
//   forms). Each block's warp 0 (the producer) tests ray 0 itself, 4
//   triangles a lane and one REDUX (positive floats order as their
//   bits), and derives every next c in the block: no block waits on
//   another. K19 (E8) stages rows 0-8 of each cluster (4,608 B,
//   kLeafCopyRows) by one cp.async.bulk on an mbarrier into a ring of
//   kLeafStages stages, issued by the producer as soon as ray 0's test of
//   the leaf before gives c, the consumer warps reading the stage as
//   shared-memory broadcasts and releasing it on its empty mbarrier; K20
//   (E9) hands c to its consumer warps through a ring of kChainRing slots
//   in shared memory behind named barriers. A lane's tests are
//   split at their IEEE divisions (mt_split, mt_finish) so that the
//   divisions, each a branch to a slow path, sit back to back and the
//   rest of the tests interleave.
//
//   The constants are the A/B's (experiments/tpu_micro.py leaf_ab; PERF.md
//   §6 K19/K20 has the readings, ns a leaf, the slope from 200 to 5,200
//   leaves, device time in CUDA graphs in turns): K19 at 16 lanes a ray
//   (8: 1,354; 32: 1,047) and 8 rays a block (4: 1,011; 16: 1,156), 3
//   stages (1, 2, 4: 1,090, 961, 977), rows 0-8 (the whole 8 KB block
//   ties, 915), 914; K20 at 32 lanes (16: 1,397) and 8 rays (4: 1,098;
//   16: 1,640), a ring of 4 slots (1: 991; 2 ties, 976), 977. Yardsticks
//   outside the package: a thread-block cluster of 4 (one block's warp
//   walks the chain, one multicast copy feeds the cluster, c by
//   distributed shared memory) 1,482 and 2,096; K20 with every warp
//   testing ray 0 and no barrier 1,355; K19 with all three candidate
//   clusters copied a leaf ahead 1,059.
//
// Arithmetic follows the TPU source's order (the "MT-ish" test of
// :309-327 is not real Moller-Trumbore: v uses o1 three times), built with
// -fmad=false, so each kernel is bit-equal to its plain PyTorch version.
// Integers: the TPU code's int32 products wrap, so the LCG runs in
// unsigned arithmetic, and its floor mod by T = 2^k is a mask; float to
// int is __float2int_rz (cvt.rzi.s32.f32 truncates and saturates, as XLA
// does: int(1e30) = 2147483647); the other mods are floor mods.
//
// What bounds them: by design, latency. Each step waits on the one before
// it (a gather, a copy, a vote); the bounds the records carry (each input
// read once, or the bytes copied; E8/E9's FP32 operations) are far below.
// E5's one warp issues a step's chain loop (its SASS counted by
// experiments/tpu_micro.py copy_sass) far faster than the copy's round
// trip, which is the number to read. E8/E9 run at 2-3x their issue-rate
// floor (leaf_sass, leaf_floor: each block's consumer warps' leaf loops
// and its producer's chain step): K19 above both its chain alone (a
// copy's round trip after ray 0's test, 740 ns a leaf with the
// consumers' tests left out) and its consumers alone (819 ns with ray
// 0's test left out), which overlap; K20 at either alone (1,041 and
// 1,001 ns: ray 0's loads from the L2, its test and the hand-off, or the
// consumers' loads and tests). The card-wide FP32 bound, 1024 x 128 x 46
// operations a leaf, is 90 ns.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

constexpr unsigned kLcg = 1664525u;
constexpr int kMaxThreads = 1024;
constexpr int kTile = 1024;             // the (8, 128) lane tile of E4, E8, E9
constexpr int kRowW = 8;                // E4's table rows
constexpr int kCols = 8;                // E7's table columns
constexpr int kBlockRows = 16, kBlockW = 128;  // a (16, 128) f32 block
constexpr int kBlockFloats = kBlockRows * kBlockW;
constexpr int kCopyThreads = 32;        // E5: one warp, 4 of acc's 128 a lane
constexpr int kProxyFence = 1;          // E5, E8: proxy fence before a copy
constexpr int kE8Lanes = 16;            // E8: lanes that test one ray
constexpr int kE8Rays = 8;              // E8: rays a block
constexpr int kE9Lanes = 32;            // E9: lanes that test one ray
constexpr int kE9Rays = 8;              // E9: rays a block
constexpr int kLeafStages = 3;          // E8: the ring's stages
constexpr int kLeafCopyRows = 9;        // E8: rows a copy stages (9 or 16)
constexpr int kChainRing = 4;           // E9: the ring of c's slots
constexpr float kFar = 1e30f;
constexpr float kTMin = 1e-3f;
constexpr float kEpsA = 1e-7f;
constexpr unsigned kFull = 0xffffffffu;

enum GatherMode : int { kL2 = 0, kSmem = 1 };
enum LeafMode : int { kModeSmem = 0, kModeLanes = 1 };

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// (idx * 1664525 + int(acc)) mod T in int32 that wraps, T = mask + 1 a
// power of two: the low bits of the unsigned sum.
__device__ __forceinline__ unsigned lcg(unsigned idx, float acc,
                                        unsigned mask) {
  return (idx * kLcg + static_cast<unsigned>(__float2int_rz(acc))) & mask;
}

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads)
gather_kernel(const float* __restrict__ table, const int* __restrict__ idx0,
              int T, int L, int steps, float* __restrict__ out) {
  extern __shared__ float srow[];
  const int r = blockIdx.y;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const float* row = table + static_cast<size_t>(r) * T;
  if (kMode == kSmem) {
    for (int j = threadIdx.x; j < T; j += blockDim.x) srow[j] = row[j];
    __syncthreads();
  }
  const unsigned mask = static_cast<unsigned>(T) - 1u;
  const size_t lane = static_cast<size_t>(r) * L + l;
  // idx0 lies in [0, T); the mask keeps a caller's bad index in bounds
  unsigned idx = static_cast<unsigned>(idx0[lane]) & mask;
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    acc += kMode == kSmem ? srow[idx] : __ldcg(row + idx);
    idx = lcg(idx, acc, mask);
  }
  out[lane] = acc;
}

__global__ void __launch_bounds__(256)
onehot_kernel(const float* __restrict__ table, const int* __restrict__ idx0,
              int T, int L, int steps, float* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const unsigned mask = static_cast<unsigned>(T) - 1u;
  unsigned idx = static_cast<unsigned>(idx0[l]) & mask;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float v = __ldcg(table + static_cast<size_t>(c) * T + idx);
      acc[c] += __bfloat162float(__float2bfloat16_rn(v));
    }
    idx = lcg(idx, acc[0], mask);
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) out[static_cast<size_t>(c) * L + l] = acc[c];
}

// Lane 0 gets v[0] + v[16], then + v[8] ..., the plain version's tree.
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kTile)
row_vote_kernel(const float* __restrict__ rows, int T,
                const float* __restrict__ x, int steps,
                float* __restrict__ out) {
  __shared__ float part[kTile / 32];
  __shared__ float total;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float xv = x[t];
  float acc = 0.f;
  int i = 1;
  for (int s = 0; s < steps; ++s) {
    const float* r = rows + static_cast<size_t>(i) * kRowW;
    const float t0 = (xv - __ldg(r + 0)) * __ldg(r + 3);
    const float t1 = (xv - __ldg(r + 1)) * __ldg(r + 4);
    const float t2 = (xv - __ldg(r + 2)) * __ldg(r + 5);
    const float near = fmaxf(fmaxf(t0, t1), t2);
    acc += near;
    const float w = warp_tree(near);
    if (lane == 0) part[warp] = w;
    __syncthreads();
    if (warp == 0) {
      const float p = warp_tree(part[lane]);
      if (lane == 0) total = p;
    }
    __syncthreads();  // part[] is read before the next step rewrites it
    i = total > 0.f ? (i * 5 + 1) % T : (i * 3 + 7) % T;
  }
  out[t] = acc;
}

__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const float4* __restrict__ blocks, int C, int steps,
            float* __restrict__ out) {
  constexpr int kBlock4 = kBlockFloats / 4;  // 512 float4: 8 KB
  constexpr unsigned kBytes = kBlock4 * 16;
  __shared__ __align__(128) float4 buf[kBlock4];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  if (lane == 0) {
    pt::bar_init(&bar, 1);
    pt::bar_init_fence();
  }
  __syncwarp();
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int c = 0;
  for (int s = 0; s < steps; ++s) {
    if (lane == 0) {
      if (kProxyFence) pt::proxy_fence();
      pt::arrive_expect_tx(&bar, kBytes);
      pt::bulk_copy(buf, blocks + static_cast<size_t>(c) * kBlock4, kBytes,
                    &bar);
    }
    pt::bar_wait(&bar, s & 1);
    const float4 r = buf[lane];  // row 0: acc[4 * lane .. 4 * lane + 3]
    acc.x += r.x;
    acc.y += r.y;
    acc.z += r.z;
    acc.w += r.w;
    const int next =
        floor_mod(c * 5 + floor_mod(__float2int_rz(acc.x), 3) + 1, C);
    c = __shfl_sync(kFull, next, 0);
    __syncwarp();  // every lane has read buf before the next copy
  }
  reinterpret_cast<float4*>(out)[lane] = acc;
}

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// The source's test for one lane (o1) and one triangle, in its order (46
// FP32 operations, the division one; compares not counted), split at its
// division so that a lane's tests can share one stretch of code between
// their divisions: mt_split computes the three sums that f scales and f's
// denominator (a, or 1 where |a| < 1e-7); mt_finish takes f = 1 / den and
// returns the accepted t or 1e30. Each IEEE division is a branch to its
// slow path, across which the compiler moves no other work: with the
// divisions of a lane's tests back to back, the rest of the tests
// interleave.
struct Part {
  float den, su, sv, st;
};

__device__ __forceinline__ Part mt_split(float o1, const Tri& q) {
  const float hx = o1 * q.e2z - q.v0y * q.e2y;
  const float hy = o1 * q.e2x - q.v0z * q.e2z;
  const float hz = o1 * q.e2y - q.v0x * q.e2x;
  const float a = q.e1x * hx + q.e1y * hy + q.e1z * hz;
  const float sx = o1 - q.v0x, sy = o1 - q.v0y, sz = o1 - q.v0z;
  const float qx = sy * q.e1z - sz * q.e1y;
  const float qy = sz * q.e1x - sx * q.e1z;
  const float qz = sx * q.e1y - sy * q.e1x;
  return {fabsf(a) < kEpsA ? 1.0f : a, sx * hx + sy * hy + sz * hz,
          o1 * qx + o1 * qy + o1 * qz, q.e2x * qx + q.e2y * qy + q.e2z * qz};
}

__device__ __forceinline__ float mt_finish(const Part& p, float f) {
  const float u = f * p.su, v = f * p.sv, t = f * p.st;
  const bool ok = (u > 0.f) & (v > 0.f) & (u + v < 1.f) & (t > kTMin);
  return ok ? t : kFar;
}

template <typename Load>
__device__ __forceinline__ Tri tri_at(Load load, int w) {
  return Tri{load(0 * kBlockW + w), load(1 * kBlockW + w),
             load(2 * kBlockW + w), load(3 * kBlockW + w),
             load(4 * kBlockW + w), load(5 * kBlockW + w),
             load(6 * kBlockW + w), load(7 * kBlockW + w),
             load(8 * kBlockW + w)};
}

__device__ __forceinline__ int next_cluster(int c, float best, int C) {
  return floor_mod(c * 5 + floor_mod(__float2int_rz(best), 3) + 1, C);
}

// The least accepted t (1e30 where none) of one ray over a cluster's 128
// triangles, on an aligned group of L lanes of the warp: lane s of the
// group tests triangles s, s + L, ... (128 / L of them, unrolled), then the
// group merges by fminf over log2(L) __shfl_xor_sync steps. A test that is
// not accepted gives 1e30 and an accepted t is never NaN (t > 0.001), so
// the minimum is exact and independent of order: E8's triangle-by-triangle
// update and E9's chunk minima, bit for bit. Every lane of the group
// returns it.
template <int L, typename Load>
__device__ __forceinline__ float group_min(float o1, int s, Load load) {
  static_assert(L == 8 || L == 16 || L == 32, "a group divides the warp");
  constexpr int K = kBlockW / L;
  Part p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = mt_split(o1, tri_at(load, s + k * L));
  float f[K];
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = 1.0f / p[k].den;
  float m = kFar;
#pragma unroll
  for (int k = 0; k < K; ++k) m = fminf(m, mt_finish(p[k], f[k]));
  if (L == 32)  // positive floats order as their bits: one REDUX
    return __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(m)));
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    m = fminf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

// Named barrier `id` (1-15; 0 is __syncthreads') of `n` threads: arrive
// without waiting, or arrive and wait. An arrive synchronizes with the
// syncs of the same phase (PTX's barrier rules), so what a thread wrote
// before its arrive is visible to the waiters after their sync.
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// E8/E9 over the card: kTile / R blocks, each R rays of L lanes (the
// consumer warps) and, in front of them, one warp that walks the chain
// (the producer, warp 0): it tests ray 0 itself (32 lanes, 4 triangles a
// lane) and derives each next cluster in the block, so no block waits on
// another.
template <int L, int R>
struct LeafGrid {
  static_assert((R == 2 || R == 4 || R == 8 || R == 16) && R * L % 32 == 0,
                "2 to 16 rays a block, whole warps of rays");
  static constexpr int kConsumers = R * L / 32;  // consumer warps a block
  static constexpr int kThreads = 32 + R * L;
  static constexpr int kBlocks = kTile / R;
};
using E8Grid = LeafGrid<kE8Lanes, kE8Rays>;
using E9Grid = LeafGrid<kE9Lanes, kE9Rays>;
constexpr int kCopyFloats = kLeafCopyRows * kBlockW;
constexpr unsigned kCopyBytes = kCopyFloats * 4;
static_assert(kLeafCopyRows == 9 || kLeafCopyRows == 16,
              "the test's 9 rows or the whole block");
static_assert(kLeafStages >= 1 && kChainRing >= 1 && kChainRing <= 7,
              "a ring; named barriers 1-14");

// K19: the cluster staged in shared memory by the bulk-copy engine, a
// ring of kLeafStages stages with a full and an empty mbarrier each. The
// producer waits on leaf i's stage, tests ray 0 from it, learns c and at
// once issues leaf i + 1's copy into the next stage (lane 0: expect_tx,
// then one cp.async.bulk of rows 0 to kLeafCopyRows - 1 of cluster c),
// after the consumers released that stage's last use. The consumers wait
// on leaf i's stage, test their rays from it as broadcasts, and release it
// (one arrive a warp on its empty barrier).
__global__ void __launch_bounds__(E8Grid::kThreads)
leaf_smem_kernel(const float* __restrict__ blocks, int C,
                 const float* __restrict__ ox, int steps,
                 float* __restrict__ out) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kLeafStages], empty[kLeafStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int j = 0; j < kLeafStages; ++j) {
      pt::bar_init(&full[j], 1);
      pt::bar_init(&empty[j], E8Grid::kConsumers);
    }
    pt::bar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    const float o0 = ox[0];
    float best0 = kFar;
    int c = 0;
    if (steps > 0 && lane == 0) {  // leaf 0 is cluster 0
      pt::arrive_expect_tx(&full[0], kCopyBytes);
      pt::bulk_copy(ring, blocks, kCopyBytes, &full[0]);
    }
    for (int i = 0; i < steps; ++i) {
      const int st = i % kLeafStages;
      pt::bar_wait(&full[st], (i / kLeafStages) & 1);
      const float* r = ring + st * kCopyFloats;
      best0 = fminf(best0, group_min<32>(o0, lane,
                                         [r](int k) { return r[k]; }));
      c = next_cluster(c, best0, C);
      if (i + 1 < steps) {
        const int nx = (i + 1) % kLeafStages;
        if (i + 1 >= kLeafStages)
          pt::bar_wait(&empty[nx], ((i + 1) / kLeafStages - 1) & 1);
        __syncwarp();  // the warp has read the stage it may refill
        if (lane == 0) {
          if (kProxyFence) pt::proxy_fence();
          pt::arrive_expect_tx(&full[nx], kCopyBytes);
          pt::bulk_copy(ring + nx * kCopyFloats,
                        blocks + static_cast<size_t>(c) * kBlockFloats,
                        kCopyBytes, &full[nx]);
        }
      }
    }
    return;
  }
  const int t = threadIdx.x - 32, s = t % kE8Lanes;
  const int ray = blockIdx.x * kE8Rays + t / kE8Lanes;
  const float o1 = ox[ray];
  float best = kFar;
  for (int i = 0; i < steps; ++i) {
    const int st = i % kLeafStages;
    pt::bar_wait(&full[st], (i / kLeafStages) & 1);
    const float* r = ring + st * kCopyFloats;
    best = fminf(best, group_min<kE8Lanes>(o1, s,
                                             [r](int k) { return r[k]; }));
    __syncwarp();  // every lane has read the stage
    if (lane == 0 && i + kLeafStages < steps) pt::bar_arrive(&empty[st]);
  }
  if (s == 0) out[ray] = best;
}

// K20: every lane reads its triangles' words itself (__ldg: L1, L2). The
// producer hands each c to the consumers through a ring of kChainRing
// slots in shared memory, named barriers 1 to kChainRing (slot j written)
// and kChainRing + 1 on (slot j read): it publishes c_i, then tests ray 0
// on cluster c_i for c_{i+1}, running up to kChainRing leaves ahead of the
// consumers.
__global__ void __launch_bounds__(E9Grid::kThreads)
leaf_lanes_kernel(const float* __restrict__ blocks, int C,
                  const float* __restrict__ ox, int steps,
                  float* __restrict__ out) {
  __shared__ int cring[kChainRing];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    const float o0 = ox[0];
    float best0 = kFar;
    int c = 0;
    for (int i = 0; i < steps; ++i) {
      const int j = i % kChainRing;
      if (i >= kChainRing) named_sync(1 + kChainRing + j, E9Grid::kThreads);
      if (lane == 0) cring[j] = c;
      named_arrive(1 + j, E9Grid::kThreads);
      const float* cl = blocks + static_cast<size_t>(c) * kBlockFloats;
      const auto load = [cl](int k) { return __ldg(cl + k); };
      best0 = fminf(best0, group_min<32>(o0, lane, load));
      c = next_cluster(c, best0, C);
    }
    return;
  }
  const int t = threadIdx.x - 32, s = t % kE9Lanes;
  const int ray = blockIdx.x * kE9Rays + t / kE9Lanes;
  const float o1 = ox[ray];
  float best = kFar;
  for (int i = 0; i < steps; ++i) {
    const int j = i % kChainRing;
    named_sync(1 + j, E9Grid::kThreads);
    const float* cl = blocks + static_cast<size_t>(cring[j]) * kBlockFloats;
    if (i + kChainRing < steps)
      named_arrive(1 + kChainRing + j, E9Grid::kThreads);
    best = fminf(best, group_min<kE9Lanes>(
                           o1, s, [cl](int k) { return __ldg(cl + k); }));
  }
  if (s == 0) out[ray] = best;
}

// The launch of E8 (mode 0) or E9 (mode 1): blocks, threads a block and
// dynamic shared memory.
struct LeafLaunch {
  int grid, threads, smem;
};

inline LeafLaunch leaf_launch(int mode) {
  if (mode == kModeSmem)
    return {E8Grid::kBlocks, E8Grid::kThreads,
            kLeafStages * static_cast<int>(kCopyBytes)};
  return {E9Grid::kBlocks, E9Grid::kThreads, 0};
}

inline bool pow2(int T) { return T > 0 && (T & (T - 1)) == 0; }

}  // namespace

// Each entry launches one kernel on `stream` and returns
// cudaGetLastError() (0 = launched); pointers are device pointers of
// contiguous float32 / int32 tensors, checked by the Python wrappers.

// E3: table [R, T] (T a power of two, at most 32768 in kSmem), idx and
// out [R, L]; L <= 1024 a multiple of 32, or a multiple of 1024.
extern "C" int tpu_micro_gather(int mode, const float* table, const int* idx,
                                int R, int T, int L, int steps, float* out,
                                void* stream) {
  const int threads = L < kMaxThreads ? L : kMaxThreads;
  if (R < 1 || L < 1 || steps < 0 || !pow2(T) || threads % 32 ||
      L % threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(L / threads, R);
  if (mode == kL2) {
    gather_kernel<kL2><<<grid, threads, 0, st>>>(table, idx, T, L, steps, out);
  } else if (mode == kSmem) {
    const int smem = T * static_cast<int>(sizeof(float));
    const cudaError_t e = cudaFuncSetAttribute(
        gather_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    gather_kernel<kSmem><<<grid, threads, smem, st>>>(table, idx, T, L, steps,
                                                     out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// E4: rows [T, 8] (T >= 2: i starts at 1), x and out [1024].
extern "C" int tpu_micro_row_vote(const float* rows, int T, const float* x,
                                  int steps, float* out, void* stream) {
  if (T < 2 || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  row_vote_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, T, x, steps, out);
  return static_cast<int>(cudaGetLastError());
}

// E7: table [8, T] (T a power of two), idx [L], out [8, L].
extern "C" int tpu_micro_onehot(const float* table, const int* idx, int T,
                                int L, int steps, float* out, void* stream) {
  if (L < 1 || steps < 0 || !pow2(T))
    return static_cast<int>(cudaErrorInvalidValue);
  onehot_kernel<<<(L + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(table, idx, T, L,
                                                       steps, out);
  return static_cast<int>(cudaGetLastError());
}

// E5: blocks [C, 16, 128], 16-byte aligned; out [128], 16-byte aligned.
extern "C" int tpu_micro_copy(const float* blocks, int C, int steps,
                              float* out, void* stream) {
  if (C < 1 || steps < 0 || reinterpret_cast<uintptr_t>(blocks) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  copy_kernel<<<1, kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(blocks), C, steps, out);
  return static_cast<int>(cudaGetLastError());
}

// E8 (mode 0) and E9 (mode 1): blocks [C, 16, 128], 16-byte aligned in
// mode 0 (the bulk copy's source); ox and out [1024]. Returns the CUDA
// error of the shared-memory opt-in or of the launch.
extern "C" int tpu_micro_leaf(int mode, const float* blocks, int C,
                              const float* ox, int steps, float* out,
                              void* stream) {
  if (C < 1 || steps < 0 || (mode != kModeSmem && mode != kModeLanes) ||
      (mode == kModeSmem && reinterpret_cast<uintptr_t>(blocks) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LeafLaunch l = leaf_launch(mode);
  if (mode == kModeSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        leaf_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        l.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    leaf_smem_kernel<<<l.grid, l.threads, l.smem, st>>>(blocks, C, ox, steps,
                                                       out);
  } else {
    leaf_lanes_kernel<<<l.grid, l.threads, 0, st>>>(blocks, C, ox, steps,
                                                   out);
  }
  return static_cast<int>(cudaGetLastError());
}

// E8/E9's launch in `mode`: its blocks, threads a block and bytes of
// dynamic shared memory, for the records and the checks.
extern "C" int tpu_micro_leaf_shape(int mode, int* grid, int* threads,
                                    int* smem) {
  if (mode != kModeSmem && mode != kModeLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const LeafLaunch l = leaf_launch(mode);
  *grid = l.grid;
  *threads = l.threads;
  *smem = l.smem;
  return 0;
}
