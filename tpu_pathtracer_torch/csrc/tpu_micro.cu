// The TPU micro-benchmarks of experiments/tpu_micro.py, for NVIDIA Hopper
// (sm_90a): six chains of dependent steps, each the GPU form of one TPU
// kernel body, computing that body's function on the same inputs, and the
// bf16 view of E7's table that its chain reads.
//
// Replaces (experiments/tpu_micro.py):
//   * E3 `kernel` :123 (through _pallas_steps_runner :98, pallas_call
//     :101): a per-lane gather from an (R, T) table, acc += table[r, idx],
//     idx = (idx * 1664525 + int(acc)) mod T, one dependent gather a step.
//     Modes: kL2 reads the table with __ldcg (cached in L2 only, so every
//     step pays an L2 round trip); kSmem stages the block's table row
//     (T * 4 B, 64 KB at T = 16384, 128 KB at 32768) in dynamic shared
//     memory by one cp.async.bulk on an mbarrier: thread 0 arms it with
//     expect_tx T * 4 B and issues the copy, one barrier publishes the
//     mbarrier's init while the copy is in flight, and every warp waits on
//     its parity after loading its indices (a row under the copy's 16 B
//     grain, T <= 2, thread 0 stores itself before a plain arrive). The
//     first form staged the row by each thread's 4 B loads and stores and
//     a __syncthreads. The step loop is unrolled kGatherUnroll times, so
//     its counter and branch leave the issue at 131,072 lanes (32 warps
//     an SM) while the chain a step stays the load, FADD, F2I, IMAD, LOP3
//     and the address;
//   * E4 `kernel` :154: one (8, 128) tile against a row i of a (T, 8)
//     table read as a broadcast; near = max of three slab terms, acc +=
//     near, and i steps by a block-wide vote on sum(near) > 0. The vote
//     couples all 1,024 lanes every step, so the tile stays one block (a
//     vote across blocks would cost a grid barrier a step): kVoteWarps
//     warps, kPer = 32 / kVoteWarps lanes a thread. Thread p of a 32-lane
//     group's 32 / kPer threads holds lanes p, p + 32 / kPer, ... and adds
//     them in the first log2 kPer levels of the group's shuffle tree; the
//     shuffles finish it, one thread a group writes the partial to a slot
//     of a two-slot buffer in shared memory (by step parity), and after
//     the step's one __syncthreads every thread reads the 32 partials (8
//     float4 broadcasts) and adds them in the same tree in registers, so
//     every warp takes the same next i with no second barrier and no
//     serial stage. Both candidate rows, (5i + 1) % T and (3i + 7) % T,
//     come from i by a division-free mod (mod_small), not by an integer
//     division after the vote. This is the plain version's tree
//     (block_sum) in every layout. The maxima are PTX
//     max.NaN, NaN if either operand is NaN, as jnp.maximum and
//     torch.maximum: fmaxf, which the first form used, drops a NaN (a NaN
//     word of the row, a 0 x inf slab term, a NaN lane of x);
//   * E7 `kernel` :254: the one-hot MXU fetch of 8 columns. The one-hot
//     product selects one bf16-rounded element a column, and rounding the
//     table once gives the same bits as rounding each fetch, so each call
//     first writes the [8, T] f32 table as a view of [T] rows of 8 bf16
//     (16 B, __float2bfloat16_rn; onehot_view_kernel, on the same stream),
//     and a lane's step is one 16 B load of its row, widened to f32 (the
//     first form made 8 loads of 4 B a step, one 32 B sector each). The
//     wrapper refuses a table that is not finite in bf16 (ROADMAP C-20:
//     the TPU's product turns such a column into NaN on every lane).
//     Each call builds the view into the caller's scratch
//     (tpu_micro_onehot_rows); the first forms' entry, tpu_micro_onehot,
//     took none, and an A/B calls it where a source has no other;
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
// E3 (experiments/tpu_micro.py gather_ab; PERF.md §6 K17a): at 1,024
// lanes a step is the chain's latency, ~200 ns in kL2 and ~31 in kSmem;
// at 131,072 lanes (32 warps an SM) kSmem sits at its bank floor, a warp's
// random gather taking ~3.5 wavefronts (tpu_micro.py smem_wavefronts,
// bank_floor: 57 ns), above the conversion pipe's ~33 (the yardstick
// gather_noload, no load), and kL2 moves ~4 TB/s of 32 B sectors. The
// bulk copy takes ~16-19 us off kSmem's per-call intercept at 1,024
// lanes; one multicast copy a cluster of 8 (gather_multicast) doubles
// its step at 131,072 lanes.
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
//
// E4 and E7 (experiments/tpu_micro.py row_vote_ab, onehot_ab; PERF.md §6
// K17b/K17c, device time a call in a CUDA graph in turns on an H100, ns a
// step). K17b's step is one chain: i, the row's load (an L1 hit: the
// 2,000-step run visits 287 rows), the slab terms, the group's tree and
// shuffles, the barrier, the partials' tree, the select. At 4 warps (8
// lanes a thread) it reads 237 against the first form's 482 (two barriers
// and a serial warp-0 stage over 32 warps); 8, 16, 32 warps 295, 412,
// 627: fewer lanes a thread buy nothing once the vote must cross more
// warps. Yardsticks in experiments/yardsticks: the partials by an xor
// butterfly of 5 shuffles (vote_shfl) 313; the next row by `%`, an integer
// division after the vote (vote_div) 276; both candidate rows loaded a
// step ahead (vote_lead) 253, the rows sitting in the L1. Its issue-rate
// floor (172 SASS a warp's step, 4 warps on 4 schedulers) is 87 ns and a
// warp's step and K17a's on-chip round trip 120 ns: it runs at 2x that.
// K17c's step is one 16 B __ldg of the view, 8 widened adds and the LCG
// (24 SASS): 193-196 at the TPU's 256 lanes (one block of 256 threads; 8
// blocks of 32, kOnehotThreads 32, ties at 198), about an L2 round trip
// (K17a l2: 198), since the 256 KB view does not stay whole in one SM's
// L1; 474-484 at 131,072 lanes, where the L1s serve part of the rows
// (__ldcg, L2 only, the onehot_ldcg yardstick: 207 and 1,185); the first
// form 1,001 and 8,077. The view build adds 6-7 us a call.

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
constexpr int kVoteWarps = 4;           // E4: warps of the tile (4-32)
constexpr int kOnehotThreads = 256;     // E7: threads a block (32 or 256)
constexpr int kGatherUnroll = 4;        // E3: step loop unrolled
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

// K17a's row (T floats) into shared memory, completing on `bar`: one bulk
// copy, or, for a row under the copy's 16 B grain (T <= 2: 4 or 8 B),
// thread 0's own stores before a plain arrive (release; the waiters'
// try_wait acquires).
__device__ __forceinline__ void stage_row(float* dst, const float* row, int T,
                                          uint64_t* bar) {
  const unsigned bytes = static_cast<unsigned>(T) * 4u;
  if (bytes % 16u == 0u) {
    pt::arrive_expect_tx(bar, bytes);
    pt::bulk_copy(dst, row, bytes, bar);
  } else {
    dst[0] = row[0];
    if (T > 1) dst[1] = row[1];
    pt::bar_arrive(bar);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads)
gather_kernel(const float* __restrict__ table, const int* __restrict__ idx0,
              int T, int L, int steps, float* __restrict__ out) {
  extern __shared__ __align__(128) float srow[];
  __shared__ __align__(8) uint64_t full;
  const int r = blockIdx.y;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const float* row = table + static_cast<size_t>(r) * T;
  if (kMode == kSmem) {
    if (threadIdx.x == 0) {
      pt::bar_init(&full, 1);
      pt::bar_init_fence();
      stage_row(srow, row, T, &full);
    }
    __syncthreads();  // publishes the mbarrier's init; the copy is in flight
  }
  const unsigned mask = static_cast<unsigned>(T) - 1u;
  const size_t lane = static_cast<size_t>(r) * L + l;
  // idx0 lies in [0, T); the mask keeps a caller's bad index in bounds
  unsigned idx = static_cast<unsigned>(idx0[lane]) & mask;
  float acc = 0.f;
  if (kMode == kSmem) pt::bar_wait(&full, 0);
#pragma unroll kGatherUnroll
  for (int s = 0; s < steps; ++s) {
    acc += kMode == kSmem ? srow[idx] : __ldcg(row + idx);
    idx = lcg(idx, acc, mask);
  }
  out[lane] = acc;
}

// K17c's view: row r of the [8, T] table as 8 bf16 in 16 B, column 2k in
// the low half of word k and column 2k + 1 in its high half.
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(256)
onehot_view_kernel(const float* __restrict__ table, int T,
                   uint4* __restrict__ view) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= T) return;
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = bf16_bits(table[static_cast<size_t>(2 * k) * T + r]) |
           bf16_bits(table[static_cast<size_t>(2 * k + 1) * T + r]) << 16;
  view[r] = make_uint4(w[0], w[1], w[2], w[3]);
}

// K17c: a lane's step is one 16 B load of its row of the view, its 8 bf16
// widened to f32 (a bf16 is the high half of its f32) and added.
__global__ void __launch_bounds__(kOnehotThreads)
onehot_kernel(const uint4* __restrict__ view, const int* __restrict__ idx0,
              int T, int L, int steps, float* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const unsigned mask = static_cast<unsigned>(T) - 1u;
  unsigned idx = static_cast<unsigned>(idx0[l]) & mask;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const uint4 q = __ldg(view + idx);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] += __uint_as_float(w[k] << 16);
      acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
    }
    idx = lcg(idx, acc[0], mask);
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) out[static_cast<size_t>(c) * L + l] = acc[c];
}

// n % T for 0 <= n < 6 T: E4's candidates 5i + 1 and 3i + 7 with 0 <= i <
// T, T >= 2. The quotient (0 to 5) from T's float inverse is off by at
// most one, which the two corrections take back.
__device__ __forceinline__ int mod_small(int n, int T, float inv) {
  const int q = __float2int_rz(__int2float_rn(n) * inv);
  int r = n - q * T;
  if (r < 0) r += T;
  if (r >= T) r -= T;
  return r;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// jnp.maximum's max (and torch.maximum's): NaN if either operand is NaN,
// where fmaxf returns the other one.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// E4's tile over kVoteWarps warps: thread p of the kSub threads of 32-lane
// group g holds lanes 32 g + p + j kSub, j < kPer.
struct VoteGrid {
  static_assert(kVoteWarps == 4 || kVoteWarps == 8 || kVoteWarps == 16 ||
                    kVoteWarps == 32,
                "4, 8, 16 or 32 warps: 8, 4, 2 or 1 lanes a thread");
  static constexpr int kThreads = 32 * kVoteWarps;
  static constexpr int kPer = kTile / kThreads;  // lanes a thread
  static constexpr int kSub = 32 / kPer;         // threads a group
};

__global__ void __launch_bounds__(VoteGrid::kThreads)
row_vote_kernel(const float* __restrict__ rows, int T,
                const float* __restrict__ x, int steps,
                float* __restrict__ out) {
  constexpr int kPer = VoteGrid::kPer, kSub = VoteGrid::kSub;
  __shared__ __align__(16) float part[2][kTile / 32];  // by step parity
  const int lane = threadIdx.x & 31;
  const int g = (threadIdx.x >> 5) * kPer + lane / kSub, p = lane % kSub;
  const int base = 32 * g + p;
  float xv[kPer], acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    xv[j] = x[base + j * kSub];
    acc[j] = 0.f;
  }
  const float inv = 1.0f / static_cast<float>(T);
  int i = 1;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    // both candidates by a division-free mod, which ptxas schedules in the
    // vote's shadow: left to itself the compiler selects the numerator
    // after the vote and runs an integer division there, on the chain
    int up = mod_small(i * 5 + 1, T, inv);
    int down = mod_small(i * 3 + 7, T, inv);
    asm volatile("" : "+r"(up), "+r"(down));
    const float* r = rows + static_cast<size_t>(i) * kRowW;
    const float r0 = __ldg(r + 0), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
    const float r3 = __ldg(r + 3), r4 = __ldg(r + 4), r5 = __ldg(r + 5);
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float t0 = (xv[j] - r0) * r3;
      const float t1 = (xv[j] - r1) * r4;
      const float t2 = (xv[j] - r2) * r5;
      v[j] = max_nan(max_nan(t0, t1), t2);
      acc[j] += v[j];
    }
    // the group's tree: offsets 16 .. kSub in the thread, then shuffles
#pragma unroll
    for (int h = kPer / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int j = 0; j < h; ++j) v[j] += v[j + h];
    }
    float w = v[0];
#pragma unroll
    for (int off = kSub / 2; off > 0; off >>= 1)
      w += __shfl_down_sync(kFull, w, off);
    float* slot = part[s & 1];
    if (p == 0) slot[g] = w;
    __syncthreads();  // the slot written by step s + 2 is read by now
    // every thread: the 32 partials as 8 float4 (broadcasts), block_sum's
    // tree over them in registers (offsets 16, 8, 4, 2, 1)
    const float4* q = reinterpret_cast<const float4*>(slot);
    float4 a0 = add4(q[0], q[4]), a1 = add4(q[1], q[5]);
    const float4 a2 = add4(q[2], q[6]), a3 = add4(q[3], q[7]);
    a0 = add4(add4(a0, a2), add4(a1, a3));
    const float total = (a0.x + a0.z) + (a0.y + a0.w);
    i = total > 0.f ? up : down;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[base + j * kSub] = acc[j];
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

// E3: table [R, T] (T a power of two, at most 32768 in kSmem; 16-byte
// aligned in kSmem, the bulk copy's source), idx and out [R, L]; L <= 1024
// a multiple of 32, or a multiple of 1024.
extern "C" int tpu_micro_gather(int mode, const float* table, const int* idx,
                                int R, int T, int L, int steps, float* out,
                                void* stream) {
  const int threads = L < kMaxThreads ? L : kMaxThreads;
  if (R < 1 || L < 1 || steps < 0 || !pow2(T) || threads % 32 ||
      L % threads ||
      (mode == kSmem && reinterpret_cast<uintptr_t>(table) % 16))
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
  row_vote_kernel<<<1, VoteGrid::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(rows, T, x, steps,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}

// E7's view of table [8, T]: view [T] rows of 16 B, 16-byte aligned.
extern "C" int tpu_micro_onehot_view(const float* table, int T, void* view,
                                     void* stream) {
  if (T < 1 || reinterpret_cast<uintptr_t>(view) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  onehot_view_kernel<<<(T + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      table, T, static_cast<uint4*>(view));
  return static_cast<int>(cudaGetLastError());
}

// E7: the view of table [8, T] (T a power of two) built into view (T * 16
// B, 16-byte aligned, the caller's scratch), then the chain over idx [L]
// into out [8, L]. The first forms' entry, tpu_micro_onehot, took no
// scratch; this one replaces it.
extern "C" int tpu_micro_onehot_rows(const float* table, void* view,
                                     const int* idx, int T, int L, int steps,
                                     float* out, void* stream) {
  if (L < 1 || steps < 0 || !pow2(T))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = tpu_micro_onehot_view(table, T, view, stream);
  if (e != 0) return e;
  onehot_kernel<<<(L + kOnehotThreads - 1) / kOnehotThreads, kOnehotThreads,
                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(view), idx, T, L, steps, out);
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
