// V back-to-back nearest-hit visits of every ray to a 64-triangle cluster,
// for NVIDIA Hopper (sm_90a): a leaf test in the heap kernel's form
// (csrc/bvh.cu, K5) with no traversal around it, and the cost of each way
// of fetching the cluster's rows to the lanes that test them.
//
// Replaces the TPU kernel experiments/leafmt_probe.py::_kernel (:36,
// through run :168, pallas_call :172) and its modes:
//   * kPure (pure): the cluster is staged once a block into shared memory
//     and every visit's lanes read their rows from there;
//   * kCond (cond): kPure, plus one branch a visit on the rays' loop-
//     carried besti and a kernel argument the compiler cannot fold (the
//     TPU mode's lax.cond join): ray i's visit runs unless besti <
//     skip - 1, which never holds at skip = 0; the warp skips a visit
//     that none of its rays runs;
//   * kDma (dma): each lane reads its slots' rows from global memory with
//     __ldg on every visit, nothing staged: K5's own fetch. Here every
//     warp reads the visit's one cluster, so its rows stay in L1, where a
//     K5 leaf's come from the L2: kDmaL1 0 reads them with __ldcg, at the
//     L2 only (a variant the A/B times);
//   * kDb (db, and db2): a two-slot ring a warp in shared memory, filled
//     one visit ahead (kBulk 1: by the bulk-copy engine, lane 0 issuing
//     one cp.async.bulk of the whole cluster that completes on the slot's
//     mbarrier; kBulk 0: the warp's 32 lanes with 16 B cp.async and
//     wait_group), as pltpu.make_async_copy with a DMA semaphore maps to
//     Hopper. The TPU's db2 differs from db only in using a dynamic slot
//     offset, which this kernel does anyway, so db2 is this mode too.
//
// Contract. n is a multiple of 1024, the TPU probe's (8, 128) tile, every
// tile computing the same function per ray; a tile is now 8 blocks of 128
// threads, a thread a ray, on 8 SMs (the first form ran a tile as one
// block of 1024 threads on one SM). Clusters are [C, 64, 12] f32 rows
// (v0, e1, e2, n = e1 x e2; tris.cu's layout). Visit i (0 <= i < V) tests
// cluster 0 (kPure, kCond) or cluster i % C (kDma, kDb), slot w = 0..63,
// with pt::mt_hit at t_min 1e-3: a strict-less nearest update of
// (closest, besti = i*64 + w) in slot order, so the first of equal t
// wins. Outputs closest [n] (t_max where nothing hit) and besti [n] (-1).
//
// Design: every visit is a leaf test by the warp, in K5's split (the
// nearest part of csrc/bvh.cu's leaf_phase, copied here): kLeafLanes
// lanes a (ray, cluster) pair, 32 / kLeafLanes pairs a pass, so
// kLeafLanes passes a visit for the warp's 32 rays. A pair's lanes take
// the ray's o, d and closest from its thread by __shfl_sync; lane s tests
// slots s, s + kLeafLanes, ... against its own running best, which starts
// at the entry closest; the lanes merge on the least (t, slot) in
// log2(kLeafLanes) __shfl_xor_sync steps (a lane without a candidate never
// wins) and the ray's thread takes the winner. Of mt_hit's accept test
// only t < t_best depends on t_best, so the serial loop's winner is the
// least t among the slots that pass against the entry closest, the lower
// slot on an equal t (a NaN t never passes): the merge keeps it, bit for
// bit. Blocks of 128 threads, 8 an SM (K5 exact's launch bounds). The 16
// lanes of a pair read 16 rows 48 B apart: in each 8-lane phase of an
// LDS.128 those are 8 distinct 16 B bank quads (48 B = 12 banks; 12 j mod
// 32 for j < 8 is 0, 12, 24, 4, 16, 28, 8, 20), so a staged mode's row
// load is conflict-free; the warp's two pairs read the same rows.
//
// The db ring is per warp, not per block, because that is the form a
// staged leaf would take inside K5 (ROADMAP B-17): a K5 warp's leaves are
// its own. It costs 2 x 3,072 B + 2 x 8 B a warp, 24,640 B a block, 197
// KB at 8 blocks an SM (of 227 KB; the kernel asks for the largest
// shared-memory carveout). Ordering of the bulk form:
//   * lane 0 initialises its warp's two mbarriers (arrival count 1) and
//     fences them (fence.mbarrier_init) before a copy may complete on
//     them; the block syncs once;
//   * a slot is refilled at visit v (for visit v + 1) after visit v - 1
//     read it: __syncwarp orders the warp's reads of it before lane 0's
//     refill, and lane 0's fence.proxy.async orders those generic-proxy
//     reads before the async proxy's write (kProxyFence; PTX's rule for
//     one location accessed through two proxies). The reads are complete
//     anyway: visit v - 1's merge consumed every row;
//   * lane 0 arrives on the slot's barrier with expect_tx 3,072 B and
//     issues the copy; the warp waits with try_wait.parity at parity
//     (v >> 1) & 1 (slot v & 1's (v >> 1)-th phase); at V = 0 nothing is
//     issued or waited on, and no copy is left in flight at the end;
//   * the copy's source, destination and size are 16 B multiples (the
//     wrapper refuses an unaligned table).
//
// What bounds it: issue. A slot test is mt_hit's 37 FP32 operations (37
// instructions under -fmad=false: the 67 TFLOP/s bound counts an FMA as
// two, so it is out of reach by 2x at least) with the IEEE division and
// the compares, about 68 SASS instructions; a pass adds the broadcasts
// and the merge. The issue-rate floor from the build's SASS
// (experiments/leafmt_probe.py mode_sass) is the yardstick.
//
// Built with -fmad=false and the plain version's operation order
// (leafmt_probe.py), so kernel and plain version agree bit for bit.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kTile = 1024;     // rays a tile: n is a multiple
constexpr int kThreads = 128;   // threads a block, a thread a ray
constexpr int kMinBlocks = 8;   // resident blocks an SM (K5 exact's)
constexpr int kLeafLanes = 16;  // lanes that test one (ray, cluster) pair
constexpr int kBulk = 1;        // db: 1 the bulk copy, 0 the lanes' cp.async
constexpr int kProxyFence = 1;  // db: fence.proxy.async before a refill
constexpr int kDmaL1 = 1;       // dma: 1 __ldg (through L1), 0 __ldcg (L2)
constexpr int kWidth = 64;
constexpr int kCluster4 = kWidth * 3;  // float4 a cluster: 3072 B
constexpr int kWarps = kThreads / 32;
constexpr float kTMin = 1e-3f;
constexpr unsigned kAll = 0xffffffffu;

enum Mode : int { kPure = 0, kCond = 1, kDma = 2, kDb = 3 };

// float4 of shared memory a block holds in each mode
__host__ __device__ constexpr int smem4(int mode) {
  return mode == kDb ? kWarps * 2 * kCluster4 : mode == kDma ? 1 : kCluster4;
}

struct Ray {
  float o1, o2, o3, d1, d2, d3;
  float closest;
  int besti;
};

template <bool GLOBAL>
__device__ __forceinline__ float4 row(const float4* p) {
  return !GLOBAL ? *p : kDmaL1 ? __ldg(p) : __ldcg(p);
}

// One visit v of the warp's rays whose lane bit is set in `run` to the
// cluster at `rows` (GLOBAL: read with __ldg from global memory; else from
// shared memory). Warp-uniform: every lane calls it.
template <bool GLOBAL>
__device__ __forceinline__ void visit(const float4* rows, int v, unsigned run,
                                      Ray& r) {
  constexpr int L = kLeafLanes;
  static_assert(L == 4 || L == 8 || L == 16 || L == 32,
                "a pair's lanes divide the warp");
  constexpr int G = 32 / L;  // pairs a pass
  const int lane = threadIdx.x & 31;
  const int g = lane / L;  // the lane's pair
  const int s = lane % L;  // its slot residue
#pragma unroll 1
  for (int p = 0; p < 32; p += G) {
    const int q = p + g;  // pair g's ray: lane q's
    const bool mine = (run >> q) & 1u;
    const float o1 = __shfl_sync(kAll, r.o1, q);
    const float o2 = __shfl_sync(kAll, r.o2, q);
    const float o3 = __shfl_sync(kAll, r.o3, q);
    const float d1 = __shfl_sync(kAll, r.d1, q);
    const float d2 = __shfl_sync(kAll, r.d2, q);
    const float d3 = __shfl_sync(kAll, r.d3, q);
    const float closest = __shfl_sync(kAll, r.closest, q);
    // a staged cluster never changes here, so without this compiler
    // barrier its rows would be hoisted into registers; each pass reads
    // them from shared memory, as K5 reads a leaf's from the L2
    if (!GLOBAL) asm volatile("" ::: "memory");
    float tb = closest;
    int kb = -1;
    if (mine) {
#pragma unroll 1  // K5 exact's: not unrolled
      for (int k = s; k < kWidth; k += L) {
        float t, u, w;
        if (pt::mt_hit<false>(row<GLOBAL>(rows + 3 * k),
                              row<GLOBAL>(rows + 3 * k + 1),
                              row<GLOBAL>(rows + 3 * k + 2), o1, o2, o3, d1,
                              d2, d3, kTMin, tb, t, u, w)) {
          tb = t;
          kb = k;
        }
      }
    }
    // the pair's first-wins winner: the least (t, slot)
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
      const float t2 = __shfl_xor_sync(kAll, tb, off);
      const int k2 = __shfl_xor_sync(kAll, kb, off);
      if (k2 >= 0 && (kb < 0 || t2 < tb || (t2 == tb && k2 < kb))) {
        tb = t2;
        kb = k2;
      }
    }
    const bool owner = lane >= p && lane < p + G;
    const int from = (owner ? lane - p : 0) * L;
    const float t_w = __shfl_sync(kAll, tb, from);
    const int k_w = __shfl_sync(kAll, kb, from);
    if (owner && k_w >= 0) {
      r.closest = t_w;
      r.besti = v * kWidth + k_w;
    }
  }
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(bar))
               : "memory");
}

// Lane 0: cluster `src` (3072 B) into `dst` by the bulk-copy engine,
// completing on `bar`.
__device__ __forceinline__ void bulk_fetch(float4* dst, const float4* src,
                                           uint64_t* bar) {
  constexpr unsigned kBytes = kCluster4 * 16;
  static_assert(kBytes % 16 == 0, "a bulk copy moves 16 B multiples");
  if (kProxyFence) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem(bar)), "r"(kBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem(dst)),
      "l"(src), "r"(kBytes), "r"(smem(bar))
      : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void copy16_async(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem(dst)),
               "l"(src)
               : "memory");
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
leafmt_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
              const float* __restrict__ oz, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const float* __restrict__ tmax,
              const float4* __restrict__ clusters, int C, int visits,
              int skip, float* __restrict__ t_out,
              int* __restrict__ best_out) {
  __shared__ float4 sm[smem4(MODE)];
  __shared__ uint64_t bars[MODE == kDb ? kWarps * 2 : 1];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i], tmax[i], -1};
  if (MODE == kPure || MODE == kCond) {
    for (int j = threadIdx.x; j < kCluster4; j += kThreads) sm[j] = clusters[j];
    __syncthreads();
    for (int v = 0; v < visits; ++v) {
      unsigned run = kAll;
      if (MODE == kCond) {
        // a branch on the loop-carried besti, which no compiler can
        // hoist out of the loop; at skip = 0 every visit runs
        run = __ballot_sync(kAll, !(r.besti < skip - 1));
        if (run == 0u) continue;
      }
      visit<false>(sm, v, run, r);
    }
  } else if (MODE == kDma) {
    for (int v = 0; v < visits; ++v)
      visit<true>(clusters + static_cast<size_t>(v % C) * kCluster4, v, kAll,
                  r);
  } else {
    float4* ring = sm + (threadIdx.x >> 5) * 2 * kCluster4;
    uint64_t* bar = bars + (threadIdx.x >> 5) * 2;
    if (kBulk && lane == 0) {
      bar_init(bar);
      bar_init(bar + 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // visit v's cluster into slot v & 1
    const auto fill = [&](int v) {
      float4* dst = ring + (v & 1) * kCluster4;
      const float4* src = clusters + static_cast<size_t>(v % C) * kCluster4;
      if (kBulk) {
        if (lane == 0) bulk_fetch(dst, src, bar + (v & 1));
      } else {
#pragma unroll
        for (int j = lane; j < kCluster4; j += 32) copy16_async(dst + j, src + j);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
    };
    if (visits > 0) fill(0);
    for (int v = 0; v < visits; ++v) {
      const bool next = v + 1 < visits;
      if (next) {
        __syncwarp();  // the warp's reads of slot (v + 1) & 1 (visit v - 1)
        fill(v + 1);
      }
      if (kBulk) {
        bar_wait(bar + (v & 1), (v >> 1) & 1u);
      } else {
        if (next) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncwarp();  // every lane's part of visit v's copy is in
      }
      visit<false>(ring + (v & 1) * kCluster4, v, kAll, r);
    }
  }
  t_out[i] = r.closest;
  best_out[i] = r.besti;
}

template <int MODE>
void launch(int blocks, cudaStream_t st, const float* ox, const float* oy,
            const float* oz, const float* dx, const float* dy,
            const float* dz, const float* tmax, const float4* cl, int C,
            int visits, int skip, float* t_out, int* best_out) {
  if constexpr (MODE == kDb) {
    // 8 rings of 24,640 B an SM need the largest carveout (once)
    static const cudaError_t set = cudaFuncSetAttribute(
        leafmt_kernel<MODE>, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    (void)set;
  }
  leafmt_kernel<MODE><<<blocks, kThreads, 0, st>>>(
      ox, oy, oz, dx, dy, dz, tmax, cl, C, visits, skip, t_out, best_out);
}

template <int MODE>
int occupancy() {
  int n = 0;
  if constexpr (MODE == kDb)
    cudaFuncSetAttribute(leafmt_kernel<MODE>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         static_cast<int>(cudaSharedmemCarveoutMaxShared));
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, leafmt_kernel<MODE>, kThreads, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// Launches one mode (0 pure, 1 cond, 2 dma, 3 db) over n / 128 blocks on
// `stream`; returns cudaGetLastError() (0 = launched). n is a multiple of
// 1024; clusters is [C, 64, 12] f32, 16-byte aligned; skip is the cond
// mode's branch bound (0: every visit runs).
extern "C" int leafmt_probe_launch(int mode, const float* ox, const float* oy,
                                   const float* oz, const float* dx,
                                   const float* dy, const float* dz,
                                   const float* tmax, const float* clusters,
                                   int C, int visits, int skip, int n,
                                   float* t_out, int* best_out,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n % kTile || C < 1 || visits < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = n / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* cl = reinterpret_cast<const float4*>(clusters);
#define PT_LEAFMT_LAUNCH(M)                                                  \
  launch<M>(blocks, st, ox, oy, oz, dx, dy, dz, tmax, cl, C, visits, skip, \
            t_out, best_out)
  switch (mode) {
    case kPure: PT_LEAFMT_LAUNCH(kPure); break;
    case kCond: PT_LEAFMT_LAUNCH(kCond); break;
    case kDma: PT_LEAFMT_LAUNCH(kDma); break;
    case kDb: PT_LEAFMT_LAUNCH(kDb); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_LEAFMT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of one mode's kernel (its threads, registers and
// shared memory), or minus the CUDA error.
extern "C" int leafmt_probe_blocks_per_sm(int mode) {
  switch (mode) {
    case kPure: return occupancy<kPure>();
    case kCond: return occupancy<kCond>();
    case kDma: return occupancy<kDma>();
    case kDb: return occupancy<kDb>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
