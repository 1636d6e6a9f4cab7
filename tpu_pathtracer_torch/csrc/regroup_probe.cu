// One window of the regrouped (demand-packed) leaf phase, for NVIDIA Hopper
// (sm_90a): K = 64 leaf visits, each with a demand mask over the 1024 rays
// of a packet, packed into S = 1024 (ray, visit) pair slots; each slot
// tests its ray against its visit's 64-triangle cluster and each ray keeps
// its nearest hit. The price of K11's leaf-major flush per pair, alone:
// once a window's visits are ranked, every cluster it needs is known
// before any test starts, and each is shared by every ray that demands it.
//
// Replaces the TPU kernel experiments/regroup_probe.py::_kernel (:94,
// through run_window :227, pallas_call :230) and its six `upto` stages,
// each a mode here that stops where the TPU kernel returns and writes its
// diagnostic outputs:
//   * kCt: per slot, float(cids[v] + k) and v (-1 when unused);
//   * kG: per ray, the number of slots it owns; per slot, 1 if used;
//   * kRay: per slot, ((ox + oy) + oz) + cl0 of its ray and
//     int((dx + dy) + dz) (0 for a slot with no ray);
//   * kTri: per slot, the sum of 0.5 * v0x over its cluster's first 8
//     triangles, in order from 0 (0 when unused); i_out 0;
//   * kMt: per slot, the least accepted t over its 64 triangles (FLT_MAX if
//     none) and cids[v] * 64 + its first triangle at that t;
//   * kFull: per ray, the least t over its slots, the earliest slot on a
//     tie, if below its cl0 (else cl0 and -1).
//
// Slot s belongs to the last visit v with vpref[v] <= s and to the ray of
// exclusive rank k = s - vpref[v] among visit v's demanding rays (flat
// row * 128 + lane order); slots at or past vpref[64] are unused. The TPU
// kernel builds that ownership as a one-hot matrix and fetches rays and
// triangles by split-bf16 products on its MXU. A block of 1024 threads
// computes a window here:
//   1. the scalars vpref and cids (the TPU's SMEM operands, passed by
//      value) are written to shared memory again every window, and a
//      thread finds its slot's visit by a binary search over vpref;
//   2. each visit's demand is ranked with __ballot_sync + __popc inside a
//      warp and a shuffle scan of the 32 warps' counts; each demanding
//      (ray, visit) writes its ray into its slot, if the slot's visit is
//      that visit (v = 63 or vpref[v + 1] > slot);
//   3. the clusters are staged in shared memory by the bulk-copy engine.
//      A visit's 12 used comp rows are words 0-767 of its cluster, 3,072
//      contiguous bytes: one cp.async.bulk on an mbarrier. The visits that
//      own a slot (vpref[v + 1] > vpref[v]) go in order into a ring of
//      kRingStages stages of 8 visits, one full and one empty mbarrier a
//      stage; a visit with no slot takes no place, so consecutive slots
//      lie in consecutive places. Lane 0 of warp 31 issues them: every
//      stage the ring holds as soon as a window's scalars are in, so the
//      copies land while the window is ranked, and each later stage once
//      the 31 consumer warps have released its place;
//   4. warps 0-30 test the slots in order, kSlotLanes lanes a slot (lane l
//      of a slot's lanes tests triangles l, l + kSlotLanes, ...), 32 /
//      kSlotLanes slots a warp step, step j on warp j % 31. The slots are
//      sorted by visit, so the warps move through the ring in order: a
//      warp waits on the full barriers of its step's stages, and releases
//      (one arrive on the empty barrier) each stage below its step's
//      lowest, after waiting on its full barrier, so that every arrive
//      lands in the stage's current phase. The rows are read from shared
//      memory: the lanes of one slot read consecutive words, and the
//      slots of a step that share a visit read the same words
//      (broadcasts); a staged visit's stride is padded (kPad words) so
//      that two visits' words fall in different banks. The lanes merge by
//      the (t, triangle) shuffle K11 and K14 use: the least t, then the
//      lowest triangle, so the winner is the serial loop's first;
//   5. no atomic: a slot's leader writes its (t, triangle) to shared
//      memory; after one barrier each ray's thread walks its own slots
//      (its demand bits and the ranks of step 2) in slot order and keeps
//      the least t, the earliest slot on an equal t.
// The 3-term bf16 split reconstructs a normal float32 exactly, so the
// float32 values stand for the TPU's fetched ones.
//
// No deadlock: a step's slots lie in at most 32 / kSlotLanes consecutive
// places, so in at most kSpan stages, and the ring holds kSpan or more;
// every stage the slowest warp still needs is filled (the producer fills
// in order), so it moves on and releases.
//
// The constants are the A/B's (experiments/regroup_probe.py, PERF.md §6
// K21 has the readings; one SM's full window, us): kSlotLanes 4 and
// kUnroll 4 (16 tests a lane a step, 4 interleaved) 34.7, against 35.8
// at 4 lanes and 2 tests interleaved, 37.1 at 8, 39.4 at 2, 41.4 at 16,
// 43.8 at 1 (a ring of 5); the tests' balance over the 31 warps and the
// merge's shuffles every 16 tests against a step's ray loads and waits.
// kRingStages 4 (32 visits, 32 x 3,088 B = 98,816 B): the first 32
// copies go out with the scalars and the rest as the tests free the
// ring, so they do not crowd the masks' loads off the L2 during the
// ranking; the whole window issued at once (8 stages) took 41.7, 3 or 6
// stages 36.3 and 39.8, 2 stages 40.9 (at 8 lanes). kProxyFence 0 drops
// the fence (within 0.3%).
//
// Contract: rays [7][1024] f32 (ox, oy, oz, dx, dy, dz, cl0), masks
// [64][1024] f32 (> 0.5 demands), tri [64][16 * 64] f32 comp-major (word
// c * 64 + w: c = 0-2 v0, 3-5 e1, 6-8 e2, 9-11 n = e1 x e2), 16-byte
// aligned; vpref[0] = 0, nondecreasing, vpref[64] <= 1024. The block
// repeats the window `windows` times (the TPU file's chained calls), each
// from memory again (scalars, masks, rays and the clusters' copies); every
// one of `blocks` blocks computes the same window into its own 1024
// outputs.
//
// What bounds it: the issue of its instructions. Its distinct bytes (the
// masks, rays and used cluster words, ~0.5 MB once a launch, and 8 KB of
// outputs a block) and its FP32 operations (37 a slot-triangle) give a
// roofline well under the issue-rate floor of its own SASS
// (experiments/regroup_probe.py bound, issue_floor); every window
// re-reads the same inputs, from the L2 or L1. A block holds a whole SM
// (1024 threads and ~122 KB of shared memory: 1 block an SM), so the
// one-block readings are one SM's, and the card-wide reading runs one
// window on each of 132 x 8 blocks, 8 waves of 132, the first form's
// count, so that ns a pair compares. Built with -fmad=false and the
// plain version's operation order (pt::mt_hit), so kernel and plain
// version (regroup_probe.py) agree bit for bit.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "bvh_common.cuh"

namespace {

constexpr int kS = 1024;   // slots
constexpr int kK = 64;     // visits
constexpr int kW = 64;     // triangles a cluster
constexpr int kR = 1024;   // rays
constexpr int kCluster = 16 * kW;  // words a cluster in tri
constexpr int kRows = 12 * kW;     // its 12 used comp rows: words 0-767
constexpr unsigned kRowBytes = kRows * 4;  // 3,072 B, one bulk copy
constexpr float kTMin = 1e-3f;
constexpr int kBig = 1 << 30;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 1024;  // a thread a ray (ranking) and a slot
constexpr int kWarps = kThreads / 32;
constexpr int kProducer = kWarps - 1;  // its lane 0 issues the copies
constexpr int kConsumers = kWarps - 1;
constexpr int kSlotLanes = 4;   // lanes that test one slot
constexpr int kRingStages = 4;  // stages in the ring
constexpr int kProxyFence = 1;  // fence.proxy.async before a stage's copies
constexpr int kUnroll = 4;  // tests a lane interleaves
constexpr int kStageVisits = 8;  // visits a stage: one full, one empty barrier
constexpr int kStages = kK / kStageVisits;  // stages a window
constexpr int kRing = kRingStages * kStageVisits;  // visits the ring holds
constexpr int kGroups = 32 / kSlotLanes;  // slots a warp step
// stages a step's visits can span: kGroups consecutive visits
constexpr int kSpan = (kGroups + kStageVisits - 2) / kStageVisits + 1;
constexpr int kPad = kSlotLanes >= 4 && kSlotLanes < 32 ? kSlotLanes : 4;
constexpr int kStride = kRows + kPad;  // words a staged visit
constexpr int kRingBytes = kRing * kStride * 4;

static_assert(kSlotLanes >= 1 && kSlotLanes <= 32 &&
                  (kSlotLanes & (kSlotLanes - 1)) == 0,
              "kSlotLanes: a power of two from 1 to 32");
static_assert(kRingStages >= kSpan && kRingStages <= kStages,
              "kRingStages: from the stages a warp step spans to 8");
static_assert(kStride % 4 == 0, "a staged visit starts 16-byte aligned");

enum Upto : int { kCt = 0, kG = 1, kRay = 2, kTri = 3, kMt = 4, kFull = 5 };

struct Scalars {
  int vpref[kK + 1];
  int cids[kK];
};

// Issues the window's stages [c0, c1) (global stage index base + c), each
// into ring stage (base + c) % kRingStages once the consumers have
// released its last use. Stage c holds the needed visits (those that own
// a slot: vpref[v + 1] > vpref[v]) of ranks 8c to 8c + 7, the ring's
// order, taken in order from visit `v`; a stage with none completes its
// phase by a plain arrival.
__device__ __forceinline__ void produce(int c0, int c1, int& v,
                                        unsigned base, const float* tri,
                                        const int* vpref, float* ring,
                                        uint64_t* full, uint64_t* empty) {
  for (int c = c0; c < c1; ++c) {
    const unsigned g = base + c;
    const int st = g % kRingStages;
    if (g >= kRingStages) pt::bar_wait(&empty[st], (g / kRingStages - 1) & 1);
    int end = v, n = 0;
    for (; end < kK && n < kStageVisits; ++end)
      n += vpref[end + 1] > vpref[end];
    if (!n) {
      pt::bar_arrive(&full[st]);
      continue;
    }
    if (kProxyFence) pt::proxy_fence();
    pt::arrive_expect_tx(&full[st], n * kRowBytes);
    for (int q = c * kStageVisits; v < end; ++v)
      if (vpref[v + 1] > vpref[v])
        pt::bulk_copy(ring + (q++ % kRing) * kStride,
                      tri + static_cast<size_t>(v) * kCluster, kRowBytes,
                      &full[st]);
  }
}

// A consumer warp's wait on stage c of the window (global base + c).
__device__ __forceinline__ void wait_full(uint64_t* full, unsigned base,
                                          int c) {
  const unsigned g = base + c;
  pt::bar_wait(&full[g % kRingStages], (g / kRingStages) & 1);
}

template <int UPTO>
__global__ void __launch_bounds__(kThreads, 1)
regroup_kernel(const float* __restrict__ rays, const float* __restrict__ masks,
               const float* __restrict__ tri, const Scalars sc, int windows,
               float* __restrict__ t_out, int* __restrict__ i_out) {
  constexpr bool kStaged = UPTO >= kTri;  // the ring's modes
  extern __shared__ __align__(128) float ring[];
  __shared__ int vpref[kK + 1], cids[kK];
  __shared__ unsigned ball[kK][32];  // per visit and warp: the demand ballot
  __shared__ int cnt[kK][32];        // and the demand in the warps before
  __shared__ float t_slot[kS];       // a slot's least t (tri: its sum)
  __shared__ short ray_of[kS];       // a slot's ray, -1 for none
  __shared__ unsigned char v_of[kS], w_slot[kS];  // its visit, its triangle
  __shared__ unsigned char vrank[kK];  // a needed visit's place in the ring
  __shared__ __align__(8) uint64_t full[kRingStages], empty[kRingStages];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  t_out += static_cast<size_t>(blockIdx.x) * kR;
  i_out += static_cast<size_t>(blockIdx.x) * kR;
  if (kStaged && tid == 0) {
    for (int b = 0; b < kRingStages; ++b) {
      pt::bar_init(&full[b], 1);
      pt::bar_init(&empty[b], kConsumers);
    }
    pt::bar_init_fence();
  }
  const int s = tid;  // this thread's slot, and its ray in kG / kFull
  for (int rep = 0; rep < windows; ++rep) {
    // every window recomputes from memory, as each TPU call does
    asm volatile("" ::: "memory");
    if (tid == 0) {  // the scalars again, as the TPU's SMEM loop reads them
#pragma unroll
      for (int v = 0; v <= kK; ++v) vpref[v] = sc.vpref[v];
#pragma unroll
      for (int v = 0; v < kK; ++v) cids[v] = sc.cids[v];
    }
    __syncthreads();
    const unsigned base = static_cast<unsigned>(rep) * kStages;
    int v_next = 0;  // the producer's next visit
    if (kStaged && tid == kProducer * 32)  // the stages the ring holds
      produce(0, kRingStages, v_next, base, tri, vpref, ring, full, empty);
    if (kStaged && warp == 0) {  // each needed visit's rank
      const bool n0 = vpref[lane + 1] > vpref[lane];
      const bool n1 = vpref[lane + 33] > vpref[lane + 32];
      const unsigned b0 = __ballot_sync(kAll, n0);
      const unsigned b1 = __ballot_sync(kAll, n1);
      const unsigned below = (1u << lane) - 1u;
      vrank[lane] = static_cast<unsigned char>(__popc(b0 & below));
      vrank[lane + 32] =
          static_cast<unsigned char>(__popc(b0) + __popc(b1 & below));
    }
    const int used_end = vpref[kK];
    const bool used = s < used_end;
    int vs = 0;  // the last v with vpref[v] <= s
#pragma unroll
    for (int step = 32; step > 0; step >>= 1)
      if (vpref[vs + step] <= s) vs += step;
    if (UPTO == kCt) {
      t_out[s] = static_cast<float>(cids[vs]) +
                 static_cast<float>(s - vpref[vs]);
      i_out[s] = used ? vs : -1;
      __syncthreads();  // vpref is read before the next window writes it
      continue;
    }
    // ranks: the demand bits of this ray and each warp's ballot per visit
    // (16 loads in flight)
    unsigned long long bits = 0;
#pragma unroll 16
    for (int v = 0; v < kK; ++v) {
      const bool d = masks[v * kR + tid] > 0.5f;
      bits |= static_cast<unsigned long long>(d) << v;
      const unsigned b = __ballot_sync(kAll, d);
      if (lane == 0) ball[v][warp] = b;
    }
    v_of[s] = static_cast<unsigned char>(vs);
    ray_of[s] = -1;
    t_slot[s] = UPTO == kTri ? 0.f : FLT_MAX;
    w_slot[s] = 0;
    __syncthreads();
    for (int v = warp; v < kK; v += 32) {  // exclusive scan over the warps
      const int c = __popc(ball[v][lane]);
      int inc = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kAll, inc, off);
        if (lane >= off) inc += y;
      }
      cnt[v][lane] = inc - c;
    }
    __syncthreads();
    // each demanding (ray, visit) into its slot: only this ray's set bits
    // (807 of 65,536 on the seeded window)
    const unsigned below = (1u << lane) - 1u;
    int owned = 0;
    for (unsigned long long left = bits; left; left &= left - 1) {
      const int v = __ffsll(static_cast<long long>(left)) - 1;
      const int slot =
          vpref[v] + cnt[v][warp] + __popc(ball[v][warp] & below);
      if (slot < used_end && (v == kK - 1 || vpref[v + 1] > slot)) {
        ray_of[slot] = static_cast<short>(tid);
        ++owned;
      }
    }
    if (UPTO == kG) {
      t_out[tid] = static_cast<float>(owned);
      i_out[s] = used ? 1 : 0;
      __syncthreads();  // the tables are read before the next window
      continue;
    }
    __syncthreads();
    if (UPTO == kRay) {
      const int r = ray_of[s];
      float o[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r >= 0)
#pragma unroll
        for (int k = 0; k < 7; ++k) o[k] = rays[k * kR + r];
      t_out[s] = ((o[0] + o[1]) + o[2]) + o[6];
      i_out[s] = static_cast<int>((o[3] + o[4]) + o[5]);
      __syncthreads();
      continue;
    }
    if (warp == kProducer) {
      if (kStaged && lane == 0)  // the window's other stages, as they free
        produce(kRingStages, kStages, v_next, base, tri, vpref, ring, full,
                empty);
    } else {
      const int group = lane / kSlotLanes, sub = lane % kSlotLanes;
      int released = 0, waited = 0;  // this warp's stages of the window
      for (int j = warp; j * kGroups < used_end; j += kConsumers) {
        const int s0 = j * kGroups;
        const int lo = vrank[v_of[s0]] / kStageVisits;
        const int hi =
            vrank[v_of[min(s0 + kGroups, used_end) - 1]] / kStageVisits;
        if (kStaged) {
          for (; released < lo; ++released) {
            if (waited <= released) wait_full(full, base, waited++);
            __syncwarp();  // every lane's reads of the stage are done
            if (lane == 0)
              pt::bar_arrive(&empty[(base + released) % kRingStages]);
          }
          for (; waited <= hi; ++waited) wait_full(full, base, waited);
        }
        const int slot = s0 + group;
        float tb = FLT_MAX;
        int wb = 0;
        if (slot < used_end) {
          // the staged visit's rows, read as shared-memory broadcasts
          const float* c = ring + (vrank[v_of[slot]] % kRing) * kStride;
          if (UPTO == kTri) {
            if (sub == 0) {
              float acc = 0.f;
#pragma unroll
              for (int w = 0; w < 8; ++w) acc = acc + c[w] * 0.5f;
              tb = acc;
            }
          } else {
            const int r = ray_of[slot];
            // a slot with no ray has a zero ray: every triangle fails as
            // parallel, as the TPU kernel's empty one-hot column gives
            if (r >= 0) {
              const float o1 = __ldg(rays + r), o2 = __ldg(rays + kR + r),
                          o3 = __ldg(rays + 2 * kR + r);
              const float d1 = __ldg(rays + 3 * kR + r),
                          d2 = __ldg(rays + 4 * kR + r),
                          d3 = __ldg(rays + 5 * kR + r);
              const float cl = __ldg(rays + 6 * kR + r);
#pragma unroll kUnroll
              for (int w = sub; w < kW; w += kSlotLanes) {
                const float4 p = make_float4(c[w], c[kW + w],
                                             c[2 * kW + w], c[3 * kW + w]);
                const float4 q =
                    make_float4(c[4 * kW + w], c[5 * kW + w],
                                c[6 * kW + w], c[7 * kW + w]);
                const float4 n =
                    make_float4(c[8 * kW + w], c[9 * kW + w],
                                c[10 * kW + w], c[11 * kW + w]);
                float t, u, v;
                if (pt::mt_hit<false>(p, q, n, o1, o2, o3, d1, d2, d3, kTMin,
                                      cl, t, u, v) &&
                    t < tb) {
                  tb = t;
                  wb = w;
                }
              }
            }
          }
        }
        if (UPTO != kTri) {
#pragma unroll
          for (int off = kSlotLanes / 2; off > 0; off >>= 1) {
            const float t2 = __shfl_xor_sync(kAll, tb, off);
            const int w2 = __shfl_xor_sync(kAll, wb, off);
            if (t2 < tb || (t2 == tb && w2 < wb)) {
              tb = t2;
              wb = w2;
            }
          }
        }
        if (sub == 0 && slot < used_end) {
          t_slot[slot] = tb;
          w_slot[slot] = static_cast<unsigned char>(wb);
        }
      }
      for (; kStaged && released < kStages; ++released) {  // the last ones
        if (waited <= released) wait_full(full, base, waited++);
        __syncwarp();
        if (lane == 0) pt::bar_arrive(&empty[(base + released) % kRingStages]);
      }
    }
    __syncthreads();
    if (UPTO == kTri) {
      t_out[s] = t_slot[s];
      i_out[s] = 0;
    } else if (UPTO == kMt) {
      t_out[s] = t_slot[s];
      i_out[s] = cids[vs] * kW + w_slot[s];
    } else {
      // each ray's least (t, slot) over its slots, in slot order
      bool any = false;
      float minv = FLT_MAX;
      int bslot = 0, bv = 0;
      for (unsigned long long left = bits; left; left &= left - 1) {
        const int v = __ffsll(static_cast<long long>(left)) - 1;
        const int slot =
            vpref[v] + cnt[v][warp] + __popc(ball[v][warp] & below);
        if (slot < used_end && (v == kK - 1 || vpref[v + 1] > slot)) {
          const float t = t_slot[slot];
          if (!any || t < minv) {
            minv = t;
            bslot = slot;
            bv = v;
            any = true;
          }
        }
      }
      const int minb = any ? cids[bv] * kW + w_slot[bslot] : kBig;
      const float clc = rays[6 * kR + tid];
      const bool hit = minv < clc;
      t_out[tid] = hit ? minv : clc;
      i_out[tid] = hit ? minb : -1;
    }
    __syncthreads();  // the tables are read before the next window
  }
}

template <int UPTO>
int launch(int blocks, cudaStream_t st, const float* rays, const float* masks,
           const float* tri, const Scalars& sc, int windows, float* t_out,
           int* i_out) {
  const int smem = UPTO >= kTri ? kRingBytes : 0;
  // the ring needs the dynamic shared-memory opt-in; a refusal is
  // returned, never a smaller ring
  const cudaError_t e = cudaFuncSetAttribute(
      regroup_kernel<UPTO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  regroup_kernel<UPTO><<<blocks, kThreads, smem, st>>>(rays, masks, tri, sc,
                                                       windows, t_out, i_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one mode (0 ct, 1 g, 2 ray, 3 tri, 4 mt, 5 full) on `blocks`
// blocks, each repeating the window `windows` times, on `stream`; vpref
// (65) and cids (64) are host arrays. Returns the CUDA error of the
// shared-memory opt-in or of the launch (0 = launched), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int regroup_probe_launch(int upto, const float* rays,
                                    const float* masks, const float* tri,
                                    const int* vpref, const int* cids,
                                    int windows, int blocks, float* t_out,
                                    int* i_out, void* stream) {
  if (windows < 1 || blocks < 1 || vpref[0] != 0 || vpref[kK] > kS ||
      reinterpret_cast<uintptr_t>(tri) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Scalars sc;
  for (int v = 0; v <= kK; ++v) sc.vpref[v] = vpref[v];
  for (int v = 0; v < kK; ++v) sc.cids[v] = cids[v];
  for (int v = 0; v < kK; ++v)
    if (sc.vpref[v + 1] < sc.vpref[v])
      return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (upto) {
    case kCt:
      return launch<kCt>(blocks, st, rays, masks, tri, sc, windows, t_out,
                         i_out);
    case kG:
      return launch<kG>(blocks, st, rays, masks, tri, sc, windows, t_out,
                        i_out);
    case kRay:
      return launch<kRay>(blocks, st, rays, masks, tri, sc, windows, t_out,
                          i_out);
    case kTri:
      return launch<kTri>(blocks, st, rays, masks, tri, sc, windows, t_out,
                          i_out);
    case kMt:
      return launch<kMt>(blocks, st, rays, masks, tri, sc, windows, t_out,
                         i_out);
    case kFull:
      return launch<kFull>(blocks, st, rays, masks, tri, sc, windows, t_out,
                           i_out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory a staged mode's block takes (the ring), in
// bytes, for the records.
extern "C" int regroup_probe_ring_bytes() { return kRingBytes; }
