// The heap walk's node phase with R rays a thread, for NVIDIA Hopper
// (sm_90a): does walking several independent rays in turn hide the
// latency of a node step's dependent loads?
//
// Replaces the TPU kernel experiments/dual_probe.py::_kernel (:37, through
// probe :118, pallas_call :134), which runs P in {1, 2, 4} independent
// 1024-ray packets in one block and issues every packet's slab tests before
// it consumes any packet's votes. Here a thread takes the place of a
// packet: it holds R in {1, 2, 4} ray slots (a template parameter), first
// loading both children's boxes and slab-testing them for every live
// slot, then advancing each slot's ray.
//
// Contract. Each ray walks the implicit-heap BVH of bvh.cu with closest
// fixed at FLT_MAX; a leaf pops at once (there is no leaf phase). The
// output is each ray's count of interior steps (bvh.cu's node_steps
// counter), int32 [n]. R does not change the function: every R gives the
// same counts, bit for bit, as the plain version (dual_probe.py).
//
// The grid. One persistent wave: kWarpsPerSm / 4 blocks of 128 threads
// on every SM, the same resident warps an SM at every R (the C entry asks
// the occupancy calculator for the R form it launches and refuses to
// launch a smaller wave), so R varies only the independent walks a thread
// interleaves, the TPU probe's own question. kWarpsPerSm is 16: the R = 4
// form's registers (the launch bounds cap them at 128) still allow it.
//
// Rays refilled lane by lane. The wave first seats R * lanes rays with no
// counter (slot r of lane g takes ray r * lanes + g). When a slot's ray
// ends, its count is written and its lane takes the next ray index from a
// global counter (the wrapper's 4-byte scratch, zeroed by the C entry on
// the same stream, so every call and every CUDA-graph replay starts from
// 0; it counts from ray R * lanes on): one refill round a loop pass, in
// which the lanes with a free slot are a ballot, lane 0 claims as many
// indices by one atomicAdd, and each lane takes base + its rank among
// them. Once the counter is spent the warp knows it (a warp-uniform flag)
// and a pass holds no ballot and no vote: a thread leaves the loop when
// its slots are empty. No thread waits on the slowest ray of a fixed
// batch.
//
// A pass. Every slot's node loads are issued first, in one straight run
// (a free slot, or one on a leaf, loads node 0's unused rows); then each
// slot that steps loads a newly seated ray's origin and direction (its
// first step: the refill puts no round trip on the chain), tests both
// children and advances, behind one branch a slot. So R slots put R
// steps' loads in flight at once, and a pass issues only its live slots'
// tests.
//
// What bounds it: the dependent node loads (two float4 a child box, from
// the L1 or the L2), each step waiting on the last; 24 FP32 operations a
// step. On the dragon the longest ray's chain sets the time: 203 interior
// steps (258 passes with its pops) against 13.1 a ray on its 131,072
// primary rays; that ray is seated in the first pass (PERF.md §6 K16: the
// readings beside the first form's and the floors; yardsticks in
// experiments/yardsticks: every ray from the counter (dual_counter_fill),
// the top 9 levels staged by one bulk copy (dual_treelet), 32 rays claimed
// a warp at a time (dual_batch), every slot's tests in every pass with no
// branch (dual_straight), the pass in three branch regions a slot
// (dual_split), the passes and refills counted (dual_trace)).

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsPerSm = 16;  // resident warps an SM, at every R
constexpr int kBlocksPerSm = kWarpsPerSm * 32 / kThreads;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBlocksPerSm >= 1 && kWarpsPerSm * 32 % kThreads == 0,
              "whole blocks an SM");

// Rows 2l .. 2l + 3 (float4) of the node table: the boxes of node l's two
// children, rows l << 1 and (l << 1) + 1 of [2 * first_leaf, 8] f32.
struct Children {
  float4 la, lb, ra, rb;
};

// A read-only 16-byte load (ld.global.nc, as __ldg), as volatile asm so
// that the compiler keeps it where it stands and does not sink it into
// the branch that uses it.
__device__ __forceinline__ float4 ldg4(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ Children children(const float4* __restrict__ nodes,
                                             unsigned idx) {
  const size_t l = static_cast<size_t>(idx) << 1;
  return {ldg4(nodes + 2 * l), ldg4(nodes + 2 * l + 1),
          ldg4(nodes + 2 * l + 2), ldg4(nodes + 2 * l + 3)};
}

// A ray slot: the ray's origin, inverse direction and its signs (loaded
// in its first step: fresh until then), its node and bitstack, its
// interior steps so far and its index.
struct Slot {
  float o1, o2, o3, i1, i2, i3;
  bool n1, n2, n3, fresh;
  unsigned idx, bs;  // idx 0: the slot is free
  int steps, ray;
};

// Ray j seated at the root, its origin and direction not loaded yet.
__device__ __forceinline__ Slot seated(int j) {
  Slot q = {};
  q.fresh = true;
  q.idx = q.bs = 1u;
  q.ray = j;
  return q;
}

__device__ __forceinline__ void load_ray(Slot& q,
                                         const float* __restrict__ ox,
                                         const float* __restrict__ oy,
                                         const float* __restrict__ oz,
                                         const float* __restrict__ dx,
                                         const float* __restrict__ dy,
                                         const float* __restrict__ dz) {
  const int j = q.ray;
  q.o1 = ox[j];
  q.o2 = oy[j];
  q.o3 = oz[j];
  q.i1 = 1.0f / dx[j];
  q.i2 = 1.0f / dy[j];
  q.i3 = 1.0f / dz[j];
  q.n1 = q.i1 < 0.f;
  q.n2 = q.i2 < 0.f;
  q.n3 = q.i3 < 0.f;
  q.fresh = false;
}

template <int R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
dual_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float4* __restrict__ nodes, unsigned first_leaf, int n,
            int* __restrict__ steps_out, int* __restrict__ next) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  const int lanes = gridDim.x * kThreads;  // the wave's
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const float closest = FLT_MAX;
  // the first fill, with no counter: slot r takes ray r * lanes + g; the
  // counter hands out the rays from R * lanes on
  Slot s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * lanes + g;
    s[r] = j < n ? seated(j) : Slot{};
  }
  bool more = R * lanes < n;  // warp-uniform: the counter may hold a ray
  for (;;) {
    if (more) {
      // refill: every lane with a free slot takes one ray
      bool free = false;
#pragma unroll
      for (int r = 0; r < R; ++r) free |= s[r].idx == 0u;
      const unsigned ball = __ballot_sync(kFull, free);
      if (ball != 0u) {
        int base = 0;
        if (lane == 0) base = atomicAdd(next, __popc(ball));
        base = R * lanes + __shfl_sync(kFull, base, 0);
        more = base + __popc(ball) < n;
        const int j = base + __popc(ball & below);
        if (free && j < n) {
          bool put = false;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (!put && s[r].idx == 0u) {
              put = true;
              s[r] = seated(j);
            }
          }
        }
      }
    }
    // a lane whose slots are empty after the refill has no ray to come
    // (its warp's counter is spent), and no later pass holds a ballot
    bool alive = false;
#pragma unroll
    for (int r = 0; r < R; ++r) alive |= s[r].idx != 0u;
    if (!alive) break;
    // issue: every slot's node loads, in one straight run
    bool step[R];
    Children c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      step[r] = s[r].idx != 0u && s[r].idx < first_leaf;
      c[r] = children(nodes, step[r] ? s[r].idx : 0u);
    }
    // consume: a slot that steps loads a fresh ray's origin and direction,
    // tests both children and advances (pt::heap_node_step's descent); a
    // ray that stands on a leaf pops; a ray that ends writes its count
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Slot& q = s[r];
      if (q.idx == 0u) continue;
      if (step[r]) {
        if (q.fresh) load_ray(q, ox, oy, oz, dx, dy, dz);
        const float lhit = pt::slab_entry(c[r].la.x, c[r].la.y, c[r].la.z,
                                          c[r].la.w, c[r].lb.x, c[r].lb.y,
                                          q.o1, q.o2, q.o3, q.i1, q.i2, q.i3,
                                          q.n1, q.n2, q.n3, closest);
        const float rhit = pt::slab_entry(c[r].ra.x, c[r].ra.y, c[r].ra.z,
                                          c[r].ra.w, c[r].rb.x, c[r].rb.y,
                                          q.o1, q.o2, q.o3, q.i1, q.i2, q.i3,
                                          q.n1, q.n2, q.n3, closest);
        ++q.steps;
        const unsigned l = q.idx << 1;
        const bool tl = lhit < closest;
        const bool tr = rhit < closest;
        const unsigned child = l + (rhit < lhit ? 1u : 0u);
        if (tl && tr) {
          q.idx = child;
          q.bs = (q.bs << 1) | 1u;
        } else if (tl || tr) {
          q.idx = child;
          q.bs <<= 1;
        } else {
          pt::pop_bitstack(q.bs, q.idx);
        }
      } else {
        pt::pop_bitstack(q.bs, q.idx);
      }
      if (q.idx == 0u) steps_out[q.ray] = q.steps;
    }
  }
}

// The launch of the R form: one wave of kBlocksPerSm blocks on every SM.
// Returns 0, or the CUDA error of a query, or cudaErrorLaunchOutOfResources
// if fewer than kBlocksPerSm blocks of this form fit on an SM.
template <int R>
int wave(int* grid, int* resident) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, dual_kernel<R>,
                                                      kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *grid = sms * kBlocksPerSm;
  *resident = per;
  return per < kBlocksPerSm ? static_cast<int>(cudaErrorLaunchOutOfResources)
                            : 0;
}

template <int R>
int launch(const float* ox, const float* oy, const float* oz,
           const float* dx, const float* dy, const float* dz,
           const float4* nodes, unsigned first_leaf, int n, int* steps,
           int* next, cudaStream_t st) {
  int grid = 0, resident = 0;
  const int e = wave<R>(&grid, &resident);
  if (e != 0) return e;
  const cudaError_t m = cudaMemsetAsync(next, 0, sizeof(int), st);
  if (m != cudaSuccess) return static_cast<int>(m);
  dual_kernel<R><<<grid, kThreads, 0, st>>>(ox, oy, oz, dx, dy, dz, nodes,
                                            first_leaf, n, steps, next);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the R-ray form (R = 1, 2 or 4) on `stream`; returns 0 when
// launched, else a CUDA error (cudaErrorLaunchOutOfResources: the form
// does not fit kWarpsPerSm warps on an SM). nodes is bvh.cu's
// [2*first_leaf, 8] f32 table, 16-byte aligned; steps is int32 [n]; next
// is the caller's 4-byte scratch, the ray counter, zeroed here first.
extern "C" int dual_probe_walk(int R, const float* ox, const float* oy,
                               const float* oz, const float* dx,
                               const float* dy, const float* dz,
                               const float* nodes, int first_leaf, int n,
                               int* steps, int* next, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const unsigned fl = static_cast<unsigned>(first_leaf);
  switch (R) {
    case 1:
      return launch<1>(ox, oy, oz, dx, dy, dz, nd, fl, n, steps, next, st);
    case 2:
      return launch<2>(ox, oy, oz, dx, dy, dz, nd, fl, n, steps, next, st);
    case 4:
      return launch<4>(ox, oy, oz, dx, dy, dz, nd, fl, n, steps, next, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The R form's wave, for the records and the checks: its blocks (grid),
// the blocks of 128 threads it launches on an SM and the most that fit
// there (the occupancy calculator's). Returns as `wave`.
extern "C" int dual_probe_shape(int R, int* grid, int* per_sm,
                                int* resident) {
  *per_sm = kBlocksPerSm;
  switch (R) {
    case 1:
      return wave<1>(grid, resident);
    case 2:
      return wave<2>(grid, resident);
    case 4:
      return wave<4>(grid, resident);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
