// One window of the regrouped (demand-packed) leaf phase, for NVIDIA Hopper
// (sm_90a): K = 64 leaf visits, each with a demand mask over the 1024 rays
// of a packet, packed into S = 1024 (ray, visit) pair slots; each slot
// tests its ray against its visit's 64-triangle cluster and each ray keeps
// its nearest hit. The price of K11's leaf-major flush per pair, alone.
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
// triangles by split-bf16 products on its MXU. Here instead:
//   1. each visit's demand is ranked with __ballot_sync + __popc inside a
//      warp and a shuffle scan of the 32 warps' counts in shared memory;
//   2. each demanding (ray, visit) writes its ray into its slot, if the
//      slot's visit is that visit (a consistent vpref makes it so); a
//      thread walks only its ray's set demand bits (__ffsll);
//   3. a thread a slot tests its ray against the cluster, read through L1
//      (__ldg; all 64 clusters' 12 used words are 192 KB, which only the
//      dynamic shared-memory opt-in would hold);
//   4. each ray's winner is a 64-bit shared-memory atomicMin on
//      (t bits << 32 | slot << 6 | triangle): t > 0, so its bits order as
//      its value, then the earliest slot.
// The 3-term bf16 split reconstructs a normal float32 exactly, so the
// float32 values stand for the TPU's fetched ones. vpref and cids are the
// TPU's SMEM scalars: passed by value, staged once into shared memory.
//
// Contract: rays [7][1024] f32 (ox, oy, oz, dx, dy, dz, cl0), masks
// [64][1024] f32 (> 0.5 demands), tri [64][16 * 64] f32 comp-major (word
// c * 64 + w: c = 0-2 v0, 3-5 e1, 6-8 e2, 9-11 n = e1 x e2); vpref[0] = 0,
// nondecreasing, vpref[64] <= 1024. The block repeats the window `windows`
// times (the TPU file's chained calls); every one of `blocks` blocks
// computes the same window into its own 1024 outputs.
//
// What bounds it: per window, the bytes of the masks and clusters (~0.5
// MB) over the card's memory rate, against ~40 FP32 operations a
// slot-triangle; one block holds 1 of 132 SMs, so the one-block readings
// are latency- and single-SM-bound by design. Built with -fmad=false and
// the plain version's operation order (pt::mt_hit), so kernel and plain
// version (regroup_probe.py) agree bit for bit.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kS = 1024;   // slots
constexpr int kK = 64;     // visits
constexpr int kW = 64;     // triangles a cluster
constexpr int kR = 1024;   // rays
constexpr int kCluster = 16 * kW;
constexpr float kTMin = 1e-3f;
constexpr int kBig = 1 << 30;

enum Upto : int { kCt = 0, kG = 1, kRay = 2, kTri = 3, kMt = 4, kFull = 5 };

struct Scalars {
  int vpref[kK + 1];
  int cids[kK];
};

template <int UPTO>
__global__ void __launch_bounds__(kS, 1)
regroup_kernel(const float* __restrict__ rays, const float* __restrict__ masks,
               const float* __restrict__ tri, const Scalars sc, int windows,
               float* __restrict__ t_out, int* __restrict__ i_out) {
  __shared__ int vpref[kK + 1], cids[kK];
  __shared__ unsigned ball[kK][32];  // per visit and warp: the demand ballot
  __shared__ int cnt[kK][32];        // and the demand in the warps before
  __shared__ int v_of[kS];
  __shared__ int slot_ray[kS];
  __shared__ unsigned long long best[kR];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  t_out += static_cast<size_t>(blockIdx.x) * kR;
  i_out += static_cast<size_t>(blockIdx.x) * kR;
  if (tid == 0) {
#pragma unroll
    for (int v = 0; v <= kK; ++v) vpref[v] = sc.vpref[v];
#pragma unroll
    for (int v = 0; v < kK; ++v) cids[v] = sc.cids[v];
  }
  __syncthreads();
  const int s = tid;  // this thread's slot, and its ray in kG / kFull
  const int used_end = vpref[kK];
  const bool used = s < used_end;
  for (int rep = 0; rep < windows; ++rep) {
    // every window recomputes from memory, as each TPU call does
    asm volatile("" ::: "memory");
    // volatile: the scalars are read again every window, as the TPU
    // kernel's SMEM loop reads them on every call
    const volatile int* vp = vpref;
    int vs = 0;
    for (int v = 1; v < kK; ++v) vs = vp[v] <= s ? v : vs;
    const int ks = s - vpref[vs];
    if (UPTO == kCt) {
      t_out[s] = static_cast<float>(cids[vs]) + static_cast<float>(ks);
      i_out[s] = used ? vs : -1;
      continue;
    }
    // 1. ranks: the demand bits of this ray and each warp's ballot per
    // visit (16 loads in flight)
    unsigned long long bits = 0;
#pragma unroll 16
    for (int v = 0; v < kK; ++v) {
      const bool d = masks[v * kR + tid] > 0.5f;
      bits |= static_cast<unsigned long long>(d) << v;
      const unsigned b = __ballot_sync(0xffffffffu, d);
      if (lane == 0) ball[v][warp] = b;
    }
    v_of[s] = vs;
    slot_ray[s] = -1;
    best[tid] = ~0ull;
    __syncthreads();
    for (int v = warp; v < kK; v += 32) {  // exclusive scan over the warps
      const int c = __popc(ball[v][lane]);
      int inc = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += y;
      }
      cnt[v][lane] = inc - c;
    }
    __syncthreads();
    // 2. each demanding (ray, visit) into its slot: only this ray's set
    // bits (807 of 65,536 on the seeded window)
    const unsigned below = (1u << lane) - 1u;
    int owned = 0;
    for (unsigned long long left = bits; left; left &= left - 1) {
      const int v = __ffsll(static_cast<long long>(left)) - 1;
      const int slot =
          vpref[v] + cnt[v][warp] + __popc(ball[v][warp] & below);
      if (slot < used_end && v_of[slot] == v) {
        slot_ray[slot] = tid;
        ++owned;
      }
    }
    if (UPTO == kG) {
      t_out[tid] = static_cast<float>(owned);
      i_out[s] = used ? 1 : 0;
      __syncthreads();  // v_of and cnt are read before the next window
      continue;
    }
    __syncthreads();
    // 3. the slot's ray and cluster
    const int r = slot_ray[s];
    float o1 = 0.f, o2 = 0.f, o3 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    float cl = 0.f;
    if (r >= 0) {
      o1 = rays[r];
      o2 = rays[kR + r];
      o3 = rays[2 * kR + r];
      d1 = rays[3 * kR + r];
      d2 = rays[4 * kR + r];
      d3 = rays[5 * kR + r];
      cl = rays[6 * kR + r];
    }
    const float* c = tri + static_cast<size_t>(vs) * kCluster;
    if (UPTO == kRay) {
      t_out[s] = ((o1 + o2) + o3) + cl;
      i_out[s] = static_cast<int>((d1 + d2) + d3);
    } else if (UPTO == kTri) {
      float acc = 0.f;
      if (used)
        for (int w = 0; w < 8; ++w) acc = acc + __ldg(c + w) * 0.5f;
      t_out[s] = acc;
      i_out[s] = 0;
    } else {
      // a slot with no ray has a zero ray: every triangle fails as
      // parallel, as the TPU kernel's empty one-hot column gives
      float tb = FLT_MAX;
      int wb = 0;
      if (r >= 0) {
#pragma unroll 2
        for (int w = 0; w < kW; ++w) {
          const float4 p = make_float4(__ldg(c + w), __ldg(c + kW + w),
                                       __ldg(c + 2 * kW + w),
                                       __ldg(c + 3 * kW + w));
          const float4 q = make_float4(__ldg(c + 4 * kW + w),
                                       __ldg(c + 5 * kW + w),
                                       __ldg(c + 6 * kW + w),
                                       __ldg(c + 7 * kW + w));
          const float4 n = make_float4(__ldg(c + 8 * kW + w),
                                       __ldg(c + 9 * kW + w),
                                       __ldg(c + 10 * kW + w),
                                       __ldg(c + 11 * kW + w));
          float t, u, v;
          if (pt::mt_hit<false>(p, q, n, o1, o2, o3, d1, d2, d3, kTMin, cl, t,
                                u, v) &&
              t < tb) {
            tb = t;
            wb = w;
          }
        }
      }
      if (UPTO == kMt) {
        t_out[s] = tb;
        i_out[s] = cids[vs] * kW + wb;
      } else {
        // 4. each ray's least (t, slot) over the slots it owns
        if (r >= 0)
          atomicMin(&best[r],
                    (static_cast<unsigned long long>(__float_as_uint(tb))
                     << 32) | static_cast<unsigned>(s * kW + wb));
        __syncthreads();
        const unsigned long long key = best[tid];
        const bool any = key != ~0ull;
        const float minv = any ? __uint_as_float(key >> 32) : FLT_MAX;
        const int low = static_cast<int>(key & 0xffffffffu);
        const int minb = any ? cids[v_of[low / kW]] * kW + low % kW : kBig;
        const float clc = rays[6 * kR + tid];
        const bool hit = minv < clc;
        t_out[tid] = hit ? minv : clc;
        i_out[tid] = hit ? minb : -1;
      }
    }
    __syncthreads();  // shared tables are read before the next window
  }
}

template <int UPTO>
void launch(int blocks, cudaStream_t st, const float* rays, const float* masks,
            const float* tri, const Scalars& sc, int windows, float* t_out,
            int* i_out) {
  regroup_kernel<UPTO><<<blocks, kS, 0, st>>>(rays, masks, tri, sc, windows,
                                              t_out, i_out);
}

}  // namespace

// Launches one mode (0 ct, 1 g, 2 ray, 3 tri, 4 mt, 5 full) on `blocks`
// blocks, each repeating the window `windows` times, on `stream`; vpref
// (65) and cids (64) are host arrays. Returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int regroup_probe_launch(int upto, const float* rays,
                                    const float* masks, const float* tri,
                                    const int* vpref, const int* cids,
                                    int windows, int blocks, float* t_out,
                                    int* i_out, void* stream) {
  if (windows < 1 || blocks < 1 || vpref[0] != 0 || vpref[kK] > kS)
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
      launch<kCt>(blocks, st, rays, masks, tri, sc, windows, t_out, i_out);
      break;
    case kG:
      launch<kG>(blocks, st, rays, masks, tri, sc, windows, t_out, i_out);
      break;
    case kRay:
      launch<kRay>(blocks, st, rays, masks, tri, sc, windows, t_out, i_out);
      break;
    case kTri:
      launch<kTri>(blocks, st, rays, masks, tri, sc, windows, t_out, i_out);
      break;
    case kMt:
      launch<kMt>(blocks, st, rays, masks, tri, sc, windows, t_out, i_out);
      break;
    case kFull:
      launch<kFull>(blocks, st, rays, masks, tri, sc, windows, t_out, i_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
