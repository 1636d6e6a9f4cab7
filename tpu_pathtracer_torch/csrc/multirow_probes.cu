// The 8-row packet probes, for NVIDIA Hopper (sm_90a): 8 rows of 128 ray
// lanes, each row walking on its own, with a vote over its lanes a step.
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
// K22 (leafround_kernel): one block of 1024 threads, thread = row * 128 +
// lane. Per round, row r tests its lanes against the w triangles of
// cluster ids[r] (word c * w + j of the cluster is component c of triangle
// j: v0, e1, e2, n), a strict-less nearest update of closest, and then
// ids[r] = (ids[r] * 5 + 1 + (bits(closest[r, 0]) & 1)) & 1023. Modes,
// each adding a step of the TPU's:
//   0 (MT only): the MT loop reads the row's cluster slot in shared memory,
//     which nothing writes: the TPU reads an unwritten VMEM scratch there
//     (ROADMAP C-18); the port zero-fills it once, so every lane misses,
//     as interpret mode gives;
//   1 (+ ids): lane 0 of each row publishes the next id through shared
//     memory, a barrier, and every lane reads it back (the GPU's "ids
//     leave the vector domain");
//   2 (+ fetch): each row's 128 threads stage cluster ids[r] (2 or 4 KB)
//     into its shared-memory slot with coalesced loads, a barrier, and the
//     MT loop reads the words as warp-wide broadcasts.
// Bound: FP32 operations, ~37 a lane-triangle, on the one SM the block
// holds.
//
// K23 and K24 (walk8_kernel): one warp a row (8 warps), each thread holding
// lanes lane, lane + 32, lane + 64, lane + 96. A step: the left and right
// boxes of the row's node pair (12 words), two slab tests a lane, the
// row's votes (pref = sum of +-1 over lanes in both boxes, nl, nr = lanes
// in each) as __reduce_add_sync over the threads' partials, then the
// warp-uniform bitstack advance, ctz = __ffs - 1 (K24's float-exponent
// ctz is the same for 0 < bs < 2^31; bs <= 0xFFFF here). Fetch modes:
//   kFixed (K23 fixed): constant boxes, 0.1 i and 0.1 i + 0.05;
//   kShfl (K23 assemble, K24 shfl): lane i < 12 loads word i, and
//     __shfl_sync broadcasts each to the warp: one load a word;
//   kLanes (K24 lanes): every thread loads the 12 words itself (__ldg of
//     one address across the warp).
// K23 reads word i of pair idx at ntab[12 idx + i] and keeps idx in
// [1, N/2) odd ((x & (N/2 - 1)) | 1); K24 reads tabs[i][idx] and masks idx
// to S * 128 - 1. Optionally each row's idx and bs after every step are
// written out (the walk's trajectory: the outputs' acc counts only misses,
// ROADMAP C-19). Bound: FP32 operations, two slab tests (12 each) and the
// acc adds a lane-step, on one SM.
//
// min/max follow jnp.minimum/jnp.maximum (and torch's): a NaN in either
// operand gives NaN, where fminf/fmaxf would drop it. No input here makes a
// NaN (d != 0). Built with -fmad=false and the plain versions' operation
// order (leafround_probe.py, multirow_probe.py), so kernels and plain
// versions agree bit for bit.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kTile = kRows * kLanes;
constexpr int kClusters = 1024;
constexpr float kFar = 1e30f;

// ------------------------------------------------------------------ K22
template <int MODE, int W>
__global__ void __launch_bounds__(kTile, 1)
leafround_kernel(const float* __restrict__ rays,
                 const float* __restrict__ blocks, int rounds,
                 float* __restrict__ out) {
  constexpr int kWords = 16 * W;  // a cluster: (16 w / 128, 128) f32
  __shared__ __align__(16) float cl[kRows][kWords];
  __shared__ int ids[kRows];
  const int tid = threadIdx.x, row = tid >> 7, lane = tid & (kLanes - 1);
  const float o1 = rays[tid], o2 = rays[kTile + tid];
  const float o3 = rays[2 * kTile + tid], d1 = rays[3 * kTile + tid];
  const float d2 = rays[4 * kTile + tid], d3 = rays[5 * kTile + tid];
  for (int i = tid; i < kRows * kWords; i += kTile) (&cl[0][0])[i] = 0.f;
  if (tid < kRows) ids[tid] = (tid * 37 + 1) & (kClusters - 1);
  __syncthreads();
  float closest = kFar;
  const float* c = cl[row];
  for (int k = 0; k < rounds; ++k) {
    // mode 1 reads the row's id back and uses it only in lane 0: a lane
    // that reads late may see the next round's id, which it discards
    int id = 0;
    if (MODE >= 1) id = *static_cast<volatile int*>(&ids[row]);
    if (MODE >= 2) {
      const float4* src = reinterpret_cast<const float4*>(
          blocks + static_cast<size_t>(id) * kWords);
      float4* dst = reinterpret_cast<float4*>(cl[row]);
      for (int i = lane; i < kWords / 4; i += kLanes)
        dst[i] = __ldg(src + i);
      __syncthreads();
    } else {
      // mode 0 and 1 never write the cluster: without this compiler
      // barrier its words would be hoisted out of the loop
      asm volatile("" ::: "memory");
    }
#pragma unroll 4
    for (int j = 0; j < W; ++j) {
      const float4 p = make_float4(c[j], c[W + j], c[2 * W + j], c[3 * W + j]);
      const float4 q = make_float4(c[4 * W + j], c[5 * W + j], c[6 * W + j],
                                   c[7 * W + j]);
      const float4 n = make_float4(c[8 * W + j], c[9 * W + j],
                                   c[10 * W + j], c[11 * W + j]);
      float t, u, v;
      if (pt::mt_hit<false>(p, q, n, o1, o2, o3, d1, d2, d3, 1e-3f, closest,
                            t, u, v))
        closest = t;
    }
    if (MODE >= 1) {
      if (lane == 0)
        ids[row] = (id * 5 + 1 + (__float_as_int(closest) & 1)) &
                   (kClusters - 1);
      __syncthreads();  // the id is out, and the cluster slot read
    }
  }
  out[tid] = closest;
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

// PAIRS: K24's tables (word i of pair idx at tab[i * words + idx]); else
// K23's flat node table (at tab[12 idx + i]). `words` is K24's S * 128
// or K23's N.
template <int FETCH, bool PAIRS>
__global__ void __launch_bounds__(kRows * 32)
walk8_kernel(const float* __restrict__ rays, const float* __restrict__ tab,
             int words, int steps, float* __restrict__ acc_out,
             int* __restrict__ idx_tr, int* __restrict__ bs_tr) {
  constexpr int kPer = kLanes / 32;
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  float o1[kPer], o2[kPer], o3[kPer], i1[kPer], i2[kPer], i3[kPer];
  float cl[kPer], acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = row * kLanes + lane + 32 * k;
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
  for (int step = 0; step < steps; ++step) {
    float b[12];
    if (FETCH == kFixed) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        b[i] = static_cast<float>(0.1 * i);
        b[6 + i] = static_cast<float>(0.1 * i + 0.05);
      }
    } else if (FETCH == kShfl) {
      float word = 0.f;
      if (lane < 12)
        word = __ldg(PAIRS ? tab + static_cast<size_t>(lane) * words + idx
                           : tab + 12 * idx + lane);
#pragma unroll
      for (int i = 0; i < 12; ++i) b[i] = __shfl_sync(0xffffffffu, word, i);
    } else {
#pragma unroll
      for (int i = 0; i < 12; ++i)
        b[i] = __ldg(PAIRS ? tab + static_cast<size_t>(i) * words + idx
                           : tab + 12 * idx + i);
    }
    int pref = 0, nl = 0, nr = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float lh =
          slab(b, o1[k], o2[k], o3[k], i1[k], i2[k], i3[k], cl[k]);
      const float rh =
          slab(b + 6, o1[k], o2[k], o3[k], i1[k], i2[k], i3[k], cl[k]);
      const bool tl = lh < cl[k], tr = rh < cl[k];
      pref += (tl && tr) ? (rh < lh ? 1 : -1) : 0;
      nl += tl;
      nr += tr;
      acc[k] = (acc[k] + lh) + rh;
    }
    pref = __reduce_add_sync(0xffffffffu, pref);
    nl = __reduce_add_sync(0xffffffffu, nl);
    nr = __reduce_add_sync(0xffffffffu, nr);
    // the bitstack advance, uniform across the warp
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
    if (idx_tr != nullptr && lane == 0) {
      idx_tr[step * kRows + row] = idx;
      bs_tr[step * kRows + row] = static_cast<int>(bs);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    acc_out[row * kLanes + lane + 32 * k] = acc[k];
}

template <int MODE, int W>
void launch_leafround(cudaStream_t st, const float* rays, const float* blocks,
                      int rounds, float* out) {
  leafround_kernel<MODE, W><<<1, kTile, 0, st>>>(rays, blocks, rounds, out);
}

template <int FETCH, bool PAIRS>
void launch_walk8(cudaStream_t st, const float* rays, const float* tab,
                  int words, int steps, float* acc, int* idx_tr, int* bs_tr) {
  walk8_kernel<FETCH, PAIRS><<<1, kRows * 32, 0, st>>>(
      rays, tab, words, steps, acc, idx_tr, bs_tr);
}

}  // namespace

// K22: LEAF_MODE `mode` (0, 1, 2) at width w (32 or 64) for `rounds`
// rounds on `stream`. rays [7][1024] f32, blocks [1024][16 w] f32 16-byte
// aligned, out [1024]. Returns cudaGetLastError() (0 = launched).
extern "C" int leafround_probe_launch(int mode, int w, const float* rays,
                                      const float* blocks, int rounds,
                                      float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rounds < 0) return static_cast<int>(cudaErrorInvalidValue);
#define PT_LEAFROUND(M, WW)                                   \
  if (mode == M && w == WW) {                                 \
    launch_leafround<M, WW>(st, rays, blocks, rounds, out);   \
    return static_cast<int>(cudaGetLastError());              \
  }
  PT_LEAFROUND(0, 32)
  PT_LEAFROUND(1, 32)
  PT_LEAFROUND(2, 32)
  PT_LEAFROUND(0, 64)
  PT_LEAFROUND(1, 64)
  PT_LEAFROUND(2, 64)
#undef PT_LEAFROUND
  return static_cast<int>(cudaErrorInvalidValue);
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
    launch_walk8<kFixed, false>(st, rays, tab, words, steps, acc, idx_tr,
                                bs_tr);
  else if (!pairs && fetch == kShfl)
    launch_walk8<kShfl, false>(st, rays, tab, words, steps, acc, idx_tr,
                               bs_tr);
  else if (pairs && fetch == kShfl)
    launch_walk8<kShfl, true>(st, rays, tab, words, steps, acc, idx_tr,
                              bs_tr);
  else if (pairs && fetch == kLanesFetch)
    launch_walk8<kLanesFetch, true>(st, rays, tab, words, steps, acc, idx_tr,
                                    bs_tr);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
