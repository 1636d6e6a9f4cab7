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
// cannot gather (pallas_bvh4.py:1-33). Here one thread traces one ray with
// its own ref stack in local memory (kStackCap ints, L1-cached): no votes,
// no DMA, no prefetch. The node table (f32; a quantized table is
// dequantized to f32 once by the wrapper) is read with plain loads and
// stays in L2: staircase-hires' 1,485 nodes are 160 KB.
//
// What bounds it: FP32 ALU work, 48 flops a node step (four slab tests)
// and 37 flops and one IEEE division a triangle slot of a leaf visit,
// against 28 B a ray in and 28 B a ray out. Divergence between the rays of
// a warp is the cost of the per-ray walk; the engine's coherence sort
// groups similar rays.
//
// Numerics: -fmad=false, IEEE division, and the plain version's
// operation order (ops/cuda_bvh4.py), so the two agree bit for bit.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStackCap = 128;  // refs a ray's stack holds at most

enum Mode : int { kNearest = 0, kAnyHit = 1 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
bvh4_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float* __restrict__ tmax, const float* __restrict__ bounds,
            const int* __restrict__ refs, const float4* __restrict__ tri,
            int width, int cap, float t_min, int n,
            float* __restrict__ t_out, int* __restrict__ tri_out,
            bool* __restrict__ occ_out, int* __restrict__ cnt,
            int* __restrict__ overflow_flag) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float o1 = ox[i], o2 = oy[i], o3 = oz[i];
  const float d1 = dx[i], d2 = dy[i], d3 = dz[i];
  float closest = tmax[i];
  int best = -1;
  bool occ = false, overflow = false;
  int nb = 0, nsg = 0, nl = 0, nlp = 0, steps = 0;
  if (closest > 0.f) {
    const float i1 = 1.0f / d1, i2 = 1.0f / d2, i3 = 1.0f / d3;
    const bool n1 = i1 < 0.f, n2 = i2 < 0.f, n3 = i3 < 0.f;
    int stack[kStackCap];
    int sp = 0;
    int cur = 1;
    bool popped = false;
    while (cur != 0) {
      if (cur > 0) {
        ++steps;
        const float* b = bounds + 24 * static_cast<size_t>(cur - 1);
        const int* r = refs + 4 * static_cast<size_t>(cur - 1);
        // hit children in ascending entry distance, slot order on ties
        float hs[4];
        int rs[4];
        int nhit = 0;
        for (int k = 0; k < 4; ++k) {
          const int ref = __ldg(r + k);
          const float* c = b + 6 * k;
          const float h = pt::slab_entry(
              __ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3),
              __ldg(c + 4), __ldg(c + 5), o1, o2, o3, i1, i2, i3, n1, n2,
              n3, closest);
          if (ref != 0 && h < closest) {
            int j = nhit++;
            while (j > 0 && hs[j - 1] > h) {
              hs[j] = hs[j - 1];
              rs[j] = rs[j - 1];
              --j;
            }
            hs[j] = h;
            rs[j] = ref;
          }
        }
        if (nhit == 0) {
          popped = sp > 0;
          cur = popped ? stack[--sp] : 0;
        } else {
          nb += nhit >= 2;
          nsg += nhit == 1;
          if (sp + nhit - 1 > cap) {
            overflow = true;
            *overflow_flag = 1;
            break;
          }
          for (int j = nhit - 1; j >= 1; --j) stack[sp++] = rs[j];
          cur = rs[0];
          popped = false;
        }
      }
      if (cur < 0) {
        const int c = -cur - 1;
        ++nl;
        nlp += popped;
        const float4* row = tri + 3 * static_cast<size_t>(c) * width;
        for (int k = 0; k < width; ++k, row += 3) {
          float t, u, v;
          if (pt::mt_hit(__ldg(row), __ldg(row + 1), __ldg(row + 2), o1, o2,
                         o3, d1, d2, d3, t_min, closest, t, u, v)) {
            best = c * width + k;
            if (MODE == kAnyHit) {
              occ = true;
              break;
            }
            closest = t;
          }
        }
        if (MODE == kAnyHit && occ) break;
        popped = sp > 0;
        cur = popped ? stack[--sp] : 0;
      }
    }
  }
  if (MODE == kAnyHit) {
    occ_out[i] = occ;
  } else {
    t_out[i] = closest;
    tri_out[i] = best;
  }
  cnt[i] = nb;
  cnt[n + i] = nsg;
  cnt[2 * n + i] = nl;
  cnt[3 * n + i] = overflow ? -1 : nlp;
  cnt[4 * n + i] = steps;
}

}  // namespace

// The ref-stack capacity the kernels are compiled with.
extern "C" int bvh4_stack_capacity() { return kStackCap; }

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// bounds is [n_nodes*24] f32, refs [n_nodes*4] int32, tri [C*width, 12]
// f32 rows (v0, e1, e2, n), 16-byte aligned; cnt is [5, n] int32; cap <=
// kStackCap; overflow is one int32 the kernel sets to 1 if a ray's stack
// would outgrow cap. Pointers the mode does not use may be null.
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
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* tb = reinterpret_cast<const float4*>(tri);
  switch (mode) {
    case kNearest:
      bvh4_kernel<kNearest><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, bounds, refs, tb, width, cap, t_min,
          n, t_out, tri_out, occ_out, cnt, overflow);
      break;
    case kAnyHit:
      bvh4_kernel<kAnyHit><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, bounds, refs, tb, width, cap, t_min,
          n, t_out, tri_out, occ_out, cnt, overflow);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
