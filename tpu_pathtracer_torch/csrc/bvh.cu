// Nearest / any ray-triangle hit over the implicit-heap BVH, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels tpu_pathtracer/ops/pallas_bvh.py
//   ::_kernel_nearest (:937, through packet_trace :2695)   -> kNearest,
//   ::_kernel_shadow  (:1393, through packet_occluded :2839) -> kAnyHit,
// each in two arithmetic modes: exact, and fast_math (approx_recip,
// :820-828: the reciprocal in Moller-Trumbore from rcp.approx, see
// bvh_common.cuh). The multi-packet kernels _kernel_nearest_mp (:1766),
// _kernel_shadow_mp (:2056), _kernel_nearest_mps (:2415) and
// _kernel_shadow_mps (:2539), which packet_packs > 1 and packet_split
// select, compute the same function as the two above, outputs and
// counters bit-identical to packs = 1 (tests/test_packet_bvh.py:513-610),
// and differ only in how 1024-ray packets are interleaved on a TPU; this
// kernel is their counterpart too.
//
// Contract (the results of the TPU kernels, and the semantics of the
// reference's hitBvh, kernels.cu:148-224, as ops/bvh.traverse has them):
//   * the tree is the implicit complete heap: nodes from 1, children of
//     node i at 2i and 2i+1, node i >= first_leaf is leaf l = i -
//     first_leaf, covering triangle slots [l*P, (l+1)*P);
//   * dual-node descent: at an interior node both children's boxes are
//     slab-tested against the ray's current closest t; a child is entered
//     if its entry distance is < closest; with both entered, the nearer
//     (right only if strictly nearer) is visited first and the other is
//     remembered in the uint32 bitstack; a leaf or a node entering no
//     child pops the bitstack (pop_bitstack, kernels.cu:148);
//   * a leaf tests its P triangles in slot order with pt::mt_hit, strict
//     < against closest, so on an exact tie the first tested wins;
//   * nearest: t = closest (the ray's t_max on a miss), tri = the winning
//     heap slot (-1 on a miss);
//   * any-hit: occ = some triangle hit in (t_min, t_max); the walk ends at
//     the first hit;
//   * a ray with t_max <= 0 (a dead lane, t_max = -1) tests nothing;
//   * per-ray counters (int32 [5, n]): nodes_both, nodes_single (interior
//     steps entering two / one child, kernels.cu:220-221), leaf_visits,
//     leaf_pop (0 here: the heap walk has no ref stack), node_steps (all
//     interior steps).
//
// Design. The TPU kernel traces a packet of 1024 rays with one shared
// traversal state, decides descents by majority votes, DMAs node tables
// and leaf clusters into SMEM and prefetches sibling clusters, all
// because a TPU lane cannot gather (pallas_bvh.py:1-35). None of that
// carries over: here one thread traces one ray with its own bitstack, as
// the original CUDA hitBvh does. Node boxes are read from a [nodes, 8]
// f32 table (two float4 a node; the 872k-triangle dragon's 32,768 nodes
// are 1 MB, staircase-hires' 8,192 are 256 KB), which stays in the 50 MB
// L2. Triangles come from the [T, 12] table of tris.cu (three float4 a
// slot); sentinel slots are zero rows and miss through a = 0.
//
// What bounds it: FP32 ALU work, 24 flops a node step (two slab tests)
// and 37 flops and one IEEE division a triangle slot of a leaf visit,
// against 28 B a ray in and 28 B a ray out; the node and triangle reads
// are gathers that the L2 serves. Divergence between the rays of a warp
// (each walks its own path) is the cost a per-ray walk pays for needing
// no votes; the engine's coherence sort (sort_rays) groups similar rays
// into warps.
//
// Numerics: -fmad=false, IEEE division, and the plain version's
// operation order (ops/cuda_bvh.py), so the two agree bit for bit. The
// fast_math mode's reciprocal is within about 1 ulp of the division; its
// plain version keeps the division, so there the two agree to that bound
// and on every winner whose accept test is not within it of a bound.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kThreads = 128;

enum Mode : int { kNearest = 0, kAnyHit = 1 };

template <int MODE, bool APPROX>
__global__ void __launch_bounds__(kThreads)
heap_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float* __restrict__ tmax, const float4* __restrict__ nodes,
            const float4* __restrict__ tri, unsigned first_leaf, int P,
            float t_min, int n, float* __restrict__ t_out,
            int* __restrict__ tri_out, bool* __restrict__ occ_out,
            int* __restrict__ cnt) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float o1 = ox[i], o2 = oy[i], o3 = oz[i];
  const float d1 = dx[i], d2 = dy[i], d3 = dz[i];
  float closest = tmax[i];
  int best = -1;
  bool occ = false;
  int nb = 0, nsg = 0, nl = 0, steps = 0;
  if (closest > 0.f) {
    const float i1 = 1.0f / d1, i2 = 1.0f / d2, i3 = 1.0f / d3;
    const bool n1 = i1 < 0.f, n2 = i2 < 0.f, n3 = i3 < 0.f;
    unsigned idx = 1u, bs = 1u;
    while (idx != 0u) {
      if (idx >= first_leaf) {
        ++nl;
        const int base = static_cast<int>(idx - first_leaf) * P;
        for (int k = 0; k < P; ++k) {
          const float4* row = tri + 3 * static_cast<size_t>(base + k);
          float t, u, v;
          if (pt::mt_hit<APPROX>(__ldg(row), __ldg(row + 1), __ldg(row + 2),
                                 o1, o2, o3, d1, d2, d3, t_min, closest, t,
                                 u, v)) {
            best = base + k;
            if (MODE == kAnyHit) {
              occ = true;
              break;
            }
            closest = t;
          }
        }
        if (MODE == kAnyHit && occ) break;
        pt::pop_bitstack(bs, idx);
      } else {
        ++steps;
        pt::heap_node_step(nodes, idx, bs, closest, o1, o2, o3, i1, i2, i3,
                           n1, n2, n3, nb, nsg);
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
  cnt[3 * n + i] = 0;
  cnt[4 * n + i] = steps;
}

}  // namespace

template <bool APPROX>
static void launch_mode(int mode, dim3 grid, cudaStream_t st, const float* ox,
                        const float* oy, const float* oz, const float* dx,
                        const float* dy, const float* dz, const float* tmax,
                        const float4* nd, const float4* tb, unsigned fl, int P,
                        float t_min, int n, float* t_out, int* tri_out,
                        bool* occ_out, int* cnt) {
  if (mode == kNearest) {
    heap_kernel<kNearest, APPROX><<<grid, kThreads, 0, st>>>(
        ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, t_out, tri_out,
        occ_out, cnt);
  } else {
    heap_kernel<kAnyHit, APPROX><<<grid, kThreads, 0, st>>>(
        ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, t_out, tri_out,
        occ_out, cnt);
  }
}

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// approx != 0 selects the fast_math reciprocal. nodes is [2*first_leaf, 8]
// f32 rows (minx, miny, minz, maxx, maxy, maxz, 0, 0), tri is [T, 12] f32
// rows (v0, e1, e2, n), both 16-byte aligned; cnt is [5, n] int32.
// Pointers the mode does not use may be null.
extern "C" int bvh_heap_launch(int mode, int approx, const float* ox,
                               const float* oy, const float* oz,
                               const float* dx, const float* dy,
                               const float* dz, const float* tmax,
                               const float* nodes, const float* tri,
                               int first_leaf, int P, float t_min, int n,
                               float* t_out, int* tri_out, bool* occ_out,
                               int* cnt, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1 || P < 1 || (mode != kNearest && mode != kAnyHit))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* tb = reinterpret_cast<const float4*>(tri);
  const unsigned fl = static_cast<unsigned>(first_leaf);
  if (approx) {
    launch_mode<true>(mode, grid, st, ox, oy, oz, dx, dy, dz, tmax, nd, tb,
                      fl, P, t_min, n, t_out, tri_out, occ_out, cnt);
  } else {
    launch_mode<false>(mode, grid, st, ox, oy, oz, dx, dy, dz, tmax, nd, tb,
                       fl, P, t_min, n, t_out, tri_out, occ_out, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
