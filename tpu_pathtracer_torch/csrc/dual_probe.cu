// The heap walk's node phase with R rays a thread, for NVIDIA Hopper
// (sm_90a): does walking several independent rays in turn hide the
// latency of a node step's dependent loads?
//
// Replaces the TPU kernel experiments/dual_probe.py::_kernel (:37, through
// probe :118, pallas_call :134), which runs P in {1, 2, 4} independent
// 1024-ray packets in one block and issues every packet's slab tests before
// it consumes any packet's votes. Here a thread takes the place of a
// packet: it walks R in {1, 2, 4} rays (a template parameter), first
// loading both children's boxes and slab-testing them for every live ray,
// then advancing each ray.
//
// Contract. Each ray walks the implicit-heap BVH of bvh.cu with closest
// fixed at FLT_MAX; a leaf pops at once (there is no leaf phase). The
// output is each ray's count of interior steps (bvh.cu's node_steps
// counter), int32 [n]. R does not change the function: every R gives the
// same counts, bit for bit, as the plain version (dual_probe.py). Thread
// j of a block walks rays blockIdx*128*R + r*128 + j, r < R.
//
// What bounds it: the dependent node loads (two float4 a child box, from
// the L2), each step waiting on the last; 24 FP32 operations a step.
// Several rays a thread put R steps' loads in flight at once, at the cost
// of R times the registers and of a thread that runs until its slowest
// ray ends.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kThreads = 128;

template <int R>
__global__ void __launch_bounds__(kThreads)
dual_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float4* __restrict__ nodes, unsigned first_leaf, int n,
            int* __restrict__ steps_out) {
  const int base = blockIdx.x * kThreads * R + threadIdx.x;
  const float closest = FLT_MAX;
  float o1[R], o2[R], o3[R], i1[R], i2[R], i3[R];
  bool n1[R], n2[R], n3[R];
  unsigned idx[R], bs[R];
  int steps[R];
  bool alive = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = base + r * kThreads;
    const bool live = j < n;
    o1[r] = live ? ox[j] : 0.f;
    o2[r] = live ? oy[j] : 0.f;
    o3[r] = live ? oz[j] : 0.f;
    i1[r] = 1.0f / (live ? dx[j] : 1.f);
    i2[r] = 1.0f / (live ? dy[j] : 1.f);
    i3[r] = 1.0f / (live ? dz[j] : 1.f);
    n1[r] = i1[r] < 0.f;
    n2[r] = i2[r] < 0.f;
    n3[r] = i3[r] < 0.f;
    idx[r] = live ? 1u : 0u;
    bs[r] = 1u;
    steps[r] = 0;
    alive |= live;
  }
  while (alive) {
    // issue: every ray at an interior node loads and tests both children
    float lhit[R], rhit[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      lhit[r] = rhit[r] = FLT_MAX;
      if (idx[r] != 0u && idx[r] < first_leaf) {
        const size_t l = static_cast<size_t>(idx[r]) << 1;
        const float4 la = __ldg(nodes + 2 * l);
        const float4 lb = __ldg(nodes + 2 * l + 1);
        const float4 ra = __ldg(nodes + 2 * l + 2);
        const float4 rb = __ldg(nodes + 2 * l + 3);
        lhit[r] = pt::slab_entry(la.x, la.y, la.z, la.w, lb.x, lb.y, o1[r],
                                 o2[r], o3[r], i1[r], i2[r], i3[r], n1[r],
                                 n2[r], n3[r], closest);
        rhit[r] = pt::slab_entry(ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, o1[r],
                                 o2[r], o3[r], i1[r], i2[r], i3[r], n1[r],
                                 n2[r], n3[r], closest);
      }
    }
    // consume: advance each ray (pt::heap_node_step's descent), or pop a
    // ray that stands on a leaf
    alive = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (idx[r] == 0u) continue;
      if (idx[r] >= first_leaf) {
        pt::pop_bitstack(bs[r], idx[r]);
      } else {
        ++steps[r];
        const unsigned l = idx[r] << 1;
        const bool tl = lhit[r] < closest;
        const bool tr = rhit[r] < closest;
        const unsigned child = l + (rhit[r] < lhit[r] ? 1u : 0u);
        if (tl && tr) {
          idx[r] = child;
          bs[r] = (bs[r] << 1) | 1u;
        } else if (tl || tr) {
          idx[r] = child;
          bs[r] <<= 1;
        } else {
          pt::pop_bitstack(bs[r], idx[r]);
        }
      }
      alive |= idx[r] != 0u;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = base + r * kThreads;
    if (j < n) steps_out[j] = steps[r];
  }
}

}  // namespace

// Launches the R-ray form (R = 1, 2 or 4) on `stream`; returns
// cudaGetLastError() (0 = launched). nodes is bvh.cu's [2*first_leaf, 8]
// f32 table, 16-byte aligned; steps is int32 [n].
extern "C" int dual_probe_launch(int R, const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const float* nodes, int first_leaf, int n,
                                 int* steps, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const unsigned fl = static_cast<unsigned>(first_leaf);
  const auto grid = [n](int r) {
    return dim3((n + kThreads * r - 1) / (kThreads * r));
  };
  switch (R) {
    case 1:
      dual_kernel<1><<<grid(1), kThreads, 0, st>>>(ox, oy, oz, dx, dy, dz,
                                                   nd, fl, n, steps);
      break;
    case 2:
      dual_kernel<2><<<grid(2), kThreads, 0, st>>>(ox, oy, oz, dx, dy, dz,
                                                   nd, fl, n, steps);
      break;
    case 4:
      dual_kernel<4><<<grid(4), kThreads, 0, st>>>(ox, oy, oz, dx, dy, dz,
                                                   nd, fl, n, steps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
