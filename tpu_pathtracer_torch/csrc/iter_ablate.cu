// The heap walk of bvh.cu (K5) in three ablated modes, for NVIDIA Hopper
// (sm_90a): the probe that splits K5's time into its node walk, its
// leaf-row fetch and its leaf arithmetic.
//
// Replaces the TPU kernel experiments/iter_ablate.py::_kernel_ablate (:60,
// through trace_ablate :125, pallas_call :140), which compiles the packet
// kernel in the same three modes.
//
// Contract. heap_kernel of bvh.cu, kNearest, with closest held at the
// ray's t_max: no hit ever commits, so every mode visits the same nodes
// and leaves, and per-ray counters (int32 [5, n], bvh.cu's) are equal
// across modes. A leaf visit does, by mode:
//   * kFull:   bvh.cu's leaf loop (the three float4 rows of each slot by
//              __ldg, pt::mt_hit against closest); acc += t for every
//              accepted slot, in slot order;
//   * kNoMt:   the same three __ldg loads of every slot, folded into an
//              integer xor of their 32-bit words: no load can be dropped
//              and no float arithmetic remains;
//   * kNoLeaf: nothing; the walk pops at once.
// acc [n] holds 32-bit words: the float sum (kFull), the xor (kNoMt) or 0
// (kNoLeaf). A ray with t_max <= 0 walks nothing.
//
// What the split means (python -m tpu_pathtracer_torch.experiments.
// iter_ablate): node walk = kNoLeaf's time, leaf-row fetch = kNoMt -
// kNoLeaf, leaf arithmetic = kFull - kNoMt. The modes visit more leaves
// than K5, which culls by its closest hit, so the three parts are measured
// per visit and K5 is timed beside them.
//
// What bounds it: as bvh.cu, the walk's FP32 work (24 flops a node step,
// 37 a slot in kFull) and the distinct node and triangle rows its rays
// read; the rows are gathers the L2 serves. Built with -fmad=false and
// the plain version's operation order (iter_ablate.py), so kFull's sum is
// bit-equal to it.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kThreads = 128;

enum Mode : int { kFull = 0, kNoMt = 1, kNoLeaf = 2 };

__device__ __forceinline__ unsigned fold(const float4 a) {
  return __float_as_uint(a.x) ^ __float_as_uint(a.y) ^ __float_as_uint(a.z) ^
         __float_as_uint(a.w);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
ablate_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
              const float* __restrict__ oz, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const float* __restrict__ tmax,
              const float4* __restrict__ nodes,
              const float4* __restrict__ tri, unsigned first_leaf, int P,
              float t_min, int n, unsigned* __restrict__ acc_out,
              int* __restrict__ cnt) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float o1 = ox[i], o2 = oy[i], o3 = oz[i];
  const float d1 = dx[i], d2 = dy[i], d3 = dz[i];
  const float closest = tmax[i];
  float acc = 0.f;
  unsigned bits = 0u;
  int nb = 0, nsg = 0, nl = 0, steps = 0;
  if (closest > 0.f) {
    const float i1 = 1.0f / d1, i2 = 1.0f / d2, i3 = 1.0f / d3;
    const bool n1 = i1 < 0.f, n2 = i2 < 0.f, n3 = i3 < 0.f;
    unsigned idx = 1u, bs = 1u;
    while (idx != 0u) {
      if (idx >= first_leaf) {
        ++nl;
        if (MODE != kNoLeaf) {
          const int base = static_cast<int>(idx - first_leaf) * P;
          for (int k = 0; k < P; ++k) {
            const float4* row = tri + 3 * static_cast<size_t>(base + k);
            const float4 p = __ldg(row), q = __ldg(row + 1),
                         r = __ldg(row + 2);
            if (MODE == kFull) {
              float t, u, v;
              if (pt::mt_hit<false>(p, q, r, o1, o2, o3, d1, d2, d3, t_min,
                                    closest, t, u, v))
                acc += t;
            } else {
              bits ^= fold(p) ^ fold(q) ^ fold(r);
            }
          }
        }
        pt::pop_bitstack(bs, idx);
      } else {
        ++steps;
        pt::heap_node_step(nodes, idx, bs, closest, o1, o2, o3, i1, i2, i3,
                           n1, n2, n3, nb, nsg);
      }
    }
  }
  acc_out[i] = MODE == kFull ? __float_as_uint(acc) : bits;
  cnt[i] = nb;
  cnt[n + i] = nsg;
  cnt[2 * n + i] = nl;
  cnt[3 * n + i] = 0;
  cnt[4 * n + i] = steps;
}

}  // namespace

// Launches one mode (0 full, 1 nomt, 2 noleaf) on `stream`; returns
// cudaGetLastError() (0 = launched). nodes is [2*first_leaf, 8] f32, tri
// [T, 12] f32 (bvh.cu's tables, 16-byte aligned); acc is [n] 32-bit words,
// cnt [5, n] int32.
extern "C" int iter_ablate_launch(int mode, const float* ox, const float* oy,
                                  const float* oz, const float* dx,
                                  const float* dy, const float* dz,
                                  const float* tmax, const float* nodes,
                                  const float* tri, int first_leaf, int P,
                                  float t_min, int n, unsigned* acc, int* cnt,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* tb = reinterpret_cast<const float4*>(tri);
  const unsigned fl = static_cast<unsigned>(first_leaf);
  switch (mode) {
    case kFull:
      ablate_kernel<kFull><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, acc, cnt);
      break;
    case kNoMt:
      ablate_kernel<kNoMt><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, acc, cnt);
      break;
    case kNoLeaf:
      ablate_kernel<kNoLeaf><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, acc, cnt);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
