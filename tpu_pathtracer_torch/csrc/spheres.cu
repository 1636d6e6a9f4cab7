// Brute-force nearest / any ray-sphere hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_pathtracer/ops/pallas_spheres.py::_kernel_sb
// in all three of its modes, chosen here by a template parameter:
//   kFeatures  nearest hit + the winner's feature row (spheres_hit_feat),
//   kNearest   nearest hit, t and index only           (spheres_hit_soa),
//   kAnyHit    any hit in (t_min, t_max)                (spheres_anyhit_soa).
//
// Contract (the same as the TPU kernel's):
//   * per (ray, sphere): the oc-form quadratic with a unit direction,
//     oc = o - c, b = oc.d, c = oc.oc - r2, disc = b*b - c; the near root
//     t1 = -b - sqrt(disc) if it is > t_min, else the far root t2;
//   * a sphere wins if disc > 0, t_min < t < t_best, where t_best starts
//     at the ray's t_max; spheres are tested in slot order with a strict
//     <, so on an exact tie the first sphere wins;
//   * a slot with radius <= 0 carries r2 = -r*r, so disc < 0 and it never
//     wins (the wrapper builds the table);
//   * on a miss: t = FLT_MAX, idx = -1, features 0. t is FLT_MAX wherever
//     idx < 0, even when the ray's t_max was finite.
//
// Design. The TPU kernel tiles rays as (8,128) lane blocks, copies the
// sphere table to SMEM by DMA and fetches the winner's features with a
// 3-term bf16 one-hot matrix product, because a TPU lane cannot gather.
// A Hopper thread can: here one thread owns one ray, the block stages the
// sphere table (16 B a sphere) in shared memory a tile at a time and every
// thread walks it, and the winner's row of the [S, n_c] feature table
// (72 B for n_c = 18; the whole table is 36 KB at 512 spheres and stays
// in L2) is read with plain loads and written feature-major, so each
// feature's store is coalesced across the warp.
//
// What bounds it: FP32 ALU work, about 20 flops per ray-sphere pair
// (486 spheres: ~10k flops a ray), against 28 B a ray in (origin,
// direction, t_max) and 8 B + 72 B a ray out (t, idx, 18 features).
// Shared-memory reads are warp-uniform broadcasts. No wgmma and no TMA:
// there is no matrix product left once the feature fetch is a gather,
// and the sphere table is a few KB that one cooperative load stages.
//
// Numerics: built with -fmad=false and without --use_fast_math, sqrtf is
// IEEE round-to-nearest, and each expression is written in the operation
// order of the plain PyTorch version in ops/cuda_spheres.py, so the two
// agree on t bit for bit.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // spheres staged per pass: 16 KB of float4

enum Mode : int { kNearest = 0, kFeatures = 1, kAnyHit = 2 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
spheres_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
               const float* __restrict__ oz, const float* __restrict__ dx,
               const float* __restrict__ dy, const float* __restrict__ dz,
               const float* __restrict__ tmax,
               const float4* __restrict__ sph, int s,
               const float* __restrict__ feat, int n_c, int n, float t_min,
               float* __restrict__ t_out, int* __restrict__ idx_out,
               float* __restrict__ f_out, bool* __restrict__ occ_out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  float o1 = 0.f, o2 = 0.f, o3 = 0.f, d1 = 1.f, d2 = 0.f, d3 = 0.f;
  float t_best = 0.f;
  if (active) {
    o1 = ox[i]; o2 = oy[i]; o3 = oz[i];
    d1 = dx[i]; d2 = dy[i]; d3 = dz[i];
    t_best = tmax[i];
  }
  int i_best = -1;

  for (int base = 0; base < s; base += kTile) {
    const int cnt = min(kTile, s - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < cnt; k += kThreads) tile[k] = sph[base + k];
    __syncthreads();
    if (!active || (MODE == kAnyHit && i_best >= 0)) continue;
    for (int k = 0; k < cnt; ++k) {
      const float4 c = tile[k];
      const float ocx = o1 - c.x;
      const float ocy = o2 - c.y;
      const float ocz = o3 - c.z;
      const float b = ocx * d1 + ocy * d2 + ocz * d3;
      const float cc = ocx * ocx + ocy * ocy + ocz * ocz - c.w;
      const float disc = b * b - cc;
      const float sq = sqrtf(fmaxf(disc, 0.f));
      const float t1 = -b - sq;
      const float t2 = -b + sq;
      const float ts0 = t1 > t_min ? t1 : t2;
      if (disc > 0.f && ts0 > t_min && ts0 < t_best) {
        t_best = ts0;
        i_best = base + k;
        if (MODE == kAnyHit) break;  // any win decides the ray
      }
    }
  }
  if (!active) return;
  if (MODE == kAnyHit) {
    occ_out[i] = i_best >= 0;
    return;
  }
  t_out[i] = i_best >= 0 ? t_best : FLT_MAX;
  idx_out[i] = i_best;
  if (MODE == kFeatures) {
    const float* row = feat + static_cast<size_t>(i_best >= 0 ? i_best : 0) * n_c;
    for (int k = 0; k < n_c; ++k)
      f_out[static_cast<size_t>(k) * n + i] = i_best >= 0 ? row[k] : 0.f;
  }
}

}  // namespace

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// Pointers the mode does not use may be null. sph is [s] float4
// (cx, cy, cz, r2 * sign(r)), feat is [s, n_c] row-major, f_out is
// [n_c, n] row-major.
extern "C" int spheres_hit_launch(int mode, const float* ox, const float* oy,
                                  const float* oz, const float* dx,
                                  const float* dy, const float* dz,
                                  const float* tmax, const float* sph, int s,
                                  const float* feat, int n_c, int n,
                                  float t_min, float* t_out, int* idx_out,
                                  float* f_out, bool* occ_out,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* tab = reinterpret_cast<const float4*>(sph);
  switch (mode) {
    case kNearest:
      spheres_kernel<kNearest><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, tab, s, feat, n_c, n, t_min, t_out,
          idx_out, f_out, occ_out);
      break;
    case kFeatures:
      spheres_kernel<kFeatures><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, tab, s, feat, n_c, n, t_min, t_out,
          idx_out, f_out, occ_out);
      break;
    case kAnyHit:
      spheres_kernel<kAnyHit><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, tab, s, feat, n_c, n, t_min, t_out,
          idx_out, f_out, occ_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
