// Brute-force nearest / any ray-triangle hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_pathtracer/ops/pallas_tris.py::_kernel_sb
// in all three of its modes, chosen here by a template parameter:
//   kFeatures  nearest hit, u, v + the winner's feature row (tris_hit_feat),
//   kNearest   nearest hit, t, index, u, v            (tris_hit_soa),
//   kAnyHit    any hit in (t_min, t_max)              (tris_anyhit_soa).
//
// Contract (the same as the TPU kernel's, pallas_tris.py:44-166):
//   * per (ray, triangle): the restructured Moller-Trumbore with the face
//     normal n = e1 x e2 precomputed, in this operation order:
//       a = -(d.n), parallel = |a| < 1e-7, f = 1/a,
//       s = o - v0, q = s x d,
//       u = f (q.e2), v = -(f (q.e1)), t = f (s.n);
//     the triangle fails if parallel, min(u, v) < 0, u + v > 1,
//     !(t > t_min) or !(t < t_best), where min(u, v) is NaN when either
//     is NaN (as torch.minimum and jnp.minimum give it), so a NaN never
//     counts as < 0;
//   * t_best starts at the ray's t_max; triangles are tested in slot order
//     with a strict <, so on an exact tie the first triangle wins;
//   * any-hit tests every triangle against the ray's original t_max;
//   * sentinel triangles (+inf vertices) fail through NaN arithmetic;
//   * on a miss: t = FLT_MAX, idx = -1, u = v = 0, features 0.
//
// Design. The TPU kernel tiles rays as (8,128) lane blocks, copies the
// (12, T) triangle table to SMEM by DMA and fetches the winner's features
// with a 3-term bf16 one-hot matrix product, because a TPU lane cannot
// gather. A Hopper thread can: here one thread owns one ray, the block
// stages the triangle table (48 B a triangle, three float4) in shared
// memory a tile of 512 at a time and every thread walks it; all threads of
// a warp read the same triangle, so the shared-memory reads broadcast.
// After the loop the thread reads its winner's row of the [T, n_c] feature
// table (104 B for n_c = 26; 41 KB for the 396-triangle staircase, which
// stays in L2) and writes it feature-major, so each feature's store is
// coalesced across the warp. Any-hit leaves the loop at the first hit
// (the early-out of the reference's kernels.cu:207), and a ray with
// t_max <= t_min (a dead lane) tests nothing.
//
// What bounds it: FP32 ALU work, about 40 flops and one IEEE division per
// ray-triangle pair (396 triangles: ~16k flops a ray), against 28 B a ray
// in (origin, direction, t_max) and 16 B + 104 B a ray out (t, idx, u, v,
// 26 features). No wgmma and no TMA: there is no matrix product once the
// feature fetch is a gather, and the table is a few KB that one
// cooperative load stages.
//
// Numerics: built with -fmad=false and without --use_fast_math (IEEE
// division), and each expression is written in the operation order of the
// plain PyTorch version in ops/cuda_tris.py, so the two agree bit for bit.
// The per-pair test is pt::mt_hit of bvh_common.cuh, shared with the BVH
// kernels.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // triangles staged per pass: 24 KB of float4

enum Mode : int { kNearest = 0, kFeatures = 1, kAnyHit = 2 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
tris_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float* __restrict__ tmax, const float4* __restrict__ tri,
            int t_count, const float* __restrict__ feat, int n_c, int n,
            float t_min, float* __restrict__ t_out, int* __restrict__ idx_out,
            float* __restrict__ u_out, float* __restrict__ v_out,
            float* __restrict__ f_out, bool* __restrict__ occ_out) {
  // triangle k: tile[3k] = (v0x, v0y, v0z, e1x), tile[3k+1] = (e1y, e1z,
  // e2x, e2y), tile[3k+2] = (e2z, nx, ny, nz)
  __shared__ float4 tile[3 * kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  float o1 = 0.f, o2 = 0.f, o3 = 0.f, d1 = 1.f, d2 = 0.f, d3 = 0.f;
  float t_best = 0.f;
  if (active) {
    o1 = ox[i]; o2 = oy[i]; o3 = oz[i];
    d1 = dx[i]; d2 = dy[i]; d3 = dz[i];
    t_best = tmax[i];
  }
  // a ray that cannot hit anything in (t_min, t_max) skips the loop
  bool done = !active || !(t_best > t_min);
  int i_best = -1;
  float u_best = 0.f, v_best = 0.f;

  for (int base = 0; base < t_count; base += kTile) {
    const int cnt = min(kTile, t_count - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < 3 * cnt; k += kThreads)
      tile[k] = tri[3 * base + k];
    __syncthreads();
    if (done) continue;
    for (int k = 0; k < cnt; ++k) {
      float t, u, v;
      if (pt::mt_hit(tile[3 * k], tile[3 * k + 1], tile[3 * k + 2], o1, o2,
                     o3, d1, d2, d3, t_min, t_best, t, u, v)) {
        i_best = base + k;
        if (MODE == kAnyHit) {  // any win decides the ray
          done = true;
          break;
        }
        t_best = t;
        u_best = u;
        v_best = v;
      }
    }
  }
  if (!active) return;
  if (MODE == kAnyHit) {
    occ_out[i] = i_best >= 0;
    return;
  }
  const bool hit = i_best >= 0;
  t_out[i] = hit ? t_best : FLT_MAX;
  idx_out[i] = i_best;
  u_out[i] = hit ? u_best : 0.f;
  v_out[i] = hit ? v_best : 0.f;
  if (MODE == kFeatures) {
    const float* row = feat + static_cast<size_t>(hit ? i_best : 0) * n_c;
    for (int k = 0; k < n_c; ++k)
      f_out[static_cast<size_t>(k) * n + i] = hit ? row[k] : 0.f;
  }
}

}  // namespace

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// Pointers the mode does not use may be null. tri is [t_count, 12]
// row-major (v0, e1, e2, n), 16-byte aligned; feat is [t_count, n_c]
// row-major; f_out is [n_c, n] row-major.
extern "C" int tris_hit_launch(int mode, const float* ox, const float* oy,
                               const float* oz, const float* dx,
                               const float* dy, const float* dz,
                               const float* tmax, const float* tri,
                               int t_count, const float* feat, int n_c, int n,
                               float t_min, float* t_out, int* idx_out,
                               float* u_out, float* v_out, float* f_out,
                               bool* occ_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* tab = reinterpret_cast<const float4*>(tri);
  switch (mode) {
    case kNearest:
      tris_kernel<kNearest><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, tab, t_count, feat, n_c, n, t_min,
          t_out, idx_out, u_out, v_out, f_out, occ_out);
      break;
    case kFeatures:
      tris_kernel<kFeatures><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, tab, t_count, feat, n_c, n, t_min,
          t_out, idx_out, u_out, v_out, f_out, occ_out);
      break;
    case kAnyHit:
      tris_kernel<kAnyHit><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, tab, t_count, feat, n_c, n, t_min,
          t_out, idx_out, u_out, v_out, f_out, occ_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
