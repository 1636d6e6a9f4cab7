// Nearest / any ray-sphere hit by the MXU b/c layout, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels tpu_pathtracer/ops/pallas_spheres.py
//   ::_kernel_feat with mx=True (:271, through spheres_hit_feat(mx=True)
//     :385 -> _spheres_hit_feat_mx :436)                      -> kFeatures,
//   ::_kernel_any  with mx=True (:499, through spheres_anyhit_soa(mx=True)
//     :533 -> _spheres_anyhit_mx :562)                        -> kAnyHit.
// They are the JAX package's measured-negative decision record for moving
// the quadratic's ray x centre products onto the matrix unit; no config
// reaches them.
//
// Contract (pallas_spheres.py:205-268):
//   * b = o.d - c.d and c = (|o|^2 - 2 o.c) + (|c|^2 - r^2 sign(r)), with
//     o.d = (d1 o1 + d2 o2) + d3 o3 and |o|^2 likewise;
//   * the two ray x centre products c.d and o.c come from a 2-term bf16
//     split of each operand (hi = bf16(x), lo = bf16(x - hi), round to
//     nearest even) in three passes, P(hi, hi) + P(hi, lo), then
//     + P(lo, hi), ray part first (the lo.lo term is dropped), each pass
//     P(x, y) = (x0 y0 + x1 y1) + x2 y2;
//   * disc = b*b - c; the near root t1 = -b - sqrt(disc) if it is > t_min,
//     else t2 = -b + sqrt(disc); a sphere is valid if disc > 0 and
//     t_min < t < t_max (_mx_chunk_ts);
//   * nearest: the first slot with the smallest valid t wins (the TPU's
//     chunked min/argmin merged with a strict < is a sequential strict <
//     over slots); on a miss t = FLT_MAX, idx = -1 and the features are 0,
//     else the winner's feature row (the TPU's one-hot fetch is exact, so
//     here it is a gather);
//   * any-hit: some slot is valid; the walk over the slots ends at the
//     first.
// The wrapper (ops/cuda_spheres.py mx_sphere_table) builds the table with
// the centre already split: rows (cxh, cyh, czh, ccq, cxl, cyl, czl, 0),
// two float4 a sphere, ccq = |c|^2 - r^2 sign(r).
//
// Design. The TPU kernel computes b and c for a (256, S) tile at once,
// both ray x centre products riding one [2*256, 4] x [4, S] bf16 matrix
// product. Here one thread owns one ray and the block stages the split
// table in shared memory a tile at a time (32 B a sphere, 1024 spheres a
// tile). A product of two bf16 values is exact in FP32, so each thread
// sums the pass products on the FP32 units in the fixed order above and
// every rounding is the plain version's. No tensor cores: the product has
// depth K = 4 (3 live), and an mma.sync / wgmma form is later work
// (ROADMAP B-18). The loop runs over the live slots only. The TPU pads
// the set with slots c = 0, r^2 = -1, which give c = |o|^2 + 1 and so
// disc < 0 by Cauchy-Schwarz; that fails only if the rounding of |o|^2
// reaches 1, when |o|^2 exceeds about 2^24.
//
// What bounds it: FP32 ALU work, about 44 operations a ray-sphere pair
// (2 x 17 for the two split products, 10 for b, c, the roots and the
// tests) against K1's 20, with 28 B a ray in and 8 B + 72 B out; the
// shared-memory reads are warp-uniform broadcasts.
//
// Numerics: built with -fmad=false and without --use_fast_math, IEEE
// sqrtf, the plain version's operation order: the two agree bit for bit.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // spheres staged per pass: 32 KB of float4 x 2

enum Mode : int { kFeatures = 1, kAnyHit = 2 };  // ops/cuda_spheres.py

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One pass: (x0 y0 + x1 y1) + x2 y2.
__device__ __forceinline__ float pass3(float x0, float x1, float x2,
                                       float y0, float y1, float y2) {
  return (x0 * y0 + x1 * y1) + x2 * y2;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
spheres_mx_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ tmax,
                  const float4* __restrict__ sph, int s,
                  const float* __restrict__ feat, int n_c, int n,
                  float t_min, float* __restrict__ t_out,
                  int* __restrict__ idx_out, float* __restrict__ f_out,
                  bool* __restrict__ occ_out) {
  __shared__ float4 tile[2 * kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  float o1 = 0.f, o2 = 0.f, o3 = 0.f, d1 = 1.f, d2 = 0.f, d3 = 0.f;
  float t_best = 0.f;
  if (active) {
    o1 = ox[i]; o2 = oy[i]; o3 = oz[i];
    d1 = dx[i]; d2 = dy[i]; d3 = dz[i];
    t_best = tmax[i];
  }
  const float od = d1 * o1 + d2 * o2 + d3 * o3;
  const float oo = o1 * o1 + o2 * o2 + o3 * o3;
  const float dh1 = bf16r(d1), dh2 = bf16r(d2), dh3 = bf16r(d3);
  const float dl1 = bf16r(d1 - dh1), dl2 = bf16r(d2 - dh2),
              dl3 = bf16r(d3 - dh3);
  const float oh1 = bf16r(o1), oh2 = bf16r(o2), oh3 = bf16r(o3);
  const float ol1 = bf16r(o1 - oh1), ol2 = bf16r(o2 - oh2),
              ol3 = bf16r(o3 - oh3);
  int i_best = -1;

  for (int base = 0; base < s; base += kTile) {
    const int cnt = min(kTile, s - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < 2 * cnt; k += kThreads)
      tile[k] = sph[2 * static_cast<size_t>(base) + k];
    __syncthreads();
    if (!active || (MODE == kAnyHit && i_best >= 0)) continue;
    for (int k = 0; k < cnt; ++k) {
      const float4 h = tile[2 * k];      // cxh, cyh, czh, ccq
      const float4 l = tile[2 * k + 1];  // cxl, cyl, czl, 0
      const float cd = pass3(dh1, dh2, dh3, h.x, h.y, h.z) +
                       pass3(dh1, dh2, dh3, l.x, l.y, l.z) +
                       pass3(dl1, dl2, dl3, h.x, h.y, h.z);
      const float oc = pass3(oh1, oh2, oh3, h.x, h.y, h.z) +
                       pass3(oh1, oh2, oh3, l.x, l.y, l.z) +
                       pass3(ol1, ol2, ol3, h.x, h.y, h.z);
      const float b = od - cd;
      const float cc = oo - 2.0f * oc + h.w;
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
  const float* row = feat + static_cast<size_t>(i_best >= 0 ? i_best : 0) * n_c;
  for (int k = 0; k < n_c; ++k)
    f_out[static_cast<size_t>(k) * n + i] = i_best >= 0 ? row[k] : 0.f;
}

}  // namespace

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// The arguments are spheres_hit_launch's (spheres.cu), except that tmax
// is always the rays' [n] t_max (there is no tmax_all) and sph is [s, 8]
// f32 rows (cxh, cyh, czh, ccq, cxl, cyl, czl, 0), 16-byte aligned.
// Pointers the mode does not use may be null.
extern "C" int spheres_mx_launch(int mode, const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const float* tmax, const float* sph, int s,
                                 const float* feat, int n_c, int n,
                                 float t_min, float* t_out, int* idx_out,
                                 float* f_out, bool* occ_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* tab = reinterpret_cast<const float4*>(sph);
  switch (mode) {
    case kFeatures:
      spheres_mx_kernel<kFeatures><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, tab, s, feat, n_c, n, t_min, t_out,
          idx_out, f_out, occ_out);
      break;
    case kAnyHit:
      spheres_mx_kernel<kAnyHit><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, tab, s, feat, n_c, n, t_min, t_out,
          idx_out, f_out, occ_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
