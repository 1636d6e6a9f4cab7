// Nearest / any ray-triangle hit over the implicit-heap BVH with the
// MXU-leaf test (config.mx_leaf), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels tpu_pathtracer/ops/pallas_bvh_mx.py
//   ::_kernel_nearest_mx (:190, through packet_trace_mx :474)   -> kNearest,
//   ::_kernel_shadow_mx  (:302, through packet_occluded_mx :535) -> kAnyHit.
//
// Contract. The walk over the f32 node table is bvh.cu's (one thread, one
// ray, the uint32 bitstack, pt::heap_node_step). Only the leaf test
// differs: Moller-Trumbore linearized, as the TPU kernel does it on its
// matrix unit. Every numerator is bilinear in the ray and the triangle:
//   a = -(d.n), t*a = o'.n - v0'.n, u*a = (o'xd).e2 + d.(v0'xe2),
//   v*a = -(o'xd).e1 - d.(v0'xe1),
// with o' = o - center, v0' = v0 - center (center: the root box's centre
// rounded to powers of two, cuda_bvh_mx.pow2_center). So the ray's
// feature vector F = [d, o', o'xd, 1] (10 values) against the triangle's
// test columns G gives all four. G is stored per triangle slot as one
// [20] f32 row (cuda_bvh_mx.G_COLUMNS) holding only the entries that are
// not zero by construction; a structurally zero entry adds +-0 to a sum
// that starts at +0, which leaves it unchanged, so the numerators equal
// the TPU kernel's [16, 4w] x [16, 1024] product over the same G and F.
//
// The product is taken as the TPU takes it: each G and F value split into
// bf16 parts (round to nearest even: __float2bfloat16_rn, as astype
// rounds), F into hi, mid, lo (_split3, pallas_bvh_mx.py:158), and
//   passes = 3: N = S(g_hi, f_hi) + (S(g_hi, f_mid) + S(g_lo, f_hi)),
//               g_lo = bf16(g - g_hi);
//   passes = 6: N = S(hi, hi); N += S(hi, mid) + S(mid, hi);
//               N += (S(hi, lo) + S(lo, hi)) + S(mid, mid),
//               G split into three parts as F is (_mm_split :170-187),
// where S(x, y) sums x_k * y_k over the group's used rows k in ascending
// order, starting from +0. A product of two bf16 values is exact in f32,
// so with that fixed order the plain version (ops/cuda_bvh_mx.py) rounds
// alike, bit for bit. Then f = 1/a, t = tn f, u = un f, v = vn f; a slot
// is accepted unless |a| < 1e-7, min(u, v) < 0, u + v > 1, !(t > t_min)
// or !(t < closest) (pallas_bvh_mx.py:249-262). Nearest: the first
// minimum t of the accepted slots of a leaf wins and becomes closest (the
// same winner as the TPU's first-minimum over the whole leaf); any-hit:
// the walk ends at the first accepted slot (:361-369). The winner's exact
// t, u, v and features are recomputed afterwards from its id
// (cuda_bvh_mx.exact_winner, the TPU's _exact_winner post-pass).
//
// Design. The TPU kernel streams a cluster's G block to VMEM and runs one
// [16, 4w] x [16, 1024] product a leaf visit for its 1024-ray packet.
// Here the 32 rays of a warp stand at 32 different leaves, so a tensor
// core product would have no shared operand; each thread computes its own
// numerators with FP32 multiplies and adds of the bf16 parts instead
// (ROADMAP keeps the tensor-core form, inside K11's leaf-major flush, for
// the later redesign).
//
// What bounds it: FP32 ALU work, 24 flops a node step as in bvh.cu, and a
// leaf slot's 19 splits of G (3 operations each, passes = 3) and 19 x 3
// products and sums (x 6 with passes = 6) plus the accept test, about
// 200 operations (passes = 3) against K5's 37; G is 80 B a slot against
// K5's 48 B rows, gathered through the L2.
//
// Numerics: -fmad=false and IEEE division, the plain version's order.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

constexpr int kThreads = 128;

enum Mode : int { kNearest = 0, kAnyHit = 1 };

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Parts {
  float hi, mid, lo;
};

// _split3: hi + mid + lo reproduces x to about 2^-27.
__device__ __forceinline__ Parts split3(float x) {
  const float hi = bf16r(x);
  const float r1 = x - hi;
  const float mid = bf16r(r1);
  return {hi, mid, bf16r(r1 - mid)};
}

// G's parts: hi and lo = bf16(g - hi) for three passes (the lo part is
// then _split3's mid), hi, mid and lo for six.
template <int PASSES>
__device__ __forceinline__ Parts split_g(float g) {
  if (PASSES == 3) {
    const float hi = bf16r(g);
    return {hi, bf16r(g - hi), 0.f};
  }
  return split3(g);
}

// One numerator over K used rows: g[k] against F value f[k].
template <int PASSES, int K>
__device__ __forceinline__ float numerator(const float (&g)[K],
                                           const Parts (&f)[K]) {
  Parts gp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) gp[k] = split_g<PASSES>(g[k]);
  float hh = 0.f, hm = 0.f, mh = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    hh = hh + gp[k].hi * f[k].hi;
    hm = hm + gp[k].hi * f[k].mid;
    mh = mh + gp[k].mid * f[k].hi;
  }
  if (PASSES == 3) return hh + (hm + mh);
  float hl = 0.f, lh = 0.f, mm = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    hl = hl + gp[k].hi * f[k].lo;
    lh = lh + gp[k].lo * f[k].hi;
    mm = mm + gp[k].mid * f[k].mid;
  }
  float out = hh;
  out = out + (hm + mh);
  out = out + ((hl + lh) + mm);
  return out;
}

template <int MODE, int PASSES>
__global__ void __launch_bounds__(kThreads)
mx_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
          const float* __restrict__ oz, const float* __restrict__ dx,
          const float* __restrict__ dy, const float* __restrict__ dz,
          const float* __restrict__ tmax, const float4* __restrict__ nodes,
          const float4* __restrict__ g, unsigned first_leaf, int P,
          float cx, float cy, float cz, float t_min, int n,
          float* __restrict__ t_out, int* __restrict__ tri_out,
          bool* __restrict__ occ_out, int* __restrict__ cnt) {
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
    // F = [d, o', o' x d, 1] (pallas_bvh_mx._fmat), split once per ray
    const float p1 = o1 - cx, p2 = o2 - cy, p3 = o3 - cz;
    const Parts fd1 = split3(d1), fd2 = split3(d2), fd3 = split3(d3);
    const Parts fo1 = split3(p1), fo2 = split3(p2), fo3 = split3(p3);
    const Parts fc1 = split3(p2 * d3 - p3 * d2);
    const Parts fc2 = split3(p3 * d1 - p1 * d3);
    const Parts fc3 = split3(p1 * d2 - p2 * d1);
    const Parts fone = split3(1.0f);
    const Parts fa[3] = {fd1, fd2, fd3};
    const Parts ft[4] = {fo1, fo2, fo3, fone};
    const Parts fuv[6] = {fd1, fd2, fd3, fc1, fc2, fc3};
    unsigned idx = 1u, bs = 1u;
    while (idx != 0u) {
      if (idx >= first_leaf) {
        ++nl;
        const int base = static_cast<int>(idx - first_leaf) * P;
        for (int k = 0; k < P; ++k) {
          const float4* row = g + 5 * static_cast<size_t>(base + k);
          const float4 r0 = __ldg(row), r1 = __ldg(row + 1);
          const float4 r2 = __ldg(row + 2), r3 = __ldg(row + 3);
          const float4 r4 = __ldg(row + 4);
          const float ga[3] = {r0.x, r0.y, r0.z};
          const float gt[4] = {r0.w, r1.x, r1.y, r1.z};
          const float gu[6] = {r1.w, r2.x, r2.y, r2.z, r2.w, r3.x};
          const float gv[6] = {r3.y, r3.z, r3.w, r4.x, r4.y, r4.z};
          const float a = numerator<PASSES>(ga, fa);
          const float tn = numerator<PASSES>(gt, ft);
          const float un = numerator<PASSES>(gu, fuv);
          const float vn = numerator<PASSES>(gv, fuv);
          const float f = 1.0f / a;
          const float t = tn * f;
          const float u = un * f;
          const float v = vn * f;
          const bool neg = (u < 0.f || v < 0.f) && !isnan(u) && !isnan(v);
          if (!(fabsf(a) < 1e-7f || neg || u + v > 1.f || !(t > t_min) ||
                !(t < closest))) {
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

template <int PASSES>
void launch_passes(int mode, dim3 grid, cudaStream_t st, const float* ox,
                   const float* oy, const float* oz, const float* dx,
                   const float* dy, const float* dz, const float* tmax,
                   const float4* nd, const float4* gt, unsigned fl, int P,
                   float cx, float cy, float cz, float t_min, int n,
                   float* t_out, int* tri_out, bool* occ_out, int* cnt) {
  if (mode == kNearest) {
    mx_kernel<kNearest, PASSES><<<grid, kThreads, 0, st>>>(
        ox, oy, oz, dx, dy, dz, tmax, nd, gt, fl, P, cx, cy, cz, t_min, n,
        t_out, tri_out, occ_out, cnt);
  } else {
    mx_kernel<kAnyHit, PASSES><<<grid, kThreads, 0, st>>>(
        ox, oy, oz, dx, dy, dz, tmax, nd, gt, fl, P, cx, cy, cz, t_min, n,
        t_out, tri_out, occ_out, cnt);
  }
}

}  // namespace

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// passes is 3 or 6. nodes is [2*first_leaf, 8] f32 (bvh.cu's table), g is
// [T, 20] f32 test columns, both 16-byte aligned; (cx, cy, cz) is the
// recentering G was built with; cnt is [5, n] int32. Pointers the mode
// does not use may be null.
extern "C" int bvh_mx_launch(int mode, int passes, const float* ox,
                             const float* oy, const float* oz,
                             const float* dx, const float* dy,
                             const float* dz, const float* tmax,
                             const float* nodes, const float* g,
                             int first_leaf, int P, float cx, float cy,
                             float cz, float t_min, int n, float* t_out,
                             int* tri_out, bool* occ_out, int* cnt,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1 || P < 1 || (mode != kNearest && mode != kAnyHit) ||
      (passes != 3 && passes != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* gt = reinterpret_cast<const float4*>(g);
  const unsigned fl = static_cast<unsigned>(first_leaf);
  if (passes == 3) {
    launch_passes<3>(mode, grid, st, ox, oy, oz, dx, dy, dz, tmax, nd, gt, fl,
                     P, cx, cy, cz, t_min, n, t_out, tri_out, occ_out, cnt);
  } else {
    launch_passes<6>(mode, grid, st, ox, oy, oz, dx, dy, dz, tmax, nd, gt, fl,
                     P, cx, cy, cz, t_min, n, t_out, tri_out, occ_out, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
