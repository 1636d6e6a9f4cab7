// Shared device code of the triangle kernels (tris.cu, bvh.cu, bvh4.cu,
// bvh_mx.cu, bvh_rg.cu): the restructured Moller-Trumbore test, the
// entry-distance slab test and the heap BVH's interior step.
//
// Both are written in the operation order of the JAX package's Pallas
// kernels (tpu_pathtracer/ops/pallas_bvh.py: _mt_scalar_tri :775-844 and
// _slab :292-317) and of the plain PyTorch versions beside each kernel,
// and the kernels are built with -fmad=false and IEEE division, so a
// kernel and its plain version round alike, bit for bit. The one
// exception is mt_hit's fast_math mode (kApproxRecip), which the heap
// kernels of bvh.cu instantiate beside the exact one.

#pragma once

#include <cfloat>

#include <cuda_runtime.h>

namespace pt {

// the slab test's initial entry distance (intersections.h:8, :26)
constexpr float kBboxTMin = 0.001f;

// Moller-Trumbore of one triangle, given as three float4 rows
// p = (v0x, v0y, v0z, e1x), q = (e1y, e1z, e2x, e2y), r = (e2z, nx, ny, nz)
// with n = e1 x e2 precomputed:
//   a = -(d.n), parallel = |a| < 1e-7, f = 1/a,
//   s = o - v0, q = s x d,
//   u = f (q.e2), v = -(f (q.e1)), t = f (s.n).
// Returns true if the triangle is hit in (t_min, t_best), i.e. none of
// parallel, min(u, v) < 0, u + v > 1, !(t > t_min), !(t < t_best) holds.
// min(u, v) is NaN when either is NaN (as torch.minimum and jnp.minimum
// give it), so a NaN never counts as < 0: such triangles fail through t.
// A zero row (padding, or a sentinel slot zeroed by the wrapper) gives
// a = 0 and fails as parallel.
//
// kApproxRecip (config.fast_math; the JAX package's approx_recip,
// pallas_bvh.py:820-828) takes f from the hardware's approximate
// reciprocal, rcp.approx.ftz.f32, accurate to about 1 ulp (the TPU's
// approximate reciprocal is good to about 2^-14, the bound config.py
// states for fast_math). Every other operation is the exact mode's.
__device__ __forceinline__ float rcp_approx(float a) {
  float f;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(f) : "f"(a));
  return f;
}

template <bool kApproxRecip = false>
__device__ __forceinline__ bool mt_hit(const float4 p, const float4 q4,
                                       const float4 r, float o1, float o2,
                                       float o3, float d1, float d2,
                                       float d3, float t_min, float t_best,
                                       float& t, float& u, float& v) {
  const float v0x = p.x, v0y = p.y, v0z = p.z;
  const float g1x = p.w, g1y = q4.x, g1z = q4.y;
  const float g2x = q4.z, g2y = q4.w, g2z = r.x;
  const float n1 = r.y, n2 = r.z, n3 = r.w;
  const float a = -(d1 * n1 + d2 * n2 + d3 * n3);
  const bool parallel = fabsf(a) < 1e-7f;
  const float f = kApproxRecip ? rcp_approx(a) : 1.0f / a;
  const float sx = o1 - v0x;
  const float sy = o2 - v0y;
  const float sz = o3 - v0z;
  const float qx = sy * d3 - sz * d2;
  const float qy = sz * d1 - sx * d3;
  const float qz = sx * d2 - sy * d1;
  u = f * (qx * g2x + qy * g2y + qz * g2z);
  v = -(f * (qx * g1x + qy * g1y + qz * g1z));
  t = f * (sx * n1 + sy * n2 + sz * n3);
  const bool neg = (u < 0.f || v < 0.f) && !isnan(u) && !isnan(v);
  return !(parallel || neg || (u + v > 1.f) || !(t > t_min) ||
           !(t < t_best));
}

// Entry distance of a ray into the box (mnx, mny, mnz)-(mxx, mxy, mxz),
// or FLT_MAX on a miss; inv = 1/d componentwise, neg = inv < 0. The
// where-form compares keep C's NaN semantics: a NaN slab bound (0 * inf)
// leaves the running bound unchanged. Never fminf/fmaxf, which drop a NaN
// the other way.
__device__ __forceinline__ float slab_entry(
    float mnx, float mny, float mnz, float mxx, float mxy, float mxz,
    float o1, float o2, float o3, float i1, float i2, float i3, bool n1,
    bool n2, bool n3, float closest) {
  const float t0x = (mnx - o1) * i1;
  const float t1x = (mxx - o1) * i1;
  const float t0y = (mny - o2) * i2;
  const float t1y = (mxy - o2) * i2;
  const float t0z = (mnz - o3) * i3;
  const float t1z = (mxz - o3) * i3;
  const float lox = n1 ? t1x : t0x;
  const float hix = n1 ? t0x : t1x;
  const float loy = n2 ? t1y : t0y;
  const float hiy = n2 ? t0y : t1y;
  const float loz = n3 ? t1z : t0z;
  const float hiz = n3 ? t0z : t1z;
  float tmin = kBboxTMin;
  float tmax = closest;
  tmin = lox > tmin ? lox : tmin;
  tmax = hix < tmax ? hix : tmax;
  tmin = loy > tmin ? loy : tmin;
  tmax = hiy < tmax ? hiy : tmax;
  tmin = loz > tmin ? loz : tmin;
  tmax = hiz < tmax ? hiz : tmax;
  return tmax < tmin ? FLT_MAX : tmin;
}

// Pops the heap walk's uint32 bitstack (pop_bitstack, kernels.cu:148):
// drops the trailing zeros of bs (levels with no pending sibling) and
// moves idx up as many levels, to the remembered sibling (bs != 0).
__device__ __forceinline__ void pop_bitstack(unsigned& bs, unsigned& idx) {
  const int m = __ffs(bs) - 1;  // trailing zeros
  bs = (bs >> m) ^ 1u;
  idx = (idx >> m) ^ 1u;
}

// One interior step of the heap walk (the reference's dual-node descent,
// kernels.cu:154-224) at node idx < first_leaf: both children's boxes
// (rows 2*idx and 2*idx + 1 of the [nodes, 8] f32 table, two float4 a
// row) are slab-tested against closest; a child is entered if its entry
// distance is < closest; with both entered, the nearer (right only if
// strictly nearer) comes first and the other is remembered in bs; with
// none, the walk pops. nb / nsg count steps entering two / one child.
__device__ __forceinline__ void heap_node_step(
    const float4* __restrict__ nodes, unsigned& idx, unsigned& bs,
    float closest, float o1, float o2, float o3, float i1, float i2,
    float i3, bool n1, bool n2, bool n3, int& nb, int& nsg) {
  const unsigned l = idx << 1;
  const float4 la = __ldg(nodes + 2 * static_cast<size_t>(l));
  const float4 lb = __ldg(nodes + 2 * static_cast<size_t>(l) + 1);
  const float4 ra = __ldg(nodes + 2 * static_cast<size_t>(l) + 2);
  const float4 rb = __ldg(nodes + 2 * static_cast<size_t>(l) + 3);
  const float lhit = slab_entry(la.x, la.y, la.z, la.w, lb.x, lb.y, o1, o2,
                                o3, i1, i2, i3, n1, n2, n3, closest);
  const float rhit = slab_entry(ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, o1, o2,
                                o3, i1, i2, i3, n1, n2, n3, closest);
  const bool tl = lhit < closest;
  const bool tr = rhit < closest;
  const unsigned child = l + (rhit < lhit ? 1u : 0u);
  if (tl && tr) {
    ++nb;
    idx = child;
    bs = (bs << 1) | 1u;
  } else if (tl || tr) {
    ++nsg;
    idx = child;
    bs <<= 1;
  } else {
    pop_bitstack(bs, idx);
  }
}

}  // namespace pt
