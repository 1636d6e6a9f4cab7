// The sphere layout probe for NVIDIA Hopper (sm_90a): the headline's
// nearest sphere hit with the sphere table in constant memory (K25a), and
// the same with the winner's feature column fetched (K25b).
//
// Replaces the TPU kernels experiments/sphere_layout_probe.py::_kernel_sb
// (through run_sb) and ::_kernel_sbf (through run_sbf). On the TPU they
// lay the rays out in (8, 128) lane tiles and scalar-broadcast each
// sphere from SMEM, so that no cross-lane op is left; sbf then fetches
// the winner's feature column by a 3-term split-bf16 one-hot product.
//
// Contract (the TPU kernels' and K1's, csrc/spheres.cu): per (ray, slot)
// the oc-form quadratic with a unit direction, oc = o - c, b = oc.d,
// c = oc.oc - r2, disc = b*b - c; the near root t1 = -b - sqrt(disc) if
// it is > t_min, else the far root; a slot wins if disc > 0,
// t_min < t < t_best (t_best starts at the ray's t_max), slots in order
// with a strict <, so the first wins a tie. Pad slots carry r2 = -1 and
// never win. Out: t = FLT_MAX where idx < 0. K25b: for a winner, per
// feature x of column idx, hi = bf16(x), r1 = x - hi, mid = bf16(r1),
// lo = bf16(r1 - mid), f = (hi + mid) + lo (the one-hot product's
// sum, lane by lane: x itself on a table that is finite in bf16); 0 on a
// miss; written feature-major [n_c, n], so each feature's store is
// coalesced.
//
// Design. One thread owns one ray. The table, 512 slots x 16 B = 8 KB,
// lives in constant memory: every lane of a warp reads the same slot on
// the same iteration, so each read is a constant-cache broadcast. That is
// the layout the original CUDA renderer's fastest step used; K1 stages
// the same table in shared memory a tile at a time instead. The table is
// slot-major, a float4 (cx, cy, cz, r2) a slot, where the TPU's is
// component-major [4, S] (the wrapper transposes it): the compiler reads
// it with a register-indexed LDC (the slot index does not go to uniform
// registers), and four 4-byte LDCs a slot from rows 2 KB apart took 3.9x
// the time of two 8-byte LDCs from one slot's 16 B at the headline's
// 960,000 rays on an H100 (2.92 against 0.75 ms; PERF.md). The
// table is copied to the symbol by cudaMemcpyToSymbolAsync, device to
// device, on the launch's stream (torch's current stream): the symbol is
// one global of this library, so a copy on another stream would race
// with a launch. (The alternative, an 8 KB __grid_constant__ parameter,
// needs the table on the host: a device-to-host copy and a sync before
// every launch.) The fetch is a per-lane gather of n_c words of the
// feature table (36 KB, in L2); there is no matrix product left, so no
// mma.
//
// What bounds it: FP32 work, about 20 operations a ray-slot pair over
// all 512 slots, pads included (20 x 512 ~ 10k a ray), against 28 B a ray
// in and 8 B (+ 4 n_c B for K25b) out.
//
// Numerics: built with -fmad=false and IEEE sqrtf, each expression in the
// operation order of the plain PyTorch version
// (tpu_pathtracer_torch/experiments/sphere_layout_probe.py) and of K1,
// so t and idx are bit-equal to both.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 512;  // the table's width (the TPU file's S)

// Slot s: (cx, cy, cz, r2 * sign r).
__constant__ float4 c_sph[kSlots];

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool FEAT>
__global__ void __launch_bounds__(kThreads)
sphere_layout_kernel(const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ tmax, int n_s, int n,
                     float t_min, const float* __restrict__ feat_t, int n_c,
                     float* __restrict__ t_out, int* __restrict__ idx_out,
                     float* __restrict__ f_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float o1 = ox[i], o2 = oy[i], o3 = oz[i];
  const float d1 = dx[i], d2 = dy[i], d3 = dz[i];
  float t_best = tmax[i];
  int i_best = -1;
#pragma unroll 4
  for (int s = 0; s < n_s; ++s) {
    const float4 c = c_sph[s];
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
      i_best = s;
    }
  }
  t_out[i] = i_best >= 0 ? t_best : FLT_MAX;
  idx_out[i] = i_best;
  if (!FEAT) return;
  for (int k = 0; k < n_c; ++k) {
    float f = 0.f;
    if (i_best >= 0) {
      const float x = feat_t[static_cast<size_t>(k) * kSlots + i_best];
      const float hi = bf16_round(x);
      const float r1 = x - hi;
      const float mid = bf16_round(r1);
      const float lo = bf16_round(r1 - mid);
      f = (hi + mid) + lo;
    }
    f_out[static_cast<size_t>(k) * n + i] = f;
  }
}

}  // namespace

// Copies the table sph [512, 4] (device memory) to the constant symbol
// and launches K25a (feat = 0) or K25b (feat = 1) on `stream`, both
// ordered on that stream. Returns the first CUDA error (0 = launched).
// feat_t is [n_c, 512] row-major, f_out [n_c, n]; K25a takes them null.
extern "C" int sphere_layout_launch(int feat, const float* ox,
                                    const float* oy, const float* oz,
                                    const float* dx, const float* dy,
                                    const float* dz, const float* tmax,
                                    const float* sph, int n_s,
                                    const float* feat_t, int n_c, int n,
                                    float t_min, float* t_out, int* idx_out,
                                    float* f_out, void* stream) {
  if (n_s < 0 || n_s > kSlots) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyToSymbolAsync(c_sph, sph,
                                            sizeof(float4) * kSlots, 0,
                                            cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads);
  if (feat)
    sphere_layout_kernel<true><<<grid, kThreads, 0, st>>>(
        ox, oy, oz, dx, dy, dz, tmax, n_s, n, t_min, feat_t, n_c, t_out,
        idx_out, f_out);
  else
    sphere_layout_kernel<false><<<grid, kThreads, 0, st>>>(
        ox, oy, oz, dx, dy, dz, tmax, n_s, n, t_min, feat_t, n_c, t_out,
        idx_out, f_out);
  return static_cast<int>(cudaGetLastError());
}
