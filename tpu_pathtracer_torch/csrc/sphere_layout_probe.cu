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
// The question it answers is K1's: does a table in constant memory beat
// K1's table staged in shared memory? So the kernel is K1's current form
// (csrc/spheres.cu design points 1, 2 and 4) everywhere but where the
// table lives:
//   1. A group of kLanes consecutive lanes owns a ray; lane s tests slots
//      s, s + kLanes, ... in order, keeps its first-wins best (t, slot),
//      and the group merges them on the lexicographic (t, slot) minimum
//      in log2(kLanes) __shfl_xor_sync steps: the serial winner, ties
//      included, t bit for bit (spheres.cu point 1 says why).
//   2. The roots are computed only where disc > 0, the running best
//      updated inside that branch (spheres.cu point 4).
//   3. After the merge the group fetches the winner's feature column, its
//      n_c features spread over the kLanes lanes.
//   4. The grid holds at most the blocks resident at once; a block takes
//      a contiguous chunk of the rays, a ray a group a round.
// The table, 512 slots x 16 B = 8 KB, lives in __constant__ memory,
// slot-major, a float4 (cx, cy, cz, r2) a slot. Every thread runs the
// slot loop, a dead or absent ray at a t_best that no slot passes, so the
// loop's trip count is uniform and the loop runs converged. It is copied
// to the symbol by cudaMemcpyToSymbolAsync, device to device, on the
// launch's stream (torch's current stream): the symbol is one global of
// this library, so a copy on another stream would race with a launch. (An
// 8 KB __grid_constant__ parameter would need the table on the host: a
// device-to-host copy and a sync before every launch.)
//
// Two arms, one source: kLanes picks the arm.
//   * A, kLanes = 4: K1's groups. A group's 4 lanes read 4 distinct slots
//     at a step, which the constant cache serves one address at a time
//     (K1's shared-memory read is one wavefront).
//   * B, kLanes = 1: a thread a ray. The slot index is then warp-uniform:
//     with the loop's bound a constant (ALL), the compiler keeps it in a
//     uniform register, reads each slot by two ULDC.64 at immediate
//     offsets from it, and the FP32 operations take those uniform
//     registers as operands.
// The A/B (experiments/sphere_layout_ab.py on an H100, each source held
// bit-equal to the plain version and to K1 first, device time a call in a
// CUDA graph, the table's copy included, in turns with K1 and the first
// form, commit 68d9d84's source given as parent=; PERF.md) picked arm B, the faster at the headline's 32,768-lane
// pool, the shape the frame launches K1 at: 0.0323 ms against arm A's
// 0.0436 (K1b 0.0168, the first form 0.0686). At 960,000 rays arm A takes
// 1.153 ms, arm B 0.613 (K1b 0.383): the uniform reads lose there, where
// a register-indexed LDC (16 slots unrolled) takes 0.446 ms but 0.0424
// at the pool; 4 slots unrolled took 1.719 ms, 64 0.680, 128 threads a
// block 0.703.
//
// What bounds it: FP32 issue, as K1: 16 FP32 operations a pair and its
// compare where disc <= 0 (99.5% of the headline's pairs), the IEEE
// sqrtf, the two roots and their compares where disc > 0, each its own
// FMUL/FADD under -fmad=false, against 28 B a ray in and 8 B (+ 4 n_c B
// for K25b) out. The slot loop issues 22.5 instructions a pair (K1: 21;
// the two ULDC take the place of K1's LDS) and 17 more where disc > 0: at
// the pool the kernel reaches 35% of that floor (a thread a ray leaves
// 1,024 warps on 132 SMs), at 960,000 rays 54%.
//
// Numerics: built with -fmad=false and IEEE sqrtf, each expression in the
// operation order of the plain PyTorch version
// (tpu_pathtracer_torch/experiments/sphere_layout_probe.py) and of K1,
// so t and idx are bit-equal to both; the merge only moves values.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 1;      // lanes a ray: 1 arm B, 4 arm A
constexpr int kMinBlocks = 8;  // resident blocks an SM
constexpr int kUnroll = 8;     // slots a lane unrolled
constexpr int kSlots = 512;    // the table's width (the TPU file's S)
constexpr unsigned kAll = 0xffffffffu;

// Slot s: (cx, cy, cz, r2 * sign r).
__constant__ float4 c_sph[kSlots];

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ALL: n_s is kSlots, the loop's bound a constant (every call but a
// K25a call on fewer slots).
template <bool FEAT, bool ALL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  static_assert(kLanes >= 1 && kLanes <= 16 && (kLanes & (kLanes - 1)) == 0,
                "a ray's group is 1, 2, 4, 8 or 16 lanes");
  constexpr int kGroups = kThreads / kLanes;
  const int sl = threadIdx.x & (kLanes - 1);  // the lane's slot residue
  const int g = threadIdx.x / kLanes;         // its group in the block
  // the block's contiguous chunk of rays; its length is the block's own,
  // so every thread takes as many rounds
  const int per_block = (n + gridDim.x - 1) / gridDim.x;
  const int c0 = blockIdx.x * per_block;
  const int c1 = min(n, c0 + per_block);
  for (int r = c0; r < c1; r += kGroups) {
    const int i = r + g;
    const bool has = i < c1;
    float o1 = 0.f, o2 = 0.f, o3 = 0.f, d1 = 1.f, d2 = 0.f, d3 = 0.f;
    float t_best = -1.f;  // an absent ray: no slot passes
    if (has) {
      o1 = ox[i]; o2 = oy[i]; o3 = oz[i];
      d1 = dx[i]; d2 = dy[i]; d3 = dz[i];
      t_best = tmax[i];
    }
    int i_best = -1;
    const int ns = ALL ? kSlots : n_s;
#pragma unroll (kUnroll)
    for (int k = sl; k < ns; k += kLanes) {
      const float4 c = c_sph[k];
      const float ocx = o1 - c.x;
      const float ocy = o2 - c.y;
      const float ocz = o3 - c.z;
      const float b = ocx * d1 + ocy * d2 + ocz * d3;
      const float cc = ocx * ocx + ocy * ocy + ocz * ocz - c.w;
      const float disc = b * b - cc;
      if (disc > 0.f) {
        // sqrtf(disc) is the plain version's sqrt(max(disc, 0)) here
        const float sq = sqrtf(disc);
        const float t1 = -b - sq;
        const float t2 = -b + sq;
        const float ts0 = t1 > t_min ? t1 : t2;
        if (ts0 > t_min && ts0 < t_best) {
          t_best = ts0;
          i_best = k;
        }
      }
    }
    // the group's first-wins winner: the least (t, slot) of its lanes'
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const float t2 = __shfl_xor_sync(kAll, t_best, off);
      const int i2 = __shfl_xor_sync(kAll, i_best, off);
      if (i2 >= 0 && (i_best < 0 || t2 < t_best ||
                      (t2 == t_best && i2 < i_best))) {
        t_best = t2;
        i_best = i2;
      }
    }
    if (!has) continue;
    if (sl == 0) {
      t_out[i] = i_best >= 0 ? t_best : FLT_MAX;
      idx_out[i] = i_best;
    }
    if (FEAT) {
      for (int k = sl; k < n_c; k += kLanes) {
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
  }
}

// The blocks of one kernel that the current device holds at once (SMs x
// blocks an SM), cached per device and kernel.
template <bool FEAT, bool ALL>
int resident_blocks() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, sphere_layout_kernel<FEAT, ALL>, kThreads, 0) !=
            cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

template <bool FEAT, bool ALL>
int launch(const float* ox, const float* oy, const float* oz,
           const float* dx, const float* dy, const float* dz,
           const float* tmax, int n_s, const float* feat_t, int n_c, int n,
           float t_min, float* t_out, int* idx_out, float* f_out,
           cudaStream_t st) {
  const int resident = resident_blocks<FEAT, ALL>();
  if (resident <= 0) {  // no device, or the kernel fits on no SM
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e
                                             : cudaErrorInvalidConfiguration);
  }
  // no more blocks than are resident at once, and no block without a ray
  // for each of its groups
  constexpr int kGroups = kThreads / kLanes;
  const int want = (n + kGroups - 1) / kGroups;
  const dim3 grid(want < resident ? want : resident);
  sphere_layout_kernel<FEAT, ALL><<<grid, kThreads, 0, st>>>(
      ox, oy, oz, dx, dy, dz, tmax, n_s, n, t_min, feat_t, n_c, t_out,
      idx_out, f_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Copies the table sph [512, 4] (device memory) to the constant symbol
// and launches K25a (feat = 0) or K25b (feat = 1) on `stream`, both
// ordered on that stream. Returns the first CUDA error (0 = launched).
// n = 0 copies the table alone. feat_t is [n_c, 512] row-major, f_out
// [n_c, n]; K25a takes them null, K25b n_s = 512.
extern "C" int sphere_layout_launch(int feat, const float* ox,
                                    const float* oy, const float* oz,
                                    const float* dx, const float* dy,
                                    const float* dz, const float* tmax,
                                    const float* sph, int n_s,
                                    const float* feat_t, int n_c, int n,
                                    float t_min, float* t_out, int* idx_out,
                                    float* f_out, void* stream) {
  if (n_s < 0 || n_s > kSlots || sph == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemcpyToSymbolAsync(
      c_sph, sph, sizeof(float4) * kSlots, 0, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaSuccess);
#define PT_LAYOUT_LAUNCH(F, A)                                              \
  launch<F, A>(ox, oy, oz, dx, dy, dz, tmax, n_s, feat_t, n_c, n, t_min,   \
               t_out, idx_out, f_out, st)
  if (feat) {  // K25b walks every slot
    if (n_s != kSlots) return static_cast<int>(cudaErrorInvalidValue);
    return PT_LAYOUT_LAUNCH(true, true);
  }
  if (n_s == kSlots) return PT_LAYOUT_LAUNCH(false, true);
  return PT_LAYOUT_LAUNCH(false, false);
#undef PT_LAYOUT_LAUNCH
}
