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
// Here the regen engine launches it on its lane pool, 32,768 rays
// (engine/regen.py _pool_size), once a regen iteration. One thread a ray
// filled 128 blocks of 256 threads there, 8 warps on each of 128 SMs,
// each thread a chain of S dependent tests (486 on the headline) with two
// warps a scheduler to hide it. So, as csrc/tris.cu does for triangles:
//   1. A group of kP consecutive lanes of a warp owns one ray. Lane s of
//      the group tests slots s, s + kP, s + 2 kP, ... in order and keeps
//      its own first-wins best (t, slot) under the ray's t_max. Of the win
//      conditions only ts0 < t_best depends on t_best, and ts0 does not
//      depend on it, so the serial loop's winner is the least ts0 among
//      the slots that pass with ts0 < t_max, the lowest slot on an exact
//      tie (a candidate's ts0 is never NaN: it passed ts0 > t_min). The
//      group merges its lanes' bests in log2(kP) __shfl_xor_sync steps on
//      the lexicographic (t, slot) minimum, a lane without a candidate
//      (slot -1) never winning: the serial winner, ties included, and its
//      t bit for bit. A NaN or dead (<= t_min) t_max passes no slot, so
//      such a ray tests nothing and misses, as the serial loop has it.
//   2. After the merge the group fetches the winner's feature row, its
//      n_c columns spread over the kP lanes, and writes it feature-major
//      ([n_c, n]): each store of a warp covers kP features of 32 / kP
//      neighbouring rays.
//   3. The sphere table (16 B a sphere, one float4) is staged in shared
//      memory once a block by a cooperative load when it fits one tile
//      (kTile spheres: the headline's 486 are 7.8 KB), else a tile at a
//      time for each round of rays. The grid holds at most the blocks
//      that are resident at once, and each block takes a contiguous chunk
//      of the rays, a ray a group a round. The kP lanes of a group read kP
//      neighbouring float4, which the warp's other groups read at the same
//      step: one broadcast wavefront.
//   4. The roots are computed only where disc > 0, and the running best
//      is updated inside that branch: a slot with disc <= 0 never wins,
//      and 99.5% of the headline's pairs have disc <= 0, so the IEEE
//      sqrtf, the compares and the selects are skipped there; where it
//      holds, max(disc, 0) is disc, so every result is the plain
//      version's.
//   5. Any-hit takes groups of its own and stops at a hit: the group's
//      lanes vote every kVote slots each. It runs in no frame (no sphere
//      scene uses NEE) and does not compact its live rays.
//   6. Launch bounds hold the nearest modes to 8 resident blocks an SM
//      (32 registers, no spills) and any-hit to 4 (64 registers).
// The A/B (experiments/spheres_ab.py on an H100, each source held
// bit-equal to the plain version first, device time a call in a CUDA
// graph, in turns with one thread a ray; PERF.md) picked each parameter
// at the pool's shape, on its primary and bounce-2 rays and the rays the
// engine hands K1 at two regen iterations:
//   * the group alone (8 lanes a ray, item 4's branch holding only the
//     roots) gained 2.6-3.1x at the pool; without the branch, 1.8-2.0x
//     there and 0.74-0.83x at 960,000 rays;
//   * the update inside that branch: 1.15-1.24x on that, 21 SASS
//     instructions a pair where disc <= 0 instead of ~26;
//   * kPNearest 4 (2: -7 to -9% at the pool, +4% at 960,000 rays; 8: -4%
//     at the pool, -12% at 960,000), kUnroll 8 (2: -14 to -27%; 4 and 16
//     within 2%), 8 blocks an SM (6, 40 registers: within 1%);
//   * any-hit kPAnyHit 8 (4 within 1%; 16: -8%), 4 blocks an SM (8,
//     spilling at 32 registers: -14%), kVote 32 (16 within 2%).
//
// What bounds it: FP32 issue. A pair is 20 FP32 operations (the oc
// differences, two 3-term dots, disc, the roots), each its own FMUL/FADD
// under -fmad=false: 21 SASS instructions a pair where disc <= 0 (its 17
// FP32 operations, the shared-memory load, the compare and branch and
// their reconvergence), 18 more where disc > 0 (the IEEE sqrtf's
// sequence, the roots, the compares and the selects). No operation pairs
// into an FFMA, so the issue rate of the instruction mix (a warp
// instruction a scheduler a cycle), not the FP32 peak that counts an
// FFMA as two, is the floor (PERF.md). The rays (28 B in, 8 B + 4 n_c B
// out) and the table (16 B a sphere) are a few MB. No wgmma and no TMA:
// there is no matrix product once the feature fetch is a gather, and the
// table is a few KB that one cooperative load stages.
//
// Numerics: built with -fmad=false and without --use_fast_math, sqrtf is
// IEEE round-to-nearest, and each expression is written in the operation
// order of the plain PyTorch version in ops/cuda_spheres.py, so the two
// agree on t bit for bit; the merge only moves values.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

enum Mode : int { kNearest = 0, kFeatures = 1, kAnyHit = 2 };

constexpr int kThreads = 256;
constexpr int kPNearest = 4;          // lanes a ray, nearest modes
constexpr int kPAnyHit = 8;           // lanes a ray, any-hit
constexpr int kNearestMinBlocks = 8;  // resident blocks an SM, nearest
constexpr int kAnyHitMinBlocks = 4;   // resident blocks an SM, any-hit
constexpr int kUnroll = 8;  // nearest: slots a lane unrolled
constexpr int kVote = 32;   // any-hit: slots a lane between group votes
constexpr int kTile = 1024; // spheres staged per pass: 16 KB of float4
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int lanes_a_ray(int mode) {
  return mode == kAnyHit ? kPAnyHit : kPNearest;
}
__host__ __device__ constexpr int min_blocks(int mode) {
  return mode == kAnyHit ? kAnyHitMinBlocks : kNearestMinBlocks;
}

__device__ __forceinline__ void stage(float4* tile,
                                      const float4* __restrict__ sph,
                                      int base, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += kThreads) tile[k] = sph[base + k];
}

// b and disc of one (ray, sphere) pair, c = (cx, cy, cz, r2).
__device__ __forceinline__ float pair_disc(float4 c, float o1, float o2,
                                           float o3, float d1, float d2,
                                           float d3, float& b) {
  const float ocx = o1 - c.x;
  const float ocy = o2 - c.y;
  const float ocz = o3 - c.z;
  b = ocx * d1 + ocy * d2 + ocz * d3;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - c.w;
  return b * b - cc;
}

// The pair's root where disc > 0: the near one if it is > t_min, else
// the far one (sqrtf(disc) is the plain version's sqrt(max(disc, 0))).
__device__ __forceinline__ float pair_root(float b, float disc,
                                           float t_min) {
  const float sq = sqrtf(disc);
  const float t1 = -b - sq;
  const float t2 = -b + sq;
  return t1 > t_min ? t1 : t2;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, min_blocks(MODE))
spheres_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
               const float* __restrict__ oz, const float* __restrict__ dx,
               const float* __restrict__ dy, const float* __restrict__ dz,
               const float* __restrict__ tmax, float tmax_all,
               const float4* __restrict__ sph, int s,
               const float* __restrict__ feat, int n_c, int n, float t_min,
               float* __restrict__ t_out, int* __restrict__ idx_out,
               float* __restrict__ f_out, bool* __restrict__ occ_out) {
  __shared__ float4 tile[kTile];
  constexpr int kP = lanes_a_ray(MODE);
  constexpr int kGroups = kThreads / kP;
  static_assert(kP >= 1 && kP <= 16 && (kP & (kP - 1)) == 0,
                "a ray's group is 1, 2, 4, 8 or 16 lanes");
  const int sl = threadIdx.x & (kP - 1);  // the lane's slot residue
  const int g = threadIdx.x / kP;         // its group in the block
  const unsigned gmask = ((1u << kP) - 1u)
                         << ((threadIdx.x & 31) & ~(kP - 1));
  const bool one_tile = s <= kTile;
  if (one_tile) {
    stage(tile, sph, 0, s);
    __syncthreads();
  }
  // the block's contiguous chunk of rays; its length is the block's own,
  // so every thread takes as many rounds
  const int per_block = (n + gridDim.x - 1) / gridDim.x;
  const int c0 = blockIdx.x * per_block;
  const int c1 = min(n, c0 + per_block);
  for (int r = c0; r < c1; r += kGroups) {
    const int i = r + g;
    const bool has = i < c1;
    float o1 = 0.f, o2 = 0.f, o3 = 0.f, d1 = 1.f, d2 = 0.f, d3 = 0.f;
    float tm = 0.f;
    if (has) {
      o1 = ox[i]; o2 = oy[i]; o3 = oz[i];
      d1 = dx[i]; d2 = dy[i]; d3 = dz[i];
      tm = tmax != nullptr ? tmax[i] : tmax_all;
    }
    // a ray that cannot hit anything in (t_min, t_max) tests nothing
    bool go = has && tm > t_min;
    float t_best = tm;
    int i_best = -1;
    bool hit = false;
    for (int base = 0; base < s; base += kTile) {
      const int cnt = min(kTile, s - base);
      if (!one_tile) {
        __syncthreads();  // the previous tile is no longer read
        stage(tile, sph, base, cnt);
        __syncthreads();
      }
      if constexpr (MODE == kAnyHit) {
        // steps and votes are the warp's own: every lane reaches them
        const int steps = (cnt + kP - 1) / kP;
        for (int j0 = 0; j0 < steps; j0 += kVote) {
          if (go) {
            const int j1 = min(steps, j0 + kVote);
            for (int jj = j0; jj < j1 && !hit; ++jj) {
              const int k = jj * kP + sl;
              if (k >= cnt) continue;
              float b;
              const float disc =
                  pair_disc(tile[k], o1, o2, o3, d1, d2, d3, b);
              if (!(disc > 0.f)) continue;
              const float t = pair_root(b, disc, t_min);
              hit = t > t_min && t < tm;
            }
          }
          if (__ballot_sync(kAll, hit) & gmask) {  // the group's vote
            hit = true;
            go = false;
          }
          if (!__any_sync(kAll, go)) break;
        }
      } else if (go) {
#pragma unroll (kUnroll)
        for (int k = sl; k < cnt; k += kP) {
          float b;
          const float disc = pair_disc(tile[k], o1, o2, o3, d1, d2, d3, b);
          if (!(disc > 0.f)) continue;
          const float t = pair_root(b, disc, t_min);
          if (t > t_min && t < t_best) {
            t_best = t;
            i_best = base + k;
          }
        }
      }
    }
    if constexpr (MODE == kAnyHit) {
      if (has && sl == 0) occ_out[i] = hit;
    } else {
      // the group's first-wins winner: the least (t, slot) of its lanes'
#pragma unroll
      for (int off = 1; off < kP; off <<= 1) {
        const float t2 = __shfl_xor_sync(kAll, t_best, off);
        const int i2 = __shfl_xor_sync(kAll, i_best, off);
        if (i2 >= 0 && (i_best < 0 || t2 < t_best ||
                        (t2 == t_best && i2 < i_best))) {
          t_best = t2;
          i_best = i2;
        }
      }
      const bool won = i_best >= 0;
      if (has && sl == 0) {
        t_out[i] = won ? t_best : FLT_MAX;
        idx_out[i] = i_best;
      }
      if (MODE == kFeatures && has) {
        const float* row = feat + static_cast<size_t>(won ? i_best : 0) * n_c;
        for (int k = sl; k < n_c; k += kP) {
          float v = 0.f;
          if (won) v = row[k];
          f_out[static_cast<size_t>(k) * n + i] = v;
        }
      }
    }
  }
}

// The blocks of one mode that the current device holds at once (SMs x
// blocks an SM), cached per device and mode.
template <int MODE>
int resident_blocks() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, spheres_kernel<MODE>, kThreads, 0) != cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

template <int MODE>
int launch(const float* ox, const float* oy, const float* oz,
           const float* dx, const float* dy, const float* dz,
           const float* tmax, float tmax_all, const float4* tab, int s,
           const float* feat, int n_c, int n, float t_min, float* t_out,
           int* idx_out, float* f_out, bool* occ_out, cudaStream_t st) {
  const int resident = resident_blocks<MODE>();
  if (resident <= 0) {  // no device, or the kernel fits on no SM
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e
                                             : cudaErrorInvalidConfiguration);
  }
  // no more blocks than are resident at once, and no block without a ray
  // for each of its groups
  constexpr int kGroups = kThreads / lanes_a_ray(MODE);
  const int want = (n + kGroups - 1) / kGroups;
  const dim3 grid(want < resident ? want : resident);
  spheres_kernel<MODE><<<grid, kThreads, 0, st>>>(
      ox, oy, oz, dx, dy, dz, tmax, tmax_all, tab, s, feat, n_c, n, t_min,
      t_out, idx_out, f_out, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// Pointers the mode does not use may be null. tmax is the rays' [n] t_max,
// or null for one t_max of every ray, tmax_all. sph is [s] float4
// (cx, cy, cz, r2 * sign(r)), 16-byte aligned; feat is [s, n_c]
// row-major; f_out is [n_c, n] row-major.
extern "C" int spheres_hit_launch(int mode, const float* ox, const float* oy,
                                  const float* oz, const float* dx,
                                  const float* dy, const float* dz,
                                  const float* tmax, float tmax_all,
                                  const float* sph, int s, const float* feat,
                                  int n_c, int n, float t_min, float* t_out,
                                  int* idx_out, float* f_out, bool* occ_out,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* tab = reinterpret_cast<const float4*>(sph);
  switch (mode) {
    case kNearest:
      return launch<kNearest>(ox, oy, oz, dx, dy, dz, tmax, tmax_all, tab, s,
                              feat, n_c, n, t_min, t_out, idx_out, f_out,
                              occ_out, st);
    case kFeatures:
      return launch<kFeatures>(ox, oy, oz, dx, dy, dz, tmax, tmax_all, tab,
                               s, feat, n_c, n, t_min, t_out, idx_out, f_out,
                               occ_out, st);
    case kAnyHit:
      return launch<kAnyHit>(ox, oy, oz, dx, dy, dz, tmax, tmax_all, tab, s,
                             feat, n_c, n, t_min, t_out, idx_out, f_out,
                             occ_out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
