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
// gather. Here the engine launches it on its lane pool, 32,768 rays
// (engine/regen.py _pool_size), twice a regen iteration. One thread a ray
// filled 128 blocks of 256 threads there, 8 warps on each of 128 SMs,
// each thread a chain of T dependent tests with too few warps to hide
// it. So:
//   1. A group of kP consecutive lanes of a warp owns one ray. Lane s of
//      the group tests slots s, s + kP, s + 2 kP, ... in order and keeps
//      its own first-wins best (t, slot, u, v) under the ray's t_max. Of
//      the hit conditions only t < t_best depends on t_best, and t, u, v
//      do not depend on it, so the serial loop's winner is the least t
//      among the slots that pass with t < t_max, the lowest slot on an
//      exact tie (a candidate's t is never NaN: it passed t > t_min).
//      The group merges its lanes' bests in log2(kP) __shfl_xor_sync
//      steps on the lexicographic (t, slot) minimum, a lane without a
//      candidate (slot -1) never winning: the serial winner, ties
//      included, and its t, u, v bit for bit. A NaN t_max passes no
//      t < t_max: the ray misses, as the serial loop has it.
//      kP is 4 in the nearest modes and 8 in any-hit, from an A/B on an
//      H100 at the staircase's 32,768-lane pool (PERF.md): each ray
//      costs its group a fixed part (the ray's loads, the merge, the
//      feature fetch), which 4 lanes spread over 96 of the 384 slots each
//      and 8 lanes over 48; any-hit has no merge and no fetch, and more
//      lanes a ray shorten its compacted rounds.
//   2. After the merge the group fetches the winner's feature row, its
//      n_c columns spread over the kP lanes, and writes it feature-major.
//   3. Any-hit compacts its live rays: the block ranks a window of rays
//      by t_max > t_min with __ballot_sync/__popc and a prefix over its
//      warps in shared memory, writes false for the others, and hands the
//      live rays densely, in lane order, to its groups; a group without a
//      ray skips the round. At phase 6's NEE set 39% of the lanes carry a
//      shadow ray, so without it most of a warp's lanes sat idle beside
//      its live ones. A group stops at a hit: its lanes vote every kVote
//      slots each (16: 128 slots of the group, a third of the staircase;
//      4 and 8 voted too often, 32 too late). Occlusion is a boolean, so
//      slot order does not matter there.
//      The nearest modes do not compact: the regen engine restarts a lane
//      the iteration its path ends, so nearly every lane of the pool
//      carries a ray, and a dead one costs only its own group.
//   4. The triangle table (48 B a triangle, three float4) is staged in
//      shared memory once a block by a cooperative float4 load when it
//      fits one tile (kTile triangles: the staircase's 384 are 18 KB),
//      else a tile at a time for each round of rays. The grid holds at
//      most the blocks that are resident at once, and each block takes a
//      contiguous chunk of the rays in windows, so a one-tile table is
//      read from L2 once for each resident block, 5 or 6 times an SM. The
//      kP lanes of a group read kP neighbouring triangles (48 B apart,
//      no bank conflict), which the warp's other groups read at the same
//      step (a broadcast).
//   5. Launch bounds hold a mode to 5 (nearest: 48 registers) or 6
//      (any-hit: 40) resident blocks an SM; left free, the nearest modes
//      took 80 registers, 3 blocks an SM, and ran 1.2x slower at the pool.
//
// What bounds it: FP32 issue. Every test is mt_hit's 37 operations, each
// its own FMUL/FADD under -fmad=false, plus the IEEE division's sequence
// and the compares and selects, ~71-75 SASS instructions a pair; no
// operation pairs into an FFMA, so the issue rate of this instruction mix
// (a warp instruction a scheduler a cycle), not the FP32 peak that counts
// an FFMA as two, is the floor (PERF.md). At the pool the kernel reaches
// ~60% of that rate, limited by warps (5 blocks of 8 an SM). At 960,000
// rays, a shape the engine does not launch, the nearest modes take ~9%
// longer than one thread a ray, which amortized a ray's fixed part over
// all 384 slots. The rays (28 B in, 16 B + 4 n_c B out) and the table
// (48 B a triangle) are a few MB. No wgmma and no TMA: there is no matrix
// product once the feature fetch is a gather, and the table is a few KB
// that one cooperative load stages.
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

enum Mode : int { kNearest = 0, kFeatures = 1, kAnyHit = 2 };

constexpr int kThreads = 256;
constexpr int kPNearest = 4;  // lanes a ray, nearest modes
constexpr int kPAnyHit = 8;   // lanes a ray, any-hit
constexpr int kNearestMinBlocks = 5;  // resident blocks an SM, nearest
constexpr int kAnyHitMinBlocks = 6;   // resident blocks an SM, any-hit
constexpr int kVote = 16;     // any-hit: slots a lane between group votes
constexpr int kTile = 512;    // triangles staged per pass: 24 KB of float4
constexpr int kWindow = 1024; // any-hit: rays ranked per window
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kWindow % kThreads == 0, "windows are ranked a block at a time");

__host__ __device__ constexpr int lanes_a_ray(int mode) {
  return mode == kAnyHit ? kPAnyHit : kPNearest;
}
__host__ __device__ constexpr int min_blocks(int mode) {
  return mode == kAnyHit ? kAnyHitMinBlocks : kNearestMinBlocks;
}

// tile[3k] = (v0x, v0y, v0z, e1x), tile[3k+1] = (e1y, e1z, e2x, e2y),
// tile[3k+2] = (e2z, nx, ny, nz) of triangle base + k
__device__ __forceinline__ void stage(float4* tile,
                                      const float4* __restrict__ tri,
                                      int base, int cnt) {
  for (int k = threadIdx.x; k < 3 * cnt; k += kThreads)
    tile[k] = tri[3 * static_cast<size_t>(base) + k];
}

// Ranks the rays of [w0, w1) with t_max > t_min into live[] in lane
// order, writes false for the others; returns how many are live.
__device__ __forceinline__ int compact(const float* __restrict__ tmax,
                                       int w0, int w1, float t_min,
                                       int* live, int* warp_live,
                                       bool* __restrict__ occ_out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int count = 0;
  for (int x0 = w0; x0 < w1; x0 += kThreads) {
    const int i = x0 + threadIdx.x;
    const bool in = i < w1;
    const bool liv = in && tmax[i] > t_min;  // a NaN t_max is dead
    if (in && !liv) occ_out[i] = false;
    const unsigned b = __ballot_sync(kAll, liv);
    if (lane == 0) warp_live[warp] = __popc(b);
    __syncthreads();
    int before = 0, total = 0;
    for (int q = 0; q < kWarps; ++q) {
      const int c = warp_live[q];
      before += q < warp ? c : 0;
      total += c;
    }
    if (liv) live[count + before + __popc(b & ((1u << lane) - 1u))] = i;
    count += total;
    __syncthreads();  // warp_live is rewritten; live[] is complete
  }
  return count;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, min_blocks(MODE))
tris_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float* __restrict__ tmax, const float4* __restrict__ tri,
            int t_count, const float* __restrict__ feat, int n_c, int n,
            float t_min, float* __restrict__ t_out, int* __restrict__ idx_out,
            float* __restrict__ u_out, float* __restrict__ v_out,
            float* __restrict__ f_out, bool* __restrict__ occ_out) {
  __shared__ float4 tile[3 * kTile];
  __shared__ int live[MODE == kAnyHit ? kWindow : 1];
  __shared__ int warp_live[kWarps];
  constexpr int kP = lanes_a_ray(MODE);
  constexpr int kGroups = kThreads / kP;
  static_assert(kP == 4 || kP == 8, "a ray's group is 4 or 8 lanes");
  const int s = threadIdx.x & (kP - 1);  // the lane's slot residue
  const int g = threadIdx.x / kP;        // its group in the block
  const unsigned gmask = ((1u << kP) - 1u) << ((threadIdx.x & 31) & ~(kP - 1));
  const bool one_tile = t_count <= kTile;
  if (one_tile) {
    stage(tile, tri, 0, t_count);
    __syncthreads();
  }
  // the block's contiguous chunk of rays, in windows
  const int per_block = (n + gridDim.x - 1) / gridDim.x;
  const int c0 = blockIdx.x * per_block;
  const int c1 = min(n, c0 + per_block);
  for (int w0 = c0; w0 < c1; w0 += kWindow) {
    const int w1 = min(c1, w0 + kWindow);
    int count = w1 - w0;
    if constexpr (MODE == kAnyHit)
      count = compact(tmax, w0, w1, t_min, live, warp_live, occ_out);
    // count is the block's own, so every thread takes as many rounds
    for (int r = 0; r < count; r += kGroups) {
      const int j = r + g;
      const bool has = j < count;
      const int i = !has ? 0 : MODE == kAnyHit ? live[j] : w0 + j;
      float o1 = 0.f, o2 = 0.f, o3 = 0.f, d1 = 1.f, d2 = 0.f, d3 = 0.f;
      float tm = 0.f;
      if (has) {
        o1 = ox[i]; o2 = oy[i]; o3 = oz[i];
        d1 = dx[i]; d2 = dy[i]; d3 = dz[i];
        tm = tmax[i];
      }
      // a ray that cannot hit anything in (t_min, t_max) tests nothing
      bool go = has && tm > t_min;
      float t_best = tm, u_best = 0.f, v_best = 0.f;
      int i_best = -1;
      bool hit = false;
      for (int base = 0; base < t_count; base += kTile) {
        const int cnt = min(kTile, t_count - base);
        if (!one_tile) {
          __syncthreads();  // the previous tile is no longer read
          stage(tile, tri, base, cnt);
          __syncthreads();
        }
        if constexpr (MODE == kAnyHit) {
          // steps and votes are the warp's own: every lane reaches them
          const int steps = (cnt + kP - 1) / kP;
          for (int j0 = 0; j0 < steps; j0 += kVote) {
            if (go) {
              const int j1 = min(steps, j0 + kVote);
              for (int jj = j0; jj < j1 && !hit; ++jj) {
                const int k = jj * kP + s;
                float t, u, v;
                if (k < cnt &&
                    pt::mt_hit(tile[3 * k], tile[3 * k + 1], tile[3 * k + 2],
                               o1, o2, o3, d1, d2, d3, t_min, tm, t, u, v))
                  hit = true;
              }
            }
            if (__ballot_sync(kAll, hit) & gmask) {  // the group's vote
              hit = true;
              go = false;
            }
            if (!__any_sync(kAll, go)) break;
          }
        } else if (go) {
#pragma unroll 4
          for (int k = s; k < cnt; k += kP) {
            float t, u, v;
            if (pt::mt_hit(tile[3 * k], tile[3 * k + 1], tile[3 * k + 2], o1,
                           o2, o3, d1, d2, d3, t_min, t_best, t, u, v)) {
              t_best = t;
              i_best = base + k;
              u_best = u;
              v_best = v;
            }
          }
        }
      }
      if constexpr (MODE == kAnyHit) {
        if (has && s == 0) occ_out[i] = hit;
      } else {
        // the group's first-wins winner: the least (t, slot) of its lanes'
#pragma unroll
        for (int off = 1; off < kP; off <<= 1) {
          const float t2 = __shfl_xor_sync(kAll, t_best, off);
          const int i2 = __shfl_xor_sync(kAll, i_best, off);
          const float u2 = __shfl_xor_sync(kAll, u_best, off);
          const float v2 = __shfl_xor_sync(kAll, v_best, off);
          if (i2 >= 0 && (i_best < 0 || t2 < t_best ||
                          (t2 == t_best && i2 < i_best))) {
            t_best = t2;
            i_best = i2;
            u_best = u2;
            v_best = v2;
          }
        }
        const bool won = i_best >= 0;
        if (has && s == 0) {
          t_out[i] = won ? t_best : FLT_MAX;
          idx_out[i] = i_best;
          u_out[i] = won ? u_best : 0.f;
          v_out[i] = won ? v_best : 0.f;
        }
        if (has && MODE == kFeatures) {
          const float* row =
              feat + static_cast<size_t>(won ? i_best : 0) * n_c;
          for (int k = s; k < n_c; k += kP)
            f_out[static_cast<size_t>(k) * n + i] = won ? row[k] : 0.f;
        }
      }
    }
    if constexpr (MODE == kAnyHit)
      __syncthreads();  // the next window rewrites live
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
            &per_sm, tris_kernel<MODE>, kThreads, 0) != cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

template <int MODE>
int launch(const float* ox, const float* oy, const float* oz,
           const float* dx, const float* dy, const float* dz,
           const float* tmax, const float4* tab, int t_count,
           const float* feat, int n_c, int n, float t_min, float* t_out,
           int* idx_out, float* u_out, float* v_out, float* f_out,
           bool* occ_out, cudaStream_t st) {
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
  tris_kernel<MODE><<<grid, kThreads, 0, st>>>(
      ox, oy, oz, dx, dy, dz, tmax, tab, t_count, feat, n_c, n, t_min, t_out,
      idx_out, u_out, v_out, f_out, occ_out);
  return static_cast<int>(cudaGetLastError());
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* tab = reinterpret_cast<const float4*>(tri);
  switch (mode) {
    case kNearest:
      return launch<kNearest>(ox, oy, oz, dx, dy, dz, tmax, tab, t_count,
                              feat, n_c, n, t_min, t_out, idx_out, u_out,
                              v_out, f_out, occ_out, st);
    case kFeatures:
      return launch<kFeatures>(ox, oy, oz, dx, dy, dz, tmax, tab, t_count,
                               feat, n_c, n, t_min, t_out, idx_out, u_out,
                               v_out, f_out, occ_out, st);
    case kAnyHit:
      return launch<kAnyHit>(ox, oy, oz, dx, dy, dz, tmax, tab, t_count,
                             feat, n_c, n, t_min, t_out, idx_out, u_out,
                             v_out, f_out, occ_out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
