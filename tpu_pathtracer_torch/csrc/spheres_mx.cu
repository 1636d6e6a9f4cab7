// Nearest / any ray-sphere hit by the MXU b/c layout, for NVIDIA Hopper
// (sm_90a), the ray x centre products on the tensor cores.
//
// Replaces the TPU kernels tpu_pathtracer/ops/pallas_spheres.py
//   ::_kernel_feat with mx=True (:271, through spheres_hit_feat(mx=True)
//     :385 -> _spheres_hit_feat_mx :436)                      -> kFeatures,
//   ::_kernel_any  with mx=True (:499, through spheres_anyhit_soa(mx=True)
//     :533 -> _spheres_anyhit_mx :562)                        -> kAnyHit.
// They are the JAX package's measured-negative decision record for moving
// the quadratic's ray x centre products onto the matrix unit
// (_bc_mxu :205-255); no config reaches them. kProducts writes the two
// products themselves, for the checks of their bound.
//
// Contract (pallas_spheres.py:205-268):
//   * b = o.d - c.d and c = (|o|^2 - 2 o.c) + (|c|^2 - r^2 sign(r)), with
//     o.d = (d1 o1 + d2 o2) + d3 o3 and |o|^2 likewise;
//   * the two ray x centre products c.d and o.c are the sums of the nine
//     products of a 2-term bf16 split of each operand (hi = bf16(x),
//     lo = bf16(x - hi), round to nearest even): hi.hi + hi.lo + lo.hi,
//     the lo.lo term dropped;
//   * disc = b*b - c; the near root t1 = -b - sqrt(disc) if it is > t_min,
//     else t2 = -b + sqrt(disc); a sphere is valid if disc > 0 and
//     t_min < t < t_max (_mx_chunk_ts);
//   * nearest: the first slot with the smallest valid t wins (the TPU's
//     chunked min/argmin merged with a strict < is a sequential strict <
//     over slots); on a miss t = FLT_MAX, idx = -1 and the features are 0,
//     else the winner's feature row (the TPU's one-hot fetch is exact, so
//     here it is a gather);
//   * any-hit: some slot is valid.
//
// Numerics. A product of two bf16 values is exact in FP32, but the tensor
// core adds the nine in its own order and rounding, so c.d and o.c are
// not bit-equal to the plain version's fixed order (ops/cuda_spheres.py
// mx_products). Each stays within MX_ULPS = 32 units of 2^-24 times the
// sum of its products' magnitudes of the plain one (mx_product_bound;
// the plain order's 8 roundings to nearest and the tensor core's own
// accumulation), and ops/cuda_spheres.py carries that through b, c, disc
// and the roots (mx_pair_error): where a lane's winner or occlusion
// differs from the plain version's, the bound can flip it. As the TPU's
// MXU, whose JAX checks are bounds too (C-15). The epilogue is FP32 in
// the plain version's order, built with -fmad=false, IEEE sqrtf.
//
// Design. The TPU kernel computes b and c for a (256, S) tile at once,
// both products riding one [2*256, 4] x [4, S] bf16 matrix product. Here
// one mma.sync.m16n8k16 (bf16 in, f32 accumulate) takes 8 rays against 8
// spheres, both products at once:
//   1. The three passes fold into one depth-16 operand. A ray's row of A
//      is (dh1 dh2 dh3 dh1 dh2 dh3 dl2 dl3 | dl1 0 ...), a sphere's
//      column of B (ch1 ch2 ch3 cl1 cl2 cl3 ch2 ch3 | ch1 ...): the nine
//      live products are hi.hi at k 0-2, hi.lo at 3-5, lo.hi at 6-8.
//      Rows 0-7 of A are a warp tile's 8 rays' d-rows and rows 8-15 their
//      o-rows times 2 (exact), so the accumulator hands each thread c.d
//      (c0, c1) and 2 o.c (c2, c3) of its own ray (lane / 4) against the
//      same two spheres, and the epilogue needs no shuffle and no FMUL by
//      2. B's depth 8-15 repeats depth 0-7 (the second register is the
//      first): A is 0 there but at k 8, where ch1 meets dl1, and a
//      product 0 x b adds exactly 0 (non-finite centres give NaN in both
//      forms).
//   2. The wrapper builds B once (ops/cuda_spheres.py mx_operands: 16 B of
//      bf16 and the f32 |c|^2 - r^2 sign(r) a sphere, padded to 32 with
//      slots whose ccq is +inf, which are never valid). A block stages it
//      in shared memory once (kTile spheres, else a tile for each round of
//      rays) and each ldmatrix.x4 brings two n-tiles' B fragments, each
//      twice, as the register pairs the mma reads (16 spheres, 256
//      contiguous bytes, no bank conflict); each thread's eight ccq of 32
//      spheres lie contiguous (two 16 B loads).
//   3. A step of the loop issues its 4 mma back to back, then the
//      epilogue: b, c, disc and one compare a pair, and one branch for
//      its 8 pairs. The roots only where disc > 0 (99.5% of the
//      headline's pairs have disc <= 0), as csrc/spheres.cu does.
//   4. Nearest: each thread keeps its own first-wins (t, slot) over its
//      slots in increasing order; the 4 threads of a ray merge on the
//      lexicographic (t, slot) minimum, a thread without a candidate never
//      winning, which is the sequential strict <'s winner; then they
//      fetch the winner's feature row, a column in four each.
//   5. Any-hit: after each 32 spheres the warp votes (one ballot) and
//      stops once each of its 8 rays is occluded or cannot be (t_max <=
//      t_min, NaN, past n).
//   6. The grid holds at most the blocks resident at once, each a
//      contiguous chunk of warp tiles (8 rays), a tile a warp a round. At
//      the regen engine's 32,768-lane pool that is 4,096 tiles, 512 blocks
//      of 8 warps on 132 SMs: every SM holds warps without splitting the
//      sphere set across warps; at 960,000 rays 120,000 tiles.
// What bounds it: issue. The tensor cores' share is 18 MACs a pair
// (0.017 ms for 960,000 x 486 pairs at 989 TFLOP/s bf16); a warp's 64
// pairs an mma take one HMMA, half an LDSM, half a 16 B LDS and
// the FP32 epilogue, 5 operations (10 FADD/FMUL and 2 FSETP a thread)
// a pair (PERF.md has the SASS counts). No wgmma: depth 16 and 8 spheres
// an n-tile already leave the tensor cores idle most of the time.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRays = 8;      // rays a warp tile: A's rows 0-7 and 8-15
constexpr int kChunk = 32;    // spheres a step of the loop: 4 n-tiles
constexpr int kTile = 1024;   // spheres staged per pass: 16 KB + 4 KB
constexpr int kMinBlocks = 4; // resident blocks an SM (launch bounds)
constexpr int kRowWords = 5;  // a table row: 4 words of bf16, ccq's bits
constexpr unsigned kAll = 0xffffffffu;

enum Mode : int { kFeatures = 1, kAnyHit = 2, kProducts = 3 };

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two bf16-exact floats in one register, the lower depth in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Where sphere k of a staged tile keeps its ccq: lane t's eight of each 32
// (n-tile j's slots 2t and 2t + 1 at 2j and 2j + 1) lie together.
__device__ __forceinline__ int q_slot(int k) {
  const int r = k & (kChunk - 1);
  return (k & ~(kChunk - 1)) + ((r & 7) >> 1) * 8 + (r >> 3) * 2 + (r & 1);
}

__device__ __forceinline__ void stage(uint4* sb, float* sq,
                                      const int* __restrict__ tab, int base,
                                      int cnt) {
  for (int k = threadIdx.x; k < cnt; k += kThreads) {
    const int* row = tab + static_cast<size_t>(base + k) * kRowWords;
    sb[k] = make_uint4(row[0], row[1], row[2], row[3]);
    sq[q_slot(k)] = __int_as_float(row[4]);
  }
}

// Two n-tiles' B fragments, each twice (b[0] = b[1] the first's, b[2] =
// b[3] the second's): the mma's two B registers, depth 0-7 and 8-15, come
// as the register pair it reads, with no copy.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* b, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// c = A x B for one n-tile, from a zero accumulator; B's depth 8-15 is
// its depth 0-7 (item 1).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A thread's two registers of a ray's row (item 1) for lane residue t:
// depth 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void row_regs(float x1, float x2, float x3,
                                         float scale, int t, uint32_t& lo,
                                         uint32_t& hi) {
  const float h1 = bf16r(x1), h2 = bf16r(x2), h3 = bf16r(x3);
  const float l1 = bf16r(x1 - h1), l2 = bf16r(x2 - h2), l3 = bf16r(x3 - h3);
  const float e0 = t == 0 ? h1 : t == 1 ? h3 : t == 2 ? h2 : l2;
  const float e1 = t == 0 ? h2 : t == 1 ? h1 : t == 2 ? h3 : l3;
  lo = pack(scale * e0, scale * e1);
  hi = t == 0 ? pack(scale * l1, 0.f) : 0u;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spheres_mx_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ tmax,
                  const int* __restrict__ tab, int s,
                  const float* __restrict__ feat, int n_c, int n,
                  float t_min, float* __restrict__ t_out,
                  int* __restrict__ idx_out, float* __restrict__ f_out,
                  bool* __restrict__ occ_out) {
  __shared__ __align__(16) uint4 sb[kTile];
  __shared__ __align__(16) float sq[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the thread's ray in the tile
  const int t = lane & 3;   // its residue: slots 2t, 2t + 1 of an n-tile
  const int s_pad = (s + kChunk - 1) & ~(kChunk - 1);
  const bool one_tile = s_pad <= kTile;
  if (one_tile) {
    stage(sb, sq, tab, 0, s_pad);
    __syncthreads();
  }
  // ldmatrix.x4 row addresses: lanes 8m..8m+7 give matrix m's 8 rows,
  // spheres (lane & 7) + 8 (lane >> 4) of the 16 an ldmatrix brings, so
  // matrices 0 and 1 are one n-tile and 2 and 3 the next
  const uint32_t b_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(sb)) +
      ((lane & 7) + 8 * (lane >> 4)) * 16;
  const float* qp = sq + t * 8;  // the thread's ccq of each 32 (q_slot)
  // the block's contiguous chunk of tiles; its length is the block's own,
  // so every warp takes as many rounds
  const int tiles = (n + kRays - 1) / kRays;
  const int per_block = (tiles + gridDim.x - 1) / gridDim.x;
  const int c0 = blockIdx.x * per_block;
  const int c1 = min(tiles, c0 + per_block);
  for (int r = c0; r < c1; r += kWarps) {
    const int tile = r + warp;
    const int i = tile * kRays + g;
    const bool has = tile < c1 && i < n;
    float o1 = 0.f, o2 = 0.f, o3 = 0.f, d1 = 1.f, d2 = 0.f, d3 = 0.f;
    float tm = -FLT_MAX;
    if (has) {
      o1 = ox[i]; o2 = oy[i]; o3 = oz[i];
      d1 = dx[i]; d2 = dy[i]; d3 = dz[i];
      tm = MODE == kProducts ? 0.f : tmax[i];
    }
    const float od = d1 * o1 + d2 * o2 + d3 * o3;
    const float oo = o1 * o1 + o2 * o2 + o3 * o3;
    uint32_t a[4];
    row_regs(d1, d2, d3, 1.f, t, a[0], a[2]);
    row_regs(o1, o2, o3, 2.f, t, a[1], a[3]);
    // a ray that cannot win anything in (t_min, t_max) is done; a warp
    // whose rays all are tests nothing (kProducts tests every tile)
    const bool dead = !(has && tm > t_min);
    bool go = MODE == kProducts ? tile < c1 : !__all_sync(kAll, dead);
    float t_best = tm;
    int i_best = -1;
    bool found = false;
    for (int base = 0; base < s_pad; base += kTile) {
      const int cnt = min(kTile, s_pad - base);
      if (!one_tile) {
        __syncthreads();  // the previous tile is no longer read
        stage(sb, sq, tab, base, cnt);
        __syncthreads();
      }
      if (!go) continue;
      for (int k0 = 0; k0 < cnt; k0 += kChunk) {
        uint32_t bf[8];
        ldmatrix_x4(bf, b_addr + k0 * 16);
        ldmatrix_x4(bf + 4, b_addr + (k0 + 16) * 16);
        float c[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(c[j], a, bf[2 * j], bf[2 * j + 1]);
        // pair p = 2j + h of the step is slot slot0 + 8j + h: p
        // ascending is slot order
        const int slot0 = base + k0 + 2 * t;
        if constexpr (MODE == kProducts) {
          if (has) {
            const size_t row = static_cast<size_t>(i) * s;
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              const int slot = slot0 + 8 * (p >> 1) + (p & 1);
              if (slot < s) {
                t_out[row + slot] = c[p >> 1][p & 1];
                f_out[row + slot] = 0.5f * c[p >> 1][2 + (p & 1)];
              }
            }
          }
        } else {
          const float4 qa = *reinterpret_cast<const float4*>(qp + k0);
          const float4 qb = *reinterpret_cast<const float4*>(qp + k0 + 4);
          const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
          float b[8], disc[8];
          bool any = false;
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            b[p] = od - c[p >> 1][p & 1];
            const float cc = (oo - c[p >> 1][2 + (p & 1)]) + q[p];
            disc[p] = b[p] * b[p] - cc;
            any |= disc[p] > 0.f;
          }
          if (any) {  // rare: the roots of the pairs with disc > 0
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              if (disc[p] > 0.f) {
                const float sqd = sqrtf(disc[p]);
                const float t1 = -b[p] - sqd;
                const float t2 = -b[p] + sqd;
                const float ts0 = t1 > t_min ? t1 : t2;
                if (ts0 > t_min && ts0 < t_best) {
                  if constexpr (MODE == kAnyHit) {
                    found = true;
                  } else {
                    t_best = ts0;
                    i_best = slot0 + 8 * (p >> 1) + (p & 1);
                  }
                }
              }
            }
          }
        }
        if constexpr (MODE == kAnyHit) {
          // the warp's vote: bit 4g of m is ray g's 4 lanes' or
          unsigned m = __ballot_sync(kAll, dead || found);
          m |= m >> 1;
          m |= m >> 2;
          if ((m & 0x11111111u) == 0x11111111u) {
            go = false;
            break;
          }
        }
      }
    }
    if constexpr (MODE == kAnyHit) {
      unsigned m = __ballot_sync(kAll, found);
      m |= m >> 1;
      m |= m >> 2;
      if (has && t == 0) occ_out[i] = (m >> (4 * g)) & 1u;
    } else if constexpr (MODE == kFeatures) {
      // the ray's first-wins winner: the least (t, slot) of its 4 lanes'
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float t2 = __shfl_xor_sync(kAll, t_best, off);
        const int i2 = __shfl_xor_sync(kAll, i_best, off);
        if (i2 >= 0 && (i_best < 0 || t2 < t_best ||
                        (t2 == t_best && i2 < i_best))) {
          t_best = t2;
          i_best = i2;
        }
      }
      const bool won = i_best >= 0;
      if (has && t == 0) {
        t_out[i] = won ? t_best : FLT_MAX;
        idx_out[i] = i_best;
      }
      if (has) {
        const float* row = feat + static_cast<size_t>(won ? i_best : 0) * n_c;
        for (int k = t; k < n_c; k += 4) {
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
            &per_sm, spheres_mx_kernel<MODE>, kThreads, 0) != cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

template <int MODE>
int launch(const float* ox, const float* oy, const float* oz,
           const float* dx, const float* dy, const float* dz,
           const float* tmax, const int* tab, int s, const float* feat,
           int n_c, int n, float t_min, float* t_out, int* idx_out,
           float* f_out, bool* occ_out, cudaStream_t st) {
  const int resident = resident_blocks<MODE>();
  if (resident <= 0) {  // no device, or the kernel fits on no SM
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e
                                             : cudaErrorInvalidConfiguration);
  }
  // no more blocks than are resident at once, and none without a tile
  // for each of its warps
  const int tiles = (n + kRays - 1) / kRays;
  const int want = (tiles + kWarps - 1) / kWarps;
  const dim3 grid(want < resident ? want : resident);
  spheres_mx_kernel<MODE><<<grid, kThreads, 0, st>>>(
      ox, oy, oz, dx, dy, dz, tmax, tab, s, feat, n_c, n, t_min, t_out,
      idx_out, f_out, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one mode on `stream`; returns cudaGetLastError() (0 = launched).
// The arguments are spheres_hit_launch's (spheres.cu), except that tmax
// is always the rays' [n] t_max (there is no tmax_all) and sph is the
// [s_pad, 5] int32 table of ops/cuda_spheres.py mx_operands (s_pad = s
// rounded up to 32): a sphere's B column as 8 bf16, then the bits of its
// f32 ccq. kProducts (3) writes c.d to t_out and o.c to f_out, each
// [n, s] row-major. Pointers the mode does not use may be null.
extern "C" int spheres_mx_launch(int mode, const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const float* tmax, const float* sph, int s,
                                 const float* feat, int n_c, int n,
                                 float t_min, float* t_out, int* idx_out,
                                 float* f_out, bool* occ_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tab = reinterpret_cast<const int*>(sph);
  switch (mode) {
    case kFeatures:
      return launch<kFeatures>(ox, oy, oz, dx, dy, dz, tmax, tab, s, feat,
                               n_c, n, t_min, t_out, idx_out, f_out,
                               occ_out, st);
    case kAnyHit:
      return launch<kAnyHit>(ox, oy, oz, dx, dy, dz, tmax, tab, s, feat,
                             n_c, n, t_min, t_out, idx_out, f_out, occ_out,
                             st);
    case kProducts:
      return launch<kProducts>(ox, oy, oz, dx, dy, dz, tmax, tab, s, feat,
                               n_c, n, t_min, t_out, idx_out, f_out,
                               occ_out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
