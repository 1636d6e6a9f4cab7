// The TPU micro-benchmarks of experiments/tpu_micro.py, for NVIDIA Hopper
// (sm_90a): six chains of dependent steps, each the GPU form of one TPU
// kernel body, computing that body's function on the same inputs.
//
// Replaces (experiments/tpu_micro.py):
//   * E3 `kernel` :123 (through _pallas_steps_runner :98, pallas_call
//     :101): a per-lane gather from an (R, T) table, acc += table[r, idx],
//     idx = (idx * 1664525 + int(acc)) mod T. Modes: kL2 reads the table
//     with __ldcg (cached in L2 only, so every step pays an L2 round trip);
//     kSmem stages the block's table row (T * 4 B, 64 KB at T = 16384) in
//     dynamic shared memory first;
//   * E4 `kernel` :154: one (8, 128) tile against a row i of a (T, 8)
//     table read as a broadcast; near = max of three slab terms, acc +=
//     near, and i steps by a block-wide vote on sum(near) > 0. The sum is
//     a warp shuffle tree, then the 32 warp partials through shared memory
//     and the same tree in warp 0; the plain version sums in this order;
//   * E7 `kernel` :254: the one-hot MXU fetch of 8 columns. The one-hot
//     product selects one bf16-rounded element a column, so its GPU form
//     is a per-lane gather of the 8 values, each rounded with
//     __float2bfloat16_rn. L2 only: the (8, 16384) table in bf16 (256 KB)
//     exceeds a block's 227 KB of shared memory;
//   * E5 `kernel` :187 (pallas_call :206): a chain of blocking 8 KB copies
//     of a (16, 128) block into shared memory, of which row 0 is added to
//     acc; the next block's index follows from the data just copied,
//     c = (c * 5 + int(acc[0]) % 3 + 1) % C, so no copy can be issued
//     before the last one has landed and been read: a leaf learned with
//     no lead. The TPU's make_async_copy on a DMA semaphore is Hopper's
//     bulk copy on an mbarrier (csrc/dma_probe.cu's K15a): a block is one
//     warp; for each step lane 0 arrives with expect_tx 8,192 B and issues
//     one cp.async.bulk of block c, the warp waits with try_wait.parity
//     and adds row 0 (4 floats a lane), lane 0 takes the next c from its
//     own acc[0] and a __shfl_sync gives it to the warp; a __syncwarp
//     orders every lane's reads of the buffer before lane 0's
//     fence.proxy.async (kProxyFence; the A/B prices it at 0) and the next
//     copy. The first form gave each copy to 128 threads' 16 B loads and
//     stores, with two __syncthreads a copy;
//   * E8 `kernel` :299 (pallas_call :341): leaf phase A, the cluster
//     staged in shared memory and its 128 triangles' 9 words read as
//     broadcasts by the 1024 lanes, best updated triangle by triangle;
//   * E9 `kernel` :367 (pallas_call :411): leaf phase B, each lane loads
//     the cluster's words itself (__ldg: L1/L2) and takes the min of each
//     chunk of 32. t > 0.001 excludes NaN and 1e30 never beats best, so
//     this is E8's function and the two outputs are bit-equal.
//
// Arithmetic follows the TPU source's order (the "MT-ish" test of
// :309-327 is not real Moller-Trumbore: v uses o1 three times), built with
// -fmad=false, so each kernel is bit-equal to its plain PyTorch version.
// Integers: the TPU code's int32 products wrap, so the LCG runs in
// unsigned arithmetic, and its floor mod by T = 2^k is a mask; float to
// int is __float2int_rz (cvt.rzi.s32.f32 truncates and saturates, as XLA
// does: int(1e30) = 2147483647); the other mods are floor mods.
//
// What bounds them: by design, latency. Each step waits on the one before
// it (a gather, a copy, a vote); the bounds the records carry (each input
// read once, or the bytes copied; E8/E9's FP32 operations) are far below.
// E5's one warp issues a step's chain loop (its SASS counted by
// experiments/tpu_micro.py copy_sass) far faster than the copy's round
// trip, which is the number to read.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

constexpr unsigned kLcg = 1664525u;
constexpr int kMaxThreads = 1024;
constexpr int kTile = 1024;             // the (8, 128) lane tile of E4, E8, E9
constexpr int kRowW = 8;                // E4's table rows
constexpr int kCols = 8;                // E7's table columns
constexpr int kBlockRows = 16, kBlockW = 128;  // a (16, 128) f32 block
constexpr int kBlockFloats = kBlockRows * kBlockW;
constexpr int kCopyThreads = 32;        // E5: one warp, 4 of acc's 128 a lane
constexpr int kProxyFence = 1;          // E5: fence.proxy.async before a copy
constexpr int kChunk = 32;              // E9's chunk of triangles
constexpr float kFar = 1e30f;
constexpr float kTMin = 1e-3f;
constexpr float kEpsA = 1e-7f;
constexpr unsigned kFull = 0xffffffffu;

enum GatherMode : int { kL2 = 0, kSmem = 1 };
enum LeafMode : int { kLeafSmem = 0, kLeafLanes = 1 };

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// (idx * 1664525 + int(acc)) mod T in int32 that wraps, T = mask + 1 a
// power of two: the low bits of the unsigned sum.
__device__ __forceinline__ unsigned lcg(unsigned idx, float acc,
                                        unsigned mask) {
  return (idx * kLcg + static_cast<unsigned>(__float2int_rz(acc))) & mask;
}

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads)
gather_kernel(const float* __restrict__ table, const int* __restrict__ idx0,
              int T, int L, int steps, float* __restrict__ out) {
  extern __shared__ float srow[];
  const int r = blockIdx.y;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const float* row = table + static_cast<size_t>(r) * T;
  if (kMode == kSmem) {
    for (int j = threadIdx.x; j < T; j += blockDim.x) srow[j] = row[j];
    __syncthreads();
  }
  const unsigned mask = static_cast<unsigned>(T) - 1u;
  const size_t lane = static_cast<size_t>(r) * L + l;
  // idx0 lies in [0, T); the mask keeps a caller's bad index in bounds
  unsigned idx = static_cast<unsigned>(idx0[lane]) & mask;
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    acc += kMode == kSmem ? srow[idx] : __ldcg(row + idx);
    idx = lcg(idx, acc, mask);
  }
  out[lane] = acc;
}

__global__ void __launch_bounds__(256)
onehot_kernel(const float* __restrict__ table, const int* __restrict__ idx0,
              int T, int L, int steps, float* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const unsigned mask = static_cast<unsigned>(T) - 1u;
  unsigned idx = static_cast<unsigned>(idx0[l]) & mask;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float v = __ldcg(table + static_cast<size_t>(c) * T + idx);
      acc[c] += __bfloat162float(__float2bfloat16_rn(v));
    }
    idx = lcg(idx, acc[0], mask);
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) out[static_cast<size_t>(c) * L + l] = acc[c];
}

// Lane 0 gets v[0] + v[16], then + v[8] ..., the plain version's tree.
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kTile)
row_vote_kernel(const float* __restrict__ rows, int T,
                const float* __restrict__ x, int steps,
                float* __restrict__ out) {
  __shared__ float part[kTile / 32];
  __shared__ float total;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float xv = x[t];
  float acc = 0.f;
  int i = 1;
  for (int s = 0; s < steps; ++s) {
    const float* r = rows + static_cast<size_t>(i) * kRowW;
    const float t0 = (xv - __ldg(r + 0)) * __ldg(r + 3);
    const float t1 = (xv - __ldg(r + 1)) * __ldg(r + 4);
    const float t2 = (xv - __ldg(r + 2)) * __ldg(r + 5);
    const float near = fmaxf(fmaxf(t0, t1), t2);
    acc += near;
    const float w = warp_tree(near);
    if (lane == 0) part[warp] = w;
    __syncthreads();
    if (warp == 0) {
      const float p = warp_tree(part[lane]);
      if (lane == 0) total = p;
    }
    __syncthreads();  // part[] is read before the next step rewrites it
    i = total > 0.f ? (i * 5 + 1) % T : (i * 3 + 7) % T;
  }
  out[t] = acc;
}

__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const float4* __restrict__ blocks, int C, int steps,
            float* __restrict__ out) {
  constexpr int kBlock4 = kBlockFloats / 4;  // 512 float4: 8 KB
  constexpr unsigned kBytes = kBlock4 * 16;
  __shared__ __align__(128) float4 buf[kBlock4];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  if (lane == 0) {
    pt::bar_init(&bar, 1);
    pt::bar_init_fence();
  }
  __syncwarp();
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int c = 0;
  for (int s = 0; s < steps; ++s) {
    if (lane == 0) {
      if (kProxyFence) pt::proxy_fence();
      pt::arrive_expect_tx(&bar, kBytes);
      pt::bulk_copy(buf, blocks + static_cast<size_t>(c) * kBlock4, kBytes,
                    &bar);
    }
    pt::bar_wait(&bar, s & 1);
    const float4 r = buf[lane];  // row 0: acc[4 * lane .. 4 * lane + 3]
    acc.x += r.x;
    acc.y += r.y;
    acc.z += r.z;
    acc.w += r.w;
    const int next =
        floor_mod(c * 5 + floor_mod(__float2int_rz(acc.x), 3) + 1, C);
    c = __shfl_sync(kFull, next, 0);
    __syncwarp();  // every lane has read buf before the next copy
  }
  reinterpret_cast<float4*>(out)[lane] = acc;
}

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// The source's test for one lane (o1) and one triangle, in its order:
// 46 FP32 operations (the division one), compares not counted.
__device__ __forceinline__ float mt_ish(float o1, const Tri& q, bool& ok) {
  const float hx = o1 * q.e2z - q.v0y * q.e2y;
  const float hy = o1 * q.e2x - q.v0z * q.e2z;
  const float hz = o1 * q.e2y - q.v0x * q.e2x;
  const float a = q.e1x * hx + q.e1y * hy + q.e1z * hz;
  const float f = 1.0f / (fabsf(a) < kEpsA ? 1.0f : a);
  const float sx = o1 - q.v0x, sy = o1 - q.v0y, sz = o1 - q.v0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * q.e1z - sz * q.e1y;
  const float qy = sz * q.e1x - sx * q.e1z;
  const float qz = sx * q.e1y - sy * q.e1x;
  const float v = f * (o1 * qx + o1 * qy + o1 * qz);
  const float t = f * (q.e2x * qx + q.e2y * qy + q.e2z * qz);
  ok = (u > 0.f) & (v > 0.f) & (u + v < 1.f) & (t > kTMin);
  return t;
}

template <typename Load>
__device__ __forceinline__ Tri tri_at(Load load, int w) {
  return Tri{load(0 * kBlockW + w), load(1 * kBlockW + w),
             load(2 * kBlockW + w), load(3 * kBlockW + w),
             load(4 * kBlockW + w), load(5 * kBlockW + w),
             load(6 * kBlockW + w), load(7 * kBlockW + w),
             load(8 * kBlockW + w)};
}

__device__ __forceinline__ int next_cluster(int c, float best, int C) {
  return floor_mod(c * 5 + floor_mod(__float2int_rz(best), 3) + 1, C);
}

__global__ void __launch_bounds__(kTile)
leaf_smem_kernel(const float2* __restrict__ blocks, int C,
                 const float* __restrict__ ox, int steps,
                 float* __restrict__ out) {
  __shared__ float2 buf[kBlockFloats / 2];  // one (16, 128) cluster
  __shared__ int next;
  const int t = threadIdx.x;
  const float o1 = ox[t];
  const float* s = reinterpret_cast<const float*>(buf);
  float best = kFar;
  int c = 0;
  for (int step = 0; step < steps; ++step) {
    buf[t] = blocks[static_cast<size_t>(c) * (kBlockFloats / 2) + t];
    __syncthreads();  // the cluster is in
    for (int w = 0; w < kBlockW; ++w) {
      bool ok;
      const float tt = mt_ish(o1, tri_at([s](int k) { return s[k]; }, w), ok);
      if (ok && tt < best) best = tt;
    }
    if (t == 0) next = next_cluster(c, best, C);
    __syncthreads();  // every lane is done with buf; next is written
    c = next;
  }
  out[t] = best;
}

__global__ void __launch_bounds__(kTile)
leaf_lanes_kernel(const float* __restrict__ blocks, int C,
                  const float* __restrict__ ox, int steps,
                  float* __restrict__ out) {
  __shared__ int next[2];  // by step parity: one barrier a step
  const int t = threadIdx.x;
  const float o1 = ox[t];
  float best = kFar;
  int c = 0;
  for (int step = 0; step < steps; ++step) {
    const float* cl = blocks + static_cast<size_t>(c) * kBlockFloats;
    for (int k = 0; k < kBlockW; k += kChunk) {
      float m = kFar;
      for (int w = k; w < k + kChunk; ++w) {
        bool ok;
        const float tt =
            mt_ish(o1, tri_at([cl](int j) { return __ldg(cl + j); }, w), ok);
        m = fminf(m, ok ? tt : kFar);
      }
      best = fminf(best, m);
    }
    if (t == 0) next[step & 1] = next_cluster(c, best, C);
    __syncthreads();
    c = next[step & 1];
  }
  out[t] = best;
}

inline bool pow2(int T) { return T > 0 && (T & (T - 1)) == 0; }

}  // namespace

// Each entry launches one kernel on `stream` and returns
// cudaGetLastError() (0 = launched); pointers are device pointers of
// contiguous float32 / int32 tensors, checked by the Python wrappers.

// E3: table [R, T] (T a power of two, at most 32768 in kSmem), idx and
// out [R, L]; L <= 1024 a multiple of 32, or a multiple of 1024.
extern "C" int tpu_micro_gather(int mode, const float* table, const int* idx,
                                int R, int T, int L, int steps, float* out,
                                void* stream) {
  const int threads = L < kMaxThreads ? L : kMaxThreads;
  if (R < 1 || L < 1 || steps < 0 || !pow2(T) || threads % 32 ||
      L % threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(L / threads, R);
  if (mode == kL2) {
    gather_kernel<kL2><<<grid, threads, 0, st>>>(table, idx, T, L, steps, out);
  } else if (mode == kSmem) {
    const int smem = T * static_cast<int>(sizeof(float));
    const cudaError_t e = cudaFuncSetAttribute(
        gather_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    gather_kernel<kSmem><<<grid, threads, smem, st>>>(table, idx, T, L, steps,
                                                     out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// E4: rows [T, 8] (T >= 2: i starts at 1), x and out [1024].
extern "C" int tpu_micro_row_vote(const float* rows, int T, const float* x,
                                  int steps, float* out, void* stream) {
  if (T < 2 || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  row_vote_kernel<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, T, x, steps, out);
  return static_cast<int>(cudaGetLastError());
}

// E7: table [8, T] (T a power of two), idx [L], out [8, L].
extern "C" int tpu_micro_onehot(const float* table, const int* idx, int T,
                                int L, int steps, float* out, void* stream) {
  if (L < 1 || steps < 0 || !pow2(T))
    return static_cast<int>(cudaErrorInvalidValue);
  onehot_kernel<<<(L + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(table, idx, T, L,
                                                       steps, out);
  return static_cast<int>(cudaGetLastError());
}

// E5: blocks [C, 16, 128], 16-byte aligned; out [128], 16-byte aligned.
extern "C" int tpu_micro_copy(const float* blocks, int C, int steps,
                              float* out, void* stream) {
  if (C < 1 || steps < 0 || reinterpret_cast<uintptr_t>(blocks) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  copy_kernel<<<1, kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(blocks), C, steps, out);
  return static_cast<int>(cudaGetLastError());
}

// E8 (mode 0) and E9 (mode 1): blocks [C, 16, 128], 8-byte aligned; ox
// and out [1024].
extern "C" int tpu_micro_leaf(int mode, const float* blocks, int C,
                              const float* ox, int steps, float* out,
                              void* stream) {
  if (C < 1 || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kLeafSmem:
      leaf_smem_kernel<<<1, kTile, 0, st>>>(
          reinterpret_cast<const float2*>(blocks), C, ox, steps, out);
      break;
    case kLeafLanes:
      leaf_lanes_kernel<<<1, kTile, 0, st>>>(blocks, C, ox, steps, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
