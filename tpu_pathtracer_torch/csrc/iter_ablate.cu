// The heap walk of bvh.cu (K5) in three ablated modes, for NVIDIA Hopper
// (sm_90a): the probe that splits K5's time into its node walk, its
// leaf-row fetch and its leaf arithmetic.
//
// Replaces the TPU kernel experiments/iter_ablate.py::_kernel_ablate (:60,
// through trace_ablate :125, pallas_call :140), which compiles the packet
// kernel in the same three modes.
//
// Contract. heap_kernel<kNearest, exact> of bvh.cu with closest held at
// the ray's t_max: no hit ever commits, so every mode visits the same
// nodes and leaves, and the per-ray counters (int32 [5, n], bvh.cu's) are
// equal across modes and to the plain walk's. A leaf visit does, by mode:
//   * kFull:   pt::mt_hit of every slot against closest, lane s of the
//              visit's kLeafLanes lanes taking slots s, s + kLeafLanes,
//              ...: the lane adds the t of its accepted slots in slot
//              order from 0, the pair's kLeafLanes partial sums are added
//              in a fixed __shfl_xor_sync tree (offsets 1, 2, 4, 8: all
//              lanes end with one value, float addition being
//              commutative), and the ray's acc += that sum;
//   * kNoMt:   the same three float4 rows of each slot loaded by the same
//              lanes and folded into an integer xor of their 32-bit words,
//              the lanes' xors folded by the same tree: no load can be
//              dropped and no float arithmetic remains;
//   * kNoLeaf: no row is loaded or tested; the visit keeps the leaf
//              phase's control flow (the wait, the batch, the broadcast of
//              the ray to the pair's lanes), then pops.
// acc [n] holds 32-bit words: the float sum (kFull), the xor (kNoMt) or 0
// (kNoLeaf). A ray with t_max <= 0 walks nothing.
//
// Design: bvh.cu's two phases, its nearest exact parameters. The leaf
// phase is a copy of bvh.cu's leaf_phase (:241, nearest mode), its merge
// of (t, slot) replaced by each mode's sum; the walk loop is
// heap_kernel's.
//   1. Node steps: one thread a ray (pt::heap_node_step).
//   2. Leaf visits by the warp: a thread whose walk reaches a leaf waits;
//      when kLeafBatch of the warp's threads wait, or none still walks
//      nodes, the warp tests the waiting (ray, leaf) pairs 32 / kLeafLanes
//      at a time, kLeafLanes lanes a pair, the ray's o, d, closest and
//      node taken from its thread by __shfl_sync.
// kLeafLanes 16, kLeafBatch 2 and 8 blocks of 128 an SM are bvh.cu's
// picks for nearest exact (its header: the A/B on the dragon-class knot).
//
// What the split means (python -m tpu_pathtracer_torch.experiments.
// iter_ablate): node walk = kNoLeaf's time, leaf-row fetch = kNoMt -
// kNoLeaf, leaf arithmetic = kFull - kNoMt. The wait and the batch (a
// leaf phase's selection, its 8 broadcasts, the pops and its ballots)
// are in kNoLeaf, so they land in the node walk: kNoMt - kNoLeaf is the
// rows' fetch and their xor tree alone, kFull - kNoMt the slot tests and
// the add tree instead of the xor. kNoLeaf and kNoMt fold the broadcast
// words they do not test into acc under a mask that is 0 at every launch
// but a kernel argument, so the compiler keeps those shuffles (an empty
// asm volatile does not: ptxas dropped them) at 4 integer instructions a
// round; chip_smoke.py phase 10d counts each mode's SHFL in the build's
// SASS. The modes visit more leaves than K5, which culls by its closest
// hit, so K5 is timed beside them.
//
// Measured (python -m tpu_pathtracer_torch.experiments.iter_ablate
// --frame parent=<commit 68d9d84's iter_ablate.cu, the first form: a
// thread a ray, its own loop over a leaf's slots> on an H100, device time
// a call in a CUDA graph, in turns with K5 and the first form; PERF.md):
// at K5's hit t on the dragon's 131,072 primary rays kFull takes 0.87x
// K5's time and 1/6.7 of the first form's; of it the node walk is 29%,
// the leaf-row fetch 42%, the leaf arithmetic 29% (the first form's: 3%,
// 42%, 55%). kNoLeaf takes 1.35x the first form's cut walk, which pops
// at once where this one batches.
//
// What bounds it: as bvh.cu, the walk's FP32 work (24 flops a node step,
// 37 a slot in kFull) and the distinct node and triangle rows its rays
// read; the rows are gathers the L2 serves. Built with -fmad=false and
// the plain version's operation order (iter_ablate.py), so kFull's sum is
// bit-equal to it.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

enum Mode : int { kFull = 0, kNoMt = 1, kNoLeaf = 2 };

constexpr int kThreads = 128;   // threads a block
constexpr int kMinBlocks = 8;   // resident blocks an SM
constexpr int kLeafLanes = 16;  // lanes that test one (ray, leaf) pair
constexpr int kLeafBatch = 2;   // pending leaves that start a leaf phase
constexpr unsigned kAll = 0xffffffffu;

// One ray's walk state: a thread's own.
struct Ray {
  float o1, o2, o3, d1, d2, d3, i1, i2, i3;
  bool n1, n2, n3;
  float closest;     // held: no hit commits
  unsigned idx, bs;  // the heap node (0: done) and the bitstack
  float acc;         // kFull
  unsigned bits;     // kNoMt
  int nb, nsg, nl, steps;
};

__device__ __forceinline__ unsigned fold(const float4 a) {
  return __float_as_uint(a.x) ^ __float_as_uint(a.y) ^ __float_as_uint(a.z) ^
         __float_as_uint(a.w);
}

// The warp's pending leaf visits (lanes in `todo`), kLeafLanes lanes a
// visit, 32 / kLeafLanes visits at a time. Warp-uniform: every lane calls
// it.
template <int MODE>
__device__ __forceinline__ void leaf_phase(Ray& r, unsigned todo,
                                           const float4* __restrict__ tri,
                                           unsigned first_leaf, int P,
                                           float t_min, unsigned keep) {
  constexpr int L = kLeafLanes;
  static_assert(L == 4 || L == 8 || L == 16 || L == 32,
                "a leaf's lanes divide the warp");
  const int lane = threadIdx.x & 31;
  const int g = lane / L;  // the lane's part of the warp
  const int s = lane % L;  // its slot residue
  while (todo) {
    // part g takes the (g+1)-th pending lane
    unsigned m = todo;
#pragma unroll
    for (int x = 0; x < 32 / L - 1; ++x)
      if (x < g) m &= m - 1u;
    const bool mine = m != 0u;
    const int q = mine ? __ffs(m) - 1 : lane;
    const float o1 = __shfl_sync(kAll, r.o1, q);
    const float o2 = __shfl_sync(kAll, r.o2, q);
    const float o3 = __shfl_sync(kAll, r.o3, q);
    const float d1 = __shfl_sync(kAll, r.d1, q);
    const float d2 = __shfl_sync(kAll, r.d2, q);
    const float d3 = __shfl_sync(kAll, r.d3, q);
    const float closest = __shfl_sync(kAll, r.closest, q);
    const unsigned idx = __shfl_sync(kAll, r.idx, q);
    // the owner's place among the pending lanes: the part that tests it
    const int rank = __popc(todo & ((1u << lane) - 1u));
    const bool owner = ((todo >> lane) & 1u) && rank < 32 / L;
    const int from = (owner ? rank : 0) * L;
    // what the mode does not test of the broadcast, folded and masked by
    // keep (0 at every launch, which the compiler cannot know): the
    // shuffles stay, and acc does not change
    const unsigned kept =
        (__float_as_uint(o1) ^ __float_as_uint(o2) ^ __float_as_uint(o3) ^
         __float_as_uint(d1) ^ __float_as_uint(d2) ^ __float_as_uint(d3) ^
         __float_as_uint(closest) ^ idx) &
        keep;
    if constexpr (MODE == kNoLeaf) {
      if (owner) r.bits ^= kept;
    } else {
      const float4* row =
          mine ? tri + 3 * static_cast<size_t>(idx - first_leaf) *
                           static_cast<size_t>(P)
               : tri;
      if constexpr (MODE == kFull) {
        float part = 0.f;
        if (mine) {
#pragma unroll 1
          for (int k = s; k < P; k += L) {
            float t, u, v;
            if (pt::mt_hit<false>(__ldg(row + 3 * k), __ldg(row + 3 * k + 1),
                                  __ldg(row + 3 * k + 2), o1, o2, o3, d1,
                                  d2, d3, t_min, closest, t, u, v))
              part += t;
          }
        }
#pragma unroll
        for (int off = 1; off < L; off <<= 1)
          part += __shfl_xor_sync(kAll, part, off);
        const float sum = __shfl_sync(kAll, part, from);
        if (owner) r.acc += sum;
      } else {
        unsigned x = 0u;
        if (mine) {
#pragma unroll 1
          for (int k = s; k < P; k += L)
            x ^= fold(__ldg(row + 3 * k)) ^ fold(__ldg(row + 3 * k + 1)) ^
                 fold(__ldg(row + 3 * k + 2));
        }
#pragma unroll
        for (int off = 1; off < L; off <<= 1)
          x ^= __shfl_xor_sync(kAll, x, off);
        const unsigned sum = __shfl_sync(kAll, x, from);
        if (owner) r.bits ^= sum ^ kept;
      }
    }
    if (owner) {
      ++r.nl;
      pt::pop_bitstack(r.bs, r.idx);
    }
    todo &= ~__ballot_sync(kAll, owner);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ablate_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
              const float* __restrict__ oz, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const float* __restrict__ tmax,
              const float4* __restrict__ nodes,
              const float4* __restrict__ tri, unsigned first_leaf, int P,
              float t_min, int n, unsigned keep,
              unsigned* __restrict__ acc_out, int* __restrict__ cnt) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool has = j < n;
  const int i = has ? j : 0;
  Ray r;
  r.o1 = ox[i]; r.o2 = oy[i]; r.o3 = oz[i];
  r.d1 = dx[i]; r.d2 = dy[i]; r.d3 = dz[i];
  r.closest = tmax[i];
  r.i1 = 1.0f / r.d1; r.i2 = 1.0f / r.d2; r.i3 = 1.0f / r.d3;
  r.n1 = r.i1 < 0.f; r.n2 = r.i2 < 0.f; r.n3 = r.i3 < 0.f;
  r.idx = has && r.closest > 0.f ? 1u : 0u;
  r.bs = 1u;
  r.acc = 0.f;
  r.bits = 0u;
  r.nb = r.nsg = r.nl = r.steps = 0;
  for (;;) {
    const bool walking = r.idx != 0u && r.idx < first_leaf;
    const unsigned pend = __ballot_sync(kAll, r.idx >= first_leaf);
    const unsigned walk = __ballot_sync(kAll, walking);
    if ((pend | walk) == 0u) break;
    if (pend != 0u && (walk == 0u || __popc(pend) >= kLeafBatch)) {
      leaf_phase<MODE>(r, pend, tri, first_leaf, P, t_min, keep);
    } else if (walking) {
      ++r.steps;
      pt::heap_node_step(nodes, r.idx, r.bs, r.closest, r.o1, r.o2, r.o3,
                         r.i1, r.i2, r.i3, r.n1, r.n2, r.n3, r.nb, r.nsg);
    }
  }
  if (has) {
    acc_out[i] = MODE == kFull ? __float_as_uint(r.acc) : r.bits;
    cnt[i] = r.nb;
    cnt[n + i] = r.nsg;
    cnt[2 * n + i] = r.nl;
    cnt[3 * n + i] = 0;
    cnt[4 * n + i] = r.steps;
  }
}

}  // namespace

// Launches one mode (0 full, 1 nomt, 2 noleaf) on `stream`; returns
// cudaGetLastError() (0 = launched). nodes is [2*first_leaf, 8] f32, tri
// [T, 12] f32 (bvh.cu's tables, 16-byte aligned); acc is [n] 32-bit words,
// cnt [5, n] int32.
extern "C" int iter_ablate_launch(int mode, const float* ox, const float* oy,
                                  const float* oz, const float* dx,
                                  const float* dy, const float* dz,
                                  const float* tmax, const float* nodes,
                                  const float* tri, int first_leaf, int P,
                                  float t_min, int n, unsigned* acc, int* cnt,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (first_leaf < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* tb = reinterpret_cast<const float4*>(tri);
  const unsigned fl = static_cast<unsigned>(first_leaf);
  switch (mode) {
    case kFull:
      ablate_kernel<kFull><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, 0u, acc, cnt);
      break;
    case kNoMt:
      ablate_kernel<kNoMt><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, 0u, acc, cnt);
      break;
    case kNoLeaf:
      ablate_kernel<kNoLeaf><<<grid, kThreads, 0, st>>>(
          ox, oy, oz, dx, dy, dz, tmax, nd, tb, fl, P, t_min, n, 0u, acc, cnt);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
