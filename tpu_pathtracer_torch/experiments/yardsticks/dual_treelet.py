"""K16 (``csrc/dual_probe.cu`` ``dual_kernel``) with the heap's top
levels staged once a block in shared memory: rows [2, 2^(K+1)) of the
node table (the children of nodes 1 to 2^K - 1; K = 9, 32 KB) by one
bulk copy on an mbarrier, and a step at a node above level K reading its
children there instead of by ``__ldg``. The same function, bit for bit.
"""

FILE = "dual_probe.cu"

PATCHES = [
    ("""#include "bvh_common.cuh"
""",
     """#include "bulk_copy.cuh"
#include "bvh_common.cuh"
"""),
    ("""constexpr unsigned kFull = 0xffffffffu;
""",
     """constexpr unsigned kFull = 0xffffffffu;
constexpr int kTopLevels = 9;  // nodes 1 .. 2^K - 1 read from shared memory
"""),
    ("""template <int R>
__global__ void""",
     """// The children of a node above level kTopLevels, from the block's copy
// of rows [2, 2^(kTopLevels + 1)) (top[4 ..]).
__device__ __forceinline__ Children top_children(const float4* top,
                                                 unsigned idx) {
  const unsigned l = idx << 1;
  return {top[2 * l], top[2 * l + 1], top[2 * l + 2], top[2 * l + 3]};
}

template <int R>
__global__ void"""),
    ("""  // the first fill, with no counter: slot r takes ray r * lanes + g; the
""",
     """  __shared__ __align__(16) float4 top[4 << kTopLevels];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    const unsigned end = min(2u << kTopLevels, 2u * first_leaf);
    pt::bar_init(&bar, 1);
    pt::bar_init_fence();
    if (end > 2u) {
      pt::arrive_expect_tx(&bar, (end - 2u) * 32u);
      pt::bulk_copy(top + 4, nodes + 4, (end - 2u) * 32u, &bar);
    } else {
      pt::bar_arrive(&bar);
    }
  }
  __syncthreads();
  pt::bar_wait(&bar, 0);
  // the first fill, with no counter: slot r takes ray r * lanes + g; the
"""),
    ("""      c[r] = children(nodes, step[r] ? s[r].idx : 0u);""",
     """      const unsigned at = step[r] ? s[r].idx : 0u;
      c[r] = at < (1u << kTopLevels) ? top_children(top, at)
                                     : children(nodes, at);"""),
]
