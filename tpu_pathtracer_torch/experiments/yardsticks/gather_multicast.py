"""K17a's ``smem`` mode (``csrc/tpu_micro.cu`` ``gather_kernel``) with a
row's blocks in one thread-block cluster (up to 8, the largest power of
two that divides the row's blocks) fed by one
``cp.async.bulk .multicast::cluster`` of the row, issued by the cluster's
block 0 once every block's mbarrier is initialised (a cluster barrier),
instead of one bulk copy a block: at 131,072 lanes a row's 16 blocks
each copy the same 64 KB. A row under the copy's 16 B grain is staged by
each block itself. The same function, bit for bit."""

FILE = "tpu_micro.cu"

PATCHES = [
    ("""#include <cuda_bf16.h>
""",
     """#include <cooperative_groups.h>
#include <cuda_bf16.h>
"""),
    ("""  if (kMode == kSmem) {
    if (threadIdx.x == 0) {
      pt::bar_init(&full, 1);
      pt::bar_init_fence();
      stage_row(srow, row, T, &full);
    }
    __syncthreads();  // publishes the mbarrier's init; the copy is in flight
  }
""",
     """  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (kMode == kSmem) {
    const unsigned bytes = static_cast<unsigned>(T) * 4u;
    if (threadIdx.x == 0) {
      pt::bar_init(&full, 1);
      pt::bar_init_fence();
    }
    cluster.sync();  // every block's mbarrier initialised, before the copy
    if (threadIdx.x == 0) {
      if (bytes % 16u != 0u) {
        stage_row(srow, row, T, &full);
      } else {
        pt::arrive_expect_tx(&full, bytes);
        if (cluster.block_rank() == 0) {
          const unsigned short ctas =
              static_cast<unsigned short>((1u << cluster.num_blocks()) - 1u);
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes.multicast::cluster [%0], [%1], %2, [%3], %4;\\n" ::"r"(
                  pt::smem(srow)),
              "l"(row), "r"(bytes), "r"(pt::smem(&full)), "h"(ctas)
              : "memory");
        }
      }
    }
  }
"""),
    ("""  out[lane] = acc;
}

// K17c's view""",
     """  out[lane] = acc;
  if (kMode == kSmem) cluster.sync();  // no block leaves its cluster early
}

// K17c's view"""),
    ("""    gather_kernel<kSmem><<<grid, threads, smem, st>>>(table, idx, T, L, steps,
                                                     out);
""",
     """    unsigned cl = 8;
    while (grid.x % cl) cl /= 2;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t k = cudaLaunchKernelEx(&cfg, gather_kernel<kSmem>, table,
                                             idx, T, L, steps, out);
    if (k != cudaSuccess) return static_cast<int>(k);
"""),
]
