"""K19/K20's edge inputs (``csrc/tpu_micro.cu`` ``leaf_smem_kernel`` and
``leaf_lanes_kernel``: E8/E9's chain of 128-triangle leaves, the next
cluster from lane (0, 0)'s best), as numpy clusters and lanes: shared by
the CPU tests (``test_torch_tpu_micro.py``: the plain version against
E8's and E9's TPU kernels in interpret mode) and the card's tests
(``test_torch_cuda.py``: the kernels against the plain version at every
split the source allows). Imports no JAX.

  * ``ray0_misses``: every triangle ray 0 accepts in clusters 0, 2, 12
    and 62 (the chain while it misses: int(1e30) = 2^31 - 1, whose
    remainder by 3 is 1) made flat (e1 = e2 = 0: u = 0, never accepted),
    so the chain runs on 2^31 - 1 for four leaves and then leaves it;
  * ``tie``: ray 0's winner in cluster 0 (triangle 99) copied to
    triangles 100, 107 and 35 (w + 1, w + 8, w + 64 mod 128): four
    triangles share its least t, on different lanes of every split;
  * ``flat``: triangle 33 of cluster 0 with e1z set so that e1 is
    orthogonal to lane 1's h: |a| < 1e-7 (-4.7e-10), f = 1, and the
    test accepts t = 0.00209, lane 1's least in cluster 0;
  * ``t_min``: triangle 85 of cluster 0 with e1x set so that lane 29's t
    is 0.001 exactly (u, v and u + v accept): excluded by t > 0.001;
  * ``one_cluster``: C = 1, every leaf is cluster 0;
  * ``zero_steps`` and ``one_step``: the seeded inputs at 0 and 1 leaves.
``LEAF_CASES[name]`` is the case's step count.
"""

import numpy as np
import torch

from tpu_pathtracer_torch.experiments import tpu_micro as um

LEAF_CASES = {"ray0_misses": 6, "tie": 3, "flat": 3, "t_min": 2,
              "one_cluster": 4, "zero_steps": 0, "one_step": 1}
MISS_CHAIN = (0, 2, 12, 62)
TIE_W, TIE_COPIES = 99, (100, 107, 35)
T_MIN_LANE, T_MIN_W = 29, 85
T_MIN_E1X = np.uint32(0x3F0EA5A1).view(np.float32)  # 0.5572148
FLAT_LANE, FLAT_W = 1, 33
FLAT_E1Z = np.uint32(0x3CC21475).view(np.float32)  # 0.023691395


def _accepted(blocks, x, c, lane):
    """The triangles of cluster ``c`` that lane ``lane`` accepts (the
    plain version's test)."""
    ox = torch.from_numpy(x.reshape(-1)[lane:lane + 1].copy())
    _, ok = um.mt_ish(ox, torch.from_numpy(blocks[c, :um.TRI_WORDS]))
    return np.nonzero(ok[:, 0].numpy())[0]


def leaf_case(name):
    """(blocks [C, 16, 128] f32, ox (8, 128) f32, steps) of the case: the
    TPU file's E8/E9 inputs (``RandomState(0)`` clusters,
    ``RandomState(1)`` lanes) changed as the case says."""
    blocks = um._rand(0, (um.LEAF_CLUSTERS, *um.BLOCK))
    x = um._rand(1, (8, 128))
    if name == "ray0_misses":
        for c in MISS_CHAIN:
            blocks[c, 3:9, _accepted(blocks, x, c, 0)] = 0.0
    elif name == "tie":
        blocks[0][:, list(TIE_COPIES)] = blocks[0][:, [TIE_W]]
    elif name == "flat":
        blocks[0, 5, FLAT_W] = FLAT_E1Z
    elif name == "t_min":
        blocks[0, 3, T_MIN_W] = T_MIN_E1X
    elif name == "one_cluster":
        blocks = blocks[:1].copy()
    return blocks, x, LEAF_CASES[name]
