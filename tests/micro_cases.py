"""K18's edge inputs (``csrc/tpu_micro.cu`` ``copy_kernel``: E5's chain of
8 KB copies, the next block from the copied data), as numpy blocks:
shared by the CPU tests (``test_torch_tpu_micro.py``: the plain version
against E5's TPU kernel in interpret mode) and the card's tests
(``test_torch_cuda.py``: the kernel against the plain version). Imports
no JAX.

  * ``negative``: row 0's first value -7.25 in every block but block 86,
    -1e10: int(acc[0]) runs -7, -14, -21 (remainders by 3 of -1, -2 and
    0: both branches of the floor mod) and then saturates at -2^31;
  * ``one_block``: C = 1, every step copies block 0;
  * ``one_step``: one copy.
``COPY_CASES[name]`` is the case's step count.
"""

import numpy as np

from tpu_pathtracer_torch.experiments import tpu_micro as um

COPY_CASES = {"negative": 17, "one_block": 5, "one_step": 1}


def copy_blocks(name):
    """The case's blocks, [C, 16, 128] f32: the TPU file's E5 blocks
    (``RandomState(0)``) changed as the case says."""
    blocks = um._rand(0, (um.COPY_BLOCKS, *um.BLOCK))
    if name == "negative":
        blocks[:, 0, 0] = -7.25
        blocks[86, 0, 0] = -1e10
    elif name == "one_block":
        blocks = blocks[:1].copy()
    return blocks


def chain_ints(blocks, steps):
    """int(acc[0]) after each step, truncated and saturated as the kernel
    converts it, along the chain of blocks."""
    c, acc, out = 0, np.float32(0.0), []
    for _ in range(steps):
        acc = np.float32(acc + blocks[c, 0, 0])
        i = int(np.clip(np.trunc(np.float64(acc)), -2 ** 31, 2 ** 31 - 1))
        out.append(i)
        c = (c * 5 + i % 3 + 1) % blocks.shape[0]
    return out
