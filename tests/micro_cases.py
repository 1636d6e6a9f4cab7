"""The micro kernels' edge inputs, as numpy arrays: shared by the CPU tests
(``test_torch_tpu_micro.py``: the plain versions against the TPU kernels
of ``experiments/tpu_micro.py`` in interpret mode), the card's tests
(``test_torch_cuda.py``: the kernels against the plain versions),
``chip_smoke.py`` phase 16 and the A/Bs of
``tpu_pathtracer_torch/experiments/tpu_micro.py`` (both load this file by
its path). Imports no JAX. The TPU file fixes T = 16384 and the shapes
(8, 128) and (1, 256) inside its kernels (``experiments/tpu_micro.py``
:152, :252), so a case of another T or lane count (``PLAIN_ONLY``) is held
against the plain version only.

K18 (``copy_kernel``: E5's chain of 8 KB copies, the next block from the
copied data), ``COPY_CASES``:

  * ``negative``: row 0's first value -7.25 in every block but block 86,
    -1e10: int(acc[0]) runs -7, -14, -21 (remainders by 3 of -1, -2 and
    0: both branches of the floor mod) and then saturates at -2^31;
  * ``one_block``: C = 1, every step copies block 0;
  * ``one_step``: one copy.
``COPY_CASES[name]`` is the case's step count.

K17b (``row_vote_kernel``: E4's tile against row i, i by the vote on
sum(near) > 0), ``VOTE_CASES``, on the TPU file's rows and tile:

  * ``nan_row``: row 1 (the first step's) has word 3 NaN, so t0 and near
    are NaN on every lane (fmaxf would drop it), and so is every acc;
  * ``zero_inf``: row 1 has word 4 = 0 and lanes (0, 5) and (3, 77) of x
    are +inf and -inf: t1 = inf x 0 = NaN there;
  * ``nan_lane``: lane (2, 40) of x is NaN: near is NaN there every step
    and the vote always takes the (3i + 7) branch;
  * ``zero_near``: row 1's words 0-5 are 0, so near = +0 on every lane (x
    >= 0), the sum is +0 and the first vote takes the (3i + 7) branch;
  * ``seeded_0``, ``seeded_1``, ``seeded_17``: the TPU file's inputs at 0,
    1 and 17 steps;
  * ``t2`` (plain only): T = 2, the smallest the wrapper takes.

K17c (``onehot_kernel``: E7's one-hot fetch of 8 bf16-rounded columns),
``ONEHOT_CASES``, on the TPU file's table and (1, 256) lanes:

  * ``ties``: every value of columns 1-7 exactly halfway between two bf16
    values (low 16 bits 0x8000), both ways of ties to even;
  * ``bf16_max``: columns 1 and 2 hold +-0x7F7F7FFF (3.3961e38), the
    largest float32 that stays finite in bf16 (3.3895e38), in a quarter
    of their rows; acc overflows to +-inf in float32 as the sums grow;
  * ``neg_zero``: a quarter of every column's values are -0;
  * ``saturate``: column 0 holds +-3e9, so int(acc[0]) saturates at
    2^31 - 1 and -2^31;
  * ``t2_one_lane`` (plain only): T = 2 and 1 lane.

``REFUSED`` (E7 tables the wrapper refuses, ROADMAP C-20): a NaN, an inf,
and 3.4e38, which rounds to inf in bf16.

K17a (``gather_kernel``: E3's per-lane gather chain, both modes),
``GATHER_CASES`` (all plain only: the TPU file fixes (8, 16384) and
(8, 128)), each with an idx of T - 1 in the first and last lane of every
row; ``GATHER_SHAPES[name]`` is its (R, T, L):

  * ``t2``: T = 2 (8 B, a row under the bulk copy's 16 B grain), 32 lanes;
  * ``t32768``: T = 32,768, the wrapper's largest row in ``smem`` (a
    128 KB bulk copy), 1,024 lanes;
  * ``l32``, ``l1024``, ``l131072``: T = 16,384 at 32, 1,024 and 131,072
    lanes a row (one block of 32 and of 1,024 threads, 128 blocks of one
    row).
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


VOTE_CASES = {"nan_row": 17, "zero_inf": 17, "nan_lane": 17, "zero_near": 17,
              "seeded_0": 0, "seeded_1": 1, "seeded_17": 17, "t2": 17}
ONEHOT_CASES = {"ties": 17, "bf16_max": 17, "neg_zero": 17, "saturate": 17,
                "t2_one_lane": 17}
PLAIN_ONLY = ("t2", "t2_one_lane")
GATHER_SHAPES = {"t2": (2, 2, 32), "t32768": (2, 32_768, 1024),
                 "l32": (8, um.T, 32), "l1024": (1, um.T, 1024),
                 "l131072": (1, um.T, 131_072)}
GATHER_CASES = {name: 17 for name in GATHER_SHAPES}
# the last float32 below the tie that rounds bf16's largest finite value
# (0x7F7F) up to inf
BF16_MAX_F32 = np.array(0x7F7F7FFF, np.uint32).view(np.float32)
REFUSED = {"nan": np.float32("nan"), "inf": np.float32("inf"),
           "big": np.float32(3.4e38)}


def vote_case(name):
    """The case's (rows [T, 8], x (8, 128)), f32: the TPU file's E4 inputs
    changed as the case says."""
    rows, x = um._rand(0, (um.T, 8)), um._rand(1, (8, 128))
    if name == "nan_row":
        rows[1, 3] = np.nan
    elif name == "zero_inf":
        rows[1, 4] = 0.0
        x[0, 5], x[3, 77] = np.inf, -np.inf
    elif name == "nan_lane":
        x[2, 40] = np.nan
    elif name == "zero_near":
        rows[1, :6] = 0.0
    elif name == "t2":
        rows = rows[:2].copy()
    return rows, x


def onehot_case(name):
    """The case's (table [8, T] f32, idx [1, L] int32): the TPU file's E7
    inputs changed as the case says."""
    table = um._rand(0, (um.ROWS, um.T))
    idx = um._lanes((1, um.TPU_LANES["E7"]), um.TPU_LANES["E7"])
    rng = np.random.RandomState(7)
    quarter = rng.rand(um.ROWS, um.T) < 0.25
    if name == "ties":
        bits = table.view(np.uint32) & np.uint32(0xFFFF0000)
        table[1:] = (bits | np.uint32(0x8000)).view(np.float32)[1:]
    elif name == "bf16_max":
        sign = np.where(rng.rand(um.T) < 0.5, -1, 1).astype(np.float32)
        for c in (1, 2):
            table[c] = np.where(quarter[c], sign * BF16_MAX_F32, table[c])
    elif name == "neg_zero":
        table = np.where(quarter, np.float32(-0.0), table)
    elif name == "saturate":
        table[0] = np.where(rng.rand(um.T) < 0.5, -3e9, 3e9)
    elif name == "t2_one_lane":
        table, idx = table[:, :2].copy(), np.array([[1]], np.int32)
    return table.astype(np.float32), idx


def gather_case(name):
    """The case's (table [R, T] f32, idx [R, L] int32 in [0, T)) of
    ``GATHER_SHAPES``: the table ``RandomState(0).rand``, the indices
    ``RandomState(3)``, T - 1 in each row's first and last lane."""
    rows, t, lanes = GATHER_SHAPES[name]
    idx = np.random.RandomState(3).randint(0, t, (rows, lanes))
    idx[:, 0] = idx[:, -1] = t - 1
    return um._rand(0, (rows, t)), idx.astype(np.int32)


def refused_table(name):
    """The TPU file's E7 table with one value (row 5 of column 2) set to
    ``REFUSED[name]``."""
    table = um._rand(0, (um.ROWS, um.T))
    table[2, 5] = REFUSED[name]
    return table
