"""K17a (``csrc/tpu_micro.cu`` ``gather_kernel``) with its gather taken
out: a step adds a float built from idx's bits by one integer operation
(idx | 0x3f800000, a value in [1, 2)) instead of the loaded one, so the
chain is the step's arithmetic alone (LOP3, FADD, F2I, IMAD, LOP3) and
the conversion pipe's share of a step is read, not assumed. Another
function: an A/B times it under a name that starts with ``diag_``,
without the check."""

FILE = "tpu_micro.cu"

PATCHES = [
    ("""    acc += kMode == kSmem ? srow[idx] : __ldcg(row + idx);""",
     """    acc += __uint_as_float(idx | 0x3f800000u);"""),
]
