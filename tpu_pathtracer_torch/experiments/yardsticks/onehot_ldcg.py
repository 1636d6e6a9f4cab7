"""K17c (``csrc/tpu_micro.cu`` ``onehot_kernel``) with the view read by
``__ldcg``, cached in the L2 only, as the first form read the table,
where the package's form reads it by ``__ldg`` through the L1 and the L2.
The same function, bit for bit."""

FILE = "tpu_micro.cu"

PATCHES = [
    ("""    const uint4 q = __ldg(view + idx);""",
     """    const uint4 q = __ldcg(view + idx);"""),
]
