"""K16 (``csrc/dual_probe.cu`` ``dual_kernel``) with every ray taken from
the counter, the first ones too: the wave starts with its slots free and
fills one slot a lane a loop pass by the refill round (its ballot and one
atomic a warp), where the package's form seats the first R rays of each
lane with no counter. The same function, bit for bit."""

FILE = "dual_probe.cu"

PATCHES = [
    ("""    const int j = r * lanes + g;
    s[r] = j < n ? seated(j) : Slot{};
""",
     """    s[r] = Slot{};  // free: every ray comes from the counter
"""),
    ("""  bool more = R * lanes < n;  // warp-uniform: the counter may hold a ray
""",
     """  bool more = true;  // n > 0: the counter holds a ray
"""),
    ("""        base = R * lanes + __shfl_sync(kFull, base, 0);""",
     """        base = __shfl_sync(kFull, base, 0);"""),
]
