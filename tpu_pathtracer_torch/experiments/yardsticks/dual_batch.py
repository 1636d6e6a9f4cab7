"""K16 (``csrc/dual_probe.cu`` ``dual_kernel``) with a warp claiming 32
rays from the counter at a time by one atomic and handing them out over
its refill rounds, where the package's form claims, by one atomic a
round, as many rays as its lanes want. The same function, bit for bit.
"""

FILE = "dual_probe.cu"

PATCHES = [
    ("""  bool more = R * lanes < n;  // warp-uniform: the counter may hold a ray
  for (;;) {
    if (more) {""",
     """  bool more = R * lanes < n;  // warp-uniform: the counter may hold a ray
  int pool = 0, left = 0;     // warp-uniform: claimed, not yet seated
  for (;;) {
    if (more || left > 0) {"""),
    ("""      if (ball != 0u) {
        int base = 0;
        if (lane == 0) base = atomicAdd(next, __popc(ball));
        base = R * lanes + __shfl_sync(kFull, base, 0);
        more = base + __popc(ball) < n;
        const int j = base + __popc(ball & below);
""",
     """      if (ball != 0u) {
        const int k = __popc(ball);
        const int rank = __popc(ball & below);
        int j = rank < left ? pool + rank : n;
        if (k > left && more) {  // claim 32 rays
          int base = 0;
          if (lane == 0) base = atomicAdd(next, 32);
          base = R * lanes + __shfl_sync(kFull, base, 0);
          if (rank >= left) j = base + rank - left;
          more = base + 32 < n;
          pool = base + k - left;
          left = min(32 - (k - left), n - pool);
        } else {
          pool += k;
          left -= k;
        }
        left = max(left, 0);
"""),
]
