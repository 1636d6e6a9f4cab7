"""K16 (``csrc/dual_probe.cu`` ``dual_kernel``) with its passes counted:
the same function, bit for bit, and beside it, in device globals that
the C entry ``dual_probe_trace`` reads back and zeroes, the loop pass at
which each ray was seated (0 for the first fill), each warp's passes
(the most any of its threads ran), and the wave's refill rounds and
claims from the counter. ``experiments/dual_probe.py`` ``trace`` reads
them."""

FILE = "dual_probe.cu"

PATCHES = [
    ("""namespace {

constexpr int kThreads = 128;
""",
     """namespace {

constexpr int kTraceRays = 1 << 19;   // rays whose seating pass is kept
constexpr int kTraceWarps = 1 << 13;  // warps whose passes are kept
__device__ int g_seat[kTraceRays];
__device__ int g_passes[kTraceWarps];
__device__ unsigned long long g_stat[2];  // refill rounds, claims

constexpr int kThreads = 128;
"""),
    ("""  bool more = R * lanes < n;  // warp-uniform: the counter may hold a ray
""",
     """  bool more = R * lanes < n;  // warp-uniform: the counter may hold a ray
  int pass = 0, rounds = 0, claims = 0;
"""),
    ("""      if (ball != 0u) {
        int base = 0;
""",
     """      ++rounds;
      if (ball != 0u) {
        int base = 0;
"""),
    ("""        if (lane == 0) base = atomicAdd(next, __popc(ball));
""",
     """        if (lane == 0) base = atomicAdd(next, __popc(ball));
        ++claims;
"""),
    ("""              s[r] = seated(j);
""",
     """              s[r] = seated(j);
              if (j < kTraceRays) g_seat[j] = pass;
"""),
    ("""    if (!alive) break;
""",
     """    if (!alive) {
      // no ballot follows a thread's exit: lane 0's rounds are its warp's
      if (g / 32 < kTraceWarps) atomicMax(&g_passes[g / 32], pass);
      if (lane == 0) {
        atomicAdd(&g_stat[0], static_cast<unsigned long long>(rounds));
        atomicAdd(&g_stat[1], static_cast<unsigned long long>(claims));
      }
      break;
    }
    ++pass;
"""),
    ("""extern "C" int dual_probe_shape(""",
     """// Copies the trace out (the seating pass of rays 0 .. n - 1, n at most
// kTraceRays; the passes of warps 0 .. warps - 1, at most kTraceWarps;
// g_stat) and zeroes it; 0 or a CUDA error.
extern "C" int dual_probe_trace(int* seat, int n, int* passes, int warps,
                                unsigned long long* stat) {
  if (n < 0 || n > kTraceRays || warps < 0 || warps > kTraceWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess && n > 0)
    e = cudaMemcpyFromSymbol(seat, g_seat, n * sizeof(int));
  if (e == cudaSuccess && warps > 0)
    e = cudaMemcpyFromSymbol(passes, g_passes, warps * sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(stat, g_stat, sizeof(g_stat));
  void* p = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_seat);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_seat));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_passes);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_passes));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_stat);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_stat));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}

extern "C" int dual_probe_shape("""),
]
