"""K17b (``csrc/tpu_micro.cu`` ``row_vote_kernel``) with the next row by
``%``, as the first form wrote it: the compiler then selects the
numerator, 5i + 1 or 3i + 7, after the vote and divides there, so an
integer division stands on the chain of every step. The same function,
bit for bit."""

FILE = "tpu_micro.cu"

PATCHES = [
    ("""  const float inv = 1.0f / static_cast<float>(T);
  int i = 1;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    // both candidates by a division-free mod, which ptxas schedules in the
    // vote's shadow: left to itself the compiler selects the numerator
    // after the vote and runs an integer division there, on the chain
    int up = mod_small(i * 5 + 1, T, inv);
    int down = mod_small(i * 3 + 7, T, inv);
    asm volatile("" : "+r"(up), "+r"(down));
""", """  int i = 1;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int up = (i * 5 + 1) % T, down = (i * 3 + 7) % T;
"""),
]
