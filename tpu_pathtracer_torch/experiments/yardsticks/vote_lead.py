"""K17b (``csrc/tpu_micro.cu`` ``row_vote_kernel``) with the next row a
step ahead: once i is known, every thread loads the 6 used words of both
candidate rows, (5i + 1) % T and (3i + 7) % T, beside the step's slab work
and vote, and the vote selects one; the row's words never wait on a load
after the vote. The same function, bit for bit."""

FILE = "tpu_micro.cu"

PATCHES = [
    ("""  int i = 1;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
""", """  int i = 1;
  float cur[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) cur[k] = __ldg(rows + kRowW + k);
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
"""),
    ("""    asm volatile("" : "+r"(up), "+r"(down));
    const float* r = rows + static_cast<size_t>(i) * kRowW;
    const float r0 = __ldg(r + 0), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
    const float r3 = __ldg(r + 3), r4 = __ldg(r + 4), r5 = __ldg(r + 5);
""", """    asm volatile("" : "+r"(up), "+r"(down));
    float nu[6], nd[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      nu[k] = __ldg(rows + static_cast<size_t>(up) * kRowW + k);
      nd[k] = __ldg(rows + static_cast<size_t>(down) * kRowW + k);
    }
    const float r0 = cur[0], r1 = cur[1], r2 = cur[2];
    const float r3 = cur[3], r4 = cur[4], r5 = cur[5];
"""),
    ("""    i = total > 0.f ? up : down;
  }
""", """    i = total > 0.f ? up : down;
#pragma unroll
    for (int k = 0; k < 6; ++k) cur[k] = total > 0.f ? nu[k] : nd[k];
  }
"""),
]
