"""K17b (``csrc/tpu_micro.cu`` ``row_vote_kernel``) with the 32 group
partials summed by shuffles: after the step's barrier lane l of every warp
reads partial l and the warp runs ``block_sum``'s tree as an xor butterfly
of 5 shuffles (each lane the same bits: IEEE addition commutes), where the
package's form reads the slot as 8 float4 and adds them in registers. The
same function, bit for bit."""

FILE = "tpu_micro.cu"

PATCHES = [
    ("""    // every thread: the 32 partials as 8 float4 (broadcasts), block_sum's
    // tree over them in registers (offsets 16, 8, 4, 2, 1)
    const float4* q = reinterpret_cast<const float4*>(slot);
    float4 a0 = add4(q[0], q[4]), a1 = add4(q[1], q[5]);
    const float4 a2 = add4(q[2], q[6]), a3 = add4(q[3], q[7]);
    a0 = add4(add4(a0, a2), add4(a1, a3));
    const float total = (a0.x + a0.z) + (a0.y + a0.w);
""", """    float total = slot[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_xor_sync(kFull, total, off);
"""),
]
