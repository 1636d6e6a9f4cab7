"""K16 (``csrc/dual_probe.cu`` ``dual_kernel``) with a pass in three
stages, each a branch a slot: every slot's fresh ray loaded, then the
slab tests of every slot that steps, then every slot advanced, where the
package's form loads, tests and advances a slot behind one branch. The
same function, bit for bit."""

FILE = "dual_probe.cu"

PATCHES = [
    ("""    // consume: a slot that steps loads a fresh ray's origin and direction,
    // tests both children and advances (pt::heap_node_step's descent); a
    // ray that stands on a leaf pops; a ray that ends writes its count
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Slot& q = s[r];
      if (q.idx == 0u) continue;
      if (step[r]) {
        if (q.fresh) load_ray(q, ox, oy, oz, dx, dy, dz);
        const float lhit = pt::slab_entry(c[r].la.x, c[r].la.y, c[r].la.z,
                                          c[r].la.w, c[r].lb.x, c[r].lb.y,
                                          q.o1, q.o2, q.o3, q.i1, q.i2, q.i3,
                                          q.n1, q.n2, q.n3, closest);
        const float rhit = pt::slab_entry(c[r].ra.x, c[r].ra.y, c[r].ra.z,
                                          c[r].ra.w, c[r].rb.x, c[r].rb.y,
                                          q.o1, q.o2, q.o3, q.i1, q.i2, q.i3,
                                          q.n1, q.n2, q.n3, closest);
        ++q.steps;
        const unsigned l = q.idx << 1;
        const bool tl = lhit < closest;
        const bool tr = rhit < closest;
        const unsigned child = l + (rhit < lhit ? 1u : 0u);
        if (tl && tr) {
          q.idx = child;
          q.bs = (q.bs << 1) | 1u;
        } else if (tl || tr) {
          q.idx = child;
          q.bs <<= 1;
        } else {
          pt::pop_bitstack(q.bs, q.idx);
        }
      } else {
        pt::pop_bitstack(q.bs, q.idx);
      }
      if (q.idx == 0u) steps_out[q.ray] = q.steps;
    }
""",
     """#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (step[r] && s[r].fresh) load_ray(s[r], ox, oy, oz, dx, dy, dz);
    }
    float lhit[R], rhit[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!step[r]) continue;
      lhit[r] = pt::slab_entry(c[r].la.x, c[r].la.y, c[r].la.z, c[r].la.w,
                               c[r].lb.x, c[r].lb.y, s[r].o1, s[r].o2,
                               s[r].o3, s[r].i1, s[r].i2, s[r].i3, s[r].n1,
                               s[r].n2, s[r].n3, closest);
      rhit[r] = pt::slab_entry(c[r].ra.x, c[r].ra.y, c[r].ra.z, c[r].ra.w,
                               c[r].rb.x, c[r].rb.y, s[r].o1, s[r].o2,
                               s[r].o3, s[r].i1, s[r].i2, s[r].i3, s[r].n1,
                               s[r].n2, s[r].n3, closest);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Slot& q = s[r];
      if (q.idx == 0u) continue;
      if (!step[r]) {
        pt::pop_bitstack(q.bs, q.idx);
      } else {
        ++q.steps;
        const unsigned l = q.idx << 1;
        const bool tl = lhit[r] < closest;
        const bool tr = rhit[r] < closest;
        const unsigned child = l + (rhit[r] < lhit[r] ? 1u : 0u);
        if (tl && tr) {
          q.idx = child;
          q.bs = (q.bs << 1) | 1u;
        } else if (tl || tr) {
          q.idx = child;
          q.bs <<= 1;
        } else {
          pt::pop_bitstack(q.bs, q.idx);
        }
      }
      if (q.idx == 0u) steps_out[q.ray] = q.steps;
    }
"""),
]
