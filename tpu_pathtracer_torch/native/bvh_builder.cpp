// Native BVH build-order computation.
//
// The reference's builder lives in an unshipped separate project and used
// median/split-axis partitioning (SURVEY §7 hard-part 4). This builder is
// better: binned surface-area-heuristic (SAH) splits, constrained to the
// implicit complete-heap layout the traversal kernels assume (a power-of-two
// leaf count, each leaf holding `prims_per_leaf` consecutive triangles).
//
// Exported C API (ctypes):
//   int bvh_build_order(const float* mins, const float* maxs, int num_tris,
//                       int num_leaves, int prims_per_leaf, long long* out);
// `out` has num_leaves*prims_per_leaf slots; receives the original triangle
// index for each padded slot, -1 for sentinel padding. Returns 0 on success.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Job {
  int lo, hi;    // index range into order[]
  int leaf0;     // first leaf covered by this subtree
  int nl;        // number of leaves in this subtree (power of two)
};

struct Box {
  float mn[3] = {1e30f, 1e30f, 1e30f};
  float mx[3] = {-1e30f, -1e30f, -1e30f};
  void grow(const float* lo, const float* hi) {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], lo[a]);
      mx[a] = std::max(mx[a], hi[a]);
    }
  }
  void grow(const Box& b) { grow(b.mn, b.mx); }
  float half_area() const {
    float dx = std::max(mx[0] - mn[0], 0.0f);
    float dy = std::max(mx[1] - mn[1], 0.0f);
    float dz = std::max(mx[2] - mn[2], 0.0f);
    return dx * dy + dy * dz + dz * dx;
  }
};

constexpr int kBins = 16;

}  // namespace

// ---------------------------------------------------------------------------
// Binned-SAH *binary* tree under the packet per-VISIT cost model — the native
// fast path for ops/bvh4.py's `_build_sah_binary` (the Python collapse to
// 4-wide nodes is cheap and stays shared). Same semantics: a leaf visit costs
// the full cluster width regardless of fill, so split costs count
// ceil(n/width) visits; leaves form when n <= width and splitting isn't
// cheaper (ct + ci*childcost/parent_area >= ci).
//
// Exported C API (ctypes):
//   int bvh4_build_binary(const float* v0, const float* v1, const float* v2,
//                         int num_tris, int width, int n_bins,
//                         float ci, float ct,
//                         float* bmin, float* bmax,   // [cap*3]
//                         long long* c0, long long* c1,       // [cap]
//                         long long* order,                   // [num_tris]
//                         long long* leaf_first, long long* leaf_count,
//                         long long* out_meta);  // [2]: n_nodes, max_depth
// cap = 2*num_tris node slots is always sufficient (every interior node has
// two children and every leaf holds >= 1 triangle). Returns 0 on success.

extern "C" int bvh4_build_binary(const float* v0f, const float* v1f,
                                 const float* v2f, int num_tris, int width,
                                 int n_bins, float ci, float ct, float* obmin,
                                 float* obmax, long long* oc0, long long* oc1,
                                 long long* oorder, long long* olf,
                                 long long* olc, long long* ometa) {
  if (num_tris < 1 || width < 1 || n_bins < 2 || n_bins > 64) return 1;
  const int T = num_tris;
  std::vector<float> tmin(3ull * T), tmax(3ull * T), cent(3ull * T);
  for (int i = 0; i < T; ++i) {
    for (int a = 0; a < 3; ++a) {
      const float lo = std::min(v0f[3 * i + a],
                                std::min(v1f[3 * i + a], v2f[3 * i + a]));
      const float hi = std::max(v0f[3 * i + a],
                                std::max(v1f[3 * i + a], v2f[3 * i + a]));
      tmin[3 * i + a] = lo;
      tmax[3 * i + a] = hi;
      cent[3 * i + a] = 0.5f * (lo + hi);
    }
  }

  std::vector<int> order(T);
  for (int i = 0; i < T; ++i) order[i] = i;

  struct SJob {
    int node, lo, hi, depth;
  };
  std::vector<SJob> stack;
  int n_nodes = 1;
  int n_ordered = 0;
  int max_depth = 0;
  stack.push_back({0, 0, T, 0});

  std::vector<double> bin_cost(n_bins);
  while (!stack.empty()) {
    SJob j = stack.back();
    stack.pop_back();
    const int n = j.hi - j.lo;
    max_depth = std::max(max_depth, j.depth);

    Box bb;
    for (int k = j.lo; k < j.hi; ++k) {
      const int t = order[k];
      bb.grow(&tmin[3 * t], &tmax[3 * t]);
    }
    for (int a = 0; a < 3; ++a) {
      obmin[3 * j.node + a] = bb.mn[a];
      obmax[3 * j.node + a] = bb.mx[a];
    }

    // best split over 3 axes x n_bins boundaries (child SAH visit cost)
    double best_cost = 1e38;
    int best_axis = -1, best_bin = -1;
    float lo_ax = 0.0f, inv_w = 0.0f;
    for (int axis = 0; axis < 3; ++axis) {
      float clo = 1e30f, chi = -1e30f;
      for (int k = j.lo; k < j.hi; ++k) {
        const float c = cent[3 * order[k] + axis];
        clo = std::min(clo, c);
        chi = std::max(chi, c);
      }
      if (chi - clo < 1e-12f) continue;
      const float iw = n_bins / (chi - clo);
      std::vector<Box> bins(n_bins);
      std::vector<int> counts(n_bins, 0);
      for (int k = j.lo; k < j.hi; ++k) {
        const int t = order[k];
        int b = (int)((cent[3 * t + axis] - clo) * iw);
        b = std::min(std::max(b, 0), n_bins - 1);
        bins[b].grow(&tmin[3 * t], &tmax[3 * t]);
        counts[b]++;
      }
      std::vector<Box> lacc(n_bins);
      std::vector<int> lcnt(n_bins);
      Box acc;
      int cnt = 0;
      for (int b = 0; b < n_bins; ++b) {
        acc.grow(bins[b]);
        cnt += counts[b];
        lacc[b] = acc;
        lcnt[b] = cnt;
      }
      Box racc;
      int rcnt = 0;
      for (int b = n_bins - 1; b >= 1; --b) {
        racc.grow(bins[b]);
        rcnt += counts[b];
        const int lc = lcnt[b - 1];
        if (lc == 0 || rcnt == 0) continue;
        // ceil(n/width) leaf VISITS, not triangle counts
        const double vl = (lc + width - 1) / width;
        const double vr = (rcnt + width - 1) / width;
        const double cost = (double)lacc[b - 1].half_area() * vl +
                            (double)racc.half_area() * vr;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
          lo_ax = clo;
          inv_w = iw;
        }
      }
    }

    const double parent_area = std::max((double)bb.half_area(), 1e-30);
    if (n <= width &&
        (best_axis < 0 || ct + ci * best_cost / parent_area >= ci)) {
      // leaf
      oc0[j.node] = -1;
      oc1[j.node] = 0;
      olf[j.node] = n_ordered;
      olc[j.node] = n;
      for (int k = 0; k < n; ++k) oorder[n_ordered + k] = order[j.lo + k];
      n_ordered += n;
      continue;
    }

    int mid;
    if (best_axis < 0) {
      // degenerate centroids: median halves on the widest axis
      int axis = 0;
      float w = -1.0f;
      for (int a = 0; a < 3; ++a) {
        const float d = bb.mx[a] - bb.mn[a];
        if (d > w) {
          w = d;
          axis = a;
        }
      }
      mid = j.lo + n / 2;
      std::nth_element(order.begin() + j.lo, order.begin() + mid,
                       order.begin() + j.hi, [&](int a, int b) {
                         return cent[3 * a + axis] < cent[3 * b + axis];
                       });
    } else {
      auto it = std::partition(order.begin() + j.lo, order.begin() + j.hi,
                               [&](int t) {
                                 int b = (int)((cent[3 * t + best_axis] -
                                                lo_ax) * inv_w);
                                 b = std::min(std::max(b, 0), n_bins - 1);
                                 return b < best_bin;
                               });
      mid = (int)(it - order.begin());
      if (mid == j.lo || mid == j.hi) mid = j.lo + n / 2;  // safety
    }

    const int l_id = n_nodes++;
    const int r_id = n_nodes++;
    oc0[j.node] = l_id;
    oc1[j.node] = r_id;
    stack.push_back({l_id, j.lo, mid, j.depth + 1});
    stack.push_back({r_id, mid, j.hi, j.depth + 1});
  }

  ometa[0] = n_nodes;
  ometa[1] = max_depth;
  return 0;
}

extern "C" int bvh_build_order(const float* mins, const float* maxs,
                               int num_tris, int num_leaves,
                               int prims_per_leaf, long long* out) {
  if (num_tris < 0 || num_leaves < 1 || prims_per_leaf < 1) return 1;
  const long long slots = (long long)num_leaves * prims_per_leaf;
  for (long long i = 0; i < slots; ++i) out[i] = -1;
  if (num_tris == 0) return 0;
  if ((long long)num_tris > slots) return 2;

  std::vector<int> order(num_tris);
  for (int i = 0; i < num_tris; ++i) order[i] = i;
  std::vector<float> cent(3ull * num_tris);
  for (int i = 0; i < num_tris; ++i)
    for (int a = 0; a < 3; ++a)
      cent[3 * i + a] = 0.5f * (mins[3 * i + a] + maxs[3 * i + a]);

  std::vector<Job> stack;
  stack.push_back({0, num_tris, 0, num_leaves});

  while (!stack.empty()) {
    Job j = stack.back();
    stack.pop_back();
    const int n = j.hi - j.lo;
    if (n <= 0) continue;
    if (j.nl == 1) {
      for (int k = 0; k < n; ++k)
        out[(long long)j.leaf0 * prims_per_leaf + k] = order[j.lo + k];
      continue;
    }

    // centroid bounds over the range
    Box cb;
    for (int k = j.lo; k < j.hi; ++k) {
      const float* c = &cent[3ull * order[k]];
      cb.grow(c, c);
    }

    int best_axis = -1;
    int best_bin = -1;
    float best_cost = 1e38f;
    float lo_axis[3], inv_w[3];
    for (int axis = 0; axis < 3; ++axis) {
      const float w = cb.mx[axis] - cb.mn[axis];
      lo_axis[axis] = cb.mn[axis];
      inv_w[axis] = w > 1e-12f ? kBins / w : 0.0f;
      if (w <= 1e-12f) continue;
      Box bins[kBins];
      int counts[kBins] = {0};
      for (int k = j.lo; k < j.hi; ++k) {
        const int t = order[k];
        int b = (int)((cent[3 * t + axis] - lo_axis[axis]) * inv_w[axis]);
        b = std::min(std::max(b, 0), kBins - 1);
        bins[b].grow(&mins[3 * t], &maxs[3 * t]);
        counts[b]++;
      }
      // sweep
      Box left_acc[kBins];
      int left_cnt[kBins];
      Box acc;
      int cnt = 0;
      for (int b = 0; b < kBins; ++b) {
        acc.grow(bins[b]);
        cnt += counts[b];
        left_acc[b] = acc;
        left_cnt[b] = cnt;
      }
      Box racc;
      int rcnt = 0;
      for (int b = kBins - 1; b >= 1; --b) {
        racc.grow(bins[b]);
        rcnt += counts[b];
        const int lc = left_cnt[b - 1];
        if (lc == 0 || rcnt == 0) continue;
        const float cost =
            left_acc[b - 1].half_area() * lc + racc.half_area() * rcnt;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }

    const int half_cap = (j.nl / 2) * prims_per_leaf;
    int mid;
    if (best_axis >= 0) {
      // partition by chosen bin boundary
      auto it = std::partition(
          order.begin() + j.lo, order.begin() + j.hi, [&](int t) {
            int b = (int)((cent[3 * t + best_axis] - lo_axis[best_axis]) *
                          inv_w[best_axis]);
            b = std::min(std::max(b, 0), kBins - 1);
            return b < best_bin;
          });
      mid = (int)(it - order.begin());
    } else {
      mid = j.lo + n / 2;  // degenerate: all centroids equal
    }

    // enforce complete-heap capacities: left gets at most half_cap, and at
    // least n - half_cap (so the right fits too)
    int left_n = mid - j.lo;
    int want_left = std::min(std::max(left_n, n - half_cap), half_cap);
    if (want_left != left_n) {
      // move the boundary by partially sorting along the split axis
      const int axis = best_axis >= 0 ? best_axis : 0;
      std::nth_element(order.begin() + j.lo, order.begin() + j.lo + want_left,
                       order.begin() + j.hi, [&](int a, int b) {
                         return cent[3 * a + axis] < cent[3 * b + axis];
                       });
      left_n = want_left;
    }

    stack.push_back({j.lo, j.lo + left_n, j.leaf0, j.nl / 2});
    stack.push_back({j.lo + left_n, j.hi, j.leaf0 + j.nl / 2, j.nl / 2});
  }
  return 0;
}
