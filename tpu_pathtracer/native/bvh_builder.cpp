// Native BVH build-order computation.
//
// The reference's builder lives in an unshipped separate project and used
// median/split-axis partitioning (SURVEY §7 hard-part 4). This builder is
// better: binned surface-area-heuristic (SAH) splits, constrained to the
// implicit complete-heap layout the traversal assumes (a power-of-two
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
