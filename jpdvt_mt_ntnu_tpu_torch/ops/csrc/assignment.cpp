// Batched assignment solvers for permutation recovery, on the host.
//
// The port's own copy of native/src/assignment.cpp (jn_greedy_batch,
// jn_hungarian_batch), built by ops/_build.py with g++ at first use:
//  - jp_greedy_batch: the reference's greedy column scan (for each
//    canonical slot, the remaining piece of least distance, first index on
//    ties; image_model/inference.py:113-125), then argsort -> pred;
//  - jp_hungarian_batch: the O(n^3) Hungarian method (potentials and
//    shortest augmenting paths), the optimal assignment.
//
// C ABI, float32 row-major dist[b][n][n]; out_pred[b][n] is the slot
// assigned to each piece (the convention of assignment.greedy_permutation).

#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

void greedy_one(const float* dist, int n, int32_t* pred) {
  std::vector<double> d(dist, dist + static_cast<long>(n) * n);
  std::vector<int32_t> order(n);
  for (int col = 0; col < n; ++col) {
    int best = 0;
    double best_v = kInf;
    for (int row = 0; row < n; ++row) {
      const double v = d[static_cast<long>(row) * n + col];
      if (v < best_v) {  // strict: the first index wins a tie, as argmin
        best_v = v;
        best = row;
      }
    }
    order[col] = best;
    for (int j = 0; j < n; ++j) d[static_cast<long>(best) * n + j] = 1e9;
  }
  for (int col = 0; col < n; ++col) pred[order[col]] = col;  // argsort(order)
}

void hungarian_one(const float* a, int n, int32_t* pred) {
  // 1-indexed internals: p[j] is the row matched to column j, way[j] the
  // previous column on the augmenting path.
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  std::vector<int> p(n + 1, 0), way(n + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(n + 1, kInf);
    std::vector<char> used(n + 1, 0);
    do {
      used[j0] = 1;
      const int i0 = p[j0];
      int j1 = -1;
      double delta = kInf;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        const double cur =
            static_cast<double>(a[static_cast<long>(i0 - 1) * n + (j - 1)]) - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= n; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      const int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int j = 1; j <= n; ++j)
    if (p[j]) pred[p[j] - 1] = j - 1;
}

}  // namespace

extern "C" {

void jp_greedy_batch(const float* dist, int batch, int n, int32_t* out_pred) {
  for (int b = 0; b < batch; ++b)
    greedy_one(dist + static_cast<long>(b) * n * n, n, out_pred + static_cast<long>(b) * n);
}

void jp_hungarian_batch(const float* dist, int batch, int n, int32_t* out_pred) {
  for (int b = 0; b < batch; ++b)
    hungarian_one(dist + static_cast<long>(b) * n * n, n, out_pred + static_cast<long>(b) * n);
}

}  // extern "C"
