// Linear sum assignment (min-cost bipartite matching) via the
// Jonker-Volgenant shortest-augmenting-path algorithm, O(n^3): the exact
// solver of the set-prediction matcher's "hungarian" arm and of the tracker
// baseline. Plain C++ with a C ABI, built with g++ at first use by
// ops/_kernels.py::host_library and loaded by ops/native_lap.py.
//
// Contract: rows <= cols (the caller transposes otherwise). Each row is
// assigned a distinct column minimizing the total cost. Returns 0 on
// success (the assigned column of each row written into col_of_row), 1 on
// bad sizes, 2 when no finite assignment exists.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" int lap_solve(int nr, int nc, const double* cost, int32_t* col_of_row) {
  if (nr < 0 || nc < 0 || nr > nc) return 1;
  if (nr == 0) return 0;

  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(nr, 0.0), v(nc, 0.0);  // dual potentials
  std::vector<int> row_of_col(nc, -1);
  for (int i = 0; i < nr; ++i) col_of_row[i] = -1;

  std::vector<double> dist(nc);
  std::vector<int> pred_row(nc);  // row from which each column was reached
  std::vector<char> done(nc);

  for (int i0 = 0; i0 < nr; ++i0) {
    std::fill(dist.begin(), dist.end(), INF);
    std::fill(pred_row.begin(), pred_row.end(), -1);
    std::fill(done.begin(), done.end(), 0);

    int i = i0;
    int sink = -1;
    double min_dist = 0.0;
    while (sink == -1) {
      const double* cost_i = cost + static_cast<size_t>(i) * nc;
      double best = INF;
      int best_j = -1;
      for (int j = 0; j < nc; ++j) {
        if (done[j]) continue;
        const double d = min_dist + cost_i[j] - u[i] - v[j];
        if (d < dist[j]) {
          dist[j] = d;
          pred_row[j] = i;
        }
        if (dist[j] < best) {
          best = dist[j];
          best_j = j;
        }
      }
      if (best_j < 0 || best == INF) return 2;  // infeasible
      done[best_j] = 1;
      min_dist = best;
      if (row_of_col[best_j] < 0) {
        sink = best_j;
      } else {
        i = row_of_col[best_j];
      }
    }

    // Update dual potentials for the alternating tree (before augmenting, so
    // row_of_col still describes the old matching).
    u[i0] += min_dist;
    for (int j = 0; j < nc; ++j) {
      if (!done[j] || j == sink) continue;
      const int rj = row_of_col[j];
      if (rj >= 0) u[rj] += min_dist - dist[j];
      v[j] += dist[j] - min_dist;
    }

    // Augment along the path sink -> i0.
    int j = sink;
    while (true) {
      const int ri = pred_row[j];
      row_of_col[j] = ri;
      const int next_j = col_of_row[ri];
      col_of_row[ri] = j;
      if (ri == i0) break;
      j = next_j;
    }
  }
  return 0;
}
