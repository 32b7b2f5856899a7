// Hungarian (Kuhn-Munkres) assignment via shortest augmenting paths with
// potentials — O(n^3). A copy of opencv_tpu/native/munkres.cpp, so that
// the PyTorch port needs nothing of the JAX package: the code below the
// comment is the same, line for line.
//
// The reference implements Munkres steps 1-4 in C++ inside the
// tracking-by-detection module (modules/trackingbydetection/src/
// tbd.cpp:381-905). Assignment is sequential, so it stays on the host in
// native code; the batch-numeric work around it (IoU cost matrices,
// Kalman updates) runs on the card. Built by the host compiler at first
// use (ops/cuda/_build.py) and bound with ctypes (tbd/assignment.py).
//
// C ABI: solve rectangular cost matrices [n_rows, n_cols] row-major;
// writes assignment[r] = column index or -1. Rectangular problems are
// handled by the standard potentials formulation directly (n_rows <=
// n_cols required; callers transpose if needed).

#include <cstdint>
#include <cstddef>
#include <vector>
#include <limits>

extern "C" {

// Returns 0 on success. Requires n_rows <= n_cols.
int munkres_solve(const double* cost, int32_t n_rows, int32_t n_cols,
                  int32_t* assignment) {
  if (n_rows > n_cols) return 1;
  const double INF = std::numeric_limits<double>::infinity();
  // potentials u (rows), v (cols); way[c] = previous column on the path;
  // match_col[c] = row matched to column c (0-based; -1 = free).
  std::vector<double> u(n_rows + 1, 0.0), v(n_cols + 1, 0.0);
  std::vector<int32_t> match_col(n_cols + 1, -1), way(n_cols + 1, 0);
  for (int32_t r = 0; r < n_rows; ++r) {
    // virtual column n_cols acts as the source
    int32_t j0 = n_cols;
    match_col[j0] = r;
    std::vector<double> minv(n_cols + 1, INF);
    std::vector<char> used(n_cols + 1, 0);
    do {
      used[j0] = 1;
      int32_t r0 = match_col[j0], j1 = -1;
      double delta = INF;
      for (int32_t j = 0; j < n_cols; ++j) {
        if (used[j]) continue;
        double cur = cost[(size_t)r0 * n_cols + j] - u[r0] - v[j];
        if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        if (minv[j] < delta) { delta = minv[j]; j1 = j; }
      }
      if (j1 < 0) return 2;  // infeasible (all remaining columns INF)
      for (int32_t j = 0; j <= n_cols; ++j) {
        if (used[j]) {
          if (match_col[j] >= 0) u[match_col[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (match_col[j0] != -1);
    // augment along the path
    do {
      int32_t j1 = way[j0];
      match_col[j0] = match_col[j1];
      j0 = j1;
    } while (j0 != n_cols);
  }
  for (int32_t r = 0; r < n_rows; ++r) assignment[r] = -1;
  for (int32_t j = 0; j < n_cols; ++j)
    if (match_col[j] >= 0) assignment[match_col[j]] = j;
  return 0;
}

}  // extern "C"
