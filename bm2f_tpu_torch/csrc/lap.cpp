// Batched rectangular linear-sum-assignment solver (Jonker-Volgenant style
// shortest augmenting path), used by bm2f_tpu_torch.matching.hungarian via
// ctypes: the port's copy of the JAX package's native/lap/lap.cpp, so that
// both packages break ties alike.
//
// Replaces the reference's per-image scipy.optimize.linear_sum_assignment
// calls (reference: mask2former/modeling/matcher.py:557-559) with one native
// batched call per training step covering every image and decoder layer.
//
// Cost matrices are (B, Q, G) row-major float32 with Q >= G; for each batch
// element we assign every column (target) a distinct row (query) minimizing
// total cost. Output is (B, G) int32: column -> assigned row.
//
// Built at first use with the host C++ compiler into bm2f_tpu_torch/_build/
// (ops/cuda_build.py `load_host`).

#include <cfloat>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Shortest-augmenting-path LSA on an n x m cost matrix (n <= m), assigning
// each row a distinct column. O(n^2 m). Returns row -> column in row2col.
void solve_one(const float* cost, int n, int m, int* row2col) {
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int> p(m + 1, 0), way(m + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(m + 1, DBL_MAX);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = 0;
      double delta = DBL_MAX;
      const float* row = cost + (size_t)(i0 - 1) * m;
      for (int j = 1; j <= m; ++j) {
        if (used[j]) continue;
        double cur = (double)row[j - 1] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= m; ++j) {
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
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int j = 1; j <= m; ++j) {
    if (p[j] > 0) row2col[p[j] - 1] = j - 1;
  }
}

}  // namespace

extern "C" {

// costs: (B, Q, G) row-major, Q >= G. out: (B, G) column(target) -> row(query).
// The solver runs on the transposed problem (G rows x Q cols) so the smaller
// side drives the augmenting paths.
void solve_lap_batch(const float* costs, int B, int Q, int G, int* out) {
  auto solve_range = [&](int b0, int b1) {
    std::vector<float> t((size_t)G * Q);
    for (int b = b0; b < b1; ++b) {
      const float* c = costs + (size_t)b * Q * G;
      // transpose to (G, Q)
      for (int q = 0; q < Q; ++q)
        for (int g = 0; g < G; ++g) t[(size_t)g * Q + q] = c[(size_t)q * G + g];
      solve_one(t.data(), G, Q, out + (size_t)b * G);
    }
  };
  int hw = (int)std::thread::hardware_concurrency();
  int nthreads = hw > 0 ? (hw < 16 ? hw : 16) : 4;
  if (B < 2 * nthreads) nthreads = 1;
  if (nthreads <= 1) {
    solve_range(0, B);
    return;
  }
  std::vector<std::thread> threads;
  int per = (B + nthreads - 1) / nthreads;
  for (int t0 = 0; t0 < B; t0 += per) {
    int t1 = t0 + per < B ? t0 + per : B;
    threads.emplace_back(solve_range, t0, t1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
