// Native batched exact changepoint search (ruptures.KernelCPD 'linear'
// replacement, batched over cells).
//
// The deterministic normalize-by-cell path scans every S cell's profile
// for 1 or 2 least-squares breakpoints per flattening round (reference:
// normalize_by_cell.py:45-46, 73-74).  The exact 2-breakpoint search is
// O(n^2) per cell; in Python that is the 10k-cell scalability cliff, so
// the (a, b) sweep runs here over raw prefix sums with one thread per
// slab of cells.  Rows may be ragged: row_len[i] gives the number of
// valid leading entries of row i (<= n_loci, the row stride).
//
// Cost model: cost(i, j) = sum_{k in [i,j)} (y_k - mean)^2
//           = (S2[j]-S2[i]) - (S1[j]-S1[i])^2 / (j-i)
// minimised over segment splits with min_size spacing — identical to the
// single-profile search in pipeline/segment.py (kept as the oracle).
//
// Output layout: out[i*2+0] = a, out[i*2+1] = b for 2 breakpoints
// ([a, b, n] in ruptures terms); for 1 breakpoint out[i*2+0] = k,
// out[i*2+1] = -1.  Rows too short for the search get a = -1.

#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline double seg_cost(const double* s1, const double* s2,
                       int64_t i, int64_t j) {
  const double tot = s1[j] - s1[i];
  const int64_t n = j - i;
  return (s2[j] - s2[i]) - tot * tot / static_cast<double>(n > 0 ? n : 1);
}

// Scratch buffers reused across the rows a thread owns.
struct Scratch {
  std::vector<double> s1, s2, left, right, inv, m;
  explicit Scratch(int64_t n)
      : s1(n + 1), s2(n + 1), left(n + 1), right(n + 1), inv(n + 1),
        m(n + 1) {}
};

void row_bkps(const double* y, int64_t n, int32_t n_bkps, int32_t min_size,
              Scratch& sc, int64_t* out) {
  double* s1 = sc.s1.data();
  double* s2 = sc.s2.data();
  s1[0] = 0.0;
  s2[0] = 0.0;
  for (int64_t k = 0; k < n; ++k) {
    s1[k + 1] = s1[k] + y[k];
    s2[k + 1] = s2[k] + y[k] * y[k];
  }

  if (n_bkps == 1) {
    out[1] = -1;
    if (n - min_size < min_size) {  // no admissible split
      out[0] = -1;
      return;
    }
    double best = 0.0;
    int64_t best_k = -1;
    for (int64_t k = min_size; k <= n - min_size; ++k) {
      const double c = seg_cost(s1, s2, 0, k) + seg_cost(s1, s2, k, n);
      if (best_k < 0 || c < best) {
        best = c;
        best_k = k;
      }
    }
    out[0] = best_k;
    return;
  }

  // n_bkps == 2 — the O(n^2) sweep, restructured gap-major for SIMD.
  //
  // The Python oracle (pipeline/segment.py, find_breakpoints) computes
  // every cost as
  // (s2[j]-s2[i]) - tot*tot/len with a true IEEE division; the fast pass
  // here uses a reciprocal multiply instead (vdivpd would throttle the
  // whole loop to division throughput).  That approximation is then made
  // EXACT by a refinement pass: any `a` whose approximate minimum lies
  // within a provable error bound of the approximate optimum is
  // recomputed with true division, and the winner is selected with the
  // oracle's tie semantics (first strict minimum over ascending a, then
  // first strict minimum over ascending b).  For non-degenerate data the
  // candidate set is a single `a`; fully-tied rows degrade to the exact
  // scan but remain bit-faithful.
  out[0] = -1;
  out[1] = -1;
  if (n - 2 * min_size < min_size) return;

  double* __restrict__ left = sc.left.data();    // cost(0, a), exact
  double* __restrict__ right = sc.right.data();  // cost(b, n), exact
  double* __restrict__ inv = sc.inv.data();      // 1/len reciprocals
  double* __restrict__ m = sc.m.data();          // per-a approx min
  inv[0] = 0.0;
  for (int64_t len = 1; len <= n; ++len)
    inv[len] = 1.0 / static_cast<double>(len);
  for (int64_t b = min_size; b <= n - min_size; ++b) {
    const double tot = s1[n] - s1[b];
    right[b] = (s2[n] - s2[b]) - tot * tot / static_cast<double>(n - b);
  }
  for (int64_t a = min_size; a <= n - 2 * min_size; ++a) {
    left[a] = s2[a] - s1[a] * s1[a] / static_cast<double>(a);
    m[a] = 1.0 / 0.0;
  }

  // pass A: approximate per-a minima, gap-major (unit-stride FMA + min)
  for (int64_t g = min_size; g <= n - 2 * min_size; ++g) {
    const double inv_g = inv[g];
    const double* __restrict__ s1g = s1 + g;  // s1g[a] == s1[a + g]
    const double* __restrict__ s2g = s2 + g;
    const double* __restrict__ rg = right + g;
    const int64_t a_hi = n - min_size - g;
    for (int64_t a = min_size; a <= a_hi; ++a) {
      const double tot = s1g[a] - s1[a];
      const double mid = (s2g[a] - s2[a]) - tot * tot * inv_g;
      const double c = (left[a] + mid) + rg[a];
      m[a] = c < m[a] ? c : m[a];
    }
  }

  double vt = 1.0 / 0.0;  // approximate optimum
  for (int64_t a = min_size; a <= n - 2 * min_size; ++a)
    vt = m[a] < vt ? m[a] : vt;
  if (!(vt < 1.0 / 0.0)) return;

  // sound error bound: approx and exact costs differ only in the
  // tot^2*inv vs tot^2/len term plus downstream rounding, all bounded by
  // a few ulps of the largest intermediate magnitude
  double s1_abs_max = 0.0;
  for (int64_t k = 0; k <= n; ++k) {
    const double v = s1[k] < 0 ? -s1[k] : s1[k];
    s1_abs_max = v > s1_abs_max ? v : s1_abs_max;
  }
  const double mag = s2[n] + 4.0 * s1_abs_max * s1_abs_max
                             / static_cast<double>(min_size) + 1.0;
  const double eps_abs = 32.0 * 2.220446049250313e-16 * mag;

  // refinement: exact-division rescan of every candidate a, oracle ties
  double best = 0.0;
  int64_t best_a = -1;
  for (int64_t a = min_size; a <= n - 2 * min_size; ++a) {
    // 2x: |m~[a_v] - v*| <= eps and |v* - vt| <= eps can stack
    if (m[a] > vt + 2.0 * eps_abs) continue;
    const double lft = left[a];
    const double s1a = s1[a], s2a = s2[a];
    double row_min = 1.0 / 0.0;
    int64_t row_b = -1;
    for (int64_t b = a + min_size; b <= n - min_size; ++b) {
      const double tot = s1[b] - s1a;
      // true division: IEEE-rounds identically to the NumPy oracle, so
      // exact cost TIES break the same way
      const double c = (lft + ((s2[b] - s2a)
                                - tot * tot / static_cast<double>(b - a)))
                       + right[b];
      if (c < row_min) {
        row_min = c;
        row_b = b;
      }
    }
    if (row_b >= 0 && (best_a < 0 || row_min < best)) {
      best = row_min;
      best_a = a;
      out[0] = a;
      out[1] = row_b;
    }
  }
}

}  // namespace

extern "C" {

// Y: (n_rows, n_loci) row-major; row i uses Y[i*n_loci .. i*n_loci+row_len[i])
// out: (n_rows, 2) int64 as described above.
void batch_bkps_f64(const double* Y, const int64_t* row_len, int64_t n_rows,
                    int64_t n_loci, int32_t n_bkps, int32_t min_size,
                    int64_t* out, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t lo, int64_t hi) {
    Scratch sc(n_loci);
    for (int64_t i = lo; i < hi; ++i) {
      row_bkps(Y + i * n_loci, row_len[i], n_bkps, min_size, sc,
               out + i * 2);
    }
  };
  if (n_threads == 1 || n_rows < 4) {
    worker(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n_rows ? lo + chunk : n_rows;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
