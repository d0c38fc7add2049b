// Native host-side scatter-pivot: long-form (cell, locus, value) triples
// into a dense (cells x loci) float32 matrix, and the gather back.
//
// The loader's pivot (data/loader.py pivot_matrix) replaces the
// reference's pandas pivot_table (reference: pert_model.py:143-146),
// which walks groupby machinery per call.  At 1000 cells x 5451 loci that
// is ~5.5M scattered writes per pivot and several pivots per run; this
// kernel does the scatter with raw pointers across N threads (each thread
// owns a disjoint slice of the *input* triples).  Input contract: (cell,
// locus) keys MUST be unique -- with duplicates, two threads may write the
// same output slot unsynchronised, which is a data race under the C++
// memory model and leaves an unspecified winner.  data/loader.py routes
// duplicate-key inputs to the pandas pivot_table path before ever calling
// this kernel.
//
// A copy of the JAX package's native/pivot.cpp, the same plain C
// interface; built at first use by the host's c++ through ops/_cuda.py
// (HOST_SOURCES) and loaded with ctypes (native/pivot.py).  A failed
// build raises; only use_native=False asks for the NumPy scatter.

#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// out must be pre-filled by the caller (NaN for "missing").
void scatter_pivot_f32(const int32_t* cell_codes, const int32_t* locus_codes,
                       const double* values, int64_t n, float* out,
                       int64_t n_loci, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out[static_cast<int64_t>(cell_codes[i]) * n_loci + locus_codes[i]] =
          static_cast<float>(values[i]);
    }
  };
  if (n_threads == 1 || n < (1 << 16)) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Inverse direction (dense -> long) for melting model outputs back to the
// pandas contract: gathers out[i] = mat[cell_codes[i] * n_loci + locus_codes[i]].
void gather_melt_f32(const float* mat, const int32_t* cell_codes,
                     const int32_t* locus_codes, int64_t n, int64_t n_loci,
                     float* out, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out[i] = mat[static_cast<int64_t>(cell_codes[i]) * n_loci +
                   locus_codes[i]];
    }
  };
  if (n_threads == 1 || n < (1 << 16)) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
