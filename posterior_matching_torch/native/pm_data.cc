// Multithreaded host batch assembly, loaded by native/__init__.py (ctypes).
//
// A host batch is a shuffled row gather out of the dataset arrays held in
// memory and, for images, the uint8 -> float32 rescale, fused into the
// gather as float32(u8) * float32(scale). Both are memory-bound host work
// between steps; these entry points split a batch's rows over threads.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Runs fn(lo, hi) over [0, n_rows) in contiguous chunks on up to
// n_threads threads (one thread: in the caller's).
template <typename Fn>
void parallel_rows(int64_t n_rows, int n_threads, Fn fn) {
  n_threads = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(n_threads, n_rows)));
  if (n_threads == 1) {
    fn(int64_t{0}, n_rows);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(n_rows, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(fn, lo, hi);
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// out[i, :] = src[indices[i], :], rows of row_bytes bytes
void pm_gather_rows(const uint8_t* src, const int64_t* indices, uint8_t* out,
                    int64_t n_rows, int64_t row_bytes, int n_threads) {
  parallel_rows(n_rows, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * row_bytes, src + indices[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  });
}

// out[i, :] = float32(src[indices[i], :]) * scale
void pm_gather_u8_to_f32(const uint8_t* src, const int64_t* indices, float* out,
                         int64_t n_rows, int64_t row_elems, float scale,
                         int n_threads) {
  parallel_rows(n_rows, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* s = src + indices[i] * row_elems;
      float* d = out + i * row_elems;
      for (int64_t j = 0; j < row_elems; ++j) {
        d[j] = static_cast<float>(s[j]) * scale;
      }
    }
  });
}

// out[i, :] = src[indices[i], :], float32 rows of row_elems
void pm_gather_f32(const float* src, const int64_t* indices, float* out,
                   int64_t n_rows, int64_t row_elems, int n_threads) {
  parallel_rows(n_rows, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * row_elems, src + indices[i] * row_elems,
                  sizeof(float) * static_cast<size_t>(row_elems));
    }
  });
}

}  // extern "C"
