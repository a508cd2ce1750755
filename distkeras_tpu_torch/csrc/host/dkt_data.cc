// dkt_data — native columnar data kernels for distkeras_tpu.
//
// The reference outsources its data plane to Apache Spark (partition
// shuffles, row marshalling inside executors — SURVEY §3.1 flags the
// per-row path as a bottleneck). The TPU build replaces that with columnar
// host arrays; these kernels are the multithreaded hot ops behind them:
//
//   dkt_gather        epoch permutation gather (the per-epoch shuffle)
//   dkt_one_hot       label -> one-hot matrix (transformers.OneHotTransformer)
//   dkt_minmax        min/max reduce + affine rescale (MinMaxTransformer)
//   dkt_csv_parse_f32 ASCII float CSV -> flat f32 (examples' CSV ingest)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (see native/Makefile).
// Python binding: distkeras_tpu/data/native.py (ctypes, numpy fallback).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

int clamp_threads(int requested, int64_t work_items, int64_t min_per_thread) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int64_t by_work = std::max<int64_t>(1, work_items / min_per_thread);
  int n = std::min<int64_t>({requested > 0 ? requested : hw, hw, by_work});
  return std::max(1, n);
}

// run fn(begin, end) over [0, n) split across threads
template <typename Fn>
void parallel_for(int64_t n, int n_threads, Fn fn) {
  if (n_threads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    threads.emplace_back([=] { fn(b, e); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// out[i, :] = src[perm[i], :] over row-major rows of row_bytes each.
// Dtype-agnostic (byte copy); perm values must be in [0, n_src_rows).
void dkt_gather(const char* src, const int64_t* perm, char* out,
                int64_t n_rows, int64_t row_bytes, int n_threads) {
  int nt = clamp_threads(n_threads, n_rows * row_bytes, 1 << 20);
  parallel_for(n_rows, nt, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      std::memcpy(out + i * row_bytes, src + perm[i] * row_bytes, row_bytes);
    }
  });
}

// out[n, k] one-hot of labels[n]; out must be zero-initialized by caller.
// Out-of-range labels are left all-zero (matches the tolerant reference
// behavior of vector assembly). Returns count of out-of-range labels.
int64_t dkt_one_hot(const int64_t* labels, float* out, int64_t n, int64_t k,
                    int n_threads) {
  std::atomic<int64_t> bad{0};
  int nt = clamp_threads(n_threads, n, 1 << 16);
  parallel_for(n, nt, [&](int64_t b, int64_t e) {
    int64_t local_bad = 0;
    for (int64_t i = b; i < e; ++i) {
      int64_t y = labels[i];
      if (y >= 0 && y < k) {
        out[i * k + y] = 1.0f;
      } else {
        ++local_bad;
      }
    }
    bad.fetch_add(local_bad, std::memory_order_relaxed);
  });
  return bad.load();
}

// Column-wise min/max over x[n, d] into mins[d], maxs[d].
void dkt_col_minmax(const float* x, int64_t n, int64_t d, float* mins,
                    float* maxs, int n_threads) {
  int nt = clamp_threads(n_threads, n * d, 1 << 18);
  std::vector<std::vector<float>> tmins(nt, std::vector<float>(
      d, std::numeric_limits<float>::infinity()));
  std::vector<std::vector<float>> tmaxs(nt, std::vector<float>(
      d, -std::numeric_limits<float>::infinity()));
  std::atomic<int> tid{0};
  parallel_for(n, nt, [&](int64_t b, int64_t e) {
    int t = tid.fetch_add(1);
    float* mn = tmins[t].data();
    float* mx = tmaxs[t].data();
    for (int64_t i = b; i < e; ++i) {
      const float* row = x + i * d;
      for (int64_t j = 0; j < d; ++j) {
        mn[j] = std::min(mn[j], row[j]);
        mx[j] = std::max(mx[j], row[j]);
      }
    }
  });
  for (int64_t j = 0; j < d; ++j) {
    mins[j] = std::numeric_limits<float>::infinity();
    maxs[j] = -std::numeric_limits<float>::infinity();
  }
  for (int t = 0; t < nt; ++t) {
    for (int64_t j = 0; j < d; ++j) {
      mins[j] = std::min(mins[j], tmins[t][j]);
      maxs[j] = std::max(maxs[j], tmaxs[t][j]);
    }
  }
}

// out = (x - mn) / (mx - mn) * (hi - lo) + lo, column-wise, degenerate
// columns (mx == mn) map to lo.
void dkt_minmax_scale(const float* x, int64_t n, int64_t d, const float* mins,
                      const float* maxs, float lo, float hi, float* out,
                      int n_threads) {
  int nt = clamp_threads(n_threads, n * d, 1 << 18);
  std::vector<float> scale(d), off(d);
  for (int64_t j = 0; j < d; ++j) {
    float range = maxs[j] - mins[j];
    scale[j] = range > 0 ? (hi - lo) / range : 0.0f;
    off[j] = lo - mins[j] * scale[j];
  }
  const float* sc = scale.data();
  const float* of = off.data();
  parallel_for(n, nt, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      const float* row = x + i * d;
      float* orow = out + i * d;
      for (int64_t j = 0; j < d; ++j) orow[j] = row[j] * sc[j] + of[j];
    }
  });
}

// Parse ASCII-delimited floats from buf[0:len] into out (capacity max_vals).
// Any of {sep, '\n', '\r', '\t', ' '} delimit; empty fields are skipped.
// Returns number of values written, or -1 on malformed input / overflow.
int64_t dkt_csv_parse_f32(const char* buf, int64_t len, char sep, float* out,
                          int64_t max_vals) {
  int64_t count = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    while (p < end && (*p == sep || *p == '\n' || *p == '\r' || *p == '\t' ||
                       *p == ' '))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    float v = std::strtof(p, &next);
    if (next == p) return -1;  // not a number
    if (count >= max_vals) return -1;
    out[count++] = v;
    p = next;
  }
  return count;
}

int dkt_version() { return 1; }

}  // extern "C"
