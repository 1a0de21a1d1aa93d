// Native host GAR kernels — the framework's C++ tier.
//
// Parallel (threadpool.hpp) implementations of every Gradient Aggregation
// Rule the framework ships, semantically identical to the numpy oracle
// (aggregathor_tpu/gars/oracle.py), which itself mirrors the reference's CPU
// kernels (aggregators/deprecated_native/native.cpp:637-1041,
// native/op_krum/cpu.cpp:53-122, native/op_bulyan/cpu.cpp:52-188).
// Conventions shared across rules:
//   - non-finite values order LAST (key = +inf) in every coordinate-wise
//     selection (reference native.cpp:691-697);
//   - ties break by lowest original index (stable ordering, matching
//     numpy's stable argsort used by the oracle);
//   - accumulation is double precision regardless of input dtype.
// Exported as a C ABI (..._f32 / ..._f64 per rule) consumed via ctypes by
// aggregathor_tpu/ops/native/__init__.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

#include "threadpool.hpp"

namespace {

using std::int64_t;

constexpr double kInf = std::numeric_limits<double>::infinity();

// Ordering key: non-finite values compare as +inf (and so sort last).
inline double Key(double v) { return std::isfinite(v) ? v : kInf; }

// Indices 0..n-1 stably ordered by ascending Key(values[i]).
inline void StableOrder(const double* values, int64_t n,
                        std::vector<int64_t>& order) {
  order.resize(n);
  std::iota(order.begin(), order.end(), int64_t{0});
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return Key(values[a]) < Key(values[b]);
  });
}

// Upper median of a column: element at rank n/2 of the non-finite-last
// stable order (oracle _nonfinite_last_sorted + [n // 2]).
inline double ColumnMedian(const double* col, int64_t n,
                           std::vector<int64_t>& scratch) {
  StableOrder(col, n, scratch);
  return col[scratch[n / 2]];
}

// Mean of the beta values closest to the column's median (ties by index).
inline double ColumnAveragedMedian(const double* col, int64_t n, int64_t beta,
                                   std::vector<double>& dev,
                                   std::vector<int64_t>& scratch) {
  const double med = ColumnMedian(col, n, scratch);
  dev.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    const double a = std::fabs(col[i] - med);
    dev[i] = std::isfinite(a) ? a : kInf;
  }
  StableOrder(dev.data(), n, scratch);
  double sum = 0.0;
  for (int64_t k = 0; k < beta; ++k) sum += col[scratch[k]];
  return sum / static_cast<double>(beta);
}

// ---------------------------------------------------------------------------
// Rule implementations, templated on the I/O scalar type.

template <typename T>
void Average(const T* grads, int64_t n, int64_t d, T* out) {
  agtpu::ParallelFor(0, d, [&](int64_t lo, int64_t hi) {
    for (int64_t x = lo; x < hi; ++x) {
      double sum = 0.0;
      for (int64_t i = 0; i < n; ++i) sum += static_cast<double>(grads[i * d + x]);
      out[x] = static_cast<T>(sum / static_cast<double>(n));
    }
  });
}

template <typename T>
void AverageNaN(const T* grads, int64_t n, int64_t d, T* out) {
  agtpu::ParallelFor(0, d, [&](int64_t lo, int64_t hi) {
    for (int64_t x = lo; x < hi; ++x) {
      double sum = 0.0;
      int64_t count = 0;
      for (int64_t i = 0; i < n; ++i) {
        const double v = static_cast<double>(grads[i * d + x]);
        if (std::isfinite(v)) {
          sum += v;
          ++count;
        }
      }
      out[x] = static_cast<T>(count > 0 ? sum / static_cast<double>(count) : 0.0);
    }
  });
}

template <typename T>
void Median(const T* grads, int64_t n, int64_t d, T* out) {
  agtpu::ParallelFor(0, d, [&](int64_t lo, int64_t hi) {
    std::vector<double> col(n);
    std::vector<int64_t> scratch;
    for (int64_t x = lo; x < hi; ++x) {
      for (int64_t i = 0; i < n; ++i) col[i] = static_cast<double>(grads[i * d + x]);
      out[x] = static_cast<T>(ColumnMedian(col.data(), n, scratch));
    }
  });
}

template <typename T>
void AveragedMedian(const T* grads, int64_t n, int64_t d, int64_t f, T* out) {
  const int64_t beta = n - f;
  agtpu::ParallelFor(0, d, [&](int64_t lo, int64_t hi) {
    std::vector<double> col(n), dev;
    std::vector<int64_t> scratch;
    for (int64_t x = lo; x < hi; ++x) {
      for (int64_t i = 0; i < n; ++i) col[i] = static_cast<double>(grads[i * d + x]);
      out[x] = static_cast<T>(ColumnAveragedMedian(col.data(), n, beta, dev, scratch));
    }
  });
}

// All-pairs squared L2 distances; a non-finite distance becomes +inf
// (oracle _pairwise_sq_distances).  Parallel over the i<j upper triangle
// rows; symmetric fill, zero diagonal.
template <typename T>
void PairwiseSqDist(const T* grads, int64_t n, int64_t d, double* out) {
  agtpu::ParallelFor(0, n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out[i * n + i] = 0.0;
      for (int64_t j = i + 1; j < n; ++j) {
        double acc = 0.0;
        const T* a = grads + i * d;
        const T* b = grads + j * d;
        for (int64_t x = 0; x < d; ++x) {
          const double delta = static_cast<double>(a[x]) - static_cast<double>(b[x]);
          acc += delta * delta;
        }
        if (std::isnan(acc)) acc = kInf;
        out[i * n + j] = acc;
        out[j * n + i] = acc;
      }
    }
  });
}

// Multi-Krum scores: score(i) = sum of i's (n - f - 2) smallest distances to
// the other gradients, ascending-order summation like the oracle.
inline void KrumScores(const double* dist, int64_t n, int64_t f,
                       std::vector<double>& scores) {
  const int64_t k = n - f - 2;
  scores.resize(n);
  agtpu::ParallelFor(0, n, [&](int64_t lo, int64_t hi) {
    std::vector<double> row;
    row.reserve(n - 1);
    for (int64_t i = lo; i < hi; ++i) {
      row.clear();
      for (int64_t j = 0; j < n; ++j)
        if (j != i) row.push_back(dist[i * n + j]);
      std::sort(row.begin(), row.end(),
                [](double a, double b) { return Key(a) < Key(b); });
      double s = 0.0;
      for (int64_t t = 0; t < k; ++t) s += row[t];
      scores[i] = s;
    }
  });
}

// Mean of the rows listed in sel[0..m) over every coordinate, in parallel
// over coordinate slices.
template <typename T>
void MeanOfRows(const T* grads, int64_t d, const int64_t* sel, int64_t m,
                double* out) {
  agtpu::ParallelFor(0, d, [&](int64_t lo, int64_t hi) {
    for (int64_t x = lo; x < hi; ++x) {
      double sum = 0.0;
      for (int64_t k = 0; k < m; ++k) sum += static_cast<double>(grads[sel[k] * d + x]);
      out[x] = sum / static_cast<double>(m);
    }
  });
}

template <typename T>
void Krum(const T* grads, int64_t n, int64_t d, int64_t f, int64_t m, T* out) {
  std::vector<double> dist(n * n);
  PairwiseSqDist(grads, n, d, dist.data());
  std::vector<double> scores;
  KrumScores(dist.data(), n, f, scores);
  std::vector<int64_t> order;
  StableOrder(scores.data(), n, order);
  std::vector<double> mean(d);
  MeanOfRows(grads, d, order.data(), m, mean.data());
  agtpu::ParallelFor(0, d, [&](int64_t lo, int64_t hi) {
    for (int64_t x = lo; x < hi; ++x) out[x] = static_cast<T>(mean[x]);
  });
}

// Bulyan: iterative Multi-Krum selection with row-pruned incremental
// rescoring, then coordinate-wise averaged-median over the t winners
// (oracle bulyan(), mirroring op_bulyan/cpu.cpp:52-188).
template <typename T>
void Bulyan(const T* grads, int64_t n, int64_t d, int64_t f, T* out) {
  const int64_t m = n - f - 2;
  const int64_t t = n - 2 * f - 2;
  const int64_t b = t - 2 * f;
  const int64_t in_score = n - f - 2;

  std::vector<double> dist(n * n);
  PairwiseSqDist(grads, n, d, dist.data());
  for (int64_t i = 0; i < n; ++i) dist[i * n + i] = kInf;

  // Row-wise pruning: keep each row's in_score smallest entries; a kept
  // non-finite entry is stored as +inf; everything else is 0 so the later
  // column subtraction is a plain vector op.
  std::vector<double> pruned(n * n, 0.0);
  std::vector<double> scores(n);
  agtpu::ParallelFor(0, n, [&](int64_t lo, int64_t hi) {
    std::vector<int64_t> order;
    for (int64_t i = lo; i < hi; ++i) {
      StableOrder(dist.data() + i * n, n, order);
      double s = 0.0;
      for (int64_t k = 0; k < in_score; ++k) {
        const int64_t j = order[k];
        const double v = dist[i * n + j];
        pruned[i * n + j] = std::isfinite(v) ? v : kInf;
        s += pruned[i * n + j];
      }
      scores[i] = s;
    }
  });

  // Sequential selection loop (t rounds); each round's row-mean is parallel
  // over coordinates.  inf - inf = NaN in the rescoring is intentional: the
  // ordering key maps it back to +inf, exactly like the oracle.
  std::vector<double> selections(t * d);
  std::vector<double> live = scores;
  std::vector<int64_t> order;
  for (int64_t k = 0; k < t; ++k) {
    StableOrder(live.data(), n, order);
    MeanOfRows(grads, d, order.data(), m - k, selections.data() + k * d);
    if (k + 1 < t) {
      const int64_t best = order[0];
      for (int64_t i = 0; i < n; ++i) live[i] -= pruned[i * n + best];
      live[best] = kInf;
    }
  }

  agtpu::ParallelFor(0, d, [&](int64_t lo, int64_t hi) {
    std::vector<double> col(t), dev;
    std::vector<int64_t> scratch;
    for (int64_t x = lo; x < hi; ++x) {
      for (int64_t k = 0; k < t; ++k) col[k] = selections[k * d + x];
      out[x] = static_cast<T>(ColumnAveragedMedian(col.data(), t, b, dev, scratch));
    }
  });
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI.  int64 sizes throughout; matrices are row-major contiguous.

extern "C" {

int64_t agtpu_num_threads(void) {
  return static_cast<int64_t>(agtpu::ThreadPool::Global().size());
}

#define AGTPU_EXPORT_RULE(T, SUFFIX)                                          \
  void agtpu_average_##SUFFIX(const T* g, int64_t n, int64_t d, T* out) {     \
    Average(g, n, d, out);                                                    \
  }                                                                           \
  void agtpu_average_nan_##SUFFIX(const T* g, int64_t n, int64_t d, T* out) { \
    AverageNaN(g, n, d, out);                                                 \
  }                                                                           \
  void agtpu_median_##SUFFIX(const T* g, int64_t n, int64_t d, T* out) {      \
    Median(g, n, d, out);                                                     \
  }                                                                           \
  void agtpu_averaged_median_##SUFFIX(const T* g, int64_t n, int64_t d,       \
                                      int64_t f, T* out) {                    \
    AveragedMedian(g, n, d, f, out);                                          \
  }                                                                           \
  void agtpu_pairwise_sqdist_##SUFFIX(const T* g, int64_t n, int64_t d,       \
                                      double* out) {                          \
    PairwiseSqDist(g, n, d, out);                                             \
  }                                                                           \
  void agtpu_krum_##SUFFIX(const T* g, int64_t n, int64_t d, int64_t f,       \
                           int64_t m, T* out) {                               \
    Krum(g, n, d, f, m, out);                                                 \
  }                                                                           \
  void agtpu_bulyan_##SUFFIX(const T* g, int64_t n, int64_t d, int64_t f,     \
                             T* out) {                                        \
    Bulyan(g, n, d, f, out);                                                  \
  }

AGTPU_EXPORT_RULE(float, f32)
AGTPU_EXPORT_RULE(double, f64)

#undef AGTPU_EXPORT_RULE

}  // extern "C"
