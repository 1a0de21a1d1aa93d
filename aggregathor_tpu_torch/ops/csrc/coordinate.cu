// K3, K4, K5: per-column rank selection over an (n, d) float32 matrix, and
// K6: the per-column mean of the finite entries.
//
// Replaces the Pallas bodies of aggregathor_tpu/ops/pallas_kernels.py:
//   K3 `_median_kernel` (:143-145)           -> coordinate_median
//   K4 `_averaged_median_kernel` (:148-153)  -> coordinate_averaged_median
//   K5 `_trimmed_mean_kernel` (:156-166)     -> coordinate_trimmed_mean
//   K6 the inner `kernel` of `average_nan_columns` (:215-225)
//                                            -> average_nan_columns
// with the TPU's rank rule kept exactly (pallas_kernels.py:101-130): a
// non-finite value keys as +inf, rank_i = #{j : key_j < key_i or (key_j ==
// key_i and j < i)}, and selection is by rank.
//   K3 returns the ORIGINAL value at rank n/2 (NaN poison passes through).
//   K4 takes K3's median, keys |x - med| the same way (a NaN median keys
//      every deviation +inf, so the first beta rows by index are chosen) and
//      returns the mean of the original values at deviation ranks < beta.
//   K5 sums the KEYS at ranks [trim, trim + keep) and maps a non-finite mean
//      to NaN.
//
// What bounds it on the H100: the bytes.  One read of n*d*4 bytes and one
// write of d*4 bytes (59 MB at n=8, d=1,756,682: about 18 us at 3.35 TB/s);
// the n^2 compare-accumulates per column (one rank pass; two for K4) are
// 0.11 G operations at n=8, a few microseconds.
//
// What the design does about it: one thread per column, so neighbouring
// threads read neighbouring columns and every row's loads coalesce; each
// input value is loaded once.  Up to n = 64 the column's n values and keys
// sit in registers (`coord_regs`, templated on the padded row count; padded
// slots key +inf at the highest indices, so they rank >= n and never move a
// real row's rank -- the neutral padding the TPU kernel uses too, minus its
// (8, 128) tiling).  Beyond 64 rows (`coord_global`) each rank pass re-reads
// the column from device memory (L1/L2 serve the repeats); slower, but right
// at any n.  Sums run in row order, so results are the same on every run.
// The rank passes are fully unrolled compares on CUDA cores: at the main
// path's n = 8 they are far below the memory time.
//
// K6 needs no rank: one thread per column reads each of the n values once,
// adds the finite ones and counts them in row order, for any n (nothing is
// kept, so no register template), and writes count > 0 ? total / count : 0.
// Bound by the same bytes as K3 (63.2 MB at n=8, d=1,756,682).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

enum Op { kMedian = 0, kAveragedMedian = 1, kTrimmedMean = 2 };

__device__ __forceinline__ float inf_key(float v) {
  return isfinite(v) ? v : INFINITY;
}

// ---------------------------------------------------------------------------
// n <= MAXN: the column lives in registers.  `a`/`b`: median target and beta
// (K3/K4), or trim and keep (K5).

template <int MAXN>
__device__ __forceinline__ int rank_in(const float (&key)[MAXN], int i) {
  int r = 0;
#pragma unroll
  for (int j = 0; j < MAXN; ++j) {
    r += (key[j] < key[i]) || (key[j] == key[i] && j < i);
  }
  return r;
}

template <int MAXN, int OP>
__global__ void __launch_bounds__(kThreads)
coord_regs(const float* __restrict__ x, float* __restrict__ out, int n,
           long long d, int a, int b) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) {
    return;
  }
  float val[MAXN];
  float key[MAXN];
#pragma unroll
  for (int j = 0; j < MAXN; ++j) {
    val[j] = j < n ? x[(long long)j * d + col] : NAN;
    key[j] = inf_key(val[j]);
  }
  float result = 0.0f;
  if (OP == kTrimmedMean) {
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      const int r = rank_in<MAXN>(key, i);
      if (r >= a && r < a + b) {
        sum += key[i];
      }
    }
    const float mean = sum / (float)b;
    result = isfinite(mean) ? mean : NAN;
  } else {
    float med = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (rank_in<MAXN>(key, i) == a) {
        med = val[i];
      }
    }
    result = med;
    if (OP == kAveragedMedian) {
#pragma unroll
      for (int j = 0; j < MAXN; ++j) {
        key[j] = inf_key(fabsf(val[j] - med));
      }
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (rank_in<MAXN>(key, i) < b) {
          sum += val[i];
        }
      }
      result = sum / (float)b;
    }
  }
  out[col] = result;
}

// ---------------------------------------------------------------------------
// n > 64: every rank pass re-reads the column from device memory.

__device__ __forceinline__ float row_key(const float* column, long long d, int j,
                                         bool deviation, float med) {
  const float v = column[(long long)j * d];
  return deviation ? inf_key(fabsf(v - med)) : inf_key(v);
}

__device__ int rank_global(const float* column, long long d, int n, int i,
                           bool deviation, float med) {
  const float ki = row_key(column, d, i, deviation, med);
  int r = 0;
  for (int j = 0; j < n; ++j) {
    const float kj = row_key(column, d, j, deviation, med);
    r += (kj < ki) || (kj == ki && j < i);
  }
  return r;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
coord_global(const float* __restrict__ x, float* __restrict__ out, int n,
             long long d, int a, int b) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) {
    return;
  }
  const float* column = x + col;
  float result = 0.0f;
  if (OP == kTrimmedMean) {
    float sum = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = rank_global(column, d, n, i, false, 0.0f);
      if (r >= a && r < a + b) {
        sum += inf_key(column[(long long)i * d]);
      }
    }
    const float mean = sum / (float)b;
    result = isfinite(mean) ? mean : NAN;
  } else {
    float med = 0.0f;
    for (int i = 0; i < n; ++i) {
      if (rank_global(column, d, n, i, false, 0.0f) == a) {
        med = column[(long long)i * d];
        break;
      }
    }
    result = med;
    if (OP == kAveragedMedian) {
      float sum = 0.0f;
      for (int i = 0; i < n; ++i) {
        if (rank_global(column, d, n, i, true, med) < b) {
          sum += column[(long long)i * d];
        }
      }
      result = sum / (float)b;
    }
  }
  out[col] = result;
}

template <int OP>
int launch(const float* x, float* out, int n, long long d, int a, int b,
           void* stream) {
  const unsigned int grid = (unsigned int)((d + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 8) {
    coord_regs<8, OP><<<grid, kThreads, 0, s>>>(x, out, n, d, a, b);
  } else if (n <= 16) {
    coord_regs<16, OP><<<grid, kThreads, 0, s>>>(x, out, n, d, a, b);
  } else if (n <= 32) {
    coord_regs<32, OP><<<grid, kThreads, 0, s>>>(x, out, n, d, a, b);
  } else if (n <= 64) {
    coord_regs<64, OP><<<grid, kThreads, 0, s>>>(x, out, n, d, a, b);
  } else {
    coord_global<OP><<<grid, kThreads, 0, s>>>(x, out, n, d, a, b);
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
average_nan_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                   long long d) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) {
    return;
  }
  float total = 0.0f;
  float count = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float v = x[(long long)j * d + col];
    if (isfinite(v)) {
      total += v;
      count += 1.0f;
    }
  }
  out[col] = count > 0.0f ? total / count : 0.0f;
}

}  // namespace

extern "C" {

// x: (n, d) row-major float32; out: (d,).  Each returns cudaGetLastError().
int agg_coordinate_median(const float* x, float* out, int n, long long d,
                          void* stream) {
  return launch<kMedian>(x, out, n, d, n / 2, 0, stream);
}

int agg_coordinate_averaged_median(const float* x, float* out, int n,
                                   long long d, int beta, void* stream) {
  return launch<kAveragedMedian>(x, out, n, d, n / 2, beta, stream);
}

int agg_coordinate_trimmed_mean(const float* x, float* out, int n, long long d,
                                int trim, int keep, void* stream) {
  return launch<kTrimmedMean>(x, out, n, d, trim, keep, stream);
}

int agg_average_nan_columns(const float* x, float* out, int n, long long d,
                            void* stream) {
  const unsigned int grid = (unsigned int)((d + kThreads - 1) / kThreads);
  average_nan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, out, n, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
