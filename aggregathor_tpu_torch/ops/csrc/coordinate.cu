// K3, K4, K5: per-column rank selection over an (n, d) float32 matrix, the
// centring median in front of K2, and K6: the per-column mean of the finite
// entries.
//
// Replaces, of aggregathor_tpu/ops/pallas_kernels.py:
//   K3 `_median_kernel` (:143-145)           -> coordinate_median
//   K4 `_averaged_median_kernel` (:148-153)  -> coordinate_averaged_median
//   K5 `_trimmed_mean_kernel` (:156-166)     -> coordinate_trimmed_mean
//      with both tiers of `_ranks` feeding them (:101-121): the unrolled one
//      up to 64 rows, the `fori_loop` one beyond;
//   the centring `jnp.nanmedian` of the Gram-form distances (:289)
//                                            -> nanmedian_columns
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
//   The centring takes the k finite values of a column and returns the mean
//      of those at ranks (k-1)/2 and k/2 (numpy's even-count rule), 0 where
//      k = 0, through torch.nan_to_num's rule.
//
// What bounds it on the H100: the bytes.  One read of n*d*4 bytes and one
// write of d*4 bytes: 18 us at n=8, 0.233 ms at (110, 1,756,682) and 0.268 ms
// at (128, 1,756,682), at 3.35 TB/s.
//
// What the design does about it.  Every path reads each input value from
// device memory once, in coalesced row reads, and sums in row order, so the
// results repeat bit for bit run to run.
//   n <= 64 (`coord_regs`): one thread per column, the column's values and
//      keys in registers, templated on the padded row count (8/16/32/64;
//      padded slots key +inf at the highest indices, so they rank >= n and
//      never move a real row's rank -- the neutral padding the TPU kernel
//      uses too, minus its (8, 128) tiling); n^2 unrolled compares, far
//      below the memory time at the main path's n = 8.
//   64 < n <= 1024 (`coord_sort`, and the centring at any n <= 1024): the
//      n^2 compares per column would be 16k at n = 128, so the ranks come
//      from a sort instead.  A block stages an (n, C) tile of columns in
//      shared memory (4-byte loads: a row of the gradient matrix is not
//      16-byte aligned at odd d), then a group of 8, 16 or 32 lanes sorts
//      each column's keys, padded to P = 128/256/512/1024, with a bitonic
//      network: P log2(P)^2 / 4 compare-exchanges (1,792 at P = 128),
//      inside a lane's registers for strides below P / lanes and by
//      __shfl_xor_sync beyond -- 6 of the 28 stages at P = 128.  A group of
//      lanes, not a warp, per column: fewer lanes keep more strides in
//      registers, and registers, unlike a shared-memory network, need no
//      barrier between stages.  The sort carries keys alone; the key T at a
//      rank r and #{key < T} settle which rows rank below r, and one thread
//      per column then walks the staged column in row order to break the
//      ties by row, select the original value (K3), or sum the chosen rows
//      (K4, K5).  K4 sorts twice: the values, then the deviations.  The
//      block's layout (P, lanes, columns, tile stride) is the caller's
//      (`kernels.sort_shape`); the entry refuses one that is not exactly
//      the layout of its instance for that P.
//   n > 1024 (`coord_global`): each rank pass re-reads the column from
//      device memory (L1/L2 serve the repeats); slow, but right at any n.
//      No caller of the port comes near it; only the n = 1030 checks run it.
//
// K6 needs no rank: one thread per column reads each of the n values once,
// adds the finite ones and counts them in row order, for any n (nothing is
// kept, so no register template), and writes count > 0 ? total / count : 0.
// Bound by the same bytes as K3 (63.2 MB at n=8, d=1,756,682).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// K3, K4, K5 on every path; the centring median on the paths beyond 64 rows.
enum Op { kMedian = 0, kAveragedMedian = 1, kTrimmedMean = 2, kNanMedian = 3 };

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
// 64 < n <= 1024, and the centring at any n <= 1024: the sort path.
//
// The sort carries keys alone.  With T the key at sorted position r and
// before = #{key < T}, the rows of rank <= r are those keyed below T and the
// first r - before + 1 rows (in row order) keyed T; the row of rank r is the
// (r - before)-th of those.  Slot k of lane l sits at sorted position
// l * E + k.  Padded slots key +inf and never sort below a real key, so every
// rank < n reads the same T as an unpadded sort.

// staging loads a thread issues before it stores
constexpr int kLoadBatch = 4;

// The sort key: non-finite -> +inf, and -0 -> +0 (a tie for the rank rule,
// as a float compare sees it).
__device__ __forceinline__ float sort_key(float v) {
  return isfinite(v) ? v + 0.0f : INFINITY;
}

__host__ __device__ constexpr int log2_of(int v) { return v <= 1 ? 0 : 1 + log2_of(v / 2); }

template <int E, int LANES>
__device__ __forceinline__ void bitonic_sort(float (&key)[E], int lane) {
  constexpr int kLogP = log2_of(E * LANES);
#pragma unroll
  for (int ls = 1; ls <= kLogP; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
      if (stride >= E) {
        // partner: same slot of lane ^ (stride / E); the lower element of the
        // pair keeps the minimum where its size-block ascends
        const int lane_mask = stride / E;
        const bool lower = (lane & lane_mask) == 0;
        // size > stride >= E: the block's direction is the lane's
        const bool keep_min = lower == (((lane * E) & size) == 0);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float other = __shfl_xor_sync(0xffffffffu, key[k], lane_mask, LANES);
          key[k] = keep_min ? fminf(key[k], other) : fmaxf(key[k], other);
        }
      } else {
        // the direction: known per slot below E, per lane from E up
        const bool lane_up = ((lane * E) & size) == 0;
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if ((k & stride) == 0) {
            const bool up = size < E ? (k & size) == 0 : lane_up;
            const float lo = fminf(key[k], key[k + stride]);
            const float hi = fmaxf(key[k], key[k + stride]);
            key[k] = up ? lo : hi;
            key[k + stride] = up ? hi : lo;
          }
        }
      }
    }
  }
}

// The key at sorted position r of the group's column, and r - #{key < it}.
template <int E, int LANES>
__device__ __forceinline__ void rank_threshold(const float (&key)[E], int lane, int r,
                                               float* t_out, int* j_out) {
  float mine = key[0];
#pragma unroll
  for (int k = 1; k < E; ++k) {
    if (k == r % E) {
      mine = key[k];
    }
  }
  const float t = __shfl_sync(0xffffffffu, mine, r / E, LANES);
  int below = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    below += key[k] < t;
  }
#pragma unroll
  for (int m = LANES / 2; m > 0; m >>= 1) {
    below += __shfl_xor_sync(0xffffffffu, below, m, LANES);
  }
  *t_out = t;
  *j_out = r - below;
}

// A sort key that is its row's value: finite and not zero (a zero key may be
// -0, a +inf key NaN or either inf).
__device__ __forceinline__ bool is_value(float k) {
  return k != 0.0f && k < INFINITY;
}

// NaN -> 0, +-inf -> +-FLT_MAX, as torch.nan_to_num.
__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) {
    return 0.0f;
  }
  return isinf(v) ? copysignf(3.402823466e38f, v) : v;
}

// The sort block's layout, decided by the caller (`kernels.sort_shape`):
// rows padded to P, lanes a column, columns a block (lanes * columns =
// kThreads), and the staged tile's row stride in floats.  Zero rows: the
// re-reading path.
struct SortLayout {
  int rows;
  int lanes;
  int columns;
  int stride;
};

// The stride is a template parameter, not an argument: a run-time stride
// made the sort path 10-11 % slower on an H100 80GB HBM3.
template <int P, int LANES, int STRIDE>
__global__ void __launch_bounds__(kThreads)
coord_sort(const float* __restrict__ x, float* __restrict__ out, int n, long long d,
           int op, int a, int b) {
  constexpr int E = P / LANES;
  constexpr int C = kThreads / LANES;
  constexpr int stride = STRIDE;
  extern __shared__ float tile[];  // (n, stride)
  __shared__ float thr_key[2][C];
  __shared__ int thr_idx[2][C];
  __shared__ int finite_count[C];
  __shared__ float center[C];

  const int tid = threadIdx.x;
  const long long col0 = (long long)blockIdx.x * C;
  // kLoadBatch loads in flight a thread before the first store: one at a
  // time leaves the loads latency-bound, far below the memory rate
  const int total = n * C;
  for (int base = tid; base < total; base += kThreads * kLoadBatch) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kThreads;
      const int row = i / C;
      const long long col = col0 + (i - row * C);
      v[u] = i < total && col < d ? x[(long long)row * d + col] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < total) {
        const int row = i / C;
        tile[row * stride + (i - row * C)] = v[u];
      }
    }
  }
  __syncthreads();

  const int group = tid / LANES;  // this group's column in the tile
  const int lane = tid % LANES;
  const int nb_passes = op == kAveragedMedian ? 2 : 1;
#pragma unroll 1
  for (int pass = 0; pass < nb_passes; ++pass) {
    // pass 1 (K4 only) keys the deviations from the median of pass 0
    const float med = pass ? center[group] : 0.0f;
    float key[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int row = k * LANES + lane;  // any placement: the sort orders them
      float v = INFINITY;
      if (row < n) {
        v = tile[row * stride + group];
        v = sort_key(pass ? fabsf(v - med) : v);
      }
      key[k] = v;
    }
    bitonic_sort<E, LANES>(key, lane);

    // the ranks whose (T, j) the row-order pass needs
    int r0 = 0;
    int r1 = -1;
    if (op == kMedian || (op == kAveragedMedian && pass == 0)) {
      r0 = n / 2;
    } else if (op == kAveragedMedian) {
      r0 = b - 1;  // rank <= beta - 1
    } else if (op == kTrimmedMean) {
      r0 = a;          // rank >= trim
      r1 = a + b - 1;  // rank <= trim + keep - 1
    } else {
      int finite = 0;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        finite += key[k] < INFINITY;
      }
#pragma unroll
      for (int m = LANES / 2; m > 0; m >>= 1) {
        finite += __shfl_xor_sync(0xffffffffu, finite, m, LANES);
      }
      r0 = finite > 0 ? (finite - 1) / 2 : 0;
      r1 = finite / 2 < n ? finite / 2 : n - 1;
      if (lane == 0) {
        finite_count[group] = finite;
      }
    }
    float t0, t1 = 0.0f;
    int j0, j1 = 0;
    rank_threshold<E, LANES>(key, lane, r0, &t0, &j0);
    if (r1 >= 0) {  // group-uniform
      rank_threshold<E, LANES>(key, lane, r1, &t1, &j1);
    }
    if (lane == 0) {
      thr_key[0][group] = t0;
      thr_idx[0][group] = j0;
      thr_key[1][group] = t1;
      thr_idx[1][group] = j1;
    }
    __syncthreads();

    if (tid < C && col0 + tid < d) {
      const int c = tid;
      const float* column = tile + c;
      const float k0 = thr_key[0][c];
      const float k1 = thr_key[1][c];
      const int i0 = thr_idx[0][c];
      const int i1 = thr_idx[1][c];
      int eq0 = 0;
      int eq1 = 0;
      if (op == kMedian || (op == kAveragedMedian && pass == 0)) {
        // the row of rank n/2: the i0-th row keyed k0.  A finite non-zero key
        // is that row's value; only 0 (its sign) and +inf (NaN or which inf)
        // need the row.
        float value = k0;
        for (int row = 0; !is_value(k0) && row < n; ++row) {
          const float v = column[row * stride];
          if (sort_key(v) == k0) {
            if (eq0 == i0) {
              value = v;
              break;
            }
            ++eq0;
          }
        }
        if (op == kMedian) {
          out[col0 + c] = value;
        } else {
          center[c] = value;
        }
      } else if (op == kAveragedMedian) {
        const float column_med = center[c];  // not `med`: that is the sort group's
        float sum = 0.0f;
        for (int row = 0; row < n; ++row) {
          const float v = column[row * stride];
          const float kv = sort_key(fabsf(v - column_med));
          const bool tie = kv == k0;
          if (kv < k0 || (tie && eq0 <= i0)) {
            sum += v;
          }
          eq0 += tie;
        }
        out[col0 + c] = sum / (float)b;
      } else if (op == kTrimmedMean) {
        float sum = 0.0f;
        for (int row = 0; row < n; ++row) {
          const float v = column[row * stride];
          const float kv = sort_key(v);
          const bool tie0 = kv == k0;
          const bool tie1 = kv == k1;
          const bool below_trim = kv < k0 || (tie0 && eq0 < i0);
          const bool within_keep = kv < k1 || (tie1 && eq1 <= i1);
          if (!below_trim && within_keep) {
            sum += inf_key(v);
          }
          eq0 += tie0;
          eq1 += tie1;
        }
        const float mean = sum / (float)b;
        out[col0 + c] = isfinite(mean) ? mean : NAN;
      } else {
        // numpy's nanmedian: the finite values at ranks (k-1)//2 and k//2
        const int finite = finite_count[c];
        float low = k0;
        float high = k1;
        bool got0 = is_value(k0);
        bool got1 = is_value(k1);
        for (int row = 0; row < n && !(got0 && got1); ++row) {
          const float v = column[row * stride];
          const float kv = sort_key(v);
          if (kv == k0) {
            if (eq0 == i0 && !got0) {
              low = v;
              got0 = true;
            }
            ++eq0;
          }
          if (kv == k1) {
            if (eq1 == i1 && !got1) {
              high = v;
              got1 = true;
            }
            ++eq1;
          }
        }
        const float median = (finite & 1) ? low : (low + high) / 2.0f;
        out[col0 + c] = finite > 0 ? nan_to_num(median) : 0.0f;
      }
    }
    __syncthreads();  // pass 1 reads center[]
  }
}

template <int P, int LANES, int STRIDE>
int launch_sort(const float* x, float* out, int n, long long d, SortLayout l, int op, int a,
                int b, cudaStream_t s) {
  constexpr int C = kThreads / LANES;
  if (l.rows != P || l.lanes != LANES || l.columns != C || l.stride != STRIDE || n > P) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int grid = (unsigned int)((d + C - 1) / C);
  const size_t shared = (size_t)n * STRIDE * sizeof(float);
  coord_sort<P, LANES, STRIDE><<<grid, kThreads, shared, s>>>(x, out, n, d, op, a, b);
  return (int)cudaGetLastError();
}

// The instantiated layouts, one per P; the caller's must match one exactly.
int launch_sorted(const float* x, float* out, int n, long long d, SortLayout l, int op,
                  int a, int b, cudaStream_t s) {
  switch (l.rows) {
    case 128:
      return launch_sort<128, 8, 36>(x, out, n, d, l, op, a, b, s);
    case 256:
      return launch_sort<256, 16, 18>(x, out, n, d, l, op, a, b, s);
    case 512:
      return launch_sort<512, 32, 9>(x, out, n, d, l, op, a, b, s);
    case 1024:
      return launch_sort<1024, 32, 9>(x, out, n, d, l, op, a, b, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// n > 1024: every rank pass re-reads the column from device memory.  No caller
// of the port comes near it; it keeps every n served.

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

__global__ void __launch_bounds__(kThreads)
coord_global(const float* __restrict__ x, float* __restrict__ out, int n,
             long long d, int op, int a, int b) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) {
    return;
  }
  const float* column = x + col;
  float result = 0.0f;
  if (op == kTrimmedMean) {
    float sum = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = rank_global(column, d, n, i, false, 0.0f);
      if (r >= a && r < a + b) {
        sum += inf_key(column[(long long)i * d]);
      }
    }
    const float mean = sum / (float)b;
    result = isfinite(mean) ? mean : NAN;
  } else if (op == kNanMedian) {
    int finite = 0;
    for (int i = 0; i < n; ++i) {
      finite += isfinite(column[(long long)i * d]);
    }
    const int r0 = finite > 0 ? (finite - 1) / 2 : 0;
    const int r1 = finite / 2;
    float low = 0.0f;
    float high = 0.0f;
    for (int i = 0; finite > 0 && i < n; ++i) {
      const int r = rank_global(column, d, n, i, false, 0.0f);
      if (r == r0) {
        low = column[(long long)i * d];
      }
      if (r == r1) {
        high = column[(long long)i * d];
      }
    }
    const float median = (finite & 1) ? low : (low + high) / 2.0f;
    result = finite > 0 ? nan_to_num(median) : 0.0f;
  } else {
    float med = 0.0f;
    for (int i = 0; i < n; ++i) {
      if (rank_global(column, d, n, i, false, 0.0f) == a) {
        med = column[(long long)i * d];
        break;
      }
    }
    result = med;
    if (op == kAveragedMedian) {
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

// K3-K5 and the centring beyond the register path: the sort in the caller's
// layout, or, for a layout of zero rows, the re-reading path.
int launch_beyond_registers(const float* x, float* out, int n, long long d, SortLayout l,
                            int op, int a, int b, cudaStream_t s) {
  if (l.rows != 0) {
    return launch_sorted(x, out, n, d, l, op, a, b, s);
  }
  const unsigned int grid = (unsigned int)((d + kThreads - 1) / kThreads);
  coord_global<<<grid, kThreads, 0, s>>>(x, out, n, d, op, a, b);
  return (int)cudaGetLastError();
}

template <int OP>
int launch(const float* x, float* out, int n, long long d, int a, int b, SortLayout l,
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
    return launch_beyond_registers(x, out, n, d, l, OP, a, b, s);
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
// (rows, lanes, columns, stride): the sort path's layout (`SortLayout`), read
// beyond 64 rows; zero rows for the re-reading path.
int agg_coordinate_median(const float* x, float* out, int n, long long d, int rows,
                          int lanes, int columns, int stride, void* stream) {
  return launch<kMedian>(x, out, n, d, n / 2, 0, {rows, lanes, columns, stride}, stream);
}

int agg_coordinate_averaged_median(const float* x, float* out, int n, long long d,
                                   int beta, int rows, int lanes, int columns, int stride,
                                   void* stream) {
  return launch<kAveragedMedian>(x, out, n, d, n / 2, beta, {rows, lanes, columns, stride},
                                 stream);
}

int agg_coordinate_trimmed_mean(const float* x, float* out, int n, long long d, int trim,
                                int keep, int rows, int lanes, int columns, int stride,
                                void* stream) {
  return launch<kTrimmedMean>(x, out, n, d, trim, keep, {rows, lanes, columns, stride},
                              stream);
}

// The centring median of the distances beyond 64 rows: numpy's nanmedian
// per column, 0 where nothing is finite, at any n.
int agg_nanmedian_columns(const float* x, float* out, int n, long long d, int rows,
                          int lanes, int columns, int stride, void* stream) {
  return launch_beyond_registers(x, out, n, d, {rows, lanes, columns, stride}, kNanMedian, 0,
                                 0, (cudaStream_t)stream);
}

int agg_average_nan_columns(const float* x, float* out, int n, long long d,
                            void* stream) {
  const unsigned int grid = (unsigned int)((d + kThreads - 1) / kThreads);
  average_nan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, out, n, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
