// K1: all-pairs squared L2 distances of the rows of an (n, d) float32 matrix,
// in the difference form sum_c (x_ic - x_jc)^2, for n <= 64.
//
// Replaces the Pallas body `_dist_diff_kernel` (aggregathor_tpu/ops/
// pallas_kernels.py:237-245), reached through `pairwise_sq_distances(x,
// use_mxu=False)`, the form the JAX wrapper picks for n <= 64 (:280-281): it
// is exact without centring, which the Gram form (K2, gram.cu) is not.  The
// Krum and Bulyan rules call it once a step on the (n, d) gradient matrix.
//
// What bounds it on the H100, at d = 1,756,682 (the cnnet gradient):
//   n <= 20: the bytes.  x is read once, n*d*4 bytes: 56 MB at n = 8, 17 us
//     at 3.35 TB/s (77 MB, 23 us at n = 11), against n(n-1)/2 * d * 3 FP32
//     operations for the pairs i < j and n * d for the diagonal, which a
//     row's finiteness decides (2 us at n = 8 at 67 TFLOP/s).
//   n = 64: the operations.  2,016 pairs * 3 * d + 64 * d = 10.7 GFLOP,
//     0.160 ms at 67 TFLOP/s, against 450 MB (0.134 ms) of bytes.  The
//     kernels sum the diagonal like any pair, and a pair and column take
//     two instructions (a subtract and a fused multiply-add), so the
//     instruction rate allows them no less than about 0.22 ms.
//
// What the design does about it.  One launch, one pass over x:
//   - A block owns a contiguous chunk of columns; the grid is one wave
//     (`k1::distance_layout`, distances_layout.h, sizes it from the SM
//     count).  Every thread keeps its pair sums in registers across all
//     the columns it visits.
//   - n <= 20 (`rows_kernel<N, W>`, one instance per n): each thread
//     loads its column's n values straight from device memory into registers,
//     neighbouring threads on neighbouring columns, W = 2 columns a load
//     (8-byte loads) when d is even and x 8-byte aligned, else 1.  The next
//     column's values are loaded before this column's n(n+1)/2 pair terms
//     are added, so loads stay in flight while the block computes.  No
//     shared-memory staging.  d = 2 mod 4 at the cnnet width, so rows are
//     only 8-byte aligned: no 16-byte loads and no TMA.  Up to 11 rows (at
//     most 124 registers) two blocks share an SM; from 12 rows (164 and up)
//     one.  Past 16 rows the sums crowd the registers, yet at 17-20 rows
//     this path still beat the staged one on the card, so it serves to 20.
//     Exact instances, not padded ones: N = 8, 12, 16 and 20 with the rows
//     past n zero took 12-30 % longer at n = 8 and 11 and about twice as
//     long at 17-19 rows, and a run-time n under an exact N alone cost
//     8-29 % (`scripts/torch_rank_timing.py --k1-rows`, PERF.md).
//   - 20 < n <= 64 (`tiles_kernel<N, kBytes>`, N = 32 or 64 padded rows):
//     (n, 128) column tiles are staged in shared memory by a `cp.async`
//     ring of three stages, 8-byte copies when d is even and x 8-byte
//     aligned, else 4-byte.  A tile stores each column pair's rows side by
//     side ([pair][row][2]), so eight rows of a column pair are four 16-byte
//     shared loads.  The 8-row blocks make the tasks: each off-diagonal
//     pair of blocks (I < J) is a task of 64 pair sums, two diagonal blocks
//     together one of 2 x 36.  A thread keeps one task's sums in registers
//     on every lanes-th column pair of a tile (8 lanes a task at N = 64, 32
//     at N = 32): eight shared loads feed 128 pair terms, where the first
//     design took two loads per pair and column.  Warps hold tasks of one
//     kind, and a block has a whole number of warps: n = 64 runs 8 warps a
//     block (36 tasks of 8 lanes, the first layout, made 9, and one of the
//     SM's four schedulers had 3).  Two blocks share an SM, their sums held
//     in at most 128 registers a thread.  Rows past n are never loaded and
//     their pairs never written; columns past the chunk are zero-filled by
//     the copy and add (0 - 0)^2 = 0.
//   - Each block reduces its pair sums in a fixed order (warp shuffles,
//     then warps in order through shared memory) into row `blockIdx.x` of a
//     (blocks, n(n+1)/2) scratch.  The last block to finish -- it learns so
//     from a `__threadfence()` and an integer `atomicAdd` on an arrival
//     counter -- sums the scratch in a fixed order, writes (i, j) and (j, i),
//     and resets the counter to 0 for the next call.  The wrapper keeps one
//     zeroed counter per device and stream.  No float atomics: a run gives
//     the same bits on the same input and layout every time, so Krum's
//     selection cannot change between two runs.
// What holds the staged path back (scratch variants on the card, PERF.md):
// a warp's `cp.async` copies go out slowly whatever their size (8-byte
// copies moved about twice the bytes of 4-byte ones in the same time), so
// the summing warps, which also copy, stall on them: copies and sums take
// about as long as each alone added.  One warp copying for the others was
// slower still, spreading each thread's copies between its column steps
// did not help, and staging through registers took 255 registers.  16-byte
// copies or TMA would halve the copies, but the cnnet rows are only 8-byte
// aligned.
// The batched form: L stacked (n, d) leaves, (L, n, d) contiguous, in one
// launch of the same kernels over a (blocks, L) grid, each leaf's layout
// sized for its share of the SMs (`k1::batched_layout`).  Block (b, l)
// offsets x, the scratch, the output and the arrival counter to leaf l's and
// then runs the unbatched code: leaf l's blocks reduce among themselves and
// the last of them to arrive finishes leaf l, so each leaf's sums run in
// the order of an unbatched launch of that layout.  The wrapper keeps one
// zeroed counter a leaf.  The offsets are a template flag (BATCHED): one
// leaf runs the unbatched instances, whose pointers stay kernel parameters
// (offset ones would take registers these kernels spend on sums).
// Semantics, as the plain version's: the diagonal is computed like any
// pair, so it is exactly 0 for a finite row; a NaN anywhere in row i makes
// row and column i NaN; an inf gives inf off the diagonal and NaN on it
// ((inf - inf)^2).

#include <cuda_runtime.h>
#include <stdint.h>

#include "distances_layout.h"

using namespace k1;

namespace {

constexpr int kTileMaxThreads = 256;   // threads of a tiles_kernel block, at most

// (i, j), i <= j, -> its index in the row-major upper triangle of n rows
__host__ __device__ constexpr int pair_index(int i, int j, int n) {
  return i * n - i * (i - 1) / 2 + (j - i);
}

__device__ __forceinline__ void pair_of(int p, int n, int* i, int* j) {
  int row = 0, rem = p;
  while (rem >= n - row) {
    rem -= n - row;
    ++row;
  }
  *i = row;
  *j = row + rem;
}

// Called by every thread of every block once the block's pair sums are in
// row blockIdx.x of `scratch`.  The last block to arrive sums each pair over
// the blocks in a fixed order -- `slices` threads a pair when there are
// fewer pairs than threads, each taking every slices-th block in order,
// then the slices in order -- writes out[i][j] and out[j][i], and resets the counter.
// `red` is shared memory of at least blockDim.x floats.
__device__ void finish_last_block(const float* __restrict__ scratch, float* __restrict__ out,
                                  unsigned int* counter, int n, float* red) {
  __shared__ unsigned int arrived;
  __threadfence();  // this thread's scratch writes, before the block's arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    arrived = atomicAdd(counter, 1u);
  }
  __syncthreads();
  if (arrived != gridDim.x - 1) {
    return;
  }
  __threadfence();
  const int pairs = pair_count(n), blocks = gridDim.x, threads = blockDim.x;
  const int slices = pairs < threads ? min(threads / pairs, blocks) : 1;
  for (int task = threadIdx.x; task < pairs * slices; task += threads) {
    const int p = task % pairs, s = task / pairs;
    const float* at = scratch + p;
    float sum = 0.0f;
    int b = s;
    for (; b + 7 * slices < blocks; b += 8 * slices) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(at + (long long)(b + u * slices) * pairs);
#pragma unroll
      for (int u = 0; u < 8; ++u) sum += v[u];
    }
    for (; b < blocks; b += slices) sum += __ldcg(at + (long long)b * pairs);
    if (slices > 1) {
      red[task] = sum;
    } else {
      int i, j;
      pair_of(p, n, &i, &j);
      out[i * n + j] = sum;
      out[j * n + i] = sum;
    }
  }
  if (slices > 1) {
    __syncthreads();
    for (int p = threadIdx.x; p < pairs; p += threads) {
      float sum = 0.0f;
      for (int s = 0; s < slices; ++s) sum += red[s * pairs + p];
      int i, j;
      pair_of(p, n, &i, &j);
      out[i * n + j] = sum;
      out[j * n + i] = sum;
    }
  }
  if (threadIdx.x == 0) {
    *counter = 0u;  // ready for the next call on this stream
  }
}

// ---------------------------------------------------------------- n <= 20

template <int W>
__device__ __forceinline__ void load_column(const float* __restrict__ x, long long d, long long col,
                                            int row, float (&v)[W]) {
  if constexpr (W == 2) {
    const float2 pair = __ldcs(reinterpret_cast<const float2*>(x + (long long)row * d + col));
    v[0] = pair.x;
    v[1] = pair.y;
  } else {
    v[0] = __ldcs(x + (long long)row * d + col);
  }
}

template <int N, int W, bool BATCHED>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const float* __restrict__ x, float* __restrict__ scratch, float* __restrict__ out,
            unsigned int* counter, long long d, long long chunk) {
  constexpr int kPairs = pair_count(N);
  constexpr long long kStep = (long long)kRowThreads * W;
  extern __shared__ float smem[];  // (warps, pairs) sums, then the finish's slices
  if (BATCHED) {  // leaf blockIdx.y: its rows, scratch, output and counter
    x += (long long)blockIdx.y * N * d;
    scratch += (long long)blockIdx.y * gridDim.x * kPairs;
    out += (long long)blockIdx.y * N * N;
    counter += blockIdx.y;
  }
  float acc[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) acc[p] = 0.0f;

  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = c0 + chunk < d ? c0 + chunk : d;  // W = 2: d and chunk even
  long long col = c0 + (long long)threadIdx.x * W;
  float cur[N][W];
  if (col < c1) {
#pragma unroll
    for (int r = 0; r < N; ++r) load_column<W>(x, d, col, r, cur[r]);
  }
  for (; col < c1; col += kStep) {
    const bool more = col + kStep < c1;
    float next[N][W];
    if (more) {
#pragma unroll
      for (int r = 0; r < N; ++r) load_column<W>(x, d, col + kStep, r, next[r]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = i; j < N; ++j) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float diff = cur[i][w] - cur[j][w];
          acc[pair_index(i, j, N)] = fmaf(diff, diff, acc[pair_index(i, j, N)]);
        }
      }
    }
    if (more) {
#pragma unroll
      for (int r = 0; r < N; ++r) {
#pragma unroll
        for (int w = 0; w < W; ++w) cur[r][w] = next[r][w];
      }
    }
  }

  // the block's sums: a butterfly over the warp's lanes (every lane ends
  // with the same bits), then the warps in order
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    float v = acc[p];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
    if (lane == 0) smem[warp * kPairs + p] = v;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < kPairs; p += kRowThreads) {
    float sum = 0.0f;
    for (int w = 0; w < kRowThreads / 32; ++w) sum += smem[w * kPairs + p];
    scratch[(long long)blockIdx.x * kPairs + p] = sum;
  }
  __syncthreads();  // smem is the finish's next
  finish_last_block(scratch, out, counter, N, smem);
}

// ---------------------------------------------------------- 20 < n <= 64

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int src_bytes) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(s), "l"(src), "n"(kBytes), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Stage columns k0..k0+127 of rows 0..n-1 into `dst`; columns >= c1 read
// as 0.  A warp's copies cover 4 rows x 8 column pairs (kBytes = 8: each
// row a 64-byte run; its shared writes, 2 (column pair) + row (mod 16)
// 8-byte slots for a half warp, on distinct banks) or 4 rows x 8 columns
// (kBytes = 4).
template <int N, int kBytes>
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int n, long long d,
                                          long long k0, long long c1, float* dst) {
  constexpr int kStride = tile_pair_stride(N);
  constexpr int kWidth = kBytes / 4;                 // columns a copy
  constexpr int kAcross = kTileCols / kWidth / 8;    // patches across the tile
  const int slots = (n + 3) / 4 * 32 * kAcross;
  for (int q = threadIdx.x; q < slots; q += blockDim.x) {
    const int patch = q / 32, within = q % 32;
    const int row = patch / kAcross * 4 + within / 8;
    const int col = (patch % kAcross * 8 + within % 8) * kWidth;
    if (row < n) {
      const bool ok = k0 + col < c1;  // kBytes = 8: d even, so a pair is all in or all out
      cp_async<kBytes>(dst + col / 2 * kStride + row * 2 + col % 2,
                       ok ? x + (long long)row * d + k0 + col : x, ok ? kBytes : 0);
    }
  }
}

// Upper triangle (r <= s) of an 8-row block, row-major.
__host__ __device__ constexpr int tri(int r, int s) { return r * kMicro - r * (r - 1) / 2 + (s - r); }
constexpr int kTri = kMicro * (kMicro + 1) / 2;

// Eight rows (block `block`) of a staged column pair, as (even, odd) column
// values row by row: four 16-byte shared loads.
__device__ __forceinline__ void load_rows(const float* pair, int block, float (&v)[2 * kMicro]) {
  const float4* at = reinterpret_cast<const float4*>(pair) + kMicro / 2 * block;
#pragma unroll
  for (int k = 0; k < kMicro / 2; ++k) {
    const float4 q = at[k];
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}

template <int N, int kBytes, bool BATCHED>
__global__ void __launch_bounds__(kTileMaxThreads, kTileBlocksPerSM)  // two blocks an SM: 128 registers a thread
tiles_kernel(const float* __restrict__ x, float* __restrict__ scratch, float* __restrict__ out,
             unsigned int* counter, int n, long long d, long long chunk) {
  constexpr int kStride = tile_pair_stride(N);
  constexpr int kStageFloats = tile_floats(N);
  extern __shared__ __align__(16) float smem[];
  if (BATCHED) {  // leaf blockIdx.y: its rows, scratch, output and counter
    x += (long long)blockIdx.y * n * d;
    scratch += (long long)blockIdx.y * gridDim.x * pair_count(n);
    out += (long long)blockIdx.y * n * n;
    counter += blockIdx.y;
  }
  constexpr int kLanes = task_lanes(N);
  const Tasks tasks(n, N);
  const int task = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const bool off_diagonal = task < tasks.off_diagonal;
  const bool diagonal = task >= tasks.diagonal_start && task < tasks.count;
  int bi = 0, bj = 0;  // row blocks: an off-diagonal pair bi < bj, or diagonal blocks bi and bj = bi + 1
  if (off_diagonal) {
    int rem = task;
    while (rem >= tasks.blocks_of_rows - 1 - bi) {
      rem -= tasks.blocks_of_rows - 1 - bi;
      ++bi;
    }
    bj = bi + 1 + rem;
  } else if (diagonal) {
    bi = 2 * (task - tasks.diagonal_start);
    bj = bi + 1;  // may be the padding block past n: read, never written
  }
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = c0 + chunk < d ? c0 + chunk : d;
  const int nb_tiles = (int)((c1 - c0 + kTileCols - 1) / kTileCols);

  float acc[2 * kTri];  // off-diagonal: (r, s) at 8 r + s; diagonal: tri(r, s), then kTri + tri(r, s)
#pragma unroll
  for (int k = 0; k < 2 * kTri; ++k) acc[k] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nb_tiles) load_tile<N, kBytes>(x, n, d, c0 + (long long)s * kTileCols, c1, smem + s * kStageFloats);
    cp_async_commit();  // one group a stage, empty or not, so the wait counts hold
  }
  for (int t = 0; t < nb_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
    __syncthreads();               // everyone's have; tile t - 1 is summed
    const int ahead = t + kStages - 1;
    if (ahead < nb_tiles) {        // into tile t - 1's stage
      load_tile<N, kBytes>(x, n, d, c0 + (long long)ahead * kTileCols, c1, smem + ahead % kStages * kStageFloats);
    }
    cp_async_commit();
    const float* tile = smem + (t % kStages) * kStageFloats;
    // (a branch per task kind around each column loop, not inside it: one
    // kind's values and sums live at a time, which keeps the registers for
    // twelve warps an SM)
    if (off_diagonal) {
#pragma unroll 2
      for (int c = lane; c < kTileCols / 2; c += kLanes) {
        float a[2 * kMicro], b[2 * kMicro];  // rows' (even, odd) column values
        load_rows(tile + c * kStride, bi, a);
        load_rows(tile + c * kStride, bj, b);
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
#pragma unroll
          for (int s = 0; s < kMicro; ++s) {
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              const float diff = a[2 * r + w] - b[2 * s + w];
              acc[r * kMicro + s] = fmaf(diff, diff, acc[r * kMicro + s]);
            }
          }
        }
      }
    } else if (diagonal) {
#pragma unroll 2
      for (int c = lane; c < kTileCols / 2; c += kLanes) {
        float a[2 * kMicro], b[2 * kMicro];
        load_rows(tile + c * kStride, bi, a);
        load_rows(tile + c * kStride, bj, b);
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
#pragma unroll
          for (int s = r; s < kMicro; ++s) {
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              const float da = a[2 * r + w] - a[2 * s + w], db = b[2 * r + w] - b[2 * s + w];
              acc[tri(r, s)] = fmaf(da, da, acc[tri(r, s)]);
              acc[kTri + tri(r, s)] = fmaf(db, db, acc[kTri + tri(r, s)]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // a task's sums: a butterfly over its kLanes lanes, all in one warp
  const unsigned int mask = (0xffffffffu >> (32 - kLanes)) << (threadIdx.x % 32 / kLanes * kLanes);
#pragma unroll
  for (int k = 0; k < 2 * kTri; ++k) {
#pragma unroll
    for (int offset = kLanes / 2; offset > 0; offset >>= 1) {
      acc[k] += __shfl_xor_sync(mask, acc[k], offset);
    }
  }
  if (lane == 0) {
    float* row_out = scratch + (long long)blockIdx.x * pair_count(n);
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
#pragma unroll
      for (int s = 0; s < kMicro; ++s) {
        if (off_diagonal) {
          const int i = kMicro * bi + r, j = kMicro * bj + s;
          if (j < n) row_out[pair_index(i, j, n)] = acc[r * kMicro + s];
        } else if (diagonal && r <= s) {
          const int i = kMicro * bi + r, j = kMicro * bi + s;
          if (j < n) row_out[pair_index(i, j, n)] = acc[tri(r, s)];
          if (j + kMicro < n) row_out[pair_index(i + kMicro, j + kMicro, n)] = acc[kTri + tri(r, s)];
        }
      }
    }
  }
  __syncthreads();  // the ring's reads are done: smem is the finish's next
  finish_last_block(scratch, out, counter, n, smem);
}

// ------------------------------------------------------------ the launches

// (Every leaf starts 8-byte aligned when x is and d is even.)
template <int N>
cudaError_t launch_rows(const float* x, float* out, float* scratch, unsigned int* counter, int leaves,
                        long long d, const Layout& l, cudaStream_t s) {
  const dim3 grid(l.blocks, leaves);
  // 8-byte loads need every row start 8-byte aligned: d even and x too
  const bool pairs = d % 2 == 0 && (uintptr_t)x % 8 == 0;
  auto kernel = pairs ? (leaves > 1 ? rows_kernel<N, 2, true> : rows_kernel<N, 2, false>)
                      : (leaves > 1 ? rows_kernel<N, 1, true> : rows_kernel<N, 1, false>);
  kernel<<<grid, l.threads, l.smem, s>>>(x, scratch, out, counter, d, l.chunk);
  return cudaGetLastError();
}

// The register instance of l.rows rows, out of RegisterRows.
template <int... Ns>
cudaError_t launch_register_rows(std::integer_sequence<int, Ns...>, const float* x, float* out, float* scratch,
                                 unsigned int* counter, int leaves, long long d, const Layout& l,
                                 cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  ((err = l.rows == Ns ? launch_rows<Ns>(x, out, scratch, counter, leaves, d, l, s) : err), ...);
  return err;
}

template <int N>
cudaError_t launch_tiles(const float* x, float* out, float* scratch, unsigned int* counter, int leaves,
                         int n, long long d, const Layout& l, cudaStream_t s) {
  // 8-byte copies need every row start 8-byte aligned: d even and x too
  const bool pairs = d % 2 == 0 && (uintptr_t)x % 8 == 0;
  auto kernel = pairs ? (leaves > 1 ? tiles_kernel<N, 8, true> : tiles_kernel<N, 8, false>)
                      : (leaves > 1 ? tiles_kernel<N, 4, true> : tiles_kernel<N, 4, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<dim3(l.blocks, leaves), l.threads, l.smem, s>>>(x, scratch, out, counter, n, d, l.chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The grid K1 takes a leaf for `leaves` stacked (n, d) matrices on a card
// of `sms` SMs: the scratch rows a leaf that agg_pairwise_sq_distances
// needs.  0 if leaves, n or d is out of range.
int agg_pairwise_sq_distances_blocks(int leaves, int n, long long d, int sms) {
  if (leaves < 1 || leaves > 65535 || n < 1 || n > kMaxRows || d < 1 || sms < 1) {
    return 0;
  }
  return batched_layout(leaves, n, d, sms).blocks;
}

// x: (leaves, n, d) row-major float32 (one matrix: leaves = 1); out:
// (leaves, n, n); scratch: leaves * agg_pairwise_sq_distances_blocks(...) *
// n(n+1)/2 floats; counters: `leaves` unsigned ints, 0 on entry (and on
// return: each leaf's last block resets its own), used by no other stream
// meanwhile.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// leaves, n or d out of range.
int agg_pairwise_sq_distances(const float* x, float* out, float* scratch, unsigned int* counters,
                              int leaves, int n, long long d, int sms, void* stream) {
  if (leaves < 1 || leaves > 65535 || n < 1 || n > kMaxRows || d < 1 || sms < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout l = batched_layout(leaves, n, d, sms);
  cudaStream_t s = (cudaStream_t)stream;
  switch (l.rows) {
    case 32: return (int)launch_tiles<32>(x, out, scratch, counters, leaves, n, d, l, s);
    case 64: return (int)launch_tiles<64>(x, out, scratch, counters, leaves, n, d, l, s);
    default: return (int)launch_register_rows(RegisterRows{}, x, out, scratch, counters, leaves, d, l, s);
  }
}

}  // extern "C"
