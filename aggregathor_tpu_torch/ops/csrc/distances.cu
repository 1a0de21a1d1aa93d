// K1: all-pairs squared L2 distances of the rows of an (n, d) float32 matrix.
//
// Replaces the Pallas body `_dist_diff_kernel` (aggregathor_tpu/ops/
// pallas_kernels.py:237-245), reached through `pairwise_sq_distances(x,
// use_mxu=False)`, the form the JAX package picks for n <= 64.  The Krum and
// Bulyan rules call it once a step on the (n, d) gradient matrix.
//
// What bounds it on the H100: the bytes.  The matrix is read once (n*d*4
// bytes: 56 MB at n=8, d=1,756,682, about 17 us at 3.35 TB/s) against
// n(n+1)/2 * d * 3 FP32 operations (0.19 GFLOP at n=8, about 3 us at
// 67 TFLOP/s).
//
// What the design does about it.  The TPU kernel carries an (n, n) tile
// across the sequential column axis of its grid; Hopper blocks run in no
// order, so that carry becomes two passes:
//   1. `partial_kernel`: one block per chunk of columns stages the (n, chunk)
//      slab in dynamic shared memory (each input byte read once from device
//      memory, coalesced along the row), then each warp takes pairs (i <= j)
//      in turn, its lanes stride the chunk's columns and a fixed shuffle tree
//      sums them.  The pair sum goes to a (pairs, chunks) scratch.
//   2. `finish_kernel`: one block per pair sums that pair's chunk partials in
//      a fixed order (strided per thread, then a fixed shared-memory tree)
//      and writes both (i, j) and (j, i).
// No float atomics anywhere, so a run gives the same bits on the same input
// every time: Krum's selection cannot change between two runs.  The diagonal
// is computed like any pair, so it is exactly 0 for a finite row, and a
// NaN (or inf) anywhere in row i makes row and column i NaN, as in the TPU
// kernel.  The slab holds n * chunk floats: the wrapper picks chunk so that
// this stays at or under 64 KB for n <= 64 (above 48 KB the block needs the
// dynamic shared-memory attribute, set below).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ x, float* __restrict__ partial,
               int n, long long d, int chunk, int nb_chunks) {
  extern __shared__ float slab[];  // (n, chunk), row-major
  const long long c0 = (long long)blockIdx.x * chunk;
  const int total = n * chunk;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int r = idx / chunk;
    const int c = idx - r * chunk;
    const long long col = c0 + c;
    // columns past d read as 0 in every row: they add (0 - 0)^2 = 0
    slab[idx] = col < d ? x[(long long)r * d + col] : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nb_pairs = n * (n + 1) / 2;
  for (int p = warp; p < nb_pairs; p += kWarps) {
    // pair index p -> (i, j), i <= j, row-major over the upper triangle
    int i = 0, rem = p;
    while (rem >= n - i) {
      rem -= n - i;
      ++i;
    }
    const int j = i + rem;
    const float* a = slab + i * chunk;
    const float* b = slab + j * chunk;
    float acc = 0.0f;
    for (int c = lane; c < chunk; c += 32) {
      const float diff = a[c] - b[c];
      acc = fmaf(diff, diff, acc);
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, offset);
    }
    if (lane == 0) {
      partial[(long long)p * nb_chunks + blockIdx.x] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ partial, float* __restrict__ out,
              int n, int nb_chunks) {
  __shared__ float sums[kThreads];
  const int p = blockIdx.x;
  const float* row = partial + (long long)p * nb_chunks;
  float acc = 0.0f;
  for (int c = threadIdx.x; c < nb_chunks; c += kThreads) {
    acc += row[c];
  }
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int width = kThreads / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) {
      sums[threadIdx.x] += sums[threadIdx.x + width];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int i = 0, rem = p;
    while (rem >= n - i) {
      rem -= n - i;
      ++i;
    }
    const int j = i + rem;
    out[i * n + j] = sums[0];
    out[j * n + i] = sums[0];
  }
}

}  // namespace

extern "C" {

// x: (n, d) row-major float32; out: (n, n); scratch: n(n+1)/2 * nb_chunks
// floats, nb_chunks = ceil(d / chunk).  Returns cudaGetLastError().
int agg_pairwise_sq_distances(const float* x, float* out, float* scratch,
                              int n, long long d, int chunk, void* stream) {
  const int nb_chunks = (int)((d + chunk - 1) / chunk);
  const int nb_pairs = n * (n + 1) / 2;
  const size_t smem = (size_t)n * chunk * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    return (int)err;
  }
  partial_kernel<<<nb_chunks, kThreads, smem, s>>>(x, scratch, n, d, chunk, nb_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return (int)err;
  }
  finish_kernel<<<nb_pairs, kThreads, 0, s>>>(scratch, out, n, nb_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
