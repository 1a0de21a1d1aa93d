// K2: Gram-form all-pairs squared distances of the rows of an (n, d) float32
// matrix whose rows are already centred, clamped at 0.
//
// Replaces the Pallas body `_dist_gram_kernel` (aggregathor_tpu/ops/
// pallas_kernels.py:248-263), reached through `pairwise_sq_distances(x)` for
// n > 64 (:280-290, 317).  The wrapper centres the rows by their NaN-ignoring
// column median first, as the JAX wrapper does (:289), so |a|^2 + |b|^2 - 2a.b
// stays conditioned.  Krum and Bulyan call it once a step beyond 64 workers.
//
// What bounds it on the H100: the operations.  n(n+1)/2 * d * 2 FP32
// operations (29.0 GFLOP at n=128, d=1,756,682: 0.433 ms at 67 TFLOP/s)
// against n*d*4 bytes read (899 MB: 0.268 ms at 3.35 TB/s).  The JAX twin pins
// Precision.HIGHEST (gars/common.py:128-141), so this kernel computes in FP32
// FMAs on the CUDA cores: no tensor cores, no TF32.
//
// What the design does about it.  The TPU kernel carries a (T, T) tile
// across a sequential column grid; Hopper blocks run in no order, so, as in
// K1, two passes replace the carry and no float atomics are used (a run gives
// the same bits every time, and Krum's choice cannot flip between runs):
//   1. `partial_kernel`: one block per (row-tile pair I <= J, column chunk).
//      The 64-row tiles of I and J are staged a 32-column slab at a time in
//      shared memory, transposed ([column][row], rows padded to 68 floats:
//      the float4 stores of 8 neighbouring columns hit 32 distinct banks).
//      Each of the 256 threads accumulates a 4 x 4 register block of the
//      (64, 64) Gram tile by outer products, with two float4 shared loads per
//      16 FMAs; the next slab's loads are in flight in registers meanwhile.
//      The block writes its partial tile to a (pairs, chunks, 64, 64) scratch.
//   2. `finish_kernel`: one thread per output (i, j) sums the chunk partials
//      of G_ij, G_ii and G_jj in chunk order, forms G_ii + G_jj - 2 G_ij,
//      clamps at 0 (NaN passes, as jnp.maximum lets it) and writes it.  The
//      norms come from the Gram diagonal of the same accumulation, so the
//      diagonal of a finite row is exactly 0 and the output is symmetric.
// Rows past n and columns past the chunk read as 0.  A NaN (or inf) anywhere
// in row i makes row and column i non-finite, as in the TPU kernel; a NaN in
// another row's column never reaches a clean pair.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;            // rows of a tile
constexpr int kSlab = 32;            // columns staged per step
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 outputs each
constexpr int kStride = kTile + 4;   // padded, float4-aligned row of the slab
constexpr int kGroups = kTile * kSlab / 4 / kThreads;  // 4-row groups per thread

__device__ __forceinline__ void pair_tiles(int p, int tiles, int* a, int* b) {
  int i = 0, rem = p;
  while (rem >= tiles - i) {
    rem -= tiles - i;
    ++i;
  }
  *a = i;
  *b = i + rem;
}

__device__ __forceinline__ int pair_index(int a, int b, int tiles) {
  return a * tiles - a * (a - 1) / 2 + (b - a);
}

// Four rows (r0..r0+3 of the tile starting at `row0`) of column `col`.
__device__ __forceinline__ void load_group(const float* __restrict__ x, int n,
                                           long long d, int row0, int r0,
                                           long long col, bool in_chunk,
                                           float* v) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row0 + r0 + e;
    v[e] = (in_chunk && row < n) ? x[(long long)row * d + col] : 0.0f;
  }
}

// Stage one slab: group g = threadIdx.x + kThreads * s holds rows
// 4*(g / 32)..+3 of slab column g % 32, so a warp's loads read 32
// neighbouring columns of one row.
__device__ __forceinline__ void load_slab(const float* __restrict__ x, int n,
                                          long long d, int row_a, int row_b,
                                          bool diagonal, long long k0,
                                          long long c1, float (&ra)[kGroups][4],
                                          float (&rb)[kGroups][4]) {
#pragma unroll
  for (int s = 0; s < kGroups; ++s) {
    const int g = threadIdx.x + kThreads * s;
    const int c = g % kSlab, r0 = (g / kSlab) * 4;
    const long long col = k0 + c;
    load_group(x, n, d, row_a, r0, col, col < c1, ra[s]);
    if (!diagonal) {
      load_group(x, n, d, row_b, r0, col, col < c1, rb[s]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ x, float* __restrict__ partial, int n,
               long long d, int chunk, int nb_chunks, int tiles) {
  __shared__ __align__(16) float as[kSlab][kStride];
  __shared__ __align__(16) float bs[kSlab][kStride];
  int ti, tj;
  pair_tiles(blockIdx.y, tiles, &ti, &tj);
  const bool diagonal = ti == tj;
  const int row_a = ti * kTile, row_b = tj * kTile;
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = c0 + chunk < d ? c0 + chunk : d;

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.0f;
    }
  }

  float ra[kGroups][4], rb[kGroups][4];
  load_slab(x, n, d, row_a, row_b, diagonal, c0, c1, ra, rb);
  for (long long k0 = c0; k0 < c1; k0 += kSlab) {
#pragma unroll
    for (int s = 0; s < kGroups; ++s) {
      const int g = t + kThreads * s;
      const int c = g % kSlab, r0 = (g / kSlab) * 4;
      *reinterpret_cast<float4*>(&as[c][r0]) = make_float4(ra[s][0], ra[s][1], ra[s][2], ra[s][3]);
      if (!diagonal) {
        *reinterpret_cast<float4*>(&bs[c][r0]) = make_float4(rb[s][0], rb[s][1], rb[s][2], rb[s][3]);
      }
    }
    __syncthreads();
    if (k0 + kSlab < c1) {
      load_slab(x, n, d, row_a, row_b, diagonal, k0 + kSlab, c1, ra, rb);
    }
    const float(*b)[kStride] = diagonal ? as : bs;
#pragma unroll 8
    for (int k = 0; k < kSlab; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b[k][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* tile = partial + ((long long)blockIdx.y * nb_chunks + blockIdx.x) * kTile * kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(&tile[(ty * 4 + i) * kTile + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// Sum of the chunk partials of Gram entry (i, j), in chunk order.
__device__ __forceinline__ float gram_entry(const float* __restrict__ partial,
                                            int i, int j, int tiles,
                                            int nb_chunks) {
  int ti = i / kTile, tj = j / kTile, li = i % kTile, lj = j % kTile;
  if (ti > tj) {  // the lower triangle of tiles reads the transposed partial
    int swap = ti; ti = tj; tj = swap;
    swap = li; li = lj; lj = swap;
  }
  const float* p = partial + (long long)pair_index(ti, tj, tiles) * nb_chunks * kTile * kTile
                   + li * kTile + lj;
  float sum = 0.0f;
  for (int c = 0; c < nb_chunks; ++c) {
    sum += p[(long long)c * kTile * kTile];
  }
  return sum;
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int n,
              int nb_chunks, int tiles) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)n * n) {
    return;
  }
  const int i = (int)(idx / n), j = (int)(idx % n);
  const float gij = gram_entry(partial, i, j, tiles, nb_chunks);
  const float gii = gram_entry(partial, i, i, tiles, nb_chunks);
  const float gjj = gram_entry(partial, j, j, tiles, nb_chunks);
  const float dist = (gii + gjj) - 2.0f * gij;
  out[idx] = dist < 0.0f ? 0.0f : dist;  // NaN compares false and passes
}

}  // namespace

extern "C" {

// x: (n, d) row-major float32, centred; out: (n, n); scratch: tiles(tiles+1)/2
// * nb_chunks * 64 * 64 floats, tiles = ceil(n / 64), nb_chunks = ceil(d /
// chunk), chunk a multiple of 32.  Returns cudaGetLastError().
int agg_gram_sq_distances(const float* x, float* out, float* scratch, int n,
                          long long d, int chunk, void* stream) {
  if (chunk <= 0 || chunk % kSlab != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (n + kTile - 1) / kTile;
  const int nb_pairs = tiles * (tiles + 1) / 2;
  const int nb_chunks = (int)((d + chunk - 1) / chunk);
  cudaStream_t s = (cudaStream_t)stream;
  partial_kernel<<<dim3(nb_chunks, nb_pairs), kThreads, 0, s>>>(
      x, scratch, n, d, chunk, nb_chunks, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return (int)err;
  }
  const long long entries = (long long)n * n;
  finish_kernel<<<(unsigned int)((entries + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      scratch, out, n, nb_chunks, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
