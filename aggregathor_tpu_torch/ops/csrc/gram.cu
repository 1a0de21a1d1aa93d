// K2: Gram-form all-pairs squared distances of the rows of an (n, d) float32
// matrix, centred by a (d,) vector inside the kernel, clamped at 0.
//
// Replaces the Pallas body `_dist_gram_kernel` (aggregathor_tpu/ops/
// pallas_kernels.py:248-263), reached through `pairwise_sq_distances(x)` for
// n > 64 (:280-290, 317).  The JAX wrapper subtracts the rows' NaN-ignoring
// column median first (:289-290), so |a|^2 + |b|^2 - 2a.b stays conditioned;
// here the median comes from `nanmedian_columns` and the subtraction happens
// as each staged slab is split into its TF32 parts, so no centred (n, d) copy
// is ever written.  Krum and Bulyan call it once a step beyond 64 workers.
//
// What bounds it on the H100: the bytes.  x is read once, (n d + d + n^2) * 4
// bytes: 906 MB at n = 128, d = 1,756,682, 0.271 ms at 3.35 TB/s.  An
// FP32-accurate product on the tensor cores (3xTF32: each value split into
// two TF32 parts, three products) is 3 * 2 * n(n+1)/2 * d operations, 87.0
// GFLOP, 0.176 ms at 495 TFLOP/s dense TF32: below the bytes.  (The JAX twin
// pins Precision.HIGHEST, itself a multi-pass split on the MXU.)  The
// register-fed `mma.sync` issues TF32 well below that rate on this card, so
// the products are `wgmma` from shared memory.
//
// What the design does about it.  Hopper blocks run in no order, so, as in
// K1, two passes replace the TPU kernel's carried tile and no float atomics
// are used (a run gives the same bits every time; Krum's choice cannot flip):
//   1. `partial_kernel`: one block per (128-row tile pair I <= J, column
//      chunk), one block an SM, one wave.  At n <= 128 there is one tile, so
//      one block per chunk covers every row pair and x is read exactly once.
//      - Loads: a ring of (128 rows x 32 columns) slabs, 8 deep for one
//        tile (2 for a pair of tiles), filled by `cp.async`: 8-byte copies
//        when d is even, 4-byte when it is odd.  The rows of the cnnet
//        matrix (d = 2 mod 4) are only 8-byte aligned, which rules out TMA
//        and 16-byte copies; rows past n and columns past the chunk are
//        zero-filled.  The slab's 32 centre values ride in the same stage.
//      - Split, one slab ahead: each value, minus its centre, becomes v =
//        hi + lo with hi = rna_tf32(v), lo = rna_tf32(v - hi), written to a
//        hi and a lo tile in the K-major core-matrix layout that `wgmma`
//        reads (8 rows x 16 bytes a core matrix, no swizzle).
//      - Products: two warpgroups issue `wgmma.mma_async` m64n128k8 TF32
//        from shared memory: lo.hi, hi.lo and hi.hi for each k8 step.
//        Warpgroup 0 takes rows 0-63, warpgroup 1 rows 64-127, each against
//        all 128 columns.  On a diagonal tile pair the quarter below the
//        diagonal is computed and never read: with a narrower product for
//        warpgroup 1 the two warpgroups took different paths, and ptxas
//        serialised the wgmma chain around them.  The products of a slab
//        start from 0 and FP32 adds fold them into the chunk's sum: the
//        tensor cores' own accumulation is not round-to-nearest, and summed
//        over a whole chunk it drifts past the tolerance on the diagonal.
//      The block writes its partial tile to a (pairs, chunks, 128, 128)
//      scratch.
//   2. `finish_kernel`: one thread per output (i, j) sums the chunk partials
//      of G_ij, G_ii and G_jj (upper triangle) in chunk order, forms G_ii +
//      G_jj - 2 G_ij and clamps at 0.  The norms come from the Gram diagonal
//      of the same accumulation, so the diagonal of a finite row is exactly
//      0, and (i, j) and (j, i) read the same entries, so the output is
//      symmetric bit for bit.
// The batched form: L stacked (n, d) leaves, (L, n, d) contiguous, with (L,
// d) centres, in one launch of each kernel: the leaf is the partial
// kernel's grid z (x, its centre and its partial tiles offset to leaf z's)
// and the finish's thread index runs over the L n^2 outputs.  The wrapper
// sizes the chunks across the whole bucket (`kernels.gram_chunk`).  Each
// leaf's sums run in the order of an unbatched launch of that chunk.  The
// partial kernel's offsets are a template flag (BATCHED), so one leaf runs
// the unbatched instance, its pointers kernel parameters.
// Non-finite values: a split cannot keep FP32's mix of +inf and NaN (inf
// splits into hi = inf, lo = inf - inf = NaN, and a hi rounded up flips lo's
// sign), so every non-finite value, after centring, carries NaN (its lo part)
// into each of its products, and the finish writes NaN for every non-finite
// distance: a non-finite value in row i makes row and column i NaN, diagonal
// included, and never reaches a clean pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;                // rows of a tile
constexpr int kSlab = 32;                 // columns of a ring stage
constexpr int kThreads = 256;             // two warpgroups
constexpr int kRawStride = kSlab + 4;     // floats per staged row: conflict-free split reads
constexpr int kRawFloats = kTile * kRawStride;
constexpr int kSplitFloats = kTile * kSlab;  // one split part (hi or lo) of a tile
// ring depth: one staged tile a stage (n <= 128) or two (a pair of tiles)
constexpr int kStagesOneTile = 8;
constexpr int kStagesTwoTiles = 2;
// the wgmma operand layout: 8-row x 16-byte core matrices, K-major; the two
// core matrices of a k8 step lie kCoreK bytes apart, neighbouring 8-row
// groups kCoreRows bytes apart
constexpr unsigned int kCoreK = 128;
constexpr unsigned int kCoreRows = 1024;

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

// Stage rows row0..row0+127, columns k0..k0+31 of x into `dst` ([row][k],
// stride kRawStride); rows >= n and columns >= c1 read as 0.
template <int kBytes>
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int n, long long d,
                                          int row0, long long k0, long long c1, float* dst) {
  constexpr int kWidth = kBytes / 4;               // floats a copy
  constexpr int kPerRow = kSlab / kWidth;          // copies a row
  constexpr int kCopies = kTile * kPerRow / kThreads;
#pragma unroll
  for (int q = 0; q < kCopies; ++q) {
    const int idx = threadIdx.x + kThreads * q;
    const int row = idx / kPerRow, part = idx % kPerRow;
    const long long col = k0 + part * kWidth;
    const bool ok = row0 + row < n && col < c1;  // d even: c1 and col are even, a pair is all in
    const float* src = ok ? x + (long long)(row0 + row) * d + col : x;
    cp_async<kBytes>(dst + row * kRawStride + part * kWidth, src, ok ? kBytes : 0);
  }
}

// cvt.rna.tf32.f32 by integer arithmetic: round the 13 low mantissa bits to
// nearest, ties away from zero; a NaN stays itself.
__device__ __forceinline__ float tf32_rna(float v) {
  return v != v ? v : __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// Centre a staged (128, 32) slab and split each value v = hi + lo in TF32,
// into two tiles in the wgmma core-matrix layout: (row, k) at float
// ((row / 8) * 8 + k / 4) * 32 + (row % 8) * 4 + k % 4.  A thread takes two
// neighbouring columns; the 8 rows of a core matrix go to 8 neighbouring
// lanes, so reads and writes of a half warp cover 32 banks.  An inf splits
// into hi = inf and lo = NaN, a NaN into NaN parts.
__device__ __forceinline__ void split_tile(const float* __restrict__ raw,
                                           const float* __restrict__ ctr, float* hi, float* lo) {
#pragma unroll
  for (int q = 0; q < kSplitFloats / 2 / kThreads; ++q) {
    const int idx = threadIdx.x + kThreads * q;
    const int r8 = idx % 8, k = 2 * ((idx / 8) % (kSlab / 2)), group = idx / (8 * kSlab / 2);
    const int row = group * 8 + r8;
    const float2 v = *reinterpret_cast<const float2*>(raw + row * kRawStride + k);
    const float2 m = *reinterpret_cast<const float2*>(ctr + k);
    const float v0 = v.x - m.x, v1 = v.y - m.y;
    const float h0 = tf32_rna(v0), h1 = tf32_rna(v1);
    const int at = (group * 8 + k / 4) * 32 + r8 * 4 + k % 4;
    *reinterpret_cast<float2*>(hi + at) = make_float2(h0, h1);
    *reinterpret_cast<float2*>(lo + at) = make_float2(tf32_rna(v0 - h0), tf32_rna(v1 - h1));
  }
}

// A wgmma shared-memory matrix descriptor: start address, leading (K) and
// stride (row-group) byte offsets, each >> 4; no swizzle.
__device__ __forceinline__ uint64_t descriptor(const float* at) {
  const unsigned int address = (unsigned int)__cvta_generic_to_shared(at);
  return (uint64_t)((address & 0x3ffff) >> 4) | ((uint64_t)(kCoreK >> 4) << 16)
         | ((uint64_t)(kCoreRows >> 4) << 32);
}

// D (+)= A B^T by one wgmma, A: 64 rows x 8 columns, B: 128 rows x 8 columns,
// both K-major in shared memory; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory (the split tiles) made visible to the
// async proxy that wgmma reads its operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 3xTF32 products of one slab, from 0: lo.hi, hi.lo, then hi.hi for each
// k8 step.  a_* start at the warpgroup's 64 rows, b_* at the tile's first.
__device__ __forceinline__ void slab_products(float (&d)[64], const float* a_hi, const float* a_lo,
                                              const float* b_hi, const float* b_lo) {
  const uint64_t ah = descriptor(a_hi), al = descriptor(a_lo);
  const uint64_t bh = descriptor(b_hi), bl = descriptor(b_lo);
#pragma unroll
  for (int k = 0; k < kSlab; k += 8) {
    const uint64_t step = (uint64_t)(k / 4 * kCoreK >> 4);  // 2 core matrices a k8 step
    wgmma_n128(d, al + step, bh + step, k > 0);
    wgmma_n128(d, ah + step, bl + step, 1);
    wgmma_n128(d, ah + step, bh + step, 1);
  }
}

template <int kBytes, int kStages, bool BATCHED>
__global__ void __launch_bounds__(kThreads, 1)
partial_kernel(const float* __restrict__ x, const float* __restrict__ centre,
               float* __restrict__ partial, int n, long long d, int chunk, int nb_chunks,
               int tiles) {
  extern __shared__ __align__(128) float smem[];
  const int nb_tiles = tiles > 1 ? 2 : 1;  // tiles staged a stage
  const int stage_floats = nb_tiles * kRawFloats + kSlab;
  // split buffer b, tile u, part p (0: hi, 1: lo), two buffers
  float* split_base = smem + kStages * stage_floats;
  auto split_at = [&](int b, int u, int p) {
    return split_base + ((b * nb_tiles + u) * 2 + p) * kSplitFloats;
  };
  if (BATCHED) {  // leaf blockIdx.z: its rows, centre and partial tiles
    x += (long long)blockIdx.z * n * d;
    if (centre != nullptr) {
      centre += (long long)blockIdx.z * d;
    }
    partial += (long long)blockIdx.z * gridDim.y * nb_chunks * kTile * kTile;
  }
  int ti, tj;
  pair_tiles(blockIdx.y, tiles, &ti, &tj);
  const bool diagonal = ti == tj;
  const int row_a = ti * kTile, row_b = tj * kTile;
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = c0 + chunk < d ? c0 + chunk : d;
  const int nb_slabs = (int)((c1 - c0 + kSlab - 1) / kSlab);
  // warpgroup 0: rows 0-63 of the Gram tile, warpgroup 1: rows 64-127, each
  // x columns 0-127
  const int wg = threadIdx.x / 128;

  auto load_stage = [&](int slab) {
    float* dst = smem + (slab % kStages) * stage_floats;
    const long long k0 = c0 + (long long)slab * kSlab;
    load_tile<kBytes>(x, n, d, row_a, k0, c1, dst);
    if (!diagonal) {
      load_tile<kBytes>(x, n, d, row_b, k0, c1, dst + kRawFloats);
    }
    if (threadIdx.x < kSlab) {
      const long long col = k0 + threadIdx.x;
      const bool ok = centre != nullptr && col < c1;
      cp_async<4>(dst + stage_floats - kSlab + threadIdx.x, ok ? centre + col : x, ok ? 4 : 0);
    }
  };
  auto split_stage = [&](int slab) {  // raw slab -> split buffer slab % 2
    const float* raw = smem + (slab % kStages) * stage_floats;
    const float* ctr = raw + stage_floats - kSlab;
    split_tile(raw, ctr, split_at(slab % 2, 0, 0), split_at(slab % 2, 0, 1));
    if (!diagonal) {
      split_tile(raw + kRawFloats, ctr, split_at(slab % 2, 1, 0), split_at(slab % 2, 1, 1));
    }
    fence_proxy_async();
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.0f;
    part[i] = 0.0f;
  }

  // The ring: slab s is loaded kStages - 1 slabs ahead and split one slab
  // ahead (into the other of two split buffers, while the tensor cores
  // multiply slab s), so one barrier a slab separates every write from its
  // reads.  Past the chunk the loads fill zeros and the split's output is
  // never multiplied: the loop body has no branch.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nb_slabs) load_stage(s);
    cp_async_commit();  // one group a stage, empty or not, so the wait counts hold
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  split_stage(0);
  if (kStages - 1 < nb_slabs) load_stage(kStages - 1);
  cp_async_commit();

  for (int slab = 0; slab < nb_slabs; ++slab) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slab + 1 have landed
    __syncthreads();               // everyone's have; slab is split; slab - 1's products are done
    load_stage(slab + kStages);    // into slab's raw buffer
    cp_async_commit();

    const int b = slab % 2;
    const float* a_hi = split_at(b, 0, 0) + wg * 64 / 8 * (kCoreRows / 4);
    const float* a_lo = split_at(b, 0, 1) + wg * 64 / 8 * (kCoreRows / 4);
    const float* b_hi = split_at(b, diagonal ? 0 : 1, 0);
    const float* b_lo = split_at(b, diagonal ? 0 : 1, 1);
    wgmma_fence();
    slab_products(part, a_hi, a_lo, b_hi, b_lo);
    wgmma_commit();
    split_stage(slab + 1);
    wgmma_wait_all();
    // the tensor cores' own sum is not round-to-nearest: each slab starts
    // from 0 and FP32 adds fold it into the chunk's sum
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();

  // accumulator 4 j + e of warp w (of 4 in the warpgroup): row 16 w + g +
  // 8 (e / 2), column 8 j + 2 t + e % 2 of the warpgroup's block
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float* tile = partial + ((long long)blockIdx.y * nb_chunks + blockIdx.x) * kTile * kTile;
  const int row = wg * 64 + 16 * w + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(&tile[row * kTile + col]) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(&tile[(row + 8) * kTile + col]) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Sum of the chunk partials of Gram entry (i, j), in chunk order, read from
// the upper triangle: (i, j) and (j, i) give the same bits.
__device__ __forceinline__ float gram_entry(const float* __restrict__ partial,
                                            int i, int j, int tiles,
                                            int nb_chunks) {
  if (i > j) {
    const int swap = i; i = j; j = swap;
  }
  const int ti = i / kTile, tj = j / kTile, li = i % kTile, lj = j % kTile;
  const float* p = partial + (long long)pair_index(ti, tj, tiles) * nb_chunks * kTile * kTile
                   + li * kTile + lj;
  float sum = 0.0f;
  for (int c = 0; c < nb_chunks; ++c) {
    sum += p[(long long)c * kTile * kTile];
  }
  return sum;
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int leaves, int n,
              int nb_chunks, int tiles) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long entries = (long long)n * n;
  if (idx >= leaves * entries) {
    return;
  }
  // leaf idx / n^2's partial tiles
  partial += idx / entries * (tiles * (tiles + 1) / 2) * nb_chunks * kTile * kTile;
  const int i = (int)(idx % entries / n), j = (int)(idx % n);
  const float gij = gram_entry(partial, i, j, tiles, nb_chunks);
  const float gii = gram_entry(partial, i, i, tiles, nb_chunks);
  const float gjj = gram_entry(partial, j, j, tiles, nb_chunks);
  const float dist = (gii + gjj) - 2.0f * gij;
  out[idx] = !isfinite(dist) ? __int_as_float(0x7fc00000) : (dist < 0.0f ? 0.0f : dist);
}

template <int kBytes, int kStages>
cudaError_t launch_partial(const float* x, const float* centre, float* scratch, int leaves, int n,
                           long long d, int chunk, int nb_chunks, int tiles, cudaStream_t s) {
  const int nb_tiles = tiles > 1 ? 2 : 1;
  const int smem = (kStages * (nb_tiles * kRawFloats + kSlab) + 2 * nb_tiles * 2 * kSplitFloats)
                   * (int)sizeof(float);
  auto kernel = leaves > 1 ? partial_kernel<kBytes, kStages, true> : partial_kernel<kBytes, kStages, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<dim3(nb_chunks, tiles * (tiles + 1) / 2, leaves), kThreads, smem, s>>>(
      x, centre, scratch, n, d, chunk, nb_chunks, tiles);
  return cudaGetLastError();
}

template <int kBytes>
cudaError_t launch_partial(const float* x, const float* centre, float* scratch, int leaves, int n,
                           long long d, int chunk, int nb_chunks, int tiles, cudaStream_t s) {
  return tiles > 1
      ? launch_partial<kBytes, kStagesTwoTiles>(x, centre, scratch, leaves, n, d, chunk, nb_chunks, tiles, s)
      : launch_partial<kBytes, kStagesOneTile>(x, centre, scratch, leaves, n, d, chunk, nb_chunks, tiles, s);
}

}  // namespace

extern "C" {

// x: (leaves, n, d) row-major float32 (one matrix: leaves = 1); centre:
// (leaves, d) float32 or null (a zero centre); out: (leaves, n, n);
// scratch: leaves * tiles(tiles+1)/2 * nb_chunks * 128 * 128 floats, tiles
// = ceil(n / 128), nb_chunks = ceil(d / chunk), chunk a multiple of 32.
// Returns cudaGetLastError().
int agg_gram_sq_distances(const float* x, const float* centre, float* out, float* scratch,
                          int leaves, int n, long long d, int chunk, void* stream) {
  if (leaves < 1 || leaves > 65535 || n < 1 || d < 1 || chunk <= 0 || chunk % kSlab != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (n + kTile - 1) / kTile;
  const int nb_chunks = (int)((d + chunk - 1) / chunk);
  cudaStream_t s = (cudaStream_t)stream;
  // 8-byte copies need every row start 8-byte aligned: d even and x too
  // (then every leaf's rows are)
  const bool pairs = d % 2 == 0 && (uintptr_t)x % 8 == 0;
  cudaError_t err = pairs
      ? launch_partial<8>(x, centre, scratch, leaves, n, d, chunk, nb_chunks, tiles, s)
      : launch_partial<4>(x, centre, scratch, leaves, n, d, chunk, nb_chunks, tiles, s);
  if (err != cudaSuccess) {
    return (int)err;
  }
  const long long entries = (long long)leaves * n * n;
  finish_kernel<<<(unsigned int)((entries + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      scratch, out, leaves, n, nb_chunks, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
