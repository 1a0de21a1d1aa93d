// K1's launch layout (distances.cu): which kernel instance serves n rows,
// with how many threads, blocks, columns a block and bytes of shared memory.
// It is plain C++ so that a host compiler builds it alone:
// tests/test_torch_kernels.py checks it for every n on the CPU.
#pragma once

#include <utility>

#ifdef __CUDACC__
#define AGG_HOST_DEVICE __host__ __device__
#else
#define AGG_HOST_DEVICE
#endif

namespace k1 {

constexpr int kMaxRows = 64;        // beyond, the Gram form (gram.cu) serves
constexpr int kRowThreads = 256;    // threads of a rows_kernel block
constexpr int kTwoBlockRows = 11;   // register instances up to this many rows run two blocks an SM
constexpr int kTileCols = 128;      // columns of a staged tile
constexpr int kStages = 3;          // tiles in flight in the ring
constexpr int kMicro = 8;           // rows of a micro-tile's edge
constexpr int kTileBlocksPerSM = 2;

// The register path's instances, one per row count (padded ones were
// slower: distances.cu's note).  Beyond the last, the staged tiles of 32 or
// 64 rows.
using RegisterRows = std::integer_sequence<int, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20>;

AGG_HOST_DEVICE constexpr int pair_count(int n) { return n * (n + 1) / 2; }

template <int... Ns>
constexpr int first_cover(int n, std::integer_sequence<int, Ns...>) {
  int rows = 0;
  ((rows = rows == 0 && n <= Ns ? Ns : rows), ...);
  return rows;
}

// The instance for n rows: the first register row count >= n, else 32 or
// 64 staged rows.
constexpr int instance_rows(int n) {
  const int rows = first_cover(n, RegisterRows{});
  return rows != 0 ? rows : n <= 32 ? 32 : 64;
}

// The staged path's tasks for n rows, nb = ceil(n / 8) row blocks: first the
// nb(nb-1)/2 off-diagonal block pairs (64 pair sums each), then, from the
// next warp, the diagonal blocks two at a time (the upper triangles of
// blocks 2k and 2k+1: 72 sums), so that a warp's tasks are all of one kind;
// tasks past those are idle.  `lanes` threads a task: 32 at 32 rows, where
// the block has few tasks, 8 at 64.
AGG_HOST_DEVICE constexpr int task_lanes(int rows) { return rows == 32 ? 32 : 8; }

struct Tasks {
  int lanes, per_warp, blocks_of_rows, off_diagonal, diagonal_start, count;
  AGG_HOST_DEVICE constexpr Tasks(int n, int rows)
      : lanes(task_lanes(rows)),
        per_warp(32 / lanes),
        blocks_of_rows((n + kMicro - 1) / kMicro),
        off_diagonal(blocks_of_rows * (blocks_of_rows - 1) / 2),
        diagonal_start((off_diagonal + per_warp - 1) / per_warp * per_warp),
        count(diagonal_start + (blocks_of_rows + 1) / 2) {}
  AGG_HOST_DEVICE constexpr int threads() const { return (count + per_warp - 1) / per_warp * 32; }
};

// A staged tile holds kTileCols / 2 column pairs, each the rows' two values
// side by side ([pair][row][2]), pairs 2 * rows + 4 floats apart: a
// thread's eight rows of a column pair are four 16-byte shared loads.
AGG_HOST_DEVICE constexpr int tile_pair_stride(int rows) { return 2 * rows + 4; }
AGG_HOST_DEVICE constexpr int tile_floats(int rows) { return kTileCols / 2 * tile_pair_stride(rows); }

struct Layout {
  int rows;         // the instance's row count (>= n)
  int threads;      // a block's
  int blocks;       // the grid: one wave
  long long chunk;  // columns a block, a whole number of the path's units
  int smem;         // dynamic shared bytes a block
};

// The layout for an (n, d) matrix, 1 <= n <= kMaxRows, on a card of `sms`
// SMs.  Register path: 256 threads, two blocks an SM up to kTwoBlockRows
// rows and one beyond (the registers of 12 rows' sums allow no more), even
// chunks of at least two columns a thread, shared memory for the warps'
// pair sums.  Staged path: chunks of whole tiles, two blocks an SM, shared
// memory for the ring.  Either way at least a float a thread, for the last
// block's final sum.
inline Layout distance_layout(int n, long long d, int sms) {
  Layout l{};
  l.rows = instance_rows(n);
  long long unit, least, target;
  if (first_cover(n, RegisterRows{}) != 0) {
    l.threads = kRowThreads;
    const int sums = kRowThreads / 32 * pair_count(l.rows);
    l.smem = 4 * (sums > kRowThreads ? sums : kRowThreads);
    unit = 2;
    least = 2 * kRowThreads;
    target = (long long)sms * (l.rows <= kTwoBlockRows ? 2 : 1);
  } else {
    l.threads = Tasks(n, l.rows).threads();
    l.smem = 4 * kStages * tile_floats(l.rows);
    unit = least = kTileCols;
    target = (long long)sms * kTileBlocksPerSM;
  }
  const long long share = (d + target - 1) / target;
  l.chunk = (share + unit - 1) / unit * unit;
  if (l.chunk < least) l.chunk = least;
  l.blocks = (int)((d + l.chunk - 1) / l.chunk);
  return l;
}

// One leaf's layout in a batched launch over `leaves` stacked (n, d)
// leaves (the grid's x dimension; y counts the leaves): each leaf takes
// its share of the SMs, so the whole grid still comes near one wave.  One
// leaf: distance_layout's.
inline Layout batched_layout(int leaves, int n, long long d, int sms) {
  return distance_layout(n, d, (sms + leaves - 1) / leaves);
}

}  // namespace k1
