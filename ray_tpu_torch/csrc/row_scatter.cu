// In-place row scatter into a (M, row_bytes) ring: ring[pos[i], :] =
// vals[i, :], rows that no i names keep their contents, and where
// positions repeat the last write wins.
//
// Replaces ray_tpu/ops/framestack.py:_row_scatter_kernel (reached
// through _pallas_rows(scatter=True) from scatter_rows). On the TPU
// the ring was aliased into the output and the grid walked i = 0..R-1
// in order, one row DMA per step, so a repeated position was simply
// overwritten by the later step. Here blocks run in parallel and in no
// order, so "last write wins" is decided before any row moves.
//
// What bounds it on an H100: at the replay insert (64 rows of at most
// 7056 bytes per column) and at the priority leaf write (a train batch
// of 8-byte rows) the bytes are at most a few hundred kilobytes, which
// HBM moves in well under a microsecond. The cost is launch latency, so
// up to kOneLaunchRows positions the scatter is one launch:
//
//   - every block loads all R positions (int32 or int64, as given) into
//     shared memory and checks each against [0, M) before any write,
//     executing __trap() on one outside it; every block sees the same
//     positions, so no block writes when any position is bad;
//   - row i is written only by its last writer: the warp that owns row i
//     compares pos[i] with pos[i+1..R) in shared memory, 32 at a time
//     (__any_sync), and copies the row only when no later row names the
//     same position; no scratch, no atomics;
//   - the copy is row_copy.cuh's: a warp per row of whole 4-byte words
//     (16-byte vectors where the width and both pointers allow), else a
//     thread per 1- or 2-byte element, each block deciding the last
//     writers of the rows its elements fall in.
//
// The replay insert (R = 64 rows per column) and the priority leaf
// write (R = the train batch) take the one launch. Above kOneLaunchRows
// (set_state's whole-ring scatter, R = M, off the main path) the scatter
// takes three launches over an M-entry int32 owner scratch and int64
// positions:
//
//   1. claim_reset: owner[pos[i]] = -1 for every i, and __trap() on a
//      position outside [0, M) before anything is written;
//   2. claim:       atomicMax(&owner[pos[i]], i), so each touched
//      position ends up owned by the largest i that names it;
//   3. copy:        row i is written only where owner[pos[i]] == i.

#include "row_copy.cuh"

namespace {

using row_copy::kThreads;
using row_copy::kWarps;

// Positions a block holds in shared memory (8 KB as int64): the largest
// R that the one-launch path takes.
constexpr int kOneLaunchRows = 1024;

// Load pos[0..rows) into sp as int64 and check every one against
// [0, m). Every thread of the block calls this together.
template <typename Index>
__device__ __forceinline__ void load_positions(int64_t* __restrict__ sp,
                                               const Index* __restrict__ pos,
                                               int rows, int64_t m) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int64_t p = static_cast<int64_t>(pos[i]);
    if (p < 0 || p >= m) {
      __trap();
    }
    sp[i] = p;
  }
  __syncthreads();
}

// True when no row after row i names pos[i]. The whole warp calls this.
__device__ __forceinline__ bool last_writer(const int64_t* __restrict__ sp,
                                            int i, int rows, int lane) {
  const int64_t p = sp[i];
  for (int base = i + 1; base < rows; base += 32) {
    const int j = base + lane;
    if (__any_sync(0xffffffffu, j < rows && sp[j] == p)) {
      return false;
    }
  }
  return true;
}

// A warp per row of `words` words; a block of kWarps rows.
template <typename Index, typename Word>
__global__ void __launch_bounds__(kWarps * 32)
one_launch_word_kernel(const Word* __restrict__ src,
                       const Index* __restrict__ pos, Word* __restrict__ ring,
                       int rows, int64_t m, int64_t words) {
  __shared__ int64_t sp[kOneLaunchRows];
  load_positions(sp, pos, rows, m);
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r < rows && last_writer(sp, r, rows, lane)) {  // warp-uniform
    row_copy::copy_row(src + r * words, ring + sp[r] * words, words, lane);
  }
}

// A thread per element of 1 or 2 bytes; a block of kThreads elements,
// which fall in at most kThreads rows.
template <typename Index, typename Elem>
__global__ void __launch_bounds__(kThreads)
one_launch_narrow_kernel(const Elem* __restrict__ src,
                         const Index* __restrict__ pos,
                         Elem* __restrict__ ring, int rows, int64_t m,
                         int64_t elems) {
  __shared__ int64_t sp[kOneLaunchRows];
  __shared__ bool keep[kThreads];
  load_positions(sp, pos, rows, m);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t total = rows * elems;
  const int64_t end = first + kThreads < total ? first + kThreads : total;
  const int r0 = static_cast<int>(first / elems);
  const int count = static_cast<int>((end - 1) / elems) - r0 + 1;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x / 32; i < count; i += kThreads / 32) {
    const bool last = last_writer(sp, r0 + i, rows, lane);
    if (lane == 0) {
      keep[i] = last;
    }
  }
  __syncthreads();
  const int64_t t = first + threadIdx.x;
  if (t < total) {
    const int r = static_cast<int>(t / elems);
    if (keep[r - r0]) {
      ring[sp[r] * elems + (t - r * elems)] = src[t];
    }
  }
}

// The one-launch path: picks the word or byte path as row_copy::launch.
template <typename Index>
cudaError_t launch_one(const void* vals, const Index* pos, void* ring,
                       int rows, long long m, long long row_bytes,
                       cudaStream_t s) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(ring);
  if (row_bytes % 4 == 0) {
    const unsigned int grid = (rows + kWarps - 1) / kWarps;
    if (row_bytes % 16 == 0 && align % 16 == 0) {
      one_launch_word_kernel<Index, int4><<<grid, kWarps * 32, 0, s>>>(
          static_cast<const int4*>(vals), pos, static_cast<int4*>(ring), rows,
          m, row_bytes / 16);
    } else {
      one_launch_word_kernel<Index, int32_t><<<grid, kWarps * 32, 0, s>>>(
          static_cast<const int32_t*>(vals), pos, static_cast<int32_t*>(ring),
          rows, m, row_bytes / 4);
    }
    return cudaGetLastError();
  }
  const long long elems = row_bytes % 2 == 0 ? row_bytes / 2 : row_bytes;
  const long long blocks = (rows * elems + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) {
    return cudaErrorInvalidConfiguration;
  }
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if (row_bytes % 2 == 0) {
    one_launch_narrow_kernel<Index, uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(vals), pos, static_cast<uint16_t*>(ring),
        rows, m, elems);
  } else {
    one_launch_narrow_kernel<Index, uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(vals), pos, static_cast<uint8_t*>(ring),
        rows, m, elems);
  }
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
claim_reset_kernel(const int64_t* __restrict__ pos, int* __restrict__ owner,
                   int64_t rows, int64_t m) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < rows; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t p = pos[i];
    if (p < 0 || p >= m) {
      __trap();
    }
    owner[p] = -1;
  }
}

__global__ void __launch_bounds__(kThreads)
claim_kernel(const int64_t* __restrict__ pos, int* __restrict__ owner,
             int64_t rows) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < rows; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    atomicMax(owner + pos[i], static_cast<int>(i));
  }
}

}  // namespace

// The largest row count that takes the one-launch path.
extern "C" int row_scatter_one_launch_rows() { return kOneLaunchRows; }

// vals: (rows, row_bytes); pos: (rows,) of pos_bytes = 4 (int32) or 8
// (int64); ring: (m, row_bytes). Up to row_scatter_one_launch_rows()
// rows: one launch, owner unused (may be null). Above it: int64
// positions and owner, an (m,) int32 scratch of any contents, are
// required. rows < 2^31.
extern "C" int row_scatter_launch(const void* vals, const void* pos,
                                  int pos_bytes, void* ring, void* owner,
                                  long long rows, long long m,
                                  long long row_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0) {
    return 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= kOneLaunchRows) {
    const int r = static_cast<int>(rows);
    if (pos_bytes == 4) {
      return static_cast<int>(launch_one(vals, static_cast<const int32_t*>(pos),
                                         ring, r, m, row_bytes, s));
    }
    if (pos_bytes == 8) {
      return static_cast<int>(launch_one(vals, static_cast<const int64_t*>(pos),
                                         ring, r, m, row_bytes, s));
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pos_bytes != 8 || owner == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* px = static_cast<const int64_t*>(pos);
  int* own = static_cast<int*>(owner);
  const unsigned int claim_grid = row_copy::grid_for(
      (rows + kThreads - 1) / kThreads, row_copy::max_blocks());
  claim_reset_kernel<<<claim_grid, kThreads, 0, s>>>(px, own, rows, m);
  claim_kernel<<<claim_grid, kThreads, 0, s>>>(px, own, rows);
  row_copy::launch<true>(vals, px, own, ring, rows, m, row_bytes, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* row_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
