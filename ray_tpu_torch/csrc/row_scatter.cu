// In-place row scatter into a (M, row_bytes) ring: ring[pos[i], :] =
// vals[i, :], rows that no i names keep their contents, and where
// positions repeat the last write wins.
//
// Replaces ray_tpu/ops/framestack.py:_row_scatter_kernel (reached
// through _pallas_rows(scatter=True) from scatter_rows). On the TPU
// the ring was aliased into the output and the grid walked i = 0..R-1
// in order, one row DMA per step, so a repeated position was simply
// overwritten by the later step. Here blocks run in parallel and in no
// order, so "last write wins" is decided before any row moves:
//
//   1. claim_reset: owner[pos[i]] = -1 for every i (R stores; the
//      M-entry owner scratch is never initialised as a whole);
//   2. claim:       atomicMax(&owner[pos[i]], i), so each touched
//      position ends up owned by the largest i that names it;
//   3. copy:        row i is written only where owner[pos[i]] == i.
//
// Three launches on one stream, so each pass sees the previous one
// finished. A position outside [0, M) executes __trap() in pass 1,
// before anything is written.
//
// What bounds it on an H100: at the replay insert (64 rows of at most
// 7056 bytes per column) the bytes are a few hundred kilobytes, which
// HBM moves in well under a microsecond, so the three launches and
// their latency are the cost, not bandwidth. The copy pass is
// row_copy.cuh's, shared with the row gather and turned around: it
// reads row i and writes position pos[i].

#include "row_copy.cuh"

namespace {

using row_copy::kThreads;

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

// vals: (rows, row_bytes); pos: (rows,) int64; ring: (m, row_bytes);
// owner: (m,) int32 scratch, any contents. rows < 2^31.
extern "C" int row_scatter_launch(const void* vals, const void* pos,
                                  void* ring, void* owner, long long rows,
                                  long long m, long long row_bytes,
                                  void* stream) {
  if (rows <= 0 || row_bytes <= 0) {
    return 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
