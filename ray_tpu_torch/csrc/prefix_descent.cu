// Root-to-leaf prefix-sum descent over an f64 sum tree: for each query
// mass p, the leaf i such that the leaves before i sum to at most p.
//
// Replaces ray_tpu/ops/segment_tree.py:_descent_kernel (reached through
// find_prefixsum_pallas from draw_body(use_pallas=True)). The TPU
// kernel held the whole (2 * capacity,) tree in VMEM and stepped every
// query down one level per vector op; Mosaic has no f64, so it never
// ran on the TPU. The H100 has native f64: here one thread walks one
// query down levels = log2(capacity) levels, each level one load of
// the left child, one compare and, going right, one subtraction:
//
//   left = 2 * idx; lv = tree[left];
//   if (p > lv) { p = p - lv; idx = left + 1; } else { idx = left; }
//
// exactly the operations of find_prefixsum_body and of the host
// SumSegmentTree.find_prefixsum_idx: the compare is strict and the
// subtraction is one IEEE round-to-nearest f64 op (__dsub_rn, and the
// file builds with -fmad=false), so the kernel agrees bitwise with both.
// A NaN mass compares false at every level and lands on leaf 0, as it
// does in the plain version.
//
// What bounds it on an H100: latency. At the DQN draw (32 queries, a
// 2 * 65536 tree) the bytes are 32 x 16 x 8 of tree reads plus the
// queries and leaves, about 5 KB: nanoseconds of bandwidth. Each query
// is 16 dependent loads, each an L2 (or HBM) round trip, so one launch
// costs its launch latency plus 16 load latencies. Keeping the top
// levels of the tree in shared memory would shorten that chain; that is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
prefix_descent_kernel(const double* __restrict__ tree,
                      const double* __restrict__ mass,
                      int64_t* __restrict__ out, int64_t n, int levels,
                      int64_t capacity) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    double p = mass[i];
    int64_t idx = 1;
    for (int l = 0; l < levels; ++l) {
      const int64_t left = 2 * idx;
      const double lv = tree[left];
      if (p > lv) {
        p = __dsub_rn(p, lv);
        idx = left + 1;
      } else {
        idx = left;
      }
    }
    out[i] = idx - capacity;
  }
}

}  // namespace

// tree: (2 * capacity,) f64; mass: (n,) f64; out: (n,) int64.
extern "C" int prefix_descent_launch(const void* tree, const void* mass,
                                     void* out, long long n, int levels,
                                     long long capacity, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned int grid =
      static_cast<unsigned int>(want < 65535 ? want : 65535);
  prefix_descent_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(tree), static_cast<const double*>(mass),
      static_cast<int64_t*>(out), n, levels, capacity);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* prefix_descent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
