// Root-to-leaf prefix-sum descent over an f64 sum tree: for each query
// mass p, the leaf i such that the leaves before i sum to at most p.
//
// Replaces ray_tpu/ops/segment_tree.py:_descent_kernel (reached through
// find_prefixsum_pallas from draw_body(use_pallas=True)). The TPU
// kernel held the whole (2 * capacity,) tree in VMEM and stepped every
// query down one level per vector op; Mosaic has no f64, so it never
// ran on the TPU. The H100 has native f64. Every level does exactly the
// operations of find_prefixsum_body and of the host
// SumSegmentTree.find_prefixsum_idx:
//
//   left = 2 * idx; lv = tree[left];
//   if (p > lv) { p = p - lv; idx = left + 1; } else { idx = left; }
//
// The compare is strict and the subtraction is one IEEE round-to-nearest
// f64 op (__dsub_rn, and the file builds with -fmad=false), in level
// order, so the kernel agrees bitwise with both. A NaN mass compares
// false at every level and lands on leaf 0, as it does in the plain
// version.
//
// What bounds it on an H100: latency. At the DQN draw (32 queries, a
// 2 * 65536 tree of 1 MiB, which sits in L2) the bytes are 32 x 16 x 8
// of tree reads plus the queries and leaves, about 5 KB: nanoseconds of
// bandwidth. A thread that walks its query alone makes one dependent
// load a level, 16 L2 round trips in a row.
//
// Design: a warp per query, and the descent in chunks of up to kChunk
// = 8 levels. A chunk starting at node idx can read only the left
// children of the 255 nodes of idx's subtree of depth 8: node k of that
// subtree in heap order (1 <= k < 256, depth j = floor(log2 k)) is
// global node (idx << j) + k - 2^j. The warp loads all of them at once,
// 8 independent loads a lane, into its own slice of shared memory: one
// round trip. Then every lane walks the chunk's levels from shared
// memory in the plain version's order (the same p and the same k in
// every lane, so each read is a broadcast). 16 levels take 2 round
// trips instead of 16; levels that are not a multiple of 8 end with a
// shorter chunk, which loads only the slots it can reach. The chunk
// reads up to 255 tree words where the walk uses 8: extra L2 reads,
// which cost bandwidth the kernel has plenty of. A block is one warp, so
// the 32 draws of a DQN sample load their chunks on 32 SMs: with 4 warps
// a block, an SM's share of the traffic lengthened each chunk's round
// trip (0.00230 against 0.00185 ms of an H100's device time for the
// launch). In the walk, each level loads the four slots two levels down
// before it compares, so a level waits for its compare, its subtraction
// and a select, not for a shared-memory load as well.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 1;  // queries per block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 8;  // levels per round trip
constexpr int kSlots = 1 << kChunk;   // heap slots 1..255 (slot 0 unused)
constexpr int kLoads = kSlots / 32;   // slots per lane

__global__ void __launch_bounds__(kThreads)
prefix_descent_kernel(const double* __restrict__ tree,
                      const double* __restrict__ mass,
                      int64_t* __restrict__ out, int64_t n, int levels,
                      int64_t capacity) {
  __shared__ double s_left[kWarps][kSlots];
  const int lane = threadIdx.x & 31;
  double* left = s_left[threadIdx.x >> 5];
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       q < n; q += static_cast<int64_t>(gridDim.x) * kWarps) {
    double p = mass[q];
    int64_t idx = 1;
    for (int done = 0; done < levels; done += kChunk) {
      const int c = min(kChunk, levels - done);
      double lv[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int k = lane + 32 * i;
        const int j = 31 - __clz(k | 1);  // depth of slot k (slot 0 unused)
        lv[i] = (k >= 1 && j < c)
                    ? __ldg(tree + 2 * ((idx << j) + (k - (1 << j))))
                    : 0.0;
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        left[lane + 32 * i] = lv[i];
      }
      __syncwarp();
      // slot k's value x and its children's ch0, ch1 are in registers
      // before the level that needs them; each level loads its
      // grandchildren (clamped into the slice: past the chunk they are
      // never used), so a level waits for its compare, not for a load
      int k = 1;
      double x = left[1], ch0 = left[2], ch1 = left[3];
#pragma unroll
      for (int l = 0; l < kChunk; ++l) {
        const int g = min(4 * k, kSlots - 4);
        const double g0 = left[g], g1 = left[g + 1], g2 = left[g + 2], g3 = left[g + 3];
        const bool right = l < c && p > x;
        p = right ? __dsub_rn(p, x) : p;
        k = l < c ? 2 * k + (right ? 1 : 0) : k;
        x = right ? ch1 : ch0;
        ch0 = right ? g2 : g0;
        ch1 = right ? g3 : g1;
      }
      idx = (idx << c) + (k - (1 << c));
      __syncwarp();  // every lane has read the slots before they are refilled
    }
    if (lane == 0) {
      out[q] = idx - capacity;
    }
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
  const long long want = (n + kWarps - 1) / kWarps;
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
