// The row copy shared by the row gather and the row scatter, over a
// (M, row_bytes) store and R indexed rows:
//
//   gather  (kScatter = false): out[r, :] = src[idx[r], :]
//   scatter (kScatter = true):  out[idx[r], :] = src[r, :], written only
//                               where owner[idx[r]] == r
//
// The reference had one routine for both directions as well
// (ray_tpu/ops/framestack.py:_pallas_rows(scatter=...)). The scatter
// takes these kernels only above its one-launch limit; below it,
// row_scatter.cu's own kernel copies each row with copy_row.
//
// Design, for an H100, where a copy is bound by memory traffic and
// latency, never by arithmetic; it keeps many bytes in flight:
//  - rows that are whole 4-byte words (the word path): one warp per
//    row, a few warps per block, and blocks that loop over rows (a
//    grid of at most 16 blocks per SM), so no block is spent on a
//    single short row; neighbouring lanes copy neighbouring 16-byte
//    vectors (int4) when the row is a multiple of 16 bytes and both
//    base pointers are 16-byte aligned (then every row start is
//    aligned too), 4-byte words otherwise; each lane issues kUnroll
//    loads before its stores;
//  - rows that are not (the byte path: the replay rings' bool columns
//    of row shape (), 2-byte or odd-width rows): one thread per
//    element of 2 or 1 bytes, consecutive threads on consecutive
//    elements, so a warp covers 32 short rows at once instead of
//    spending a warp on each.
//
// The gather checks each index and executes __trap() on one outside
// [0, M); the scatter's caller has checked its positions before.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_copy {

constexpr int kWarps = 4;      // rows in flight per block (word path)
constexpr int kUnroll = 4;     // loads in flight per lane (word path)
constexpr int kThreads = 256;  // threads per block (byte path)

template <bool kScatter>
__device__ __forceinline__ bool take_row(const int64_t* __restrict__ idx,
                                         const int* __restrict__ owner,
                                         int64_t r, int64_t m, int64_t* p) {
  *p = idx[r];
  if (kScatter) {
    return owner[*p] == static_cast<int>(r);  // else a later row writes it
  }
  if (*p < 0 || *p >= m) {
    __trap();
  }
  return true;
}

// The word path's body: the calling warp copies one row of `words`
// words, neighbouring lanes on neighbouring words, kUnroll loads in
// flight per lane before its stores.
template <typename Word>
__device__ __forceinline__ void copy_row(const Word* __restrict__ in,
                                         Word* __restrict__ o, int64_t words,
                                         int lane) {
  for (int64_t j = lane; j < words; j += 32 * kUnroll) {
    Word buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t k = j + u * 32;
      if (k < words) {
        buf[u] = in[k];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t k = j + u * 32;
      if (k < words) {
        o[k] = buf[u];
      }
    }
  }
}

template <bool kScatter, typename Word>
__global__ void __launch_bounds__(kWarps * 32)
word_kernel(const Word* __restrict__ src, const int64_t* __restrict__ idx,
            const int* __restrict__ owner, Word* __restrict__ out,
            int64_t rows, int64_t m, int64_t words) {
  const int lane = threadIdx.x % 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = blockIdx.x * kWarps + threadIdx.x / 32; r < rows;
       r += warps) {
    int64_t p;
    if (!take_row<kScatter>(idx, owner, r, m, &p)) {
      continue;
    }
    copy_row(src + (kScatter ? r : p) * words, out + (kScatter ? p : r) * words,
             words, lane);
  }
}

template <bool kScatter, typename Elem>
__global__ void __launch_bounds__(kThreads)
narrow_kernel(const Elem* __restrict__ src, const int64_t* __restrict__ idx,
              const int* __restrict__ owner, Elem* __restrict__ out,
              int64_t rows, int64_t m, int64_t elems) {
  const int64_t total = rows * elems;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < total; t += stride) {
    const int64_t r = t / elems;
    int64_t p;
    if (!take_row<kScatter>(idx, owner, r, m, &p)) {
      continue;
    }
    const int64_t e = t - r * elems;
    if (kScatter) {
      out[p * elems + e] = src[t];
    } else {
      out[t] = src[p * elems + e];
    }
  }
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    sms = 132;
  }
  return sms;
}

inline unsigned int grid_for(long long want, long long cap) {
  return static_cast<unsigned int>(want < cap ? want : cap);
}

inline long long max_blocks() {
  static const long long blocks = 16LL * sm_count();
  return blocks;
}

// Picks the word (16- or 4-byte) or byte (2- or 1-byte) path for the
// row width and the pointers' alignment, and launches it on `s`.
template <bool kScatter>
void launch(const void* src, const int64_t* idx, const int* owner, void* out,
            long long rows, long long m, long long row_bytes, cudaStream_t s) {
  const long long cap = max_blocks();
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 4 == 0) {
    const unsigned int grid = grid_for((rows + kWarps - 1) / kWarps, cap);
    if (row_bytes % 16 == 0 && align % 16 == 0) {
      word_kernel<kScatter, int4><<<grid, kWarps * 32, 0, s>>>(
          static_cast<const int4*>(src), idx, owner, static_cast<int4*>(out),
          rows, m, row_bytes / 16);
    } else {
      word_kernel<kScatter, int32_t><<<grid, kWarps * 32, 0, s>>>(
          static_cast<const int32_t*>(src), idx, owner,
          static_cast<int32_t*>(out), rows, m, row_bytes / 4);
    }
  } else if (row_bytes % 2 == 0) {
    const long long elems = row_bytes / 2;
    const unsigned int grid =
        grid_for((rows * elems + kThreads - 1) / kThreads, cap);
    narrow_kernel<kScatter, uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(src), idx, owner,
        static_cast<uint16_t*>(out), rows, m, elems);
  } else {
    const unsigned int grid =
        grid_for((rows * row_bytes + kThreads - 1) / kThreads, cap);
    narrow_kernel<kScatter, uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(src), idx, owner,
        static_cast<uint8_t*>(out), rows, m, row_bytes);
  }
}

}  // namespace row_copy
