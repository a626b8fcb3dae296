// Row gather over a (M, D) store of 4-byte words: out[i, :] = src[idx[i], :].
//
// Replaces ray_tpu/ops/framestack.py:_row_copy_kernel (reached through
// _pallas_rows(scatter=False) from gather_rows). On the TPU the index
// vector was scalar-prefetched into SMEM and each grid step DMA'd one
// row HBM -> VMEM -> HBM. Here each warp loads its own row's index and
// copies the row; blocks run in parallel and in no order, which a pure
// copy does not mind.
//
// What bounds it on an H100: memory traffic. The frame-pool rebuild at
// the PPO bench geometry writes 16384 rows of 1764 words (about 116 MB)
// and reads them from a 29 MB pool that fits in the 50 MB L2, so the
// floor is the bytes over the 3.35 TB/s of HBM. There is no arithmetic
// to hide, only latency: a copy waits once for the index and once for
// the row. The design keeps many bytes in flight:
//  - one warp per row, a few warps per block, and blocks that loop over
//    rows (a grid of at most 16 blocks per SM), so no block is spent on
//    a single short row;
//  - neighbouring lanes copy neighbouring 16-byte vectors (int4) when
//    D % 4 == 0 and both base pointers are 16-byte aligned (then every
//    row start is aligned too), 4-byte words otherwise;
//  - each lane issues kUnroll loads before its stores.
// Byte-wide pools (uint8 pixels) are viewed as 4-byte words by the
// caller, as the TPU path bitcast them to uint32 lanes, so this kernel
// never moves single bytes.
//
// Out-of-range indices: the kernel never reads outside the store. An
// index outside [0, M) executes __trap(), which aborts the launch and
// makes the next synchronising call on the stream fail (as PyTorch's
// own index kernels do with their device-side assert). The CPU path of
// the wrapper raises IndexError for the same input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // rows in flight per block
constexpr int kUnroll = 4;  // loads in flight per lane

template <typename Word>
__global__ void __launch_bounds__(kWarps * 32)
row_gather_kernel(const Word* __restrict__ src,
                  const int64_t* __restrict__ idx,
                  Word* __restrict__ out,
                  int64_t rows, int64_t m, int64_t words) {
  const int lane = threadIdx.x % 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = blockIdx.x * kWarps + threadIdx.x / 32; r < rows;
       r += warps) {
    const int64_t s = idx[r];
    if (s < 0 || s >= m) {
      __trap();
    }
    const Word* in = src + s * words;
    Word* o = out + r * words;
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
}

int max_blocks() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    sms = 132;
  }
  return sms * 16;
}

}  // namespace

extern "C" int row_gather_launch(const void* src, const void* idx, void* out,
                                 long long rows, long long m, long long d,
                                 void* stream) {
  if (rows <= 0 || d <= 0) {
    return 0;
  }
  static const int kMaxBlocks = max_blocks();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  const bool vec = (d % 4 == 0) && (align % 16 == 0);
  const long long words = vec ? d / 4 : d;
  const long long want = (rows + kWarps - 1) / kWarps;
  const unsigned int grid =
      static_cast<unsigned int>(want < kMaxBlocks ? want : kMaxBlocks);
  if (vec) {
    row_gather_kernel<int4><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const int4*>(src), static_cast<const int64_t*>(idx),
        static_cast<int4*>(out), rows, m, words);
  } else {
    row_gather_kernel<int32_t><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const int32_t*>(src), static_cast<const int64_t*>(idx),
        static_cast<int32_t*>(out), rows, m, words);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
