// Row gather over a (M, row_bytes) store: out[i, :] = src[idx[i], :].
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
// the row. The copy itself (word path and byte path) is row_copy.cuh's,
// shared with the row scatter.
//
// Byte-wide pools (uint8 pixels) are viewed as 4-byte words by the
// caller, as the TPU path bitcast them to uint32 lanes, so they take
// the word path.
//
// Out-of-range indices: the kernel never reads outside the store. An
// index outside [0, M) executes __trap(), which aborts the launch and
// makes the next synchronising call on the stream fail (as PyTorch's
// own index kernels do with their device-side assert). The CPU path of
// the wrapper raises IndexError for the same input.

#include "row_copy.cuh"

extern "C" int row_gather_launch(const void* src, const void* idx, void* out,
                                 long long rows, long long m,
                                 long long row_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0) {
    return 0;
  }
  row_copy::launch<false>(src, static_cast<const int64_t*>(idx), nullptr, out,
                          rows, m, row_bytes,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
