// One attention block with its running statistics, for ring attention:
// acc = Σ_j exp(q·k_j/√D − m) v_j over the visible keys, unnormalised,
// with the row max m and the row sum l, never writing the (T, S) scores
// to device memory.
//
// Replaces ray_tpu/ops/flash_attention.py:_block_kernel (reached through
// flash_block_attention_stats from the ring's hops,
// ray_tpu/parallel/ring_attention.py:_block_attn_flash). It runs the same
// stream as flash_fwd.cu (flash_stream.cuh's attend_block: 32 query rows
// per block of 8 warps, heads packed when T < 32, K/V staged in shared
// memory, a warp per query row) and writes acc, m and l as they are
// instead of acc / l. On the TPU the band offset lived in SMEM because
// the device index was traced; here every rank knows its offset on the
// host, so it is passed by value. Key j is visible to query i iff
// j <= i + offset; an offset >= S - 1 shows every key and runs unbanded.
// A row that sees no key writes m = -1e30, l = 0 and acc = 0 exactly
// (the merge of the ring relies on it), and a block none of whose rows
// sees a key (every hop from a later shard of a causal ring) stages no
// tile and only writes those values.
//
// What bounds it on an H100: at the ring's hop shape (8 heads of
// T = S = 4096, D = 32, f32) the arithmetic, about 17 GFLOP when every
// key is visible (0.26 ms at the 67 TFLOP/s f32 rate of the CUDA cores),
// is far above the bytes (about 16 MB, 5 us at 3.35 TB/s). The kernel
// is bound by its instruction stream instead: a warp per query row makes
// every (row, key) pair a warp-wide step (a five-shuffle reduction, two
// expf and the rescaled update) for D = 32 useful multiply-adds, so it
// runs tens of times above the bound. A thread per row, or tensor-core
// tiles with a per-tile softmax, is the redesign. acc, m and l are plain
// float32 running values, as in the TPU kernel.
//
// Types: q, k, v f32 or bf16 (one type), accumulation and the outputs
// f32. D <= 128.

#include "flash_stream.cuh"

namespace {

template <typename T, int kChunks>
__global__ void __launch_bounds__(flash::kWarps * 32)
flash_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ acc,
                   float* __restrict__ m, float* __restrict__ l, int64_t n,
                   int64_t t, int64_t s, int d, int bq, bool banded,
                   int64_t offset) {
  flash::WarpRows<kChunks> w;
  flash::attend_block<T, kChunks>(w, q, k, v, n, t, s, d, bq, banded, offset);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < flash::kRowsPerWarp; ++i) {
    if (!w.live[i]) {
      continue;
    }
    const int64_t r = w.head[i] * t + w.row[i];
    float* out = acc + r * d;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = lane + 32 * c;
      if (e < d) {
        out[e] = w.st[i].acc[c];
      }
    }
    if (lane == 0) {
      m[r] = w.st[i].m;
      l[r] = w.st[i].l;
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         float* acc, float* m, float* l, int64_t n, int64_t t,
                         int64_t s, int d, bool banded, int64_t offset,
                         cudaStream_t stream) {
  int bq = 0;
  dim3 grid;
  if (!flash::block_grid(n, t, &bq, &grid)) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 block(flash::kWarps * 32);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const int chunks = (d + 31) / 32;
  switch (chunks) {
    case 1:
      flash_block_kernel<T, 1><<<grid, block, 0, stream>>>(
          qq, kk, vv, acc, m, l, n, t, s, d, bq, banded, offset);
      break;
    case 2:
      flash_block_kernel<T, 2><<<grid, block, 0, stream>>>(
          qq, kk, vv, acc, m, l, n, t, s, d, bq, banded, offset);
      break;
    case 3:
      flash_block_kernel<T, 3><<<grid, block, 0, stream>>>(
          qq, kk, vv, acc, m, l, n, t, s, d, bq, banded, offset);
      break;
    default:
      flash_block_kernel<T, 4><<<grid, block, 0, stream>>>(
          qq, kk, vv, acc, m, l, n, t, s, d, bq, banded, offset);
      break;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. acc: (n, t, d) f32; m, l: (n, t) f32.
extern "C" int flash_block_launch(const void* q, const void* k, const void* v,
                                  void* acc, void* m, void* l, long long n,
                                  long long t, long long s, int d, int dtype,
                                  long long offset, void* stream) {
  if (d <= 0 || d > flash::kMaxD || dtype < 0 || dtype > 1 || s < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || t <= 0) {
    return 0;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool banded = offset < s - 1;
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(q, k, v, a, mm, ll, n, t, s, d, banded,
                                       offset, st)
                 : launch_typed<__nv_bfloat16>(q, k, v, a, mm, ll, n, t, s, d,
                                               banded, offset, st);
  return static_cast<int>(err);
}

extern "C" const char* flash_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
