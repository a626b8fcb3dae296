// Fused attention forward: o = softmax(q kᵀ / √D + band) v, normalised,
// never writing the (T, S) scores to device memory.
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel (reached through
// _flash_fwd_pallas from flash_attention). On the TPU one grid step took
// one (batch·head, 128-row query block), padded T and S to block multiples
// with jnp.pad, and streamed every key block of that head through VMEM.
// Here a block of 8 warps owns 32 query rows: a tile of bq rows (the
// smallest power of two >= T, at most 32) from each of 32 / bq heads, so
// the decoder torso's 8-token heads go four to a block instead of one
// block per 8 rows. The block stages the K/V rows of its heads in shared
// memory, 32 key rows at a time (bq keys of each head), and every warp
// streams them through its 4 rows with flash_stream.cuh's online softmax
// (attend_block). The band (j <= i + offset)
// and the ragged edges (i < T, j < S, heads < N) are masked from indices;
// nothing is padded or copied, and a block stops streaming past the last
// key its band can see.
//
// What bounds it on an H100: at the torso's shapes (T = S = 8, D = 32,
// f32) the bytes (q, k, v read once, o written once: 8.4 MB at 2048
// heads, 2.5 us at 3.35 TB/s) are far above the arithmetic (4·T·S·D
// flops per head); in practice the launch and the dependent shuffle /
// exp chain per key bound it. The math is f32 on the CUDA cores; q is
// scaled by 1/sqrt(D) before the dot product, as the TPU kernel does.
// Tensor cores, TMA and a persistent grid are later work.
//
// Types: f32 or bf16 in (q, k, v of one type), accumulation in f32, the
// output in q's type. D <= 128.

#include "flash_stream.cuh"

namespace {

template <typename T, int kChunks>
__global__ void __launch_bounds__(flash::kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t n,
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
    const float l = fmaxf(w.st[i].l, 1e-30f);
    T* out = o + (w.head[i] * t + w.row[i]) * d;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = lane + 32 * c;
      if (e < d) {
        flash::from_f32(out + e, w.st[i].acc[c] / l);
      }
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o,
                         int64_t n, int64_t t, int64_t s, int d, bool banded,
                         int64_t offset, cudaStream_t stream) {
  int bq = 0;
  dim3 grid;
  if (!flash::block_grid(n, t, &bq, &grid)) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 block(flash::kWarps * 32);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  const int chunks = (d + 31) / 32;
  switch (chunks) {
    case 1:
      flash_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(
          qq, kk, vv, oo, n, t, s, d, bq, banded, offset);
      break;
    case 2:
      flash_fwd_kernel<T, 2><<<grid, block, 0, stream>>>(
          qq, kk, vv, oo, n, t, s, d, bq, banded, offset);
      break;
    case 3:
      flash_fwd_kernel<T, 3><<<grid, block, 0, stream>>>(
          qq, kk, vv, oo, n, t, s, d, bq, banded, offset);
      break;
    default:
      flash_fwd_kernel<T, 4><<<grid, block, 0, stream>>>(
          qq, kk, vv, oo, n, t, s, d, bq, banded, offset);
      break;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. banded: 0 = no mask, else key j is
// visible to query i iff j <= i + offset.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, long long n, long long t, long long s,
                                int d, int dtype, int banded, long long offset,
                                void* stream) {
  if (d <= 0 || d > flash::kMaxD || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || t <= 0) {
    return 0;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(q, k, v, o, n, t, s, d, banded != 0,
                                       offset, st)
                 : launch_typed<__nv_bfloat16>(q, k, v, o, n, t, s, d,
                                               banded != 0, offset, st);
  return static_cast<int>(err);
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
