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
// streams them through its 4 rows with flash_stream.cuh's online softmax.
// The band (j <= i + offset) and the ragged edges (i < T, j < S, heads
// < N) are masked from indices; nothing is padded or copied, and a block
// stops streaming past the last key its band can see.
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

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTileKeys = kRows;              // staged key rows per tile
constexpr int kMaxD = 128;

template <typename T, int kChunks>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t n,
                 int64_t t, int64_t s, int d, int bq, bool banded,
                 int64_t offset) {
  __shared__ float ks[kTileKeys * 32 * kChunks];
  __shared__ float vs[kTileKeys * 32 * kChunks];

  const int heads = kRows / bq;  // heads per block
  const int bk = kTileKeys / heads;  // keys of each head per tile (= bq)
  const int64_t head0 = static_cast<int64_t>(blockIdx.x) * heads;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * bq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));

  float qr[kRowsPerWarp][kChunks];
  flash::RowState<kChunks> st[kRowsPerWarp];
  int64_t row_of[kRowsPerWarp];
  int head_of[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    head_of[i] = r / bq;
    row_of[i] = q0 + r % bq;
    const int64_t head = head0 + head_of[i];
    live[i] = head < n && row_of[i] < t;
    flash::init_row(st[i]);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = lane + 32 * c;
      qr[i][c] = live[i] && e < d
                     ? flash::to_f32(q[(head * t + row_of[i]) * d + e]) * scale
                     : 0.0f;
    }
  }

  // the keys this block's rows can see at all
  int64_t key_end = s;
  if (banded) {
    const int64_t last_row = (q0 + bq < t ? q0 + bq : t) - 1;
    const int64_t band_end = last_row + offset + 1;
    key_end = band_end < 0 ? 0 : (band_end < s ? band_end : s);
  }
  for (int64_t first = 0; first < key_end; first += bk) {
    flash::stage_tile(ks, k, head0, heads, bk, n, s, first, d);
    flash::stage_tile(vs, v, head0, heads, bk, n, s, first, d);
    __syncthreads();
    const int in_tile = static_cast<int>(s - first < bk ? s - first : bk);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (live[i]) {  // warp-uniform: the whole warp owns row i
        const int count =
            flash::visible_keys(in_tile, first, row_of[i], banded, offset);
        const int base = head_of[i] * bk * d;
        flash::stream_keys(st[i], qr[i], ks + base, vs + base, count, d,
                           lane);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!live[i]) {
      continue;
    }
    const int64_t head = head0 + head_of[i];
    const float l = fmaxf(st[i].l, 1e-30f);
    T* out = o + (head * t + row_of[i]) * d;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = lane + 32 * c;
      if (e < d) {
        flash::from_f32(out + e, st[i].acc[c] / l);
      }
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o,
                         int64_t n, int64_t t, int64_t s, int d, bool banded,
                         int64_t offset, cudaStream_t stream) {
  int bq = 1;
  while (bq < t && bq < kRows) {
    bq *= 2;
  }
  const int heads = kRows / bq;
  const int64_t head_blocks = (n + heads - 1) / heads;
  const int64_t row_blocks = (t + bq - 1) / bq;
  if (head_blocks > 2147483647LL || row_blocks > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 grid(static_cast<unsigned>(head_blocks),
                  static_cast<unsigned>(row_blocks));
  const dim3 block(kWarps * 32);
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
  if (d <= 0 || d > kMaxD || dtype < 0 || dtype > 1) {
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
