// The online-softmax stream of fused attention, as device functions, and
// the pieces both flash_fwd.cu paths share.
//
// Counterpart of ray_tpu/ops/flash_attention.py:_online_softmax_stream,
// the body both TPU kernels share (_fwd_kernel, which normalises, and
// _block_kernel, which returns the unnormalised accumulator and the row
// statistics for ring attention). flash_fwd.cu runs attend_block below
// for heads longer than 32 rows or wider than 64 (no main path runs
// them) and writes acc / max(l, 1e-30); shorter heads take the row per
// thread of flash_rows.cuh, and flash_block.cu the tensor-core tiles of
// flash_tile.cuh.
//
// Addressing: a head n of the N = B·H heads is (b, h) = (n / H, n % H),
// and its row r starts at element b·sb + h·sh + r·sr (Strides); the head
// dim is contiguous. So a (B, H, T, D) view over (B, T, H, D) memory is
// read and written where it is.
//
// Block layout: a block of kWarps warps owns kRows query rows, a tile of
// bq rows (the smallest power of two >= T, at most kRows) from each of
// kRows / bq consecutive heads, so short heads share a block. Grid:
// (head groups, row tiles). The block stages the K/V rows of its heads
// in shared memory, kTileKeys rows at a time (bq keys of each head), and
// every warp streams them through its kRowsPerWarp rows.
//
// Layout: one warp owns one query row at a time. Lane `lane` owns the
// head dimensions lane, lane + 32, ... (kChunks of them, D <= 32 *
// kChunks), so the row's q, its running max m, its running sum l and its
// D-wide accumulator stay in registers, in f32. A key's score is each
// lane's partial dot product summed across the warp with xor shuffles,
// so every lane holds the same m and l.
//
// K and V tiles are staged in shared memory as f32 by the whole block
// (stage_tile); a lane reads its own dimensions of a key row, so the 32
// lanes touch 32 consecutive words: no bank conflicts.
//
// Masking follows the reference: key j is visible to query i iff
// j <= i + offset (when banded) and j < S. A masked key contributes no
// mass and does not move m. Keys arrive in increasing order, so a row
// simply stops at its first masked key. m starts at -1e30 (finite, as the
// reference's fill), so the first rescale exp(m_prev - m_new) is exp of a
// finite number and never inf - inf; a row that sees no key keeps l = 0
// and acc = 0, and its output acc / max(l, 1e-30) is exactly 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTileKeys = kRows;              // staged key rows per tile
constexpr int kMaxD = 128;

template <int kChunks>
struct RowState {
  float m;
  float l;
  float acc[kChunks];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

// Element strides of one tensor: batch, head, row (the head dim is 1).
struct Strides {
  int64_t b;
  int64_t h;
  int64_t r;
};

// Head n's (b, h) with `heads` heads a batch: a 32-bit division where
// both fit, as they do at every real shape.
__device__ __forceinline__ void batch_head(int64_t n, int64_t heads,
                                           int64_t* b, int64_t* h) {
  *b = ((n | heads) >> 31) == 0
           ? static_cast<int64_t>(static_cast<uint32_t>(n) /
                                  static_cast<uint32_t>(heads))
           : n / heads;
  *h = n - *b * heads;
}

// The element offset of row `row` of head n.
__device__ __forceinline__ int64_t row_offset(const Strides& st, int64_t n,
                                              int64_t heads, int64_t row) {
  int64_t b;
  int64_t h;
  batch_head(n, heads, &b, &h);
  return b * st.b + h * st.h + row * st.r;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int delta = 16; delta > 0; delta >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, delta);
  }
  return x;
}

template <int kChunks>
__device__ __forceinline__ void init_row(RowState<kChunks>& st) {
  st.m = kNegInf;
  st.l = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    st.acc[c] = 0.0f;
  }
}

// Copy `keys` rows of D elements, starting at row `first`, of `heads`
// consecutive heads into shared memory as f32: dst[(i * keys + j) * D + e]
// = src[base[i] + (first + j) * row_stride + e], base[i] being row 0 of
// the block's head i (-1 past N). Rows past S and heads past N are
// zero-filled. Every thread of the block takes part; the caller
// synchronises.
template <typename T>
__device__ __forceinline__ void stage_tile(float* __restrict__ dst,
                                           const T* __restrict__ src,
                                           const int64_t* __restrict__ base,
                                           int64_t row_stride, int heads,
                                           int keys, int64_t s, int64_t first,
                                           int d) {
  const int per_head = keys * d;
  const int total = heads * per_head;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = e / per_head;
    const int rem = e - i * per_head;
    const int j = rem / d;
    const int64_t b0 = base[i];
    const int64_t col = first + j;
    float x = 0.0f;
    if (b0 >= 0 && col < s) {
      x = to_f32(src[b0 + col * row_stride + rem - j * d]);
    }
    dst[e] = x;
  }
}

// Stream `count` staged keys (rows of ks / vs, stride d) through one query
// row held by the calling warp. q holds the lane's dimensions of the
// query, already scaled by 1/sqrt(D), and 0 past D. The whole warp must
// call this together (the shuffles).
template <int kChunks>
__device__ __forceinline__ void stream_keys(RowState<kChunks>& st,
                                            const float (&q)[kChunks],
                                            const float* __restrict__ ks,
                                            const float* __restrict__ vs,
                                            int count, int d, int lane) {
  for (int j = 0; j < count; ++j) {
    const float* krow = ks + j * d;
    const float* vrow = vs + j * d;
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = lane + 32 * c;
      if (e < d) {
        part = fmaf(q[c], krow[e], part);
      }
    }
    const float score = warp_sum(part);
    const float m_new = fmaxf(st.m, score);
    const float corr = expf(st.m - m_new);
    const float p = expf(score - m_new);
    st.l = st.l * corr + p;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = lane + 32 * c;
      const float vv = e < d ? vrow[e] : 0.0f;
      st.acc[c] = fmaf(p, vv, st.acc[c] * corr);
    }
    st.m = m_new;
  }
}

// How many of a tile's `count` keys, starting at key `first`, query row
// `row` may see: all of them without a band, else those with
// j <= row + offset (never negative).
__device__ __forceinline__ int visible_keys(int count, int64_t first,
                                            int64_t row, bool banded,
                                            int64_t offset) {
  if (!banded) {
    return count;
  }
  const int64_t last = row + offset;  // the last visible key
  if (last < first) {
    return 0;
  }
  const int64_t seen = last - first + 1;
  return seen < count ? static_cast<int>(seen) : count;
}

// The query rows the calling warp owns, and their state after the stream.
template <int kChunks>
struct WarpRows {
  RowState<kChunks> st[kRowsPerWarp];
  int64_t head[kRowsPerWarp];  // global head
  int64_t row[kRowsPerWarp];   // query row within the head
  bool live[kRowsPerWarp];     // head < N and row < T
};

// Stream every key this block's rows can see through the calling warp's
// rows (the block layout above). q, k, v: N = B·H heads of T and S rows
// of D, addressed through their Strides (H = per_batch). Every
// thread of the block calls this together. A row that sees no key keeps
// m = -1e30, l = 0 and acc = 0; a block none of whose rows sees a key
// stages no tile at all.
template <typename T, int kChunks>
__device__ __forceinline__ void attend_block(
    WarpRows<kChunks>& w, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const Strides& sq, const Strides& sk,
    const Strides& sv, int64_t n, int64_t per_batch, int64_t t, int64_t s,
    int d, int bq, bool banded, int64_t offset) {
  __shared__ float ks[kTileKeys * 32 * kChunks];
  __shared__ float vs[kTileKeys * 32 * kChunks];
  __shared__ int64_t kbase[kRows];  // row 0 of each head of the block
  __shared__ int64_t vbase[kRows];

  const int heads = kRows / bq;      // heads per block
  const int bk = kTileKeys / heads;  // keys of each head per tile (= bq)
  const int64_t head0 = static_cast<int64_t>(blockIdx.x) * heads;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * bq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));

  float qr[kRowsPerWarp][kChunks];
  int local[kRowsPerWarp];  // head within the block
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    local[i] = r / bq;
    w.head[i] = head0 + local[i];
    w.row[i] = q0 + r % bq;
    w.live[i] = w.head[i] < n && w.row[i] < t;
    init_row(w.st[i]);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = lane + 32 * c;
      qr[i][c] = w.live[i] && e < d
                     ? to_f32(q[row_offset(sq, w.head[i], per_batch,
                                           w.row[i]) + e]) * scale
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
  const int tid = threadIdx.x;
  if (tid < heads) {
    const int64_t head = head0 + tid;
    kbase[tid] = head < n ? row_offset(sk, head, per_batch, 0) : -1;
    vbase[tid] = head < n ? row_offset(sv, head, per_batch, 0) : -1;
  }
  __syncthreads();
  for (int64_t first = 0; first < key_end; first += bk) {
    stage_tile(ks, k, kbase, sk.r, heads, bk, s, first, d);
    stage_tile(vs, v, vbase, sv.r, heads, bk, s, first, d);
    __syncthreads();
    const int in_tile = static_cast<int>(s - first < bk ? s - first : bk);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (w.live[i]) {  // warp-uniform: the whole warp owns row i
        const int count =
            visible_keys(in_tile, first, w.row[i], banded, offset);
        const int base = local[i] * bk * d;
        stream_keys(w.st[i], qr[i], ks + base, vs + base, count, d, lane);
      }
    }
    __syncthreads();
  }
}

// The launch geometry of the block layout: bq (the smallest power of two
// >= t, at most kRows) and the grid. False when the grid is too large.
inline bool block_grid(int64_t n, int64_t t, int* bq, dim3* grid) {
  int rows = 1;
  while (rows < t && rows < kRows) {
    rows *= 2;
  }
  const int heads = kRows / rows;
  const int64_t head_blocks = (n + heads - 1) / heads;
  const int64_t row_blocks = (t + rows - 1) / rows;
  if (head_blocks > 2147483647LL || row_blocks > 65535) {
    return false;
  }
  *bq = rows;
  *grid = dim3(static_cast<unsigned>(head_blocks),
               static_cast<unsigned>(row_blocks));
  return true;
}

}  // namespace flash
