// The online-softmax stream of fused attention on tensor-core tiles.
//
// Counterpart of ray_tpu/ops/flash_attention.py:_online_softmax_stream,
// taken as the TPU kernel takes it: a whole key block per step
// (s = q @ k_blk.T, one tile max, one correction per row, p @ v_blk),
// not key by key. flash_block.cu runs it; flash_fwd.cu still runs the
// warp-per-row stream of flash_stream.cuh.
//
// Block layout: kWarps warps own kRows = 64 query rows of one head, 16
// rows a warp. K and V come in tiles of kKeys = 64 keys, staged in shared
// memory with cp.async (16-byte copies when the rows allow it) and
// double-buffered, so the next tile loads while this one is computed.
// The head dimension is padded with zeros to kDp (16, 32, 64 or 128).
//
// Products on tensor cores (mma.sync, accumulating in f32):
//  - S = Q·Kᵀ: bf16 inputs through m16n8k16 bf16, whose products are
//    exact; f32 inputs through m16n8k8 TF32 with the 3xTF32 split
//    (a = a_big + a_small, summing a_small·b_big + a_big·b_small +
//    a_big·b_big), which keeps about float32's accuracy where one TF32
//    product keeps three decimal digits;
//  - acc += P·V: P split the same way; bf16 V is exact in TF32 (two
//    products), f32 V is split too (three). Each tile's P·V sums into a
//    fresh fragment, added to the running acc with one fmaf per element
//    (acc·corr + tile), so the tensor core's accumulation spans 64 keys.
// The scores are scaled by 1/√D after the product (so bf16 products stay
// exact) and the softmax uses exp2f.
//
// Per-tile softmax, on the mma's accumulator fragment: a thread holds 16
// scores of each of its two rows (g and g + 8 of the warp's 16); the tile
// max is the thread's max and two quad shuffles; one corr = exp(m_prev −
// m_new) per row and tile; p = exp(s − m_new) for visible keys and exactly
// 0 for masked ones. l is kept per thread (its own columns) and summed
// across the quad once at the end, so the float32 running sums are short.
//
// Masking by tile: key j is visible to query i iff j <= i + offset (when
// banded) and j < S. A tile every row of a warp can see wholly runs
// without a per-element mask; tiles past the band are never staged; only
// the band's edge tile and the ragged tail (j >= S) mask per element. A
// row that sees no key keeps (acc, m, l) = (0, -1e30, 0) exactly, and a
// block none of whose rows sees a key stages nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tile {

constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per block
constexpr int kKeys = 64;           // keys per staged tile (== kRows)
constexpr int kMaxD = 128;
constexpr int kStages = 2;  // K/V tiles in flight: a double buffer

// Elements per staged row: kDp plus a skew that keeps the fragment loads
// free of bank conflicts. Shared memory holds the Q tile and kStages K
// and V tiles.
template <typename T, int kDp>
struct Layout {
  static constexpr int kStride = sizeof(T) == 4 ? kDp + 4 : kDp + 8;
  static constexpr int kTile = kKeys * kStride;
  static constexpr int kBytes =
      (1 + 2 * kStages) * kTile * static_cast<int>(sizeof(T));
};

// The state of a warp's 16 query rows in one thread: rows g and g + 8
// (g = lane / 4), columns 2·(lane % 4) and +1 of each 8-wide block.
template <int kDp>
struct Rows {
  float acc[kDp / 8][4];  // [column block][c0..c3 of the mma fragment]
  float m[2];
  float l[2];  // this thread's columns only, until finish()
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as the
// bits of a float whose low 13 bits are 0.
__device__ __forceinline__ uint32_t tf32_big(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: small is exact in f32; the tensor core reads its top
// 19 bits, so the pair carries x to about 2^-22 of |x|.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_big(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows first..first+kKeys of a (len, d) matrix into a staged tile; rows
// past len are zero. vec: 16-byte cp.async (rows of whole 16-byte chunks
// and aligned bases), else element copies. Every thread calls this.
template <typename T, int kDp>
__device__ __forceinline__ void stage(T* __restrict__ dst,
                                      const T* __restrict__ src, int first,
                                      int len, int d, bool vec) {
  constexpr int kStride = Layout<T, kDp>::kStride;
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    const int chunks = d / kPer;
    for (int e = threadIdx.x; e < kKeys * chunks; e += kThreads) {
      const int r = e / chunks;
      const int c = (e - r * chunks) * kPer;
      const bool ok = first + r < len;
      cp_async16(dst + r * kStride + c,
                 src + (ok ? static_cast<int64_t>(first + r) * d + c : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < kKeys * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      dst[r * kStride + c] = first + r < len
                                 ? src[static_cast<int64_t>(first + r) * d + c]
                                 : zero<T>();
    }
  }
}

// S = Q·Kᵀ for the warp's 16 rows and the tile's 64 keys: sc[nb] is the
// fragment of keys 8·nb..8·nb+7. qs, ks: the warp's Q rows and the K tile.
template <int kDp>
__device__ __forceinline__ void scores(float (&sc)[8][4],
                                       const float* __restrict__ qs,
                                       const float* __restrict__ ks, int g,
                                       int tig) {
  constexpr int kStride = Layout<float, kDp>::kStride;
#pragma unroll
  for (int kk = 0; kk < kDp / 8; ++kk) {
    const float* q0 = qs + g * kStride + 8 * kk + tig;
    uint32_t ab[4], as[4];
    split(q0[0], ab[0], as[0]);
    split(q0[8 * kStride], ab[1], as[1]);
    split(q0[4], ab[2], as[2]);
    split(q0[8 * kStride + 4], ab[3], as[3]);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float* k0 = ks + (8 * nb + g) * kStride + 8 * kk + tig;
      uint32_t bb0, bs0, bb1, bs1;
      split(k0[0], bb0, bs0);
      split(k0[4], bb1, bs1);
      mma_tf32(sc[nb], as, bb0, bb1);
      mma_tf32(sc[nb], ab, bs0, bs1);
      mma_tf32(sc[nb], ab, bb0, bb1);
    }
  }
}

template <int kDp>
__device__ __forceinline__ void scores(float (&sc)[8][4],
                                       const __nv_bfloat16* __restrict__ qs,
                                       const __nv_bfloat16* __restrict__ ks,
                                       int g, int tig) {
  constexpr int kWords = Layout<__nv_bfloat16, kDp>::kStride / 2;
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* k32 = reinterpret_cast<const uint32_t*>(ks);
#pragma unroll
  for (int kk = 0; kk < kDp / 16; ++kk) {
    const uint32_t* q0 = q32 + g * kWords + 8 * kk + tig;
    const uint32_t a[4] = {q0[0], q0[8 * kWords], q0[4], q0[8 * kWords + 4]};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const uint32_t* k0 = k32 + (8 * nb + g) * kWords + 8 * kk + tig;
      mma_bf16(sc[nb], a, k0[0], k0[4]);
    }
  }
}

// pv += P·V over the tile's 64 keys. The mma's k index is permuted so
// that P's accumulator fragment is its A fragment as it stands: k
// positions tig and tig + 4 of key block kk hold keys 2·tig and 2·tig + 1,
// and V's rows are read in the same order.
template <int kDp>
__device__ __forceinline__ void add_pv(float (&pv)[kDp / 8][4],
                                       const float (&p)[8][4],
                                       const float* __restrict__ vs, int g,
                                       int tig) {
  constexpr int kStride = Layout<float, kDp>::kStride;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ab[4], as[4];
    split(p[kk][0], ab[0], as[0]);
    split(p[kk][2], ab[1], as[1]);
    split(p[kk][1], ab[2], as[2]);
    split(p[kk][3], ab[3], as[3]);
    const float* v0 = vs + (8 * kk + 2 * tig) * kStride + g;
#pragma unroll
    for (int nd = 0; nd < kDp / 8; ++nd) {
      uint32_t bb0, bs0, bb1, bs1;
      split(v0[8 * nd], bb0, bs0);
      split(v0[kStride + 8 * nd], bb1, bs1);
      mma_tf32(pv[nd], as, bb0, bb1);
      mma_tf32(pv[nd], ab, bs0, bs1);
      mma_tf32(pv[nd], ab, bb0, bb1);
    }
  }
}

template <int kDp>
__device__ __forceinline__ void add_pv(float (&pv)[kDp / 8][4],
                                       const float (&p)[8][4],
                                       const __nv_bfloat16* __restrict__ vs,
                                       int g, int tig) {
  constexpr int kStride = Layout<__nv_bfloat16, kDp>::kStride;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ab[4], as[4];
    split(p[kk][0], ab[0], as[0]);
    split(p[kk][2], ab[1], as[1]);
    split(p[kk][1], ab[2], as[2]);
    split(p[kk][3], ab[3], as[3]);
    const __nv_bfloat16* v0 = vs + (8 * kk + 2 * tig) * kStride + g;
#pragma unroll
    for (int nd = 0; nd < kDp / 8; ++nd) {
      // a bf16 value is exact in TF32
      const uint32_t b0 = __float_as_uint(__bfloat162float(v0[8 * nd]));
      const uint32_t b1 =
          __float_as_uint(__bfloat162float(v0[kStride + 8 * nd]));
      mma_tf32(pv[nd], as, b0, b1);
      mma_tf32(pv[nd], ab, b0, b1);
    }
  }
}

// One key tile through the warp's rows: the scores, the per-tile softmax
// and acc = acc·corr + P·V. kMasked: mask per element (key j of this
// thread's row r is visible iff j <= last[r]).
template <typename T, int kDp, bool kMasked>
__device__ __forceinline__ void tile_step(Rows<kDp>& st,
                                          const T* __restrict__ qs,
                                          const T* __restrict__ ks,
                                          const T* __restrict__ vs, int j0,
                                          const int (&last)[2], float scale,
                                          int g, int tig) {
  float sc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[nb][e] = 0.0f;
    }
  }
  scores<kDp>(sc, qs, ks, g, tig);

  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[nb][e] * scale;
      if (kMasked && j0 + 8 * nb + 2 * tig + (e & 1) > last[e >> 1]) {
        x = kNegInf;
      }
      sc[nb][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float corr[2], mlog[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(st.m[r], mx[r]);
    corr[r] = exp2f((st.m[r] - m_new) * kLog2e);
    st.m[r] = m_new;
    mlog[r] = m_new * kLog2e;
  }
  float ls[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2f(fmaf(sc[nb][e], kLog2e, -mlog[r]));
      if (kMasked && j0 + 8 * nb + 2 * tig + (e & 1) > last[r]) {
        p = 0.0f;
      }
      sc[nb][e] = p;
      ls[r] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] = fmaf(st.l[r], corr[r], ls[r]);
  }

  float pv[kDp / 8][4];
#pragma unroll
  for (int nd = 0; nd < kDp / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pv[nd][e] = 0.0f;
    }
  }
  add_pv<kDp>(pv, sc, vs, g, tig);
#pragma unroll
  for (int nd = 0; nd < kDp / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      st.acc[nd][e] = fmaf(st.acc[nd][e], corr[e >> 1], pv[nd][e]);
    }
  }
}

// Stream every key the block's rows can see through the calling warp's
// rows. q: (N, T, D), k, v: (N, S, D); the block owns rows q0..q0+kRows
// of `head`. smem: Layout<T, kDp>::kBytes of dynamic shared memory. Every
// thread of the block calls this together.
template <typename T, int kDp>
__device__ __forceinline__ void attend(Rows<kDp>& st, T* __restrict__ smem,
                                       const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v, int64_t head,
                                       int q0, int t, int s, int d,
                                       float scale, bool banded,
                                       int64_t offset) {
  constexpr int kStride = Layout<T, kDp>::kStride;
  constexpr int kTile = Layout<T, kDp>::kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m[r] = kNegInf;
    st.l[r] = 0.0f;
  }
#pragma unroll
  for (int nd = 0; nd < kDp / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      st.acc[nd][e] = 0.0f;
    }
  }

  // the keys this block's rows can see at all, and this warp's rows
  auto seen = [&](int64_t row) -> int64_t {  // keys 0..seen-1 visible
    if (!banded) {
      return s;
    }
    const int64_t e = row + offset + 1;
    return e < 0 ? 0 : (e < s ? e : s);
  };
  const int block_last = (q0 + kRows < t ? q0 + kRows : t) - 1;
  const int key_end = static_cast<int>(seen(block_last));
  if (key_end == 0) {
    return;  // no row of the block sees a key: stage nothing
  }
  const int w0 = q0 + 16 * warp;
  const int warp_end =
      w0 < t ? static_cast<int>(seen(w0 + 15 < t ? w0 + 15 : t - 1)) : 0;
  int last[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    last[r] = static_cast<int>(seen(w0 + g + 8 * r)) - 1;
  }

  T* qs = smem;  // then K, V of stage 0, K, V of stage 1, ...
  const T* qh = q + head * t * d;
  const T* kh = k + head * s * d;
  const T* vh = v + head * s * d;
  const bool vec =
      (d * sizeof(T)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  if (d < kDp) {  // the padded columns of every tile, once
    const int pad = kDp - d;
    for (int e = threadIdx.x; e < (1 + 2 * kStages) * kKeys * pad;
         e += kThreads) {
      const int r = e / pad;
      smem[r * kStride + d + (e - r * pad)] = zero<T>();
    }
  }
  const int tiles = (key_end + kKeys - 1) / kKeys;
  // one commit group per tile, empty past the last, so that waiting for
  // all but kStages - 1 groups always means "tile it has landed"
  stage<T, kDp>(qs, qh, q0, t, d, vec);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < tiles) {
      stage<T, kDp>(smem + (1 + 2 * i) * kTile, kh, i * kKeys, s, d, vec);
      stage<T, kDp>(smem + (2 + 2 * i) * kTile, vh, i * kKeys, s, d, vec);
    }
    cp_async_commit();
  }

  const T* qw = qs + 16 * warp * kStride;
  for (int it = 0; it < tiles; ++it) {
    const int j0 = it * kKeys;
    const int ahead = it + kStages - 1;
    if (ahead < tiles) {
      const int b = ahead % kStages;
      stage<T, kDp>(smem + (1 + 2 * b) * kTile, kh, ahead * kKeys, s, d, vec);
      stage<T, kDp>(smem + (2 + 2 * b) * kTile, vh, ahead * kKeys, s, d, vec);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* kt = smem + (1 + 2 * (it % kStages)) * kTile;
    const T* vt = kt + kTile;
    if (j0 < warp_end) {  // warp-uniform
      const bool masked =
          j0 + kKeys > s || (banded && j0 + kKeys - 1 > w0 + offset);
      if (masked) {
        tile_step<T, kDp, true>(st, qw, kt, vt, j0, last, scale, g, tig);
      } else {
        tile_step<T, kDp, false>(st, qw, kt, vt, j0, last, scale, g, tig);
      }
    }
    __syncthreads();
  }
}

// Sum l over the quad that shares each row.
template <int kDp>
__device__ __forceinline__ void finish(Rows<kDp>& st) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
  }
}

}  // namespace flash_tile
