// Fused attention forward: o = softmax(q kᵀ / √D + band) v, normalised,
// never writing the (T, S) scores to device memory.
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel (reached through
// _flash_fwd_pallas from flash_attention). On the TPU one grid step took
// one (batch·head, 128-row query block), padded T and S to block multiples
// with jnp.pad, and streamed every key block of that head through VMEM.
// Here two paths share one entry point:
//
//  - heads of T <= 32 rows and D <= 64 (every main-path call: the decoder
//    torso's 8-token heads of 32) run flash_rows.cuh, a query row per
//    thread: a warp holds 32 / bq heads (bq the smallest power of two
//    >= T), stages their K/V rows in its own slice of shared memory with
//    16-byte cp.async copies, and each thread takes its row's scores, one
//    max, the exps and P·V in registers, with no shuffle;
//  - longer or wider heads run flash_stream.cuh's warp per query row (a
//    block of 8 warps owns 32 rows, K/V staged 32 rows at a time, an
//    online softmax key by key). No main path runs them.
//
// q, k, v and o are read and written where they are: each comes with
// (batch, head, row) element strides, the head dim contiguous, so the
// torso's projections, (B, H, T, D) views over (B, T, H, D) memory, need
// no copy, and o takes q's layout. The band (j <= i + offset) and the
// ragged edges (i < T, j < S, heads < N) are masked from indices; nothing
// is padded or copied.
//
// What bounds it on an H100: at the torso's shapes (T = S = 8, D = 32,
// f32) the bytes (q, k, v read once, o written once: 8.4 MB at 2048
// heads, 2.5 us at 3.35 TB/s) are far above the arithmetic (4·T·S·D
// flops per head). The math is f32 on the CUDA cores; q is scaled by
// 1/sqrt(D) before the dot product, as the TPU kernel does.
//
// Types: f32 or bf16 in (q, k, v of one type), accumulation in f32, the
// output in q's type. D <= 128.

#include "flash_rows.cuh"

namespace {

using flash::ThreadRow;
using flash::RowsProblem;
using flash::Strides;

// The short-head path's epilogue: o = acc / max(l, 1e-30) in T (one
// reciprocal a row), through the warp's row buffer, 16-byte stores where
// o's layout allows.
template <typename T>
struct Normalised {
  T* o;
  Strides so;
  bool vec;

  template <int kDp>
  __device__ __forceinline__ void store(const ThreadRow<kDp>& st,
                                        const flash::RowsWarp<T, kDp>& w,
                                        const RowsProblem& p) const {
    using L = flash::RowsLayout<T, kDp>;
    T* buf = reinterpret_cast<T*>(w.buf);
    if (st.live) {
      const float inv = 1.0f / fmaxf(st.l, 1e-30f);
#pragma unroll
      for (int c = 0; c < kDp; c += L::kN) {
        float x[L::kN];
#pragma unroll
        for (int i = 0; i < L::kN; ++i) {
          x[i] = st.acc[c + i] * inv;
        }
        flash::Pack<T>::store(buf + w.lane * L::kQStride + c, x);
      }
    }
    // the lane copies rows of the same slot as it loaded
    T* dst = w.in_live ? o + w.b * so.b + w.h * so.h : nullptr;
    flash::rows_store<T, kDp, L::kChunks>(w.in, dst, buf, L::kQStride, so.r,
                                          p, vec);
  }
};

template <typename T, int kChunks>
__global__ void __launch_bounds__(flash::kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides sq,
                 Strides sk, Strides sv, Strides so, int64_t n,
                 int64_t per_batch, int64_t t, int64_t s, int d, int bq,
                 bool banded, int64_t offset) {
  flash::WarpRows<kChunks> w;
  flash::attend_block<T, kChunks>(w, q, k, v, sq, sk, sv, n, per_batch, t, s,
                                  d, bq, banded, offset);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < flash::kRowsPerWarp; ++i) {
    if (!w.live[i]) {
      continue;
    }
    const float l = fmaxf(w.st[i].l, 1e-30f);
    T* out = o + flash::row_offset(so, w.head[i], per_batch, w.row[i]);
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
cudaError_t launch_stream(const T* q, const T* k, const T* v, T* o,
                          const Strides& sq, const Strides& sk,
                          const Strides& sv, const Strides& so, int64_t n,
                          int64_t per_batch, int64_t t, int64_t s, int d,
                          bool banded, int64_t offset, cudaStream_t stream) {
  int bq = 0;
  dim3 grid;
  if (!flash::block_grid(n, t, &bq, &grid)) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 block(flash::kWarps * 32);
  switch ((d + 31) / 32) {
    case 1:
      flash_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(
          q, k, v, o, sq, sk, sv, so, n, per_batch, t, s, d, bq, banded,
          offset);
      break;
    case 2:
      flash_fwd_kernel<T, 2><<<grid, block, 0, stream>>>(
          q, k, v, o, sq, sk, sv, so, n, per_batch, t, s, d, bq, banded,
          offset);
      break;
    case 3:
      flash_fwd_kernel<T, 3><<<grid, block, 0, stream>>>(
          q, k, v, o, sq, sk, sv, so, n, per_batch, t, s, d, bq, banded,
          offset);
      break;
    default:
      flash_fwd_kernel<T, 4><<<grid, block, 0, stream>>>(
          q, k, v, o, sq, sk, sv, so, n, per_batch, t, s, d, bq, banded,
          offset);
      break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o,
                         const Strides& sq, const Strides& sk,
                         const Strides& sv, const Strides& so, int64_t b,
                         int64_t h, int64_t t, int64_t s, int d, bool banded,
                         int64_t offset, cudaStream_t stream) {
  const int64_t n = b * h;
  if (t <= flash::kRowsMaxT && d <= flash::kRowsMaxD) {
    const RowsProblem p = flash::rows_problem<T>(
        q, k, v, sq, sk, sv, n, h, s, static_cast<int>(t), d, banded, offset);
    const Normalised<T> out{static_cast<T*>(o), so,
                            flash::rows_aligned<T>(o, so, d)};
    return flash::launch_rows<T>(p, out, stream);
  }
  return launch_stream<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                          static_cast<const T*>(v), static_cast<T*>(o), sq,
                          sk, sv, so, n, h, t, s, d, banded, offset, stream);
}

}  // namespace

// q: (b, h, t, d), k and v: (b, h, s, d), o: (b, h, t, d), each addressed
// through its (batch, head, row) element strides; the head dim is
// contiguous. dtype: 0 = float32, 1 = bfloat16. banded: 0 = no mask, else
// key j is visible to query i iff j <= i + offset.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, long long b, long long h, long long t,
                                long long s, int d, long long qb, long long qh,
                                long long qr, long long kb, long long kh,
                                long long kr, long long vb, long long vh,
                                long long vr, long long ob, long long oh,
                                long long orow, int dtype, int banded,
                                long long offset, void* stream) {
  if (d <= 0 || d > flash::kMaxD || dtype < 0 || dtype > 1 || s < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b <= 0 || h <= 0 || t <= 0) {
    return 0;
  }
  const Strides sq{qb, qh, qr};
  const Strides sk{kb, kh, kr};
  const Strides sv{vb, vh, vr};
  const Strides so{ob, oh, orow};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_typed<float>(q, k, v, o, sq, sk, sv, so, b, h, t, s, d,
                                banded != 0, offset, st)
          : launch_typed<__nv_bfloat16>(q, k, v, o, sq, sk, sv, so, b, h, t,
                                        s, d, banded != 0, offset, st);
  return static_cast<int>(err);
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
