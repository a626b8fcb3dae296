// One attention block with its running statistics, for ring attention:
// acc = Σ_j exp(q·k_j/√D − m) v_j over the visible keys, unnormalised,
// with the row max m and the row sum l, never writing the (T, S) scores
// to device memory.
//
// Replaces ray_tpu/ops/flash_attention.py:_block_kernel (reached through
// flash_block_attention_stats from the ring's hops,
// ray_tpu/parallel/ring_attention.py:_block_attn_flash). It runs the
// tensor-core tile stream of flash_tile.cuh (64 query rows of one head
// per block of 4 warps, 64-key K/V tiles double-buffered with cp.async,
// S = Q·Kᵀ and P·V through mma.sync, a softmax per tile) and writes acc,
// m and l as they are. On the TPU the band offset lived in SMEM because
// the device index was traced; here every rank knows its offset on the
// host, so it is passed by value. Key j is visible to query i iff
// j <= i + offset; an offset >= S - 1 shows every key and runs unbanded.
// A row that sees no key writes m = -1e30, l = 0 and acc = 0 exactly
// (the merge of the ring relies on it), and a block none of whose rows
// sees a key (every hop from a later shard of a causal ring) stages no
// tile and only writes those values.
//
// What bounds it on an H100: at the ring's hop shape (8 heads of
// T = S = 4096, D = 32) the arithmetic, about 17 GFLOP when every key is
// visible, is far above the bytes (about 16 MB, 5 us at 3.35 TB/s): it is
// bound by operations. The kernel must keep float32 accuracy, so its
// bound counts the 67 TFLOP/s f32 rate. The tile design moves the
// products onto the tensor cores (3xTF32 for f32 inputs, three TF32
// products per f32 product; exact bf16 products for bf16), and pays the
// softmax once per (row, key) with one exp2f and no shuffles: the tile
// max takes two quad shuffles per row and 64 keys, the correction one
// exp2f per row and tile. The warp-per-row stream it replaced spent a
// five-shuffle reduction and two expf per (row, key) on D multiply-adds.
//
// Heads of T <= 32 rows and D <= 64 (the decoder torso's 8-token heads)
// run flash_rows.cuh's query row per thread instead, with an epilogue that
// writes the statistics: a 64-row tile would be 56 rows of padding at
// T = 8. Its rows that see no key write (0, -1e30, 0) the same way.
//
// Types: q, k, v f32 or bf16 (one type), accumulation and the outputs
// f32. D <= 128, padded to 16, 32, 64 or 128; T <= 65535 * 64 and
// S < 2^31 - 64.

#include "flash_rows.cuh"
#include "flash_tile.cuh"

namespace {

// The short-head path's epilogue: acc (n, t, d), m and l (n, t), f32 and
// contiguous, as they are; acc through the warp's row buffer, 16-byte
// stores when D allows them.
struct Stats {
  float* acc;
  float* m;
  float* l;
  bool vec;  // D a multiple of 4

  template <typename T, int kDp>
  __device__ __forceinline__ void store(const flash::ThreadRow<kDp>& st,
                                        const flash::RowsWarp<T, kDp>& w,
                                        const flash::RowsProblem& p) const {
    constexpr int kStride = flash::RowsLayout<T, kDp>::kBufStride;
    if (st.live) {
#pragma unroll
      for (int c = 0; c < kDp; c += 4) {
        const float x[4] = {st.acc[c], st.acc[c + 1], st.acc[c + 2],
                            st.acc[c + 3]};
        flash::Pack<float>::store(w.buf + w.lane * kStride + c, x);
      }
      const int64_t o = st.head * p.t + st.row;
      m[o] = st.m;
      l[o] = st.l;
    }
    // f32 rows: kDp / 4 chunks, the lane's own slot and chunk
    const auto cl = flash::copy_lane<kDp / 4>(w.lane, w.hpw, w.hshift);
    const int64_t n = w.head0 + cl.slot;
    float* dst = n < p.n ? acc + n * p.t * p.d : nullptr;
    flash::rows_store<float, kDp, kDp / 4>(cl, dst, w.buf, kStride, p.d, p,
                                           vec);
  }
};

template <typename T>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        float* acc, float* m, float* l, int64_t n, int t,
                        int s, int d, bool banded, int64_t offset,
                        cudaStream_t stream) {
  const flash::Strides sq{0, static_cast<int64_t>(t) * d, d};
  const flash::Strides sk{0, static_cast<int64_t>(s) * d, d};
  // one batch of n heads
  const flash::RowsProblem p = flash::rows_problem<T>(
      q, k, v, sq, sk, sk, n, n, s, t, d, banded, offset);
  return flash::launch_rows<T>(p, Stats{acc, m, l, d % 4 == 0}, stream);
}

using flash_tile::kRows;
using flash_tile::kThreads;

// Up to D = 32, registers are held to 128 a thread so that four blocks
// share an SM (as their shared memory allows): the hop's 8 × 64 blocks
// then run in one wave on 132 SMs.
template <typename T, int kDp>
__global__ void __launch_bounds__(kThreads, kDp <= 32 ? 4 : 1)
flash_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ acc,
                   float* __restrict__ m, float* __restrict__ l, int t, int s,
                   int d, float scale, bool banded, int64_t offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t head = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  flash_tile::Rows<kDp> st;
  flash_tile::attend<T, kDp>(st, reinterpret_cast<T*>(smem_raw), q, k, v,
                             head, q0, t, s, d, scale, banded, offset);
  flash_tile::finish(st);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= t) {
      continue;
    }
    const int64_t o = head * t + row;
    float* out = acc + o * d;
#pragma unroll
    for (int nd = 0; nd < kDp / 8; ++nd) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * nd + 2 * tig + c;
        if (col < d) {
          out[col] = st.acc[nd][2 * r + c];
        }
      }
    }
    if (tig == 0) {
      m[o] = st.m[r];
      l[o] = st.l[r];
    }
  }
}

template <typename T, int kDp>
cudaError_t launch_padded(const void* q, const void* k, const void* v,
                          float* acc, float* m, float* l, int64_t n, int t,
                          int s, int d, bool banded, int64_t offset,
                          cudaStream_t stream) {
  constexpr int kBytes = flash_tile::Layout<T, kDp>::kBytes;
  if (kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_block_kernel<T, kDp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) {
      return err;
    }
  }
  const dim3 grid(static_cast<unsigned>(n),
                  static_cast<unsigned>((t + kRows - 1) / kRows));
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  flash_block_kernel<T, kDp><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), acc, m, l, t, s, d, scale, banded, offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         float* acc, float* m, float* l, int64_t n, int t,
                         int s, int d, bool banded, int64_t offset,
                         cudaStream_t stream) {
  if (d <= 16) {
    return launch_padded<T, 16>(q, k, v, acc, m, l, n, t, s, d, banded,
                                offset, stream);
  }
  if (d <= 32) {
    return launch_padded<T, 32>(q, k, v, acc, m, l, n, t, s, d, banded,
                                offset, stream);
  }
  if (d <= 64) {
    return launch_padded<T, 64>(q, k, v, acc, m, l, n, t, s, d, banded,
                                offset, stream);
  }
  return launch_padded<T, 128>(q, k, v, acc, m, l, n, t, s, d, banded, offset,
                               stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. acc: (n, t, d) f32; m, l: (n, t) f32.
extern "C" int flash_block_launch(const void* q, const void* k, const void* v,
                                  void* acc, void* m, void* l, long long n,
                                  long long t, long long s, int d, int dtype,
                                  long long offset, void* stream) {
  if (d <= 0 || d > flash_tile::kMaxD || dtype < 0 || dtype > 1 || s < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || t <= 0) {
    return 0;
  }
  if (n > 2147483647LL || t > 65535LL * kRows ||
      s > 2147483647LL - flash_tile::kKeys) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool banded = offset < s - 1;
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  const int ti = static_cast<int>(t);
  const int si = static_cast<int>(s);
  if (t <= flash::kRowsMaxT && d <= flash::kRowsMaxD) {
    return static_cast<int>(
        dtype == 0 ? launch_rows<float>(q, k, v, a, mm, ll, n, ti, si, d,
                                        banded, offset, st)
                   : launch_rows<__nv_bfloat16>(q, k, v, a, mm, ll, n, ti, si,
                                                d, banded, offset, st));
  }
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(q, k, v, a, mm, ll, n, ti, si, d,
                                       banded, offset, st)
                 : launch_typed<__nv_bfloat16>(q, k, v, a, mm, ll, n, ti, si,
                                               d, banded, offset, st);
  return static_cast<int>(err);
}

extern "C" const char* flash_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
