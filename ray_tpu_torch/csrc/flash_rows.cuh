// Fused attention for short heads: a query row per thread.
//
// Counterpart of ray_tpu/ops/flash_attention.py:_online_softmax_stream at
// heads of T <= kRowsMaxT (32) rows and D <= kRowsMaxD (64), the decoder
// torso's shapes (T = S = 8, D = 32 at every main-path call). flash_fwd.cu
// runs it and normalises; flash_block.cu runs it for the block statistics
// at such shapes. Longer or wider heads keep flash_stream.cuh (flash_fwd.cu)
// or flash_tile.cuh (flash_block.cu).
//
// Lanes and heads: bq is the smallest power of two >= T, at least 4 and
// kDp / 4 (CopyLane). Lane l of a warp owns query row l % bq of head slot
// l / bq, so a warp holds 32 / bq heads (4 at T = 8, D = 32). The row's q (scaled by 1/sqrt(D) before the
// product, as the TPU kernel does), its scores, m, l and its D-wide
// accumulator stay in that thread's registers, in f32: no shuffle.
//
// Loads and stores: each warp owns a slice of shared memory; no warp
// reads another's, so it syncs with __syncwarp only (no block barrier).
// It stages its heads' K and V rows, kKeys keys of each head a chunk, and
// its 32 q rows there, in the input type: a lane copies one 16-byte chunk
// (cp.async, where the pointers, strides and D allow it: `vec`; element
// copies otherwise), neighbouring lanes the neighbouring chunks of a row,
// so a warp instruction reads whole rows. Every copy of the first chunk
// and of q is issued before the first wait. Each thread then reads its q
// row from shared memory into registers; at the end it writes its output
// row there, and the warp stores the rows to device memory the same way.
// A lane's slot and chunk are fixed (CopyLane), so its base pointers are
// computed once. A first design had each lane copy its own rows, so every
// 16-byte access of a warp instruction touched 32 rows: the loads and
// stores then took most of a launch.
//
// Keys and softmax: a chunk is kKeys = 8 keys of a head. A thread scores
// all of them (key rows read as shared-memory broadcasts: the bq threads
// of a head read the same words) with no branch, so the 8 dot products
// interleave; then one max and the exps over its visible keys (a select,
// not a branch, masks the rest to 0), the sum and P·V over all 8 rows.
// Chunks merge online (m, l, acc rescaled once a chunk). At the torso's
// shapes (S = 8) there is one chunk, so the softmax is exact two-pass.
// A first design scored up to 32 keys a chunk, each behind a per-thread
// branch, so one warp's dependent multiply-add chains ran one after
// another.
//
// Masks come from indices: key j is visible to row i iff j <= i + offset
// (when banded) and j < S. A row that sees no key keeps (acc, m, l) =
// (0, -1e30, 0); a chunk no row of a warp can see is never staged. V rows
// past a partial chunk's end are zeroed, so their weight of 0 adds 0.
//
// What bounds it on an H100: at B·H = 2048 heads of T = S = 8, D = 32 the
// bytes (q, k, v read once, o written once: 8.4 MB, 2.5 us at 3.35 TB/s)
// are far above the arithmetic (4·T·S·D flops a head). With about four
// warps an SM, the latency of one warp's chain sets the time more than
// the bytes do: its loads in flight, about 700 instructions of arithmetic,
// then its stores.

#pragma once

#include <atomic>

#include "flash_stream.cuh"

namespace flash {

constexpr int kRowsMaxT = 32;   // the longest head this path takes
constexpr int kRowsMaxD = 64;   // the widest head this path takes
constexpr int kRowsMaxWarps = 4;
constexpr int kKeys = 8;        // keys of a head a chunk

// One launch of the short-head path. N = batch · heads; (b, h) = (n / H,
// n % H). The head dim is contiguous in q, k and v.
struct RowsProblem {
  const void* q;
  const void* k;
  const void* v;
  Strides sq, sk, sv;
  int64_t n;      // heads, B·H
  int64_t heads;  // H
  int64_t s;      // keys a head
  int t;          // rows a head, <= kRowsMaxT
  int d;          // head dim, <= kDp
  int bq;         // lanes a head: a power of two >= t, >= 4 and >= kDp / 4
  bool vec;       // 16-byte copies for q, k and v
  bool banded;
  int64_t offset;
  float scale;
};

// A thread's row after the stream: its accumulator (kDp wide, 0 past D),
// running max and sum, and where it lives.
template <int kDp>
struct ThreadRow {
  float acc[kDp];
  float m;
  float l;
  int64_t head;  // n
  int row;
  bool live;  // n < N and row < T
};

// 16 bytes of T as floats, and back (round to nearest even for bf16).
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&x)[4]) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    x[0] = w.x;
    x[1] = w.y;
    x[2] = w.z;
    x[3] = w.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&x)[8]) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&x)[8]) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

__device__ __forceinline__ void rows_cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void rows_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A warp's slice of shared memory: K's and V's slots (kKeys rows of kDp
// each, 16-byte skew between slots) and 32 row buffers (q in, the output
// out) of kDp + 4 floats: rows 16 bytes apart modulo 128, so a thread's
// reads of its own row fall in its own banks.
template <typename T, int kDp>
struct RowsLayout {
  static constexpr int kN = Pack<T>::kN;
  static constexpr int kChunks = kDp / kN;        // 16-byte chunks a row
  static constexpr int kSlot = kKeys * kDp + kN;  // elements of T
  static constexpr int kBufStride = kDp + 4;      // floats
  static constexpr int kQStride = kBufStride * 4 / static_cast<int>(sizeof(T));
  __host__ __device__ static int bytes(int hpw) {
    return 2 * hpw * kSlot * static_cast<int>(sizeof(T)) + 32 * kBufStride * 4;
  }
};

// A lane's share of the warp's row copies, with kC 16-byte chunks to a
// row: chunk `chunk` of rows `row`, row + step, ... of head slot `slot`.
// Neighbouring lanes take neighbouring chunks of a row, then the same row
// of the next slot (in (B, T, H, D) memory the heads of a row are
// neighbours), so a warp instruction reads or writes whole rows. The
// launch keeps hpw · kC <= 32, so a lane's slot and chunk never change.
template <int kC>
struct CopyLane {
  int slot;
  int chunk;
  int row;
  int step;
};

template <int kC>
__device__ __forceinline__ CopyLane<kC> copy_lane(int lane, int hpw,
                                                  int hshift) {
  return {(lane / kC) & (hpw - 1), lane % kC, (lane / kC) >> hshift,
          (32 / kC) >> hshift};
}

// Copy kN elements (one 16-byte chunk, cut at D) from src to dst: one
// cp.async when `vec`, else element by element.
template <typename T>
__device__ __forceinline__ void rows_copy_in(T* dst, const T* src, int c,
                                             int d, bool vec) {
  if (vec) {
    rows_cp_async16(dst, src);
  } else {
    for (int e = 0; e < Pack<T>::kN && c + e < d; ++e) {
      dst[e] = src[e];
    }
  }
}

// The calling warp's slice, and the calling lane's share of its copies:
// its slot's head (live: < N) and row 0 of that head in q, k and v.
template <typename T, int kDp>
struct RowsWarp {
  T* ks;
  T* vs;
  float* buf;  // 32 rows of kBufStride floats: row l is lane l's
  int64_t head0;
  int hpw;
  int hshift;
  int lane;
  CopyLane<RowsLayout<T, kDp>::kChunks> in;
  bool in_live;
  int64_t b;  // the slot's head is (b, h)
  int64_t h;
  const T* qg;
  const T* kg;
  const T* vg;
};

// Stage keys c0 .. c0 + nk - 1 of the warp's live head slots (slot s at
// s * kSlot, key j at j * kDp), and zero V's rows nk .. kKeys - 1.
template <typename T, int kDp>
__device__ __forceinline__ void rows_stage(const RowsWarp<T, kDp>& w,
                                           const RowsProblem& p, int64_t c0,
                                           int nk) {
  using L = RowsLayout<T, kDp>;
  const int c = w.in.chunk * L::kN;
  T* kd = w.ks + w.in.slot * L::kSlot + c;
  T* vd = w.vs + w.in.slot * L::kSlot + c;
  const bool copy = w.in_live && c < p.d;
  for (int j = w.in.row; j < kKeys; j += w.in.step) {
    if (j >= nk) {
      const float zero[L::kN] = {};
      Pack<T>::store(vd + j * kDp, zero);
    } else if (copy) {
      rows_copy_in(kd + j * kDp, w.kg + (c0 + j) * p.sk.r + c, c, p.d, p.vec);
      rows_copy_in(vd + j * kDp, w.vg + (c0 + j) * p.sv.r + c, c, p.d, p.vec);
    }
  }
}

// The dot product of a thread's q (kDp floats, 0 past D) with one staged
// key row (zero-padded to kDp).
template <typename T, int kDp>
__device__ __forceinline__ float rows_dot(const float (&q)[kDp],
                                          const T* __restrict__ kr) {
  constexpr int kN = Pack<T>::kN;
  float dot = 0.0f;
#pragma unroll
  for (int c = 0; c < kDp; c += kN) {
    float x[kN];
    Pack<T>::load(kr + c, x);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      dot = fmaf(q[c + i], x[i], dot);
    }
  }
  return dot;
}

// Stream every visible key through the calling thread's row. The whole
// warp calls this together.
template <typename T, int kDp>
__device__ __forceinline__ void attend_rows(ThreadRow<kDp>& st,
                                            const RowsWarp<T, kDp>& w,
                                            const RowsProblem& p) {
  using L = RowsLayout<T, kDp>;
  constexpr int kN = L::kN;
  const int lane = w.lane;
  const int slot = lane / p.bq;
  st.head = w.head0 + slot;
  st.row = lane % p.bq;
  st.live = st.head < p.n && st.row < p.t;
  st.m = kNegInf;
  st.l = 0.0f;
#pragma unroll
  for (int e = 0; e < kDp; ++e) {
    st.acc[e] = 0.0f;
  }

  // the keys any row of this warp can see, and those this row can
  int64_t key_end = p.s;
  int64_t row_end = p.s;
  if (p.banded) {
    key_end = p.offset >= p.s - p.t ? p.s : (p.t + p.offset > 0 ? p.t + p.offset : 0);
    row_end = p.offset >= p.s - st.row - 1
                  ? p.s
                  : (st.row + p.offset + 1 > 0 ? st.row + p.offset + 1 : 0);
  }
  if (!st.live) {
    row_end = 0;
  }
  if (key_end <= 0) {
    return;
  }

  // zero the padding columns once (the copies never write them): K's
  // slots, then V's, kKeys rows each
  if (p.d < kDp) {
    for (int r = lane; r < 2 * w.hpw * kKeys; r += 32) {
      T* row = w.ks + (r / kKeys) * L::kSlot + (r % kKeys) * kDp;
      for (int e = p.d; e < kDp; ++e) {
        from_f32(row + e, 0.0f);
      }
    }
  }
  // the first chunk of K and V, and q: row i of slot s to buffer row
  // s * bq + i, its thread's
  rows_stage<T, kDp>(w, p, 0, key_end < kKeys ? static_cast<int>(key_end) : kKeys);
  T* qbuf = reinterpret_cast<T*>(w.buf);
  {
    const int c = w.in.chunk * kN;
    if (w.in_live && c < p.d) {
      for (int i = w.in.row; i < p.t; i += w.in.step) {
        rows_copy_in(qbuf + (w.in.slot * p.bq + i) * L::kQStride + c,
                     w.qg + i * p.sq.r + c, c, p.d, p.vec);
      }
    }
  }

  float qr[kDp];
  const T* vslot = w.vs + slot * L::kSlot;
  const T* kslot = w.ks + slot * L::kSlot;
  for (int64_t c0 = 0; c0 < key_end; c0 += kKeys) {
    if (p.vec) {
      rows_cp_async_wait_all();
    }
    __syncwarp();
    if (c0 == 0) {  // the thread's q, scaled, 0 past D
#pragma unroll
      for (int c = 0; c < kDp; c += kN) {
        float x[kN];
        Pack<T>::load(qbuf + lane * L::kQStride + c, x);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          qr[c + i] = c + i < p.d ? x[i] * p.scale : 0.0f;
        }
      }
    }
    // this row's visible keys of the chunk: the first cnt (0 past its band)
    const int64_t seen = row_end - c0;
    const int cnt = seen <= 0 ? 0 : (seen < kKeys ? static_cast<int>(seen) : kKeys);

    // every key of the chunk is scored, with no branch: rows past the
    // chunk's end hold stale or unset words, masked below by a select
    float sc[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      sc[j] = rows_dot<T, kDp>(qr, kslot + j * kDp);
    }
    float mc = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      mc = fmaxf(mc, j < cnt ? sc[j] : kNegInf);
    }
    // a chunk this row cannot see leaves m, l and acc as they are:
    // m_new = m, corr = 1 and every weight 0
    const float m_new = fmaxf(st.m, mc);
    const float corr = expf(st.m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      sc[j] = j < cnt ? expf(sc[j] - m_new) : 0.0f;
      sum += sc[j];
    }
    st.l = st.l * corr + sum;
#pragma unroll
    for (int e = 0; e < kDp; ++e) {
      st.acc[e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const T* vr = vslot + j * kDp;
#pragma unroll
      for (int c = 0; c < kDp; c += kN) {
        float x[kN];
        Pack<T>::load(vr + c, x);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          st.acc[c + i] = fmaf(sc[j], x[i], st.acc[c + i]);
        }
      }
    }
    st.m = m_new;
    __syncwarp();  // every lane is done with this chunk's slice
    if (c0 + kKeys < key_end) {
      const int64_t left = key_end - c0 - kKeys;
      rows_stage<T, kDp>(w, p, c0 + kKeys, left < kKeys ? static_cast<int>(left) : kKeys);
    }
  }
}

// Store the warp's output rows from its row buffer (row s · bq + i holds
// row i of slot s; kC chunks of E to a row, row stride `stride` elements)
// to device memory: row i of the lane's slot at dst + i * row_stride,
// dst being row 0 of that slot's head in the output (null past N). Whole
// rows a warp instruction, 16-byte stores when `vec`.
template <typename E, int kDp, int kC>
__device__ __forceinline__ void rows_store(const CopyLane<kC>& cl, E* dst,
                                           const E* buf, int stride,
                                           int64_t row_stride,
                                           const RowsProblem& p, bool vec) {
  constexpr int kN = kDp / kC;
  __syncwarp();  // every row is in the buffer
  const int c = cl.chunk * kN;
  if (dst == nullptr || c >= p.d) {
    return;
  }
  for (int i = cl.row; i < p.t; i += cl.step) {
    const E* src = buf + (cl.slot * p.bq + i) * stride + c;
    E* out = dst + i * row_stride + c;
    if (vec) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kN && c + e < p.d; ++e) {
        out[e] = src[e];
      }
    }
  }
}

// The short-head kernel: attend_rows, then `out` writes the warp's rows
// (Out::store, which every lane calls). One block an SM is enough (the
// launch gives at most two to an SM at the torso's shapes): with the
// block size alone as a bound, ptxas held the f32 statistics kernel at
// D = 32 to 128 registers and spilled 24 bytes (bf16 flash_fwd at D = 16:
// 4). With (128, 1) no instance spills (-Xptxas -v on sm_90a, CUDA 12.8).
template <typename T, int kDp, typename Out>
__global__ void __launch_bounds__(kRowsMaxWarps * 32, 1)
flash_rows_kernel(const RowsProblem p, const Out out) {
  using L = RowsLayout<T, kDp>;
  extern __shared__ __align__(16) unsigned char flash_rows_smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int hpw = 32 / p.bq;
  const int hshift = __ffs(hpw) - 1;
  RowsWarp<T, kDp> w{};
  w.lane = lane;
  w.hpw = hpw;
  w.hshift = hshift;
  w.head0 = (static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + warp) * hpw;
  unsigned char* slice = flash_rows_smem + warp * L::bytes(hpw);
  w.ks = reinterpret_cast<T*>(slice);
  w.vs = w.ks + hpw * L::kSlot;
  w.buf = reinterpret_cast<float*>(w.vs + hpw * L::kSlot);
  w.in = copy_lane<L::kChunks>(lane, hpw, hshift);
  const int64_t n = w.head0 + w.in.slot;
  w.in_live = n < p.n;
  if (w.in_live) {
    batch_head(n, p.heads, &w.b, &w.h);
    w.qg = static_cast<const T*>(p.q) + w.b * p.sq.b + w.h * p.sq.h;
    w.kg = static_cast<const T*>(p.k) + w.b * p.sk.b + w.h * p.sk.h;
    w.vg = static_cast<const T*>(p.v) + w.b * p.sv.b + w.h * p.sv.h;
  }
  ThreadRow<kDp> st;
  attend_rows<T, kDp>(st, w, p);
  out.store(st, w, p);
}

// The current device's SM count, read once a device.
inline int rows_sm_count() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    dev = -1;
  }
  int count = dev >= 0 ? counts[dev].load(std::memory_order_relaxed) : 0;
  if (count <= 0) {
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                           dev >= 0 ? dev : 0);
    count = count > 0 ? count : 1;
    if (dev >= 0) {
      counts[dev].store(count, std::memory_order_relaxed);
    }
  }
  return count;
}

// Fill in the launch geometry of p (bq; the caller sets the rest) and
// launch: a warp per 32 / bq heads. bq is at least kDp / 4, so that a
// warp's heads times a row's 16-byte chunks (of T, or of f32 outputs)
// are at most 32 (CopyLane).
template <typename T, int kDp, typename Out>
cudaError_t launch_rows_padded(RowsProblem p, const Out& out,
                               cudaStream_t stream) {
  int bq = kDp / 4 > 4 ? kDp / 4 : 4;
  while (bq < p.t) {
    bq *= 2;
  }
  p.bq = bq;
  const int hpw = 32 / bq;
  const int64_t warps = (p.n + hpw - 1) / hpw;
  const int warp_bytes = RowsLayout<T, kDp>::bytes(hpw);
  // as many blocks as SMs where the heads allow, then up to 4 warps a block
  const int sms = rows_sm_count();
  int per_block = 1;
  while (per_block < kRowsMaxWarps && warps >= 2 * per_block * sms &&
         2 * per_block * warp_bytes <= 48 * 1024) {
    per_block *= 2;
  }
  const int64_t blocks = (warps + per_block - 1) / per_block;
  if (blocks > 2147483647LL) {
    return cudaErrorInvalidConfiguration;
  }
  flash_rows_kernel<T, kDp, Out>
      <<<static_cast<unsigned>(blocks), per_block * 32,
         per_block * warp_bytes, stream>>>(p, out);
  return cudaGetLastError();
}

template <typename T, typename Out>
cudaError_t launch_rows(const RowsProblem& p, const Out& out,
                        cudaStream_t stream) {
  if (p.d <= 16) {
    return launch_rows_padded<T, 16>(p, out, stream);
  }
  if (p.d <= 32) {
    return launch_rows_padded<T, 32>(p, out, stream);
  }
  return launch_rows_padded<T, 64>(p, out, stream);
}

// Whether 16-byte copies can read row starts and columns of a tensor of
// T: the base and every stride are whole 16-byte chunks, as is D.
template <typename T>
inline bool rows_aligned(const void* base, const Strides& st, int d) {
  constexpr int64_t kN = Pack<T>::kN;
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && d % kN == 0 &&
         st.b % kN == 0 && st.h % kN == 0 && st.r % kN == 0;
}

// The problem of N = n heads of T rows, `heads` a batch, for q, k and v
// read through their strides: 16-byte copies where all three allow them,
// q scaled by 1/sqrt(D). The launch fills in bq.
template <typename T>
inline RowsProblem rows_problem(const void* q, const void* k, const void* v,
                                const Strides& sq, const Strides& sk,
                                const Strides& sv, int64_t n, int64_t heads,
                                int64_t s, int t, int d, bool banded,
                                int64_t offset) {
  RowsProblem p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.sq = sq;
  p.sk = sk;
  p.sv = sv;
  p.n = n;
  p.heads = heads;
  p.s = s;
  p.t = t;
  p.d = d;
  p.vec = rows_aligned<T>(q, sq, d) && rows_aligned<T>(k, sk, d) &&
          rows_aligned<T>(v, sv, d);
  p.banded = banded;
  p.offset = offset;
  p.scale = 1.0f / sqrtf(static_cast<float>(d));
  return p;
}

}  // namespace flash
