// GAE over (N, T) fragments in one launch: the delta/coefficient
// prologue, the reverse recurrence adv[t] = delta[t] + c[t] * adv[t+1],
// and the value-target epilogue adv + values.
//
// Replaces ray_tpu/ops/gae.py:_gae_scan_kernel (reached through
// _gae_scan_pallas from compute_gae_fragment). The TPU kernel walked T
// sequentially and vectorised over a block of 8 rows, padding the row
// count to 8 for the (8, 128) tiling; here one thread walks one row
// from t = T-1 down to 0 and no padding is needed. The prologue and
// epilogue, which ran as separate XLA ops around the Pallas call, are
// folded in, so the whole function is a single launch.
//
// What bounds it on an H100: latency, not bandwidth. The device lane's
// fragment is (16, 128) f32, about 45 KB in and out, which HBM moves in
// tens of nanoseconds. What cannot be shortened is the walk: T steps of
// run = delta + coeff * run, one multiply and one add, each waiting for
// the last (8 cycles a step at best, so about 0.5 us at T = 128). So the
// design keeps everything else off that chain, a warp a row and a block
// a warp:
//
// - Staging: each lane loads 4 neighbouring steps of a 128-step tile with
//   16-byte loads (4-byte loads of the flags) where T is a multiple of 4
//   and the pointers are aligned, else 4 steps 32 apart: coalesced, with
//   no per-element divide, and every load of a lane sent before any is
//   used, so the staging is one memory round trip. While staging, each
//   lane computes the prologue, delta and coeff, for its own steps, and
//   stores them and the values in shared memory.
// - The walk: lane 0 runs only the two operations that carry the
//   dependence, reading delta and coeff 4 steps at a time (16-byte shared
//   loads) and writing the advantages to their own array. A full tile's
//   walk is unrolled, each group's loads sent 4 groups ahead, so no
//   step waits for shared memory.
// - Write-back: every lane adds the values to its advantages (the value
//   targets) and stores both, coalesced as in the staging.
//
// A row a block spreads the rows over the SMs: at (16, 128), 16 SMs stage
// 2 KB each. With 16 rows a block, one SM streamed the whole 28 KB in and
// 16 KB out, and a launch took 0.00248 ms of an H100's device time
// against 0.00189 now. Longer fragments go tile by tile from the end, the
// running advantage carried in lane 0's register.
//
// Rounding: every operation rounds on its own (__fmul_rn, __fadd_rn,
// __fsub_rn cannot be contracted into an FMA), in the operation order
// of the plain PyTorch version in ray_tpu_torch/ops/gae.py, so the
// kernel agrees with it bitwise on the card. The file is also built
// with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 128;  // time steps per shared-memory tile
constexpr int kThreads = 32;  // a warp a row, a block a warp
constexpr int kPerLane = kSteps / kThreads;  // steps a lane stages

// delta = rewards + gamma * next_values * not_term - values;
// coeff = (gamma * lambda) * not_done, in the plain version's order
__device__ __forceinline__ void prologue(float r, float v, float nv,
                                         unsigned term, unsigned done,
                                         float gamma, float gamma_lambda,
                                         float* delta, float* coeff) {
  const float not_term = __fsub_rn(1.0f, term ? 1.0f : 0.0f);
  const float not_done = __fsub_rn(1.0f, done ? 1.0f : 0.0f);
  const float boot = __fmul_rn(__fmul_rn(nv, gamma), not_term);
  *delta = __fsub_rn(__fadd_rn(r, boot), v);
  *coeff = __fmul_rn(not_done, gamma_lambda);
}

__device__ __forceinline__ float step(float delta, float coeff, float run) {
  return __fadd_rn(delta, __fmul_rn(coeff, run));
}

// four steps, from the last of the group to the first; returns the
// advantages of the group
__device__ __forceinline__ float4 step4(float4 d, float4 k, float* run) {
  float4 a;
  a.w = *run = step(d.w, k.w, *run);
  a.z = *run = step(d.z, k.z, *run);
  a.y = *run = step(d.y, k.y, *run);
  a.x = *run = step(d.x, k.x, *run);
  return a;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a whole tile walked from its end, fully unrolled, the shared loads of
// each group of 4 steps sent kAhead groups before its steps
__device__ __forceinline__ float walk_tile(const float* delta, const float* coeff, float* adv,
                                           float run) {
  constexpr int kGroups = kSteps / 4;
  constexpr int kAhead = 4;
  float4 dq[kAhead], kq[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    dq[j] = load4(delta + kSteps - 4 * (j + 1));
    kq[j] = load4(coeff + kSteps - 4 * (j + 1));
  }
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int col = kSteps - 4 * (j + 1);
    const float4 d = dq[j % kAhead], k = kq[j % kAhead];
    if (j + kAhead < kGroups) {
      dq[j % kAhead] = load4(delta + col - 4 * kAhead);
      kq[j % kAhead] = load4(coeff + col - 4 * kAhead);
    }
    *reinterpret_cast<float4*>(adv + col) = step4(d, k, &run);
  }
  return run;
}

// a tile of w < kSteps steps: the steps above the last group of 4 one by
// one, then the groups, the next group's loads sent before each
__device__ __forceinline__ float walk_part(const float* delta, const float* coeff, float* adv,
                                           int w, float run) {
  const int full = w & ~3;
  for (int c = w - 1; c >= full; --c) {
    run = step(delta[c], coeff[c], run);
    adv[c] = run;
  }
  if (full == 0) {
    return run;
  }
  float4 d = load4(delta + full - 4), k = load4(coeff + full - 4);
  for (int g = full - 4; g >= 0; g -= 4) {
    float4 dn = d, kn = k;
    if (g >= 4) {
      dn = load4(delta + g - 4);
      kn = load4(coeff + g - 4);
    }
    *reinterpret_cast<float4*>(adv + g) = step4(d, k, &run);
    d = dn;
    k = kn;
  }
  return run;
}

// kVec: T % 4 == 0 and every pointer aligned for 16-byte (floats) and
// 4-byte (flags) accesses
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gae_fragment_kernel(const float* __restrict__ rewards,
                    const float* __restrict__ values,
                    const float* __restrict__ next_values,
                    const uint8_t* __restrict__ terminateds,
                    const uint8_t* __restrict__ dones,
                    float* __restrict__ adv,
                    float* __restrict__ value_targets,
                    int t, float gamma, float gamma_lambda) {
  __shared__ __align__(16) float s_delta[kSteps];
  __shared__ __align__(16) float s_coeff[kSteps];
  __shared__ __align__(16) float s_values[kSteps];
  __shared__ __align__(16) float s_adv[kSteps];
  const int lane = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * t;
  float run = 0.0f;
  for (int end = t; end > 0; end -= kSteps) {
    const int start = max(0, end - kSteps);
    const int w = end - start;
    const int64_t g0 = row + start;

    // staging with the prologue; every load of a lane is sent before
    // any is used, so the staging is one memory round trip. A lane past
    // the tile's end reads its first element (which exists) and stores
    // nothing.
    if (kVec) {
      const int c = kPerLane * lane;
      const int64_t g = g0 + (c < w ? c : 0);
      const float4 rw = load4(rewards + g);
      const float4 v = load4(values + g);
      const float4 nv = load4(next_values + g);
      const unsigned tm = *reinterpret_cast<const unsigned*>(terminateds + g);
      const unsigned dn = *reinterpret_cast<const unsigned*>(dones + g);
      if (c < w) {
        float4 d, k;
        prologue(rw.x, v.x, nv.x, tm & 0xffu, dn & 0xffu, gamma, gamma_lambda, &d.x, &k.x);
        prologue(rw.y, v.y, nv.y, (tm >> 8) & 0xffu, (dn >> 8) & 0xffu, gamma, gamma_lambda,
                 &d.y, &k.y);
        prologue(rw.z, v.z, nv.z, (tm >> 16) & 0xffu, (dn >> 16) & 0xffu, gamma, gamma_lambda,
                 &d.z, &k.z);
        prologue(rw.w, v.w, nv.w, tm >> 24, dn >> 24, gamma, gamma_lambda, &d.w, &k.w);
        *reinterpret_cast<float4*>(s_delta + c) = d;
        *reinterpret_cast<float4*>(s_coeff + c) = k;
        *reinterpret_cast<float4*>(s_values + c) = v;
      }
    } else {
      float r[kPerLane], v[kPerLane], nv[kPerLane];
      uint8_t tm[kPerLane], dn[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int c = lane + kThreads * i;
        const int64_t g = g0 + (c < w ? c : 0);
        r[i] = rewards[g];
        v[i] = values[g];
        nv[i] = next_values[g];
        tm[i] = terminateds[g];
        dn[i] = dones[g];
      }
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int c = lane + kThreads * i;
        if (c < w) {
          prologue(r[i], v[i], nv[i], tm[i], dn[i], gamma, gamma_lambda, s_delta + c,
                   s_coeff + c);
          s_values[c] = v[i];
        }
      }
    }
    __syncwarp();

    // the walk: one thread, two operations a step on the chain
    if (lane == 0) {
      run = w == kSteps ? walk_tile(s_delta, s_coeff, s_adv, run)
                        : walk_part(s_delta, s_coeff, s_adv, w, run);
    }
    __syncwarp();

    // write-back with the epilogue: value targets = advantages + values
    if (kVec) {
      const int c = kPerLane * lane;
      if (c < w) {
        const float4 a = load4(s_adv + c);
        const float4 v = load4(s_values + c);
        float4 vt;
        vt.x = __fadd_rn(a.x, v.x);
        vt.y = __fadd_rn(a.y, v.y);
        vt.z = __fadd_rn(a.z, v.z);
        vt.w = __fadd_rn(a.w, v.w);
        *reinterpret_cast<float4*>(adv + g0 + c) = a;
        *reinterpret_cast<float4*>(value_targets + g0 + c) = vt;
      }
    } else {
      for (int c = lane; c < w; c += kThreads) {
        const float a = s_adv[c];
        adv[g0 + c] = a;
        value_targets[g0 + c] = __fadd_rn(a, s_values[c]);
      }
    }
    __syncwarp();  // the tile is read out before the next one is staged
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" int gae_fragment_launch(const void* rewards, const void* values,
                                   const void* next_values,
                                   const void* terminateds, const void* dones,
                                   void* adv, void* value_targets, int n,
                                   int t, float gamma, float gamma_lambda,
                                   void* stream) {
  if (n <= 0 || t <= 0) {
    return 0;
  }
  const bool vec = t % 4 == 0 && aligned(rewards, 16) && aligned(values, 16) &&
                   aligned(next_values, 16) && aligned(adv, 16) &&
                   aligned(value_targets, 16) && aligned(terminateds, 4) &&
                   aligned(dones, 4);
  const auto* r = static_cast<const float*>(rewards);
  const auto* v = static_cast<const float*>(values);
  const auto* nv = static_cast<const float*>(next_values);
  const auto* term = static_cast<const uint8_t*>(terminateds);
  const auto* done = static_cast<const uint8_t*>(dones);
  auto* a = static_cast<float*>(adv);
  auto* vt = static_cast<float*>(value_targets);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    gae_fragment_kernel<true><<<n, kThreads, 0, s>>>(r, v, nv, term, done, a, vt, t, gamma,
                                                     gamma_lambda);
  } else {
    gae_fragment_kernel<false><<<n, kThreads, 0, s>>>(r, v, nv, term, done, a, vt, t, gamma,
                                                      gamma_lambda);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gae_fragment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
