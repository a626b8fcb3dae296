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
// tens of nanoseconds. A thread that walked its row straight from
// global memory would wait one memory latency per step, T steps in a
// row. So a block of 128 threads stages a (16 rows x 128 steps) tile of
// the inputs in shared memory with coalesced loads, 16 of its threads
// walk their rows backwards through shared memory (a few tens of cycles
// a step), and the block writes the tile's outputs back coalesced;
// longer fragments go tile by tile from the end, the running advantage
// carried in a register. Rows of a tile are padded by one word so the
// 16 walking threads hit 16 different banks.
//
// Rounding: every operation rounds on its own (__fmul_rn, __fadd_rn,
// __fsub_rn cannot be contracted into an FMA), in the operation order
// of the plain PyTorch version in ray_tpu_torch/ops/gae.py, so the
// kernel agrees with it bitwise on the card. The file is also built
// with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;     // rows per block (one walking thread each)
constexpr int kSteps = 128;   // time steps per shared-memory tile
constexpr int kPitch = kSteps + 1;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gae_fragment_kernel(const float* __restrict__ rewards,
                    const float* __restrict__ values,
                    const float* __restrict__ next_values,
                    const uint8_t* __restrict__ terminateds,
                    const uint8_t* __restrict__ dones,
                    float* __restrict__ adv,
                    float* __restrict__ value_targets,
                    int n, int t, float gamma, float gamma_lambda) {
  // rewards/next_values tiles are overwritten in place by adv/targets
  __shared__ float s_a[kRows][kPitch];   // rewards -> advantages
  __shared__ float s_b[kRows][kPitch];   // next_values -> value targets
  __shared__ float s_v[kRows][kPitch];   // values
  __shared__ uint8_t s_term[kRows][kPitch];
  __shared__ uint8_t s_done[kRows][kPitch];

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int r_own = threadIdx.x;
  float run = 0.0f;
  for (int end = t; end > 0; end -= kSteps) {
    const int start = max(0, end - kSteps);
    const int w = end - start;
    for (int i = threadIdx.x; i < rows * w; i += kThreads) {
      const int r = i / w, c = i % w;
      const int64_t g = static_cast<int64_t>(row0 + r) * t + start + c;
      s_a[r][c] = rewards[g];
      s_b[r][c] = next_values[g];
      s_v[r][c] = values[g];
      s_term[r][c] = terminateds[g];
      s_done[r][c] = dones[g];
    }
    __syncthreads();
    if (r_own < rows) {
      for (int c = w - 1; c >= 0; --c) {
        const float not_term = __fsub_rn(1.0f, s_term[r_own][c] ? 1.0f : 0.0f);
        const float not_done = __fsub_rn(1.0f, s_done[r_own][c] ? 1.0f : 0.0f);
        const float v = s_v[r_own][c];
        // delta = rewards + gamma * next_values * not_term - values
        const float boot =
            __fmul_rn(__fmul_rn(s_b[r_own][c], gamma), not_term);
        const float delta = __fsub_rn(__fadd_rn(s_a[r_own][c], boot), v);
        // coeff = (gamma * lambda) * not_done
        const float coeff = __fmul_rn(not_done, gamma_lambda);
        run = __fadd_rn(delta, __fmul_rn(coeff, run));
        s_a[r_own][c] = run;
        s_b[r_own][c] = __fadd_rn(run, v);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * w; i += kThreads) {
      const int r = i / w, c = i % w;
      const int64_t g = static_cast<int64_t>(row0 + r) * t + start + c;
      adv[g] = s_a[r][c];
      value_targets[g] = s_b[r][c];
    }
    __syncthreads();
  }
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
  const int grid = (n + kRows - 1) / kRows;
  gae_fragment_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const float*>(values),
      static_cast<const float*>(next_values),
      static_cast<const uint8_t*>(terminateds),
      static_cast<const uint8_t*>(dones), static_cast<float*>(adv),
      static_cast<float*>(value_targets), n, t, gamma, gamma_lambda);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gae_fragment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
