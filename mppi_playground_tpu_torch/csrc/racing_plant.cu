// The racing plant's kinematic-bicycle Euler step on R rows, in one launch.
//
// Replaces: envs/racing_env.RacingEnv.dynamics's torch ops on a card
// (models/bicycle.make_dynamics: ~67 elementwise kernels a call).  It replaces
// no TPU kernel: XLA fuses the JAX package's step
// (mppi_playground_tpu/models/bicycle.py), and no Pallas kernel stands behind it.
//
// What it computes.  Row r of the states (x, y, theta, v) and the actions
// (accel, steer) steps as racing::bicycle_terms then racing::bicycle_step
// (racing_model.cuh) step it: the device functions that row 1, the re-roll and
// the tick tail roll out with, so that the plant and the solver's model cannot
// drift apart.  The rows come as B groups of K (R = B K; a plain call is B = 1),
// row b K + k of a tensor at b * batch_stride + k * row_stride elements, its
// columns contiguous: an expanded state (row stride 0), a column of a sequence
// of actions (row stride T m) and the groups of a vmapped call (the batch
// stride) are read where they lie, with no copy.  The output is contiguous
// [R, 4].
//
// What bounds it on the H100.  A row reads 24 bytes and writes 16: at R = 4,000
// that is 160 KB, 0.05 us of HBM time.  Launch latency (~2 us) bounds it at
// every R the port gives it; the torch ops paid ~67 launches a call.
//
// What the design does about it.  One thread a row, in blocks of kThreads; the
// output written as one 16-byte store a row.  Built with the port's -fmad=false
// and without fast math (ops/cuda_build.py), every operation rounds as torch's
// op-by-op kernels round it, so the step is bit for bit the torch ops'.  One
// difference of semantics is mended here: torch.clamp returns a NaN it is given,
// where clampf (fminf/fmaxf) returns a bound.  So the step runs with the map's
// clamps opened (clampf(p, NaN, NaN) is p, NaN or not), each position is then
// clamped keeping a NaN, and a NaN speed or action, which the model's clamps of
// the speed and the action turn into numbers, gives the NaN torch gives: the
// speed's for a NaN speed or acceleration, the heading's for a NaN steer.  A
// NaN state so stays NaN, as on the CPU, where a guard downstream sees it.
// Nothing here reads the host, so a CUDA graph captures the launch.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "racing_model.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float clamp_keeping_nan(float p, float lo, float hi) {
  return isnan(p) ? p : devmath::clampf(p, lo, hi);
}

__global__ void __launch_bounds__(kThreads) racing_plant_kernel(
    const float* __restrict__ states, int64_t state_batch_stride, int64_t state_row_stride,
    const float* __restrict__ actions, int64_t action_batch_stride,
    int64_t action_row_stride, int rows_per_batch, int rows, float x_lo, float x_hi, float y_lo,
    float y_hi, float* __restrict__ out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int b = r / rows_per_batch;
  const int k = r - b * rows_per_batch;
  const float* s = states + b * state_batch_stride + k * state_row_stride;
  const float* a = actions + b * action_batch_stride + k * action_row_stride;
  float x = s[0], y = s[1], th = s[2], v = s[3];
  const float u0 = a[0], u1 = a[1];
  const bool nan_speed = isnan(v) || isnan(u0);

  const float nan = __int_as_float(0x7fffffff);
  const devmath::Geometry open{nan, nan, nan, nan, 0.0f, 0.0f, 0.0f, 0, 0, 0.0f};
  float accel_dt, tan_steer;
  racing::bicycle_terms(u0, u1, accel_dt, tan_steer);
  racing::bicycle_step(x, y, th, v, accel_dt, tan_steer, open);
  reinterpret_cast<float4*>(out)[r] = make_float4(
      clamp_keeping_nan(x, x_lo, x_hi), clamp_keeping_nan(y, y_lo, y_hi),
      isnan(u1) ? nan : th, nan_speed ? nan : v);
}

}  // namespace

// states [B, K, 4] at (state_batch_stride, state_row_stride, 1) and actions [B, K, 2] at
// (action_batch_stride, action_row_stride, 1), in elements -> out [B K, 4], contiguous and
// 16-byte aligned; rows = B K, rows_per_batch = K.
extern "C" int racing_plant(const float* states, int64_t state_batch_stride,
                            int64_t state_row_stride, const float* actions,
                            int64_t action_batch_stride, int64_t action_row_stride,
                            int rows_per_batch, int rows, float x_lo, float x_hi, float y_lo,
                            float y_hi, float* out, void* stream) {
  const int blocks = (rows + kThreads - 1) / kThreads;
  racing_plant_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      states, state_batch_stride, state_row_stride, actions, action_batch_stride,
      action_row_stride, rows_per_batch, rows, x_lo, x_hi, y_lo, y_hi, out);
  return static_cast<int>(cudaGetLastError());
}
