// Nominal-trajectory re-roll of the racing bicycle: x0 [4], seq [T, 2] -> [T+1, 4].
//
// Replaces: mppi_playground_tpu/ops/fused_solve.py, make_fused_reroll.kernel
// (a Pallas TPU kernel that rolls the sequence on broadcast vregs).
//
// What bounds it on the H100.  It reads 16 + 8T bytes and writes 16(T+1):
// 1.2 KB at T=50, 0.4 ns at 3.35 TB/s, and does about 45 float operations a
// step, 2,250 in all.  Neither bound matters: the 50 steps form one chain of
// dependent operations, so its time is that chain's latency on one thread
// plus the launch.
//
// What this simple design does about it.  One thread rolls the 50 steps in
// registers through the same __device__ bicycle step as the fused solve
// (racing_model.cuh) and writes each state as it goes.  The launch itself
// is the cost; a later change may fold it into the solve's tail or a graph.
#include <cuda_runtime.h>

#include "racing_model.cuh"

namespace {

__global__ void reroll_kernel(const float* x0, const float* seq, int horizon,
                              racing::Geometry geo, float* out) {
  float x = x0[0], y = x0[1], th = x0[2], v = x0[3];
  out[0] = x;
  out[1] = y;
  out[2] = th;
  out[3] = v;
  for (int t = 0; t < horizon; ++t) {
    racing::bicycle_step(x, y, th, v, seq[2 * t], seq[2 * t + 1], geo);
    out[4 * (t + 1) + 0] = x;
    out[4 * (t + 1) + 1] = y;
    out[4 * (t + 1) + 2] = th;
    out[4 * (t + 1) + 3] = v;
  }
}

}  // namespace

extern "C" int racing_reroll(const float* x0, const float* seq, int horizon, float x_lo,
                             float x_hi, float y_lo, float y_hi, float* out, void* stream) {
  racing::Geometry geo{x_lo, x_hi, y_lo, y_hi, 0.0f, 0.0f, 1.0f, 0, 0};
  reroll_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(x0, seq, horizon, geo, out);
  return static_cast<int>(cudaGetLastError());
}
