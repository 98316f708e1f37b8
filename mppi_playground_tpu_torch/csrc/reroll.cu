// Nominal-trajectory re-roll of every model: x0 [n], seq [T, m] -> [T+1, n].
//
// Replaces: mppi_playground_tpu/ops/fused_solve.py, make_fused_reroll.kernel
// (a Pallas TPU kernel that rolls the sequence on broadcast vregs, for any
// FusedTask).
//
// What bounds it on the H100.  It reads 4(n + Tm) bytes and writes 4n(T+1):
// 1.2 KB for racing at T=50, 0.4 ns at 3.35 TB/s, and does a few tens of
// float operations a step.  Neither bound matters: the T steps form one chain
// of dependent operations, so its time is that chain's latency on one thread
// plus the launch.
//
// What this simple design does about it.  One thread rolls the horizon in
// registers through the same __device__ step as the model's fused solve
// (fused_solve.cuh reroll_kernel) and writes each state as it goes.  The
// launch itself is the cost; a later change may fold it into the solve's
// tail or a graph.  Entry points <model>_reroll(x0, seq, model_f, model_i,
// horizon, out, stream), the model floats and ints as the rollout kernels
// take them.
#include "classic_models.cuh"
#include "danger_zone_model.cuh"
#include "fused_solve.cuh"
#include "racing_model.cuh"
#include "unicycle_model.cuh"

#define REROLL_ENTRY_POINT(prefix, Model)                                                    \
  extern "C" int prefix##_reroll(const float* x0, const float* seq, const float* model_f,   \
                                 const int* model_i, int horizon, float* out, void* stream) { \
    fused::reroll_kernel<Model><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(             \
        x0, seq, horizon, Model::make_args(model_f, model_i, nullptr, nullptr), out);        \
    return static_cast<int>(cudaGetLastError());                                             \
  }

REROLL_ENTRY_POINT(racing, racing::Model)
REROLL_ENTRY_POINT(navigation, unicycle::NavigationModel)
REROLL_ENTRY_POINT(danger_zone, danger_zone::Model)
REROLL_ENTRY_POINT(pendulum, classic::Pendulum)
REROLL_ENTRY_POINT(cartpole, classic::Cartpole)
REROLL_ENTRY_POINT(mountain_car, classic::MountainCar)
REROLL_ENTRY_POINT(integrator, classic::Integrator)
