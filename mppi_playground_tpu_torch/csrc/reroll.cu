// Nominal-trajectory re-roll and the top rows' roll-out of every model:
// <model>_reroll, x0 [n], seq [T, m] -> [T+1, n]; <model>_top_rollouts, the
// states [rows, T+1, n] of chosen samples regenerated and rolled out.
//
// Replaces: mppi_playground_tpu/ops/fused_solve.py, make_fused_reroll.kernel
// (a Pallas TPU kernel that rolls the sequence on broadcast vregs, for any
// FusedTask); and run_regen (regen_dump_only mode) followed by the batched
// re-roll that core/fused_solver.py _top compiles with it.
//
// What bounds them on the H100.  The re-roll reads 4(n + Tm) bytes and writes
// 4n(T+1): 1.2 KB for racing at T=50, 0.4 ns at 3.35 TB/s, and does a few tens
// of float operations a step.  The top rows' roll-out writes 4 n (T+1) bytes a
// row and draws T m normals a row: 300 racing rows at T=50 are 245 KB and
// about 3e6 float operations, 0.07 us and 0.05 us.  Neither bound matters:
// the T steps of a row form one chain of dependent operations, so the time is
// that chain's latency on one thread plus the launch.
//
// What this simple design does about it.  One thread rolls a horizon in
// registers through the same __device__ step as the model's fused solve
// (fused_solve.cuh reroll_kernel, regen_rollout_kernel) and writes each state
// as it goes; the top rows' CTAs are small, so that their chains run on
// several SMs.  Entry points <model>_reroll(x0, seq, model_f, model_i,
// horizon, out, stream) and <model>_top_rollouts(x0, prev, noise, rows,
// bounds, model_f, model_i, seed, horizon, num_samples, threshold, num_rows,
// out, stream), the model floats and ints as the rollout kernels take them.
#include "classic_models.cuh"
#include "danger_zone_model.cuh"
#include "fused_solve.cuh"
#include "racing_model.cuh"
#include "unicycle_model.cuh"

#define TAIL_ENTRY_POINTS(prefix, Model)                                                       \
  extern "C" int prefix##_reroll(const float* x0, const float* seq, const float* model_f,     \
                                 const int* model_i, int horizon, float* out, void* stream) {   \
    fused::reroll_kernel<Model><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(               \
        x0, seq, horizon, Model::make_args(model_f, model_i, nullptr, nullptr), out);          \
    return static_cast<int>(cudaGetLastError());                                               \
  }                                                                                            \
  extern "C" int prefix##_top_rollouts(const float* x0, const float* prev, const float* noise, \
                                       const int64_t* rows, const float* bounds,              \
                                       const float* model_f, const int* model_i,              \
                                       uint32_t seed, int horizon, int num_samples,           \
                                       int threshold, int num_rows, float* out,               \
                                       void* stream) {                                        \
    return fused::launch_regen_rollout<Model>(                                                 \
        fused::make_sampling<Model::kM>(prev, noise, bounds, seed, horizon, num_samples,       \
                                        threshold),                                            \
        rows, num_rows, x0, Model::make_args(model_f, model_i, nullptr, nullptr), nullptr,     \
        out, static_cast<cudaStream_t>(stream));                                               \
  }

TAIL_ENTRY_POINTS(racing, racing::Model)
TAIL_ENTRY_POINTS(navigation, unicycle::NavigationModel)
TAIL_ENTRY_POINTS(danger_zone, danger_zone::Model)
TAIL_ENTRY_POINTS(pendulum, classic::Pendulum)
TAIL_ENTRY_POINTS(cartpole, classic::Cartpole)
TAIL_ENTRY_POINTS(mountain_car, classic::MountainCar)
TAIL_ENTRY_POINTS(integrator, classic::Integrator)
