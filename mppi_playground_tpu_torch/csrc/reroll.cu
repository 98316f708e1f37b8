// The tick's tail, the nominal re-roll and the top rows' roll-out of every
// model: <model>_tick_tail_batch (the block partials merged into the update, ESS
// and weights, the SG filter, the history shift, the re-roll: tick_tail.cuh);
// <model>_reroll, x0 [n], seq [T, m] -> [T+1, n]; <model>_top_rollouts, the
// states [rows, T+1, n] of chosen samples regenerated and rolled out.
//
// Replaces: mppi_playground_tpu/ops/fused_solve.py, make_fused_reroll.kernel
// (a Pallas TPU kernel that rolls the sequence on broadcast vregs, for any
// FusedTask) with the merge and filter XLA runs around it; and run_regen
// (regen_dump_only mode) followed by the batched re-roll that
// core/fused_solver.py _top compiles with it.
//
// What bounds them on the H100, and the design: tick_tail.cuh for the first
// two.  The top rows' roll-out writes 4 n (T+1) bytes a row and draws T m
// normals a row: 300 racing rows at T=50 are 245 KB and about 3e6 float
// operations, 0.07 us and 0.05 us; but the T steps of a row form one chain of
// dependent operations, so the time is that chain's latency on one thread
// plus the launch.  One thread a row (fused_solve.cuh regen_rollout_kernel)
// through the model's step, small CTAs so that the chains run on several
// SMs.  Entry points <model>_tick_tail_batch(x0, costs, stats, numer, lam,
// history, coeffs, model_f, model_i, blocks, horizon, num_samples, window,
// batch, actions, states, ess, weights, history_out, key, key_out, stream)
// (every array [B, ...] but the SG window, the keys [B, 3]; a single solve's
// tail is a batch of one), <model>_reroll(x0, seq, model_f, model_i, horizon,
// out, stream) and <model>_top_rollouts(x0, prev, noise, rows, bounds,
// model_f, model_i, seed, horizon, num_samples, threshold, num_rows, out,
// stream), the model floats and ints as the rollout
// kernels take them.
// The entry points of one model are TAIL_ENTRY_POINTS (tail_entry_points.cuh),
// which a user's model plug instantiates in its own generated unit.
#include "classic_models.cuh"
#include "danger_zone_model.cuh"
#include "racing_model.cuh"
#include "tail_entry_points.cuh"
#include "unicycle_model.cuh"

TAIL_ENTRY_POINTS(racing, racing::Model)
TAIL_ENTRY_POINTS(navigation, unicycle::NavigationModel)
TAIL_ENTRY_POINTS(danger_zone, danger_zone::Model)
TAIL_ENTRY_POINTS(pendulum, classic::Pendulum)
TAIL_ENTRY_POINTS(cartpole, classic::Cartpole)
TAIL_ENTRY_POINTS(mountain_car, classic::MountainCar)
TAIL_ENTRY_POINTS(integrator, classic::Integrator)
