// The cartpole (bang-bang force) on the fused kernels of
// fused_solve.cuh: cartpole_fused_solve_batch (fixed lambda and MPO),
// cartpole_costs_dump_batch (auto-lambda phase 1) and cartpole_costs_dump_lambda_batch
// (phase 1 with the ESSPS or LBPS search in the same launch).
//
// Replaces: mppi_playground_tpu/ops/fused_solve.py make_fused_solve.kernel
// (run_kernel) for this model's FusedTask.  What bounds each launch and what
// the design does about it: fused_solve.cuh.
#include "classic_models.cuh"
#include "fused_solve.cuh"

FUSED_MODEL_ENTRY_POINTS(cartpole, classic::Cartpole)
