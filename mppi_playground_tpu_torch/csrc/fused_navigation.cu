// The Navigation2D unicycle (goal distance plus 1e4 times occupancy) on the fused kernels of
// fused_solve.cuh: navigation_fused_solve_batch (fixed lambda and MPO),
// navigation_costs_dump_batch (auto-lambda phase 1) and navigation_costs_dump_lambda_batch
// (phase 1 with the ESSPS or LBPS search in the same launch).
//
// Replaces: mppi_playground_tpu/ops/fused_solve.py make_fused_solve.kernel
// (run_kernel) for this model's FusedTask.  What bounds each launch and what
// the design does about it: fused_solve.cuh.
#include "unicycle_model.cuh"
#include "fused_solve.cuh"

FUSED_MODEL_ENTRY_POINTS(navigation, unicycle::NavigationModel)
