// The unfused route's MPCC stage cost on R rows, in one launch.
//
// Replaces: models/racing_mpcc.make_mpcc_cost's torch ops on a card (~64
// elementwise, index and reduction kernels a call, T+1 calls an unfused
// solve).  It replaces no TPU kernel: XLA fuses the JAX package's cost
// (mppi_playground_tpu/models/racing_mpcc.py), and no Pallas kernel stands
// behind it.
//
// What it computes.  Row r of the states (x, y, theta, v), the actions
// (u0, u1) and the previous actions (p0, p1) against the reference row
// (rx, ry, yaw, rv) of its group, in make_mpcc_cost's operations and order:
//
//   dx = x - rx, dy = y - ry, s = sinf(yaw), c = cosf(yaw)
//   ec = s dx - c dy, el = (-c) dx - s dy, path = qc (ec ec) + ql (el el)
//   velocity = qv ((v - rv) (v - rv))
//   obstacle = qo (grid_cost(obstacle map) + grid_cost(lane map))
//   input = qin (u0 u0 + u1 u1) + qdin (d0 d0 + d1 d1), d = u - p
//   cost = ((path + velocity) + obstacle) + input
//
// This is not racing_model.cuh's mpcc_stage_cost, the fused kernels' cost,
// which follows make_mpcc_cost_soa: that one sums the input cost as
// qin u0 u0 + qin u1 u1, reads the reference's sine and cosine from the
// extended rows and tests a grid cell != 0, where this one returns the cell's
// value.  grid_cost (maps/grid_cost.py) is read as its torch ops read it: the
// IEEE division by the cell size plus the map's own origin, rounded half to
// even (rintf), converted to int64 as torch's cast converts it on the card
// (NaN to 0, the infinities and far positions saturated), 1.0 outside
// [0, W) x [0, H), the grid's value inside.  Each map brings its own origin
// (read from device memory), cell size, shape and strides: the two need not
// share a raster.
//
// The rows come as B groups of K (R = B K; a plain call is B = 1), row b K + k
// of a tensor at b * batch_stride + k * row_stride elements, its columns
// contiguous: an expanded state (row stride 0), a column of a sequence of
// actions (row stride T m), a group's reference row (its batch stride) and
// the groups of a vmapped call are read where they lie, with no copy.  The
// output is contiguous [R].
//
// What bounds it on the H100.  A row reads 32 bytes, two grid cells and its
// group's reference row, and writes 4: at R = 4,000 some 150 KB, 0.05 us of
// HBM time.  Launch latency (~2 us) bounds it at every R the port gives it;
// the torch ops paid ~64 launches a call.
//
// What the design does about it.  One thread a row, in blocks of kThreads.
// Built with the port's -fmad=false and without fast math (ops/cuda_build.py),
// every operation rounds as torch's op-by-op kernels round it, so the cost is
// bit for bit the torch ops' (tests/test_torch_mpcc_cost.py).  Nothing here
// reads the host, so a CUDA graph captures the launch.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

struct Map {
  const float* grid;
  int64_t stride_x, stride_y, width, height;
  const float* origin;
  int64_t origin_stride;
  float cell_size;
};

struct Weights {
  float qc, ql, qv, qo, qin, qdin;
};

// maps/grid_cost.grid_cost at one position.
__device__ __forceinline__ float grid_cost(float px, float py, Map m) {
  const long long ix =
      static_cast<long long>(rintf(__fdiv_rn(px, m.cell_size) + m.origin[0]));
  const long long iy =
      static_cast<long long>(rintf(__fdiv_rn(py, m.cell_size) + m.origin[m.origin_stride]));
  if (ix < 0 || ix >= m.width || iy < 0 || iy >= m.height) return 1.0f;
  return m.grid[ix * m.stride_x + iy * m.stride_y];
}

__global__ void __launch_bounds__(kThreads) mpcc_cost_kernel(
    const float* __restrict__ states, int64_t state_batch_stride, int64_t state_row_stride,
    const float* __restrict__ actions, int64_t action_batch_stride, int64_t action_row_stride,
    const float* __restrict__ prev_actions, int64_t prev_batch_stride, int64_t prev_row_stride,
    const float* __restrict__ reference, int64_t reference_batch_stride, Map obstacle, Map lane,
    Weights w, int rows_per_batch, int rows, float* __restrict__ out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int b = r / rows_per_batch;
  const int k = r - b * rows_per_batch;
  const float* s = states + b * state_batch_stride + k * state_row_stride;
  const float* a = actions + b * action_batch_stride + k * action_row_stride;
  const float* p = prev_actions + b * prev_batch_stride + k * prev_row_stride;
  const float* ref = reference + b * reference_batch_stride;
  const float x = s[0], y = s[1], v = s[3];
  const float u0 = a[0], u1 = a[1];

  const float dx = x - ref[0];
  const float dy = y - ref[1];
  const float sin_yaw = sinf(ref[2]);
  const float cos_yaw = cosf(ref[2]);
  const float ec = sin_yaw * dx - cos_yaw * dy;
  const float el = (-cos_yaw) * dx - sin_yaw * dy;
  const float path_cost = w.qc * (ec * ec) + w.ql * (el * el);

  const float dv = v - ref[3];
  const float velocity_cost = w.qv * (dv * dv);

  const float obstacle_cost = w.qo * (grid_cost(x, y, obstacle) + grid_cost(x, y, lane));

  const float d0 = u0 - p[0];
  const float d1 = u1 - p[1];
  const float input_cost = w.qin * (u0 * u0 + u1 * u1) + w.qdin * (d0 * d0 + d1 * d1);

  out[r] = ((path_cost + velocity_cost) + obstacle_cost) + input_cost;
}

Map make_map(const float* grid, int64_t stride_x, int64_t stride_y, int64_t width,
             int64_t height, const float* origin, int64_t origin_stride, float cell_size) {
  return Map{grid, stride_x, stride_y, width, height, origin, origin_stride, cell_size};
}

}  // namespace

// states [B, K, 4], actions and prev_actions [B, K, 2], each at (batch stride, row stride,
// 1) in elements; reference [B, 4] at (reference_batch_stride, 1); each map's grid [W, H] at
// (stride_x, stride_y) and its origin [2] at origin_stride, on the card, and its cell size
// -> out [B K], contiguous; rows = B K, rows_per_batch = K.
extern "C" int mpcc_cost(
    const float* states, int64_t state_batch_stride, int64_t state_row_stride,
    const float* actions, int64_t action_batch_stride, int64_t action_row_stride,
    const float* prev_actions, int64_t prev_batch_stride, int64_t prev_row_stride,
    const float* reference, int64_t reference_batch_stride,
    const float* obstacle_grid, int64_t obstacle_stride_x, int64_t obstacle_stride_y,
    int64_t obstacle_width, int64_t obstacle_height, const float* obstacle_origin,
    int64_t obstacle_origin_stride, float obstacle_cell_size,
    const float* lane_grid, int64_t lane_stride_x, int64_t lane_stride_y, int64_t lane_width,
    int64_t lane_height, const float* lane_origin, int64_t lane_origin_stride,
    float lane_cell_size, float qc, float ql, float qv, float qo, float qin, float qdin,
    int rows_per_batch, int rows, float* out, void* stream) {
  const int blocks = (rows + kThreads - 1) / kThreads;
  mpcc_cost_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      states, state_batch_stride, state_row_stride, actions, action_batch_stride,
      action_row_stride, prev_actions, prev_batch_stride, prev_row_stride, reference,
      reference_batch_stride,
      make_map(obstacle_grid, obstacle_stride_x, obstacle_stride_y, obstacle_width,
               obstacle_height, obstacle_origin, obstacle_origin_stride, obstacle_cell_size),
      make_map(lane_grid, lane_stride_x, lane_stride_y, lane_width, lane_height, lane_origin,
               lane_origin_stride, lane_cell_size),
      Weights{qc, ql, qv, qo, qin, qdin}, rows_per_batch, rows, out);
  return static_cast<int>(cudaGetLastError());
}
