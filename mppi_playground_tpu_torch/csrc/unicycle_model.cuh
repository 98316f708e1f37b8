// Unicycle navigation model (Navigation2DEnv) for the fused kernels
// (fused_solve.cuh) and the re-roll (reroll.cu).
//
// Operation for operation the plain twins of models/unicycle.py:
// make_dynamics_soa (angle_normalize, the polynomial sin/cos of the
// normalized heading, the boundary clamp) and make_navigation_cost_soa
// (distance to the goal plus the weighted occupancy of one grid, read as
// maps/grid_cost.py grid_cost reads it).
#pragma once

#include <cstdint>

#include "device_math.cuh"

namespace unicycle {

using devmath::clampf;

// State (x, y, theta), action (v, omega).  Model floats: x_lo, x_hi, y_lo,
// y_hi, origin_x, origin_y, cell_size, v_min, omega_min, v_max, omega_max,
// delta_t, goal_x, goal_y, obstacle_weight; ints: width, height; one grid.
struct NavigationModel {
  static constexpr int kN = 3, kM = 2, kRefWidth = 0;
  struct Args {
    devmath::Geometry geo;
    float u_min0, u_min1, u_max0, u_max1, delta_t;
    float goal_x, goal_y, weight;
    const uint8_t* grid;
  };
  static Args make_args(const float* f, const int* i, const uint8_t* grid_a, const uint8_t*) {
    return Args{devmath::make_geometry(f, i), f[7], f[8], f[9], f[10], f[11], f[12], f[13],
                f[14], grid_a};
  }
  // a step's action-only terms: the clamped speed and the clamped turn rate times dt
  static constexpr int kPre = 2;
  __device__ static __forceinline__ void prepare(const float (&u)[kM], float (&p)[kPre],
                                                 const Args& a) {
    p[0] = clampf(u[0], a.u_min0, a.u_max0);
    p[1] = clampf(u[1], a.u_min1, a.u_max1) * a.delta_t;
  }
  __device__ static __forceinline__ void step_prepared(float (&x)[kN], const float (&p)[kPre],
                                                       const Args& a) {
    const float theta = devmath::angle_normalize(x[2]);
    const float v = p[0];
    float s, c;
    devmath::sincos_npi(theta, &s, &c);
    const float nx = clampf(x[0] + v * c * a.delta_t, a.geo.x_lo, a.geo.x_hi);
    const float ny = clampf(x[1] + v * s * a.delta_t, a.geo.y_lo, a.geo.y_hi);
    x[2] = devmath::angle_normalize(theta + p[1]);
    x[0] = nx;
    x[1] = ny;
  }
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&)[kM],
                                                     const float (&)[kM], const float*,
                                                     const Args& a) {
    const float dx = x[0] - a.goal_x;
    const float dy = x[1] - a.goal_y;
    const float goal_cost = sqrtf(dx * dx + dy * dy);
    return goal_cost + a.weight * devmath::map_occupancy(x[0], x[1], a.grid, a.geo);
  }
};

}  // namespace unicycle
