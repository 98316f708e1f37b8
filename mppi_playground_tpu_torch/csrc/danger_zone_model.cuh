// Goal-in-danger-zone model for the fused kernels (fused_solve.cuh) and the
// re-roll (reroll.cu).
//
// Operation for operation the plain twins of models/danger_zone.py: the
// heading integrates before the position, with libm cosf/sinf (torch.cos and
// torch.sin on the card); goal and centre are recovered from the
// observation; the cost is the distance to the goal plus the weight where
// the distance to the centre is below the radius.  The 7-float state stays
// in registers.
#pragma once

#include "device_math.cuh"

namespace danger_zone {

using devmath::clampf;

// State (x, y, theta, goal_dx, goal_dy, center_dx, center_dy), action
// (v, omega).  Model floats: v_min, omega_min, v_max, omega_max, delta_t,
// radius, collision_weight.
struct Model {
  static constexpr int kN = 7, kM = 2, kRefWidth = 0;
  struct Args {
    float u_min0, u_min1, u_max0, u_max1, delta_t, radius, weight;
  };
  static Args make_args(const float* f, const int*, const uint8_t*, const uint8_t*) {
    return Args{f[0], f[1], f[2], f[3], f[4], f[5], f[6]};
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
    const float gx = x[0] + x[3], gy = x[1] + x[4];
    const float cx = x[0] + x[5], cy = x[1] + x[6];
    const float v = p[0];
    const float theta = devmath::angle_normalize(x[2] + p[1]);
    const float nx = x[0] + v * cosf(theta) * a.delta_t;
    const float ny = x[1] + v * sinf(theta) * a.delta_t;
    x[0] = nx;
    x[1] = ny;
    x[2] = theta;
    x[3] = gx - nx;
    x[4] = gy - ny;
    x[5] = cx - nx;
    x[6] = cy - ny;
  }
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&)[kM],
                                                     const float (&)[kM], const float*,
                                                     const Args& a) {
    const float dist_to_goal = sqrtf(x[3] * x[3] + x[4] * x[4]);
    const float collided = sqrtf(x[5] * x[5] + x[6] * x[6]) < a.radius ? 1.0f : 0.0f;
    return dist_to_goal + collided * a.weight;
  }
};

}  // namespace danger_zone
