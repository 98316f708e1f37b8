// Racing model (kinematic bicycle with the MPCC stage cost) for the fused
// kernels (fused_solve.cuh) and the re-roll (reroll.cu).
//
// Each function repeats, operation for operation, its plain PyTorch twin in
// the package (models/bicycle.py, models/racing_mpcc.py make_mpcc_cost_soa),
// with the shared device functions of device_math.cuh; see there for the
// compile flags that keep the rounding the twin's.
#pragma once

#include <cstdint>

#include "device_math.cuh"

namespace racing {

using devmath::clampf;
using devmath::Geometry;

// Bicycle parameters (models/bicycle.py).
constexpr float kUMin0 = -2.0f, kUMax0 = 2.0f;    // accel clamp
constexpr float kUMin1 = -0.25f, kUMax1 = 0.25f;  // steer clamp
constexpr float kWheelbase = 1.0f;
constexpr float kVMax = 8.0f;
constexpr float kDeltaT = static_cast<float>(0.1);

// MPCC weights (models/racing_mpcc.py).
constexpr float kQc = 2.0f, kQl = 3.0f, kQv = 2.0f, kQo = 10000.0f;
constexpr float kQin = static_cast<float>(0.01), kQdin = 0.5f;

// models/bicycle.py _tan_small.
__device__ __forceinline__ float tan_small(float x) {
  float x2 = x * x;
  return x * (1.0f + x2 * (static_cast<float>(1.0 / 3.0) +
                           x2 * (static_cast<float>(2.0 / 15.0) +
                                 x2 * static_cast<float>(17.0 / 315.0))));
}

// models/bicycle.py make_dynamics_soa: the terms of a step that depend on the
// action alone, the clamped acceleration times dt and tan of the clamped steer.
__device__ __forceinline__ void bicycle_terms(float u0, float u1, float& accel_dt,
                                              float& tan_steer) {
  accel_dt = clampf(u0, kUMin0, kUMax0) * kDeltaT;
  tan_steer = tan_small(clampf(u1, kUMin1, kUMax1));
}

// models/bicycle.py make_dynamics_soa, one Euler step in place from the terms.
__device__ __forceinline__ void bicycle_step(float& x, float& y, float& th, float& v,
                                             float accel_dt, float tan_steer,
                                             const Geometry& g) {
  float theta = devmath::angle_normalize(th);
  float s, c;
  devmath::sincos_npi(theta, &s, &c);
  float nx = clampf(x + v * c * kDeltaT, g.x_lo, g.x_hi);
  float ny = clampf(y + v * s * kDeltaT, g.y_lo, g.y_hi);
  float nth = devmath::angle_normalize(theta + v * tan_steer / kWheelbase * kDeltaT);
  float nv = clampf(v + accel_dt, -kVMax, kVMax);
  x = nx;
  y = ny;
  th = nth;
  v = nv;
}

// models/racing_mpcc.py make_mpcc_cost_soa.  ref = (x, y, sin, cos, v).
__device__ __forceinline__ float mpcc_stage_cost(float x, float y, float v, float u0, float u1,
                                                 float pu0, float pu1, const float* ref,
                                                 const uint8_t* grid_a, const uint8_t* grid_b,
                                                 const Geometry& g) {
  float dx = x - ref[0];
  float dy = y - ref[1];
  float sin_yaw = ref[2], cos_yaw = ref[3];
  float ec = sin_yaw * dx - cos_yaw * dy;
  float el = -cos_yaw * dx - sin_yaw * dy;
  float path_cost = kQc * ec * ec + kQl * el * el;
  float dv = v - ref[4];
  float velocity_cost = kQv * (dv * dv);
  float obstacle_cost = kQo * devmath::map_cost_pair(x, y, grid_a, grid_b, g);
  float input_cost = kQin * u0 * u0 + kQin * u1 * u1;
  float d0 = u0 - pu0;
  float d1 = u1 - pu1;
  input_cost = input_cost + (kQdin * (d0 * d0) + kQdin * (d1 * d1));
  return path_cost + velocity_cost + obstacle_cost + input_cost;
}

// The model plug of fused_solve.cuh and tick_tail.cuh.  State (x, y, theta,
// v), action (accel, steer); the tick's reference rows (x, y, sin, cos, v) in
// shared memory.
// Model floats: x_lo, x_hi, y_lo, y_hi, origin_x, origin_y, cell_size;
// ints: width, height; grids: obstacle, lane.
struct Model {
  static constexpr int kN = 4, kM = 2, kRefWidth = 5;
  struct Args {
    Geometry geo;
    const uint8_t* grid_a;
    const uint8_t* grid_b;
  };
  static Args make_args(const float* f, const int* i, const uint8_t* grid_a,
                        const uint8_t* grid_b) {
    return Args{devmath::make_geometry(f, i), grid_a, grid_b};
  }
  // a step's action-only terms (accel * dt, tan of the steer), then the step from them
  static constexpr int kPre = 2;
  __device__ static __forceinline__ void prepare(const float (&u)[kM], float (&p)[kPre],
                                                 const Args&) {
    bicycle_terms(u[0], u[1], p[0], p[1]);
  }
  __device__ static __forceinline__ void step_prepared(float (&x)[kN], const float (&p)[kPre],
                                                       const Args& a) {
    bicycle_step(x[0], x[1], x[2], x[3], p[0], p[1], a.geo);
  }
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&u)[kM],
                                                     const float (&pu)[kM], const float* ref,
                                                     const Args& a) {
    return mpcc_stage_cost(x[0], x[1], x[3], u[0], u[1], pu[0], pu[1], ref, a.grid_a, a.grid_b,
                           a.geo);
  }
};

}  // namespace racing
