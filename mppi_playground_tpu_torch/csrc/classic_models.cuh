// Classic-control models for the fused kernels (fused_solve.cuh) and the
// re-roll and tick tail (tick_tail.cuh): pendulum, cartpole, mountain car and
// the integrator.
//
// Operation for operation the plain twins of models/pendulum.py,
// models/cartpole.py, models/mountain_car.py and models/integrator.py.
// Pendulum, cartpole and mountain car call libm sinf/cosf (torch.sin and
// torch.cos on the card).  The twins divide by 0-dim tensors where these
// divide, and write x * x for the JAX package's x ** 2.  None has per-launch
// floats: their constants are the modules'.
#pragma once

#include <cstdint>

#include "device_math.cuh"

namespace classic {

using devmath::clampf;

// The plug's per-launch arguments, empty for these models.
struct NoArgsModel {
  struct Args {};
  static Args make_args(const float*, const int*, const uint8_t*, const uint8_t*) {
    return Args{};
  }
};

// State (theta, theta_dot), action (torque); g=10, m=1, l=1, dt=0.05.
struct Pendulum : NoArgsModel {
  static constexpr int kN = 2, kM = 1, kRefWidth = 0, kPre = 1;
  // -3 g / (2 l) = -15 and 3 / (m l^2) = 3, folded as the model folds them;
  // the action-only term is 3 times the clamped torque
  __device__ static __forceinline__ void prepare(const float (&u)[kM], float (&p)[kPre],
                                                 const Args&) {
    p[0] = 3.0f * clampf(u[0], -2.0f, 2.0f);
  }
  __device__ static __forceinline__ void step_prepared(float (&x)[kN], const float (&p)[kPre],
                                                       const Args&) {
    const float pi = static_cast<float>(devmath::kPi);
    const float dt = 0.05f;
    float thdot = x[1] + (-15.0f * sinf(x[0] + pi) + p[0]) * dt;
    x[0] = x[0] + thdot * dt;
    x[1] = clampf(thdot, -8.0f, 8.0f);
  }
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&)[kM],
                                                     const float (&)[kM], const float*,
                                                     const Args&) {
    const float th = devmath::angle_normalize(x[0]);
    return th * th + 0.1f * (x[1] * x[1]);
  }
};

// State (x, x_dot, theta, theta_dot), action u mapped bang-bang to +-10 N.
struct Cartpole : NoArgsModel {
  static constexpr int kN = 4, kM = 1, kRefWidth = 0, kPre = 1;
  __device__ static __forceinline__ void prepare(const float (&u)[kM], float (&p)[kPre],
                                                 const Args&) {
    p[0] = u[0] >= 0.0f ? 10.0f : -10.0f;
  }
  __device__ static __forceinline__ void step_prepared(float (&x)[kN], const float (&p)[kPre],
                                                       const Args&) {
    const float total_mass = static_cast<float>(0.1 + 1.0);
    const float polemass_length = static_cast<float>(0.1 * 0.5);
    const float tau = 0.02f;
    const float x_threshold = 2.4f;
    const float theta_threshold = static_cast<float>(12 * 2 * devmath::kPi / 360);
    const float force = p[0];
    const float c = cosf(x[2]);
    const float s = sinf(x[2]);
    const float temp = (force + polemass_length * (x[3] * x[3]) * s) / total_mass;
    const float thetaacc =
        (9.8f * s - c * temp) /
        (0.5f * (static_cast<float>(4.0 / 3.0) - 0.1f * (c * c) / total_mass));
    const float xacc = temp - polemass_length * thetaacc * c / total_mass;
    const float new_x = clampf(x[0] + tau * x[1], -x_threshold, x_threshold);
    const float new_x_dt = x[1] + tau * xacc;
    const float new_theta = clampf(x[2] + tau * x[3], -theta_threshold, theta_threshold);
    const float new_theta_dt = x[3] + tau * thetaacc;
    x[0] = new_x;
    x[1] = new_x_dt;
    x[2] = new_theta;
    x[3] = new_theta_dt;
  }
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&)[kM],
                                                     const float (&)[kM], const float*,
                                                     const Args&) {
    const float th = devmath::angle_normalize(x[2]);
    return th * th + 0.1f * (x[3] * x[3]) + 0.1f * (x[0] * x[0]);
  }
};

// State (position, velocity), action (force) in +-1.
struct MountainCar : NoArgsModel {
  static constexpr int kN = 2, kM = 1, kRefWidth = 0, kPre = 1;
  __device__ static __forceinline__ void prepare(const float (&u)[kM], float (&p)[kPre],
                                                 const Args&) {
    p[0] = clampf(u[0], -1.0f, 1.0f) * 0.0015f;
  }
  __device__ static __forceinline__ void step_prepared(float (&x)[kN], const float (&p)[kPre],
                                                       const Args&) {
    float velocity = x[1] + p[0] - 0.0025f * cosf(3.0f * x[0]);
    velocity = clampf(velocity, -0.07f, 0.07f);
    x[0] = clampf(x[0] + velocity, -1.2f, 0.6f);
    x[1] = velocity;
  }
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&)[kM],
                                                     const float (&)[kM], const float*,
                                                     const Args&) {
    const float d = 0.45f - x[0];
    return d * d;
  }
};

// The README quick-start: next = state + action, cost |state - (1, 1)|^2.
struct Integrator : NoArgsModel {
  static constexpr int kN = 2, kM = 2, kRefWidth = 0, kPre = 2;
  __device__ static __forceinline__ void prepare(const float (&u)[kM], float (&p)[kPre],
                                                 const Args&) {
    p[0] = u[0];
    p[1] = u[1];
  }
  __device__ static __forceinline__ void step_prepared(float (&x)[kN], const float (&p)[kPre],
                                                       const Args&) {
    x[0] = x[0] + p[0];
    x[1] = x[1] + p[1];
  }
  __device__ static __forceinline__ float stage_cost(const float (&x)[kN], const float (&)[kM],
                                                     const float (&)[kM], const float*,
                                                     const Args&) {
    const float d0 = x[0] - 1.0f;
    const float d1 = x[1] - 1.0f;
    return d0 * d0 + d1 * d1;
  }
};

}  // namespace classic
