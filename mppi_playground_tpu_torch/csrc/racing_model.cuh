// Racing model device functions shared by the fused solve and re-roll kernels.
//
// Each function repeats, operation for operation, its plain PyTorch twin in
// the package (utils/angles.py, utils/fastmath.py, models/bicycle.py,
// models/racing_mpcc.py make_mpcc_cost_soa, maps/grid_cost.py grid_cost_pair,
// ops/fused_solve.py philox4x32_10 and normal_pair_from_bits).  The sources
// are compiled without --use_fast_math and with -fmad=false, so every
// float operation rounds as the twin's does: no a*b+c is contracted into an
// FMA, division and sqrtf are IEEE, and fmodf is exact.  Constants are Python
// doubles rounded to float32, as they are where they meet a float32 tensor.
#pragma once

#include <cstdint>

namespace racing {

constexpr double kPi = 3.141592653589793;

// Bicycle parameters (models/bicycle.py).
constexpr float kUMin0 = -2.0f, kUMax0 = 2.0f;    // accel clamp
constexpr float kUMin1 = -0.25f, kUMax1 = 0.25f;  // steer clamp
constexpr float kWheelbase = 1.0f;
constexpr float kVMax = 8.0f;
constexpr float kDeltaT = static_cast<float>(0.1);

// MPCC weights (models/racing_mpcc.py).
constexpr float kQc = 2.0f, kQl = 3.0f, kQv = 2.0f, kQo = 10000.0f;
constexpr float kQin = static_cast<float>(0.01), kQdin = 0.5f;

struct Geometry {
  float x_lo, x_hi, y_lo, y_hi;  // position clamp of the dynamics
  float origin_x, origin_y;      // cell coordinates of the world origin
  float cell_size;               // meters per cell
  int width, height;             // grid cells, grid[ix * height + iy]
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// torch.remainder(x + pi, 2 pi) - pi: fmod, then add the divisor where the
// nonzero remainder is negative (floored remainder, as JAX's %).
__device__ __forceinline__ float angle_normalize(float x) {
  const float pi = static_cast<float>(kPi);
  const float two_pi = static_cast<float>(2.0 * kPi);
  float r = fmodf(x + pi, two_pi);
  if (r != 0.0f && r < 0.0f) r = r + two_pi;
  return r - pi;
}

// utils/fastmath.py sincos_npi: x in [-pi, pi].
__device__ __forceinline__ void sincos_npi(float x, float* s, float* c) {
  const float pi = static_cast<float>(kPi);
  const float half_pi = static_cast<float>(kPi / 2);
  const float quarter_pi = static_cast<float>(kPi / 4);
  float ax = fabsf(x);
  bool flip = ax > half_pi;
  float r = flip ? pi - ax : ax;
  bool swap = r > quarter_pi;
  float t = swap ? half_pi - r : r;
  float t2 = t * t;
  float sp = t * (1.0f + t2 * (static_cast<float>(-1.0 / 6.0) +
                               t2 * (static_cast<float>(1.0 / 120.0) +
                                     t2 * (static_cast<float>(-1.0 / 5040.0) +
                                           t2 * static_cast<float>(1.0 / 362880.0)))));
  float cp = 1.0f + t2 * (-0.5f + t2 * (static_cast<float>(1.0 / 24.0) +
                                        t2 * (static_cast<float>(-1.0 / 720.0) +
                                              t2 * static_cast<float>(1.0 / 40320.0))));
  float s_r = swap ? cp : sp;
  float c_r = swap ? sp : cp;
  *s = x < 0.0f ? -s_r : s_r;
  *c = flip ? -c_r : c_r;
}

// models/bicycle.py _tan_small.
__device__ __forceinline__ float tan_small(float x) {
  float x2 = x * x;
  return x * (1.0f + x2 * (static_cast<float>(1.0 / 3.0) +
                           x2 * (static_cast<float>(2.0 / 15.0) +
                                 x2 * static_cast<float>(17.0 / 315.0))));
}

// models/bicycle.py make_dynamics_soa, one Euler step in place.
__device__ __forceinline__ void bicycle_step(float& x, float& y, float& th, float& v,
                                             float u0, float u1, const Geometry& g) {
  float theta = angle_normalize(th);
  float accel = clampf(u0, kUMin0, kUMax0);
  float steer = clampf(u1, kUMin1, kUMax1);
  float s, c;
  sincos_npi(theta, &s, &c);
  float nx = clampf(x + v * c * kDeltaT, g.x_lo, g.x_hi);
  float ny = clampf(y + v * s * kDeltaT, g.y_lo, g.y_hi);
  float nth = angle_normalize(theta + v * tan_small(steer) / kWheelbase * kDeltaT);
  float nv = clampf(v + accel * kDeltaT, -kVMax, kVMax);
  x = nx;
  y = ny;
  th = nth;
  v = nv;
}

// maps/grid_cost.py grid_cost_pair: one shared cell index, two grid reads.
__device__ __forceinline__ float map_cost_pair(float px, float py, const uint8_t* grid_a,
                                               const uint8_t* grid_b, const Geometry& g) {
  float ix = rintf(px / g.cell_size + g.origin_x);
  float iy = rintf(py / g.cell_size + g.origin_y);
  bool oob = (ix < 0.0f) || (ix >= static_cast<float>(g.width)) || (iy < 0.0f) ||
             (iy >= static_cast<float>(g.height));
  int ixi = static_cast<int>(clampf(ix, 0.0f, static_cast<float>(g.width - 1)));
  int iyi = static_cast<int>(clampf(iy, 0.0f, static_cast<float>(g.height - 1)));
  size_t idx = static_cast<size_t>(ixi) * g.height + iyi;
  float a = (oob || __ldg(grid_a + idx) != 0) ? 1.0f : 0.0f;
  float b = (oob || __ldg(grid_b + idx) != 0) ? 1.0f : 0.0f;
  return a + b;
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
  float obstacle_cost = kQo * map_cost_pair(x, y, grid_a, grid_b, g);
  float input_cost = kQin * u0 * u0 + kQin * u1 * u1;
  float d0 = u0 - pu0;
  float d1 = u1 - pu1;
  input_cost = input_cost + (kQdin * (d0 * d0) + kQdin * (d1 * d1));
  return path_cost + velocity_cost + obstacle_cost + input_cost;
}

// Philox4x32-10 (Salmon et al., SC'11): counter ctr, key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
  const uint32_t m0 = 0xD2511F53u, m1 = 0xCD9E8D57u;
  const uint32_t w0 = 0x9E3779B9u, w1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += w0;
      k1 += w1;
    }
    uint32_t hi0 = __umulhi(m0, ctr.x), lo0 = m0 * ctr.x;
    uint32_t hi1 = __umulhi(m1, ctr.z), lo1 = m1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// Box–Muller on 24 random bits each (ops/fused_solve.py of the JAX package,
// _normal_pair_from_bits): u1 in [2^-25, 1), u2 in [0, 1).
__device__ __forceinline__ void normal_pair_from_bits(uint32_t b1, uint32_t b2, float* z1,
                                                      float* z2) {
  const float two_pi = static_cast<float>(2.0 * kPi);
  const float pi = static_cast<float>(kPi);
  float u1 = static_cast<float>(b1 & 0xFFFFFFu) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
  float u2 = static_cast<float>(b2 & 0xFFFFFFu) * 5.9604644775390625e-08f;
  float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincos_npi(two_pi * u2 - pi, &s, &c);  // sincos_2pi: sin x = -sin(x - pi)
  *z1 = r * -c;
  *z2 = r * -s;
}

}  // namespace racing
